"""Batched pixel prep for the training epoch loop (numpy); the port's own copy
of supnerf_tpu/training/pixel_prep.py.

The per-row prep (ray_prep.prepare_train_sample) materialises the masked
ROI crop, resizes it to the encoder's input and reshapes it to gather the
ray targets: work in proportion to the ROI's area. This module does the
same arithmetic with work bounded per row:

  - resize_masked_from_full: the encoder input is a bilinear resample of
    img * (mask > 0) over the ROI onto a fixed out_size square, so for a
    large ROI the four bilinear neighbours of each output pixel are
    gathered straight from the full image (half-pixel centres, border
    replicate: the sampling of geometry/roi.resize_bilinear_np) and lerped;
    a small ROI (h * w <= 5 * out_size^2) takes the crop, multiply and
    resize path, as the JAX package does;
  - the ray targets: the flat-crop gather crop.reshape(-1, 3)[ids] becomes a
    full-image index at (roi[1] + ids // w, roi[0] + ids % w) (the training
    grid over an integer ROI has step 1);
  - the ray directions of the whole batch in one vectorised block, per-ray
    arithmetic in float32 and origins and depths in float64, as the JAX
    package mixes them.

The caller draws each row's ids, depth jitter and flip coin in the order of
ray_prep.prepare_pixel_samples, so batched and per-row prep give the same
samples up to the bilinear arithmetic (tests/test_torch_pixel_prep.py).
"""
from __future__ import annotations

import numpy as np

from supnerf_tpu_torch.geometry.roi import resize_bilinear_np


def _resize_grid(src_len: int, dst_len: int):
    """Half-pixel-centre source coordinates of a dst_len output row sampled
    from a src_len input row, clamped (border replicate): the floor index,
    the next index and the lerp weight."""
    src = (np.arange(dst_len, dtype=np.float64) + 0.5) * (src_len / dst_len) - 0.5
    src = np.clip(src, 0.0, src_len - 1)
    i0 = np.floor(src).astype(np.int64)
    i1 = np.minimum(i0 + 1, src_len - 1)
    w = (src - i0).astype(np.float32)
    return i0, i1, w


def _centred(resized, new_h: int, new_w: int, out_size: int, fill: float):
    out = np.full((out_size, out_size, 3), np.float32(fill), dtype=np.float32)
    oy = int(out_size / 2 - new_h / 2)
    ox = int(out_size / 2 - new_w / 2)
    out[oy:oy + new_h, ox:ox + new_w] = resized
    return out


def resize_masked_from_full(img, mask, roi, new_hw, out_size: int, fill: float = 1.0):
    """geometry/roi.preprocess_img_square(crop * (mask_crop > 0), out_size)
    without materialising the crop of a large ROI: the (new_h, new_w)
    bilinear resample of the masked ROI, centred on a `fill` square.

    img (H, W, 3) float32; mask (H, W); roi [x0, y0, x1, y1] integers;
    new_hw the resized extent (square_resize_hw). Returns (out_size,
    out_size, 3) float32."""
    x0, y0, x1, y1 = int(roi[0]), int(roi[1]), int(roi[2]), int(roi[3])
    h, w = y1 - y0, x1 - x0
    new_h, new_w = int(new_hw[0]), int(new_hw[1])

    if h * w <= 5 * out_size * out_size:
        # a small crop: slicing and resizing it costs less than the gathers
        mc = mask[y0:y1, x0:x1, None]
        resized = resize_bilinear_np(img[y0:y1, x0:x1] * (mc > 0),
                                     (new_h, new_w)).reshape(new_h, new_w, 3)
        return _centred(resized, new_h, new_w, out_size, fill)

    ri0, ri1, wy = _resize_grid(h, new_h)
    ci0, ci1, wx = _resize_grid(w, new_w)
    cols = np.concatenate([ci0, ci1]) + x0

    # two outer-indexed gathers give all four neighbours: rows x (cols0, cols1)
    def masked(rows):
        sub = img[np.ix_(rows, cols)]
        return sub * (mask[np.ix_(rows, cols)] > 0)[..., None]

    r0, r1 = masked(ri0 + y0), masked(ri1 + y0)
    v00, v01 = r0[:, :new_w], r0[:, new_w:]
    v10, v11 = r1[:, :new_w], r1[:, new_w:]
    wxc = wx[None, :, None]
    top = v00 + (v01 - v00) * wxc
    bot = v10 + (v11 - v10) * wxc
    return _centred(top + (bot - top) * wy[:, None, None], new_h, new_w, out_size, fill)


def square_resize_hw(h: int, w: int, out_size: int):
    """The (new_h, new_w) that preprocess_img_square gives an (h, w) crop,
    with its truncation."""
    ratio = out_size / max(h, w)
    return int(h * ratio), int(w * ratio)


def batched_train_rays(rois, ids, Ks, cam_poses, wlhs, z_jitters, sym_flips, n_samples: int,
                       shapenet_obj_cood: bool):
    """prepare_pixel_samples' compact ray arithmetic for a batch of rows.

    rois (B, 4) integers; ids (B, R) flat crop-grid indices; Ks (B, 3, 3);
    cam_poses (B, 3, 4); wlhs (B, 3); z_jitters (B, S), each row's
    rng.random(S); sym_flips (B,) bool.

    Returns (dict(xyz (B, R, 3) diagonal-normalised origins, viewdir
    (B, R, 3), z_vals (B, S)) in float32, ys, xs), the pixel coordinates
    (B, R) in the full image for the target gathers."""
    rois = np.asarray(rois, np.int64)
    ids = np.asarray(ids, np.int64)
    ws = (rois[:, 2] - rois[:, 0])[:, None]
    xs = rois[:, 0:1] + ids % ws
    ys = rois[:, 1:2] + ids // ws

    # per-ray arithmetic in float32 (the per-row path's is float64 before its
    # final cast: about one float32 ulp apart)
    Ks = np.asarray(Ks, np.float32)
    xs32, ys32 = xs.astype(np.float32), ys.astype(np.float32)
    dx, dy = Ks[:, 0, 2][:, None], Ks[:, 1, 2][:, None]
    fx, fy = Ks[:, 0, 0][:, None], Ks[:, 1, 1][:, None]
    dirs = np.stack([(xs32 - dx) / fx, (ys32 - dy) / fy, np.ones_like(xs32)], axis=-1)
    c2w = np.asarray(cam_poses, np.float32)
    rays_d = np.einsum("brj,bkj->brk", dirs, c2w[:, :3, :3])
    viewdir = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)

    # origins and depths in float64
    c2w = c2w.astype(np.float64)
    diag = np.linalg.norm(np.asarray(wlhs, np.float64), axis=-1)
    origin = c2w[:, :3, 3] / diag[:, None]
    xyz = np.broadcast_to(origin[:, None, :], viewdir.shape).copy()
    vds = viewdir.copy()

    flips = np.asarray(sym_flips, bool)
    xyz[flips, :, 1] *= -1
    vds[flips, :, 1] *= -1
    if shapenet_obj_cood:
        xyz = np.stack([-xyz[..., 1], xyz[..., 0], xyz[..., 2]], axis=-1)
        vds = np.stack([-vds[..., 1], vds[..., 0], vds[..., 2]], axis=-1)

    dist_cam = np.linalg.norm(c2w[:, :, 3], axis=-1)
    near, far = dist_cam - diag / 2, dist_cam + diag / 2
    half = ((far - near) / (2 * n_samples))[:, None]
    z_vals = np.linspace(near[:, None] + half, far[:, None] - half, n_samples, axis=-1)[:, 0, :]
    z_vals = z_vals + np.asarray(z_jitters, np.float64) * half

    return {"xyz": xyz.astype(np.float32), "viewdir": vds.astype(np.float32),
            "z_vals": z_vals.astype(np.float32)}, ys, xs


def gather_targets(img, mask, ys, xs):
    """One row's masked RGB and occupancy targets at its ray pixels, from the
    full image: (crop * (mask_crop > 0)).reshape(-1, 3)[ids] and
    mask_crop.reshape(-1, 1)[ids]."""
    m = np.asarray(mask, np.float32)[ys, xs]
    rgb = np.asarray(img, np.float32)[ys, xs] * (m > 0)[:, None]
    return rgb.astype(np.float32), m[:, None].astype(np.float32)
