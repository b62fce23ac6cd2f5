"""Host-side per-sample ray preparation for training (numpy); the port's own
copy of supnerf_tpu/training/ray_prep.py (reference utils.py
prepare_pixel_samples :330-377 via data_nuscenes.py:615-658).

Build the rays over the (variable-size) ROI, draw a fixed-size subset of its
pixels, stratified-sample depths in the frustum shell around the object,
normalise by the object's diagonal and apply the object-frame transforms.
The numpy arithmetic and the order of the random draws are the JAX
package's, so the same np.random.Generator gives the same rays; the encoder
image is resized by torch.nn.functional.interpolate (geometry/roi.py)
instead of OpenCV, and the box-corner projection runs on torch tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from supnerf_tpu_torch.geometry import roi as roi_ops
from supnerf_tpu_torch.geometry.boxes import corners_of_box, view_points


def _get_rays_np(K, c2w, roi, uv_steps=None, ids=None):
    """Rays over the ROI pixel grid; with ids (flat row-major indices into
    the (h_steps, w_steps) grid) only those pixels' rays, identical to
    indexing the full grid."""
    dx, dy, fx, fy = K[0, 2], K[1, 2], K[0, 0], K[1, 1]
    if uv_steps is not None:
        xs = np.linspace(roi[0], roi[2] - 1, uv_steps[0])
        ys = np.linspace(roi[1], roi[3] - 1, uv_steps[1])
    else:
        xs = np.linspace(roi[0], roi[2] - 1, int(roi[2] - roi[0]))
        ys = np.linspace(roi[1], roi[3] - 1, int(roi[3] - roi[1]))
    if ids is not None:
        i = xs[ids % len(xs)]
        j = ys[ids // len(xs)]
    else:
        i, j = np.meshgrid(xs, ys, indexing="xy")
    dirs = np.stack([(i - dx) / fx, (j - dy) / fy, np.ones_like(i)], -1)
    rays_d = dirs @ c2w[:3, :3].T
    viewdir = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
    rays_o = np.broadcast_to(c2w[:3, 3], viewdir.shape)
    return rays_o.reshape(-1, 3), viewdir.reshape(-1, 3)


def prepare_pixel_samples(img_crop, mask_crop, cam_pose, obj_diag, K, roi,
                          n_rays: int, n_samples: int, shapenet_obj_cood: bool,
                          sym_aug: bool, rng: np.random.Generator,
                          im_sz: int | None = None, compact: bool = False):
    """img_crop (h, w, 3) ROI crop; mask_crop (h, w, 1) in {-1, 0, 1}.

    Returns dict(xyz, viewdir, z_vals (S,), rgb_tgt (n_rays, 3), occ_pixels
    (n_rays, 1)): xyz and viewdir (n_rays, S, 3), or with compact=True the
    diagonal-normalised ray origin and the unit direction (n_rays, 3) each,
    which train_step.expand_compact_rays turns into the point grid. An ROI
    with fewer pixels than n_rays repeats pixels."""
    near = np.linalg.norm(cam_pose[:, 3]) - obj_diag / 2
    far = np.linalg.norm(cam_pose[:, 3]) + obj_diag / 2

    if im_sz is None:
        h_steps = int(roi[3] - roi[1])
        w_steps = int(roi[2] - roi[0])
        img_px = img_crop.reshape(-1, 3)
        occ_px = mask_crop.reshape(-1, 1)
    else:
        h_steps = w_steps = im_sz
        img_px = roi_ops.resize_bilinear_np(img_crop, (im_sz, im_sz)).reshape(-1, 3)
        occ_px = np.trunc(
            roi_ops.resize_bilinear_np(mask_crop[..., 0], (im_sz, im_sz))).reshape(-1, 1)

    total = h_steps * w_steps
    ids = rng.permutation(total)[:n_rays]
    if len(ids) < n_rays:
        ids = np.concatenate([ids, rng.choice(total, n_rays - len(ids))])
    rays_o, viewdir = _get_rays_np(K, cam_pose, roi,
                                   uv_steps=None if im_sz is None else (im_sz, im_sz), ids=ids)
    rgb_tgt = img_px[ids]
    occ_pixels = occ_px[ids]

    # stratified depths with one jitter vector shared by the object's rays
    # (reference sample_from_rays, utils.py:154-167)
    dist = (far - near) / (2 * n_samples)
    z_vals = np.linspace(near + dist, far - dist, n_samples)
    z_vals = z_vals + rng.random(n_samples) * (far - near) / (2 * n_samples)

    if compact:
        xyz = rays_o / obj_diag
        vds = viewdir.copy()
        if sym_aug and rng.random() > 0.5:
            xyz[:, 1] *= -1
            vds[:, 1] *= -1
    else:
        xyz = (rays_o[:, None, :] + viewdir[:, None, :] * z_vals[None, :, None]) / obj_diag
        vds = np.broadcast_to(viewdir[:, None, :], xyz.shape).copy()
        if sym_aug and rng.random() > 0.5:
            xyz[:, :, 1] *= -1
            vds[:, :, 1] *= -1
    if shapenet_obj_cood:
        xyz = np.stack([-xyz[..., 1], xyz[..., 0], xyz[..., 2]], axis=-1)
        vds = np.stack([-vds[..., 1], vds[..., 0], vds[..., 2]], axis=-1)
    return {
        "xyz": xyz.astype(np.float32),
        "viewdir": vds.astype(np.float32),
        "z_vals": z_vals.astype(np.float32),
        "rgb_tgt": rgb_tgt.astype(np.float32),
        "occ_pixels": occ_pixels.astype(np.float32),
    }


def project_box_corners(obj_poses, wlh, K) -> np.ndarray:
    """Pixel coordinates (B, 2, 8) of the boxes' corners: poses (B, 3, 4),
    wlh (B, 3), K (B, 3, 3), numpy in and out."""
    t = [torch.as_tensor(np.asarray(a, np.float32)) for a in (obj_poses, wlh, K)]
    return view_points(corners_of_box(t[0], t[1]), t[2])[:, :2].numpy()


def prepare_train_sample(sample, *, n_rays: int = 1024, n_samples: int = 64,
                         in_img_sz: int = 128, roi_margin: int = 5,
                         shapenet_obj_cood: bool = True, sym_aug: bool = False,
                         rng=None, render_sz: int | None = None, src_pose=None,
                         code_idx: int = 0, compact_rays: bool = False, tgt_uv=None):
    """One dataset sample dict (data.synthetic) -> one row of a TrainBatch
    (numpy; stack rows along a new axis 0). tgt_uv: optional precomputed
    (2, 8) projected ground-truth corners (the trainer projects a whole batch
    at once)."""
    rng = np.random.default_rng() if rng is None else rng
    img, mask_occ = sample["imgs"], sample["masks_occ"]
    H, W = img.shape[:2]
    roi = roi_ops.roi_process(sample["rois"], H, W, roi_margin, sq_pad=render_sz is not None)
    # training keeps the background BLACK after masking (reference
    # data_nuscenes.py:637-639)
    mask_crop = np.asarray(mask_occ, np.float32)[roi[1]:roi[3], roi[0]:roi[2]][..., None]
    img_crop = np.asarray(img, np.float32)[roi[1]:roi[3], roi[0]:roi[2]] * (mask_crop > 0)
    img_in = roi_ops.preprocess_img_square(img_crop, in_img_sz)

    wlh = sample["wlh"]
    rays = prepare_pixel_samples(
        img_crop, mask_crop, sample["cam_poses"], float(np.linalg.norm(wlh)),
        sample["cam_intrinsics"], roi, n_rays, n_samples, shapenet_obj_cood, sym_aug, rng,
        im_sz=render_sz, compact=compact_rays)

    tgt_pose = sample["obj_poses"]
    if tgt_uv is None:
        tgt_uv = project_box_corners(np.asarray(tgt_pose)[None], np.asarray(wlh)[None],
                                     np.asarray(sample["cam_intrinsics"])[None])[0]
    tgt_uv = np.asarray(tgt_uv)[:2].astype(np.float32)
    return {
        "img_in": img_in,
        **rays,
        "src_pose": np.asarray(tgt_pose if src_pose is None else src_pose, np.float32),
        "tgt_uv": tgt_uv,
        "tgt_uv_aug": tgt_uv,
        "wlh": np.asarray(wlh, np.float32),
        "wlh_aug": np.asarray(wlh, np.float32),
        "roi": roi.astype(np.float32),
        "K": np.asarray(sample["cam_intrinsics"], np.float32),
        "code_idx": np.asarray(code_idx, np.int64),
    }
