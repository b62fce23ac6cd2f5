"""Synthetic object fixtures; the port of supnerf_tpu/data/synthetic.py
(make_synthetic_object, prepare_object_inputs).

A box at a known pose is projected into a virtual camera: its silhouette is
the occupancy mask, its faces (shaded per face) the RGB target, and pixels
inside the silhouette at the box-centre depth the lidar fixture. The convex
fill uses numpy half-plane tests instead of cv2.fillConvexPoly, so pixels on
a polygon's edge can differ from the JAX package's sample and the lidar
pixels drawn from the mask can differ with them; the random draws are made
in the same order from the same seed. The parity tests therefore feed the
JAX package's samples into both packages.
"""
from __future__ import annotations

import numpy as np

from supnerf_tpu_torch.geometry import roi as roi_ops

_DEFAULT_K = np.array([[800.0, 0, 640], [0, 800, 360], [0, 0, 1]], np.float32)


def _box_corners_np(pose, wlh):
    w, l, h = wlh
    x = l / 2 * np.array([1, 1, 1, 1, -1, -1, -1, -1])
    y = w / 2 * np.array([1, -1, -1, 1, 1, -1, -1, 1])
    z = h / 2 * np.array([1, 1, -1, -1, 1, 1, -1, -1])
    return pose[:, :3] @ np.vstack([x, y, z]) + pose[:, 3:4]


def _yaw_pose(yaw, t):
    cy, sy = np.cos(yaw), np.sin(yaw)
    R_unit = np.array([[0.0, -1.0, 0.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]])
    R_yaw = np.array([[cy, -sy, 0.0], [sy, cy, 0.0], [0.0, 0.0, 1.0]])
    return np.concatenate([R_unit @ R_yaw, np.reshape(t, (3, 1))], axis=1).astype(np.float32)


def _convex_hull(pts):
    """Monotone-chain hull of (N, 2) points, counter-clockwise."""
    pts = sorted(map(tuple, pts))

    def half(seq):
        out = []
        for p in seq:
            while len(out) >= 2 and ((out[-1][0] - out[-2][0]) * (p[1] - out[-2][1])
                                     - (out[-1][1] - out[-2][1]) * (p[0] - out[-2][0])) <= 0:
                out.pop()
            out.append(p)
        return out

    lower, upper = half(pts), half(reversed(pts))
    return np.asarray(lower[:-1] + upper[:-1], np.float64)


def _fill_convex(shape, poly):
    """Boolean (H, W) mask of the pixels whose centres lie inside or on the
    convex polygon poly (N, 2) of integer (x, y) vertices, either winding."""
    H, W = shape
    x0, y0 = np.clip(np.floor(poly.min(0)).astype(int), 0, [W - 1, H - 1])
    x1, y1 = np.clip(np.ceil(poly.max(0)).astype(int), 0, [W - 1, H - 1])
    mask = np.zeros((H, W), bool)
    if len(poly) < 3:
        return mask
    ys, xs = np.mgrid[y0:y1 + 1, x0:x1 + 1]
    pos = np.ones(xs.shape, bool)
    neg = np.ones(xs.shape, bool)
    for (ax, ay), (bx, by) in zip(poly, np.roll(poly, -1, axis=0)):
        cross = (bx - ax) * (ys - ay) - (by - ay) * (xs - ax)
        pos &= cross >= 0
        neg &= cross <= 0
    mask[y0:y1 + 1, x0:x1 + 1] = pos | neg
    return mask


def make_synthetic_object(seed: int = 0, img_h: int = 900, img_w: int = 1600,
                          K=None, color=None):
    """One synthetic sample with the real datasets' dict contract (imgs,
    masks_occ, rois, cam_intrinsics, cam_poses, obj_poses, wlh, lidar_*)."""
    rng = np.random.default_rng(seed)
    K = _DEFAULT_K if K is None else np.asarray(K, np.float32)
    wlh = np.array([1.9, 4.6, 1.7], np.float32) * rng.uniform(0.9, 1.1, 3).astype(np.float32)
    yaw = rng.uniform(-np.pi, np.pi)
    depth = rng.uniform(12.0, 30.0)
    u = rng.uniform(0.35, 0.65) * img_w
    v = rng.uniform(0.4, 0.6) * img_h
    t = np.linalg.inv(K) @ np.array([u * depth, v * depth, depth])
    obj_pose = _yaw_pose(yaw, t)

    corners = _box_corners_np(obj_pose, wlh)
    uv = K @ corners
    uv = uv[:2] / uv[2:3]
    x0, y0 = np.floor(uv.min(axis=1)).astype(int)
    x1, y1 = np.ceil(uv.max(axis=1)).astype(int)
    box_2d = [max(x0, 0), max(y0, 0), min(x1, img_w - 1), min(y1, img_h - 1)]

    uv_int = uv.T.astype(np.int32)
    mask = _fill_convex((img_h, img_w), _convex_hull(uv_int))
    mask_occ = np.where(mask, 1.0, -1.0).astype(np.float32)

    if color is None:
        color = rng.uniform(0.3, 0.9, 3).astype(np.float32)
    img = np.ones((img_h, img_w, 3), np.float32)
    # per-face shading in painter's order, so the orientation is visible
    faces = [((0, 1, 2, 3), 1.00), ((4, 5, 6, 7), 0.35), ((0, 3, 7, 4), 0.75),
             ((1, 2, 6, 5), 0.55), ((0, 1, 5, 4), 0.90), ((2, 3, 7, 6), 0.45)]
    depth_per_face = [(np.mean(corners[2, list(ids)]), ids, shade) for ids, shade in faces]
    for _, ids, shade in sorted(depth_per_face, reverse=True):
        face = _fill_convex((img_h, img_w), uv_int[list(ids)].astype(np.float64))
        img[face] = color * shade

    ys, xs = np.nonzero(mask)
    if len(xs) > 0:
        sel = rng.choice(len(xs), size=min(256, len(xs)), replace=False)
        lid_u, lid_v = xs[sel].astype(np.float32), ys[sel].astype(np.float32)
        lid_d = np.full(len(sel), float(t[2]), np.float32)
    else:
        lid_u = lid_v = lid_d = np.zeros(0, np.float32)

    cam_pose = np.concatenate(
        [obj_pose[:, :3].T, -obj_pose[:, :3].T @ obj_pose[:, 3:4]], axis=1).astype(np.float32)
    return {
        "imgs": img, "masks_occ": mask_occ, "rois": np.asarray(box_2d, np.int32),
        "cam_intrinsics": K, "cam_poses": cam_pose, "obj_poses": obj_pose, "wlh": wlh,
        "lidar_u": lid_u, "lidar_v": lid_v, "lidar_depth": lid_d, "color": color,
    }


def prepare_object_inputs(sample, *, in_img_sz: int = 128, render_im_sz: int = 32,
                          roi_margin: int = 5, n_lidar: int = 256, pose_init=None):
    """Host prep of one sample into the fixed-shape arrays of tto.core.ObjectBatch
    (reference optimizer_nuscenes.py:586-650): the refine ROI without and the
    NeRF ROI with square padding, crop and white-out, the encoder's square
    input, the render target and the padded lidar pixels."""
    img, mask_occ = sample["imgs"], sample["masks_occ"]
    H, W = img.shape[:2]
    roi = sample["rois"]
    roi_refine = roi_ops.roi_process(roi, H, W, roi_margin, sq_pad=False)
    roi_nerf = roi_ops.roi_process(roi, H, W, roi_margin, sq_pad=True)

    img_crop_r, _ = roi_ops.crop_and_whiten(img, mask_occ, roi_refine)
    img_in = roi_ops.preprocess_img_square(img_crop_r, in_img_sz)

    img_crop_n, mask_crop_n = roi_ops.crop_and_whiten(img, mask_occ, roi_nerf)
    rgb_tgt = roi_ops.resize_bilinear_np(img_crop_n, (render_im_sz, render_im_sz))
    mask_tgt = np.trunc(roi_ops.resize_bilinear_np(mask_crop_n[..., 0],
                                                   (render_im_sz, render_im_sz)))

    K = sample["cam_intrinsics"]
    lid = np.zeros((4, n_lidar), np.float32)
    n = min(n_lidar, len(sample["lidar_u"]))
    lid[0, :n] = sample["lidar_u"][:n]
    lid[1, :n] = sample["lidar_v"][:n]
    lid[2, :n] = sample["lidar_depth"][:n]
    lid[3, :n] = 1.0
    return {
        "img_in": img_in,
        "rgb_tgt": rgb_tgt.reshape(-1, 3),
        "occ_tgt": mask_tgt.reshape(-1, 1),
        "K": K,
        "K_inv": np.linalg.inv(K).astype(np.float32),
        "roi_nerf": roi_nerf,
        "roi_refine": roi_refine,
        "pose_init": (sample["obj_poses"] if pose_init is None else pose_init).astype(np.float32),
        "wlh": sample["wlh"],
        "obj_pose_gt": sample["obj_poses"],
        "lidar_u": lid[0], "lidar_v": lid[1], "lidar_depth": lid[2], "lidar_valid": lid[3],
    }
