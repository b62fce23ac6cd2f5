"""Feed-forward projected-box pose refinement; the port of
supnerf_tpu/tto/refiner.py (reference optimizer_nuscenes.py:451
fw_pose_update, :509 fw_pose_one_step), batched over objects.

A raw refiner delta (6,) maps to: axis-angle increment delta[:3] * 2 pi;
projected-centre shift delta[3:5] * max(roi_w, roi_h); depth ratio
delta[5] + 1; the translation is re-lifted through K^-1.
"""
from __future__ import annotations

import math

import torch

from supnerf_tpu_torch.geometry.boxes import corners_of_box, normalize_by_roi, view_points
from supnerf_tpu_torch.geometry.rotations import axis_angle_to_matrix, matrix_to_axis_angle


def project_box_corners_normalized(pose, wlh, roi, K):
    """pose (B,3,4), wlh (B,3), roi (B,4), K (B,3,3) -> (uv_norm (B,16), dim (B,))."""
    uv = view_points(corners_of_box(pose, wlh), K)
    uv_norm, dim = normalize_by_roi(uv[:, :2], roi)
    return uv_norm.reshape(len(pose), 16), dim


def compose_pose_delta(src_pose, delta, dim, K, K_inv):
    """Apply raw refiner deltas (B,6) to object poses (B,3,4)."""
    pred_R = axis_angle_to_matrix(matrix_to_axis_angle(src_pose[:, :, :3])
                                  + delta[:, :3] * (2.0 * math.pi))
    T_src = src_pose[:, :, 3]
    uvz = (K @ T_src[..., None])[..., 0]
    u = uvz[:, 0] / uvz[:, 2] + delta[:, 3] * dim
    v = uvz[:, 1] / uvz[:, 2] + delta[:, 4] * dim
    Z = T_src[:, 2] * (delta[:, 5] + 1.0)
    pred_T = (K_inv @ torch.stack([u * Z, v * Z, Z], -1)[..., None])[..., 0]
    return torch.cat([pred_R, pred_T[..., None]], -1)


def fw_pose_refine(pose_update_fn, posecode, init_pose, wlh, roi, K, K_inv,
                   iters: int):
    """`iters` refiner steps; pose_update_fn(posecode (B, latent), uv (B,16)) ->
    delta (B,6). Returns (B, iters + 1, 3, 4) poses starting with init_pose
    (the reference's pose_per_iter list)."""
    poses = [init_pose]
    for _ in range(iters):
        uv_norm, dim = project_box_corners_normalized(poses[-1], wlh, roi, K)
        poses.append(compose_pose_delta(poses[-1], pose_update_fn(posecode, uv_norm),
                                        dim, K, K_inv))
    return torch.stack(poses, 1)
