"""3D box corners, projection and ROI normalisation on torch tensors; the port
of supnerf_tpu/geometry/boxes.py (the parts the TTO path uses).

A pose is a (..., 3, 4) matrix [R | t] mapping object-frame points to the
camera frame (or the inverse, a camera pose in the object frame).
"""
from __future__ import annotations

import torch

# corner sign patterns: the first four corners face forward (+x)
_X_SIGNS = (1.0, 1.0, 1.0, 1.0, -1.0, -1.0, -1.0, -1.0)
_Y_SIGNS = (1.0, -1.0, -1.0, 1.0, 1.0, -1.0, -1.0, 1.0)
_Z_SIGNS = (1.0, 1.0, -1.0, -1.0, 1.0, 1.0, -1.0, -1.0)


def local_corners_of_box(wlh, scale: float = 1.0):
    """Corners in the object frame (nuScenes convention): (..., 3) -> (..., 3, 8)."""
    signs = torch.tensor([_X_SIGNS, _Y_SIGNS, _Z_SIGNS], dtype=wlh.dtype, device=wlh.device)
    half = torch.stack([wlh[..., 1], wlh[..., 0], wlh[..., 2]], -1) / 2 * scale  # (l, w, h)
    return half[..., :, None] * signs


def corners_of_box(obj_pose, wlh, scale: float = 1.0):
    """Box corners in the camera frame: pose (..., 3, 4), wlh (..., 3) -> (..., 3, 8)."""
    corners = local_corners_of_box(wlh, scale)
    return obj_pose[..., :, :3] @ corners + obj_pose[..., :, 3:4]


def view_points(points, K, normalize: bool = True):
    """Pinhole projection of (..., 3, N) camera-frame points by (..., 3, 3) K;
    divided by depth when normalize. Returns (..., 3, N)."""
    out = K @ points
    return out / out[..., 2:3, :] if normalize else out


def normalize_by_roi(pts, roi):
    """Centre (..., 2, N) pixel points on their ROI (..., 4) and scale by
    dim = max(roi_w, roi_h). Returns (pts_norm, dim)."""
    w = roi[..., 2] - roi[..., 0]
    h = roi[..., 3] - roi[..., 1]
    centre = torch.stack([(roi[..., 2] + roi[..., 0]) / 2, (roi[..., 3] + roi[..., 1]) / 2], -1)
    dim = torch.maximum(w, h)
    return (pts - centre[..., :, None]) / dim[..., None, None], dim


def invert_pose(pose):
    """Invert a (..., 3, 4) rigid transform: [R | t] -> [R^T | -R^T t]."""
    R_t = pose[..., :, :3].transpose(-1, -2)
    return torch.cat([R_t, -(R_t @ pose[..., :, 3:4])], -1)
