"""3D box corners, projection, ROI normalisation, the point-in-box test and
the KITTI <-> nuScenes object-frame conversions on torch tensors; the port of
supnerf_tpu/geometry/boxes.py (reference utils.py: corners_of_box :1076,
view_points :991, normalize_by_roi :1175, pts_in_box_3d :1150,
obj_pose_kitti2nusc :1354, obj_pose_nuse2kitti :1369).

A pose is a (..., 3, 4) matrix [R | t] mapping object-frame points to the
camera frame (or the inverse, a camera pose in the object frame). The
nuScenes object frame is x forward, y left, z up with the box centre at the
volume's centre; the KITTI one x forward, y down, z left with the centre on
the ground plane.
"""
from __future__ import annotations

import torch

# corner sign patterns: the first four corners face forward (+x)
_X_SIGNS = (1.0, 1.0, 1.0, 1.0, -1.0, -1.0, -1.0, -1.0)
_Y_SIGNS = (1.0, -1.0, -1.0, 1.0, 1.0, -1.0, -1.0, 1.0)
_Z_SIGNS = (1.0, 1.0, -1.0, -1.0, 1.0, 1.0, -1.0, -1.0)
# KITTI: the vertical offsets are {-h, 0} (centre on the ground)
_Y_SIGNS_KITTI = (-2.0, -2.0, 0.0, 0.0, -2.0, -2.0, 0.0, 0.0)

# fixed change of basis between the KITTI and nuScenes object frames
_R_K2N = ((1.0, 0.0, 0.0), (0.0, 0.0, -1.0), (0.0, 1.0, 0.0))
_R_N2K = ((1.0, 0.0, 0.0), (0.0, 0.0, 1.0), (0.0, -1.0, 0.0))


def local_corners_of_box(wlh, scale: float = 1.0, is_kitti: bool = False):
    """Corners in the object frame: (..., 3) wlh -> (..., 3, 8)."""
    if is_kitti:
        rows, half = (_X_SIGNS, _Y_SIGNS_KITTI, _Y_SIGNS), (wlh[..., 1], wlh[..., 2], wlh[..., 0])
    else:
        rows, half = (_X_SIGNS, _Y_SIGNS, _Z_SIGNS), (wlh[..., 1], wlh[..., 0], wlh[..., 2])
    signs = torch.tensor(rows, dtype=wlh.dtype, device=wlh.device)
    return (torch.stack(half, -1) / 2 * scale)[..., :, None] * signs


def corners_of_box(obj_pose, wlh, scale: float = 1.0, is_kitti: bool = False):
    """Box corners in the camera frame: pose (..., 3, 4), wlh (..., 3) -> (..., 3, 8)."""
    corners = local_corners_of_box(wlh, scale, is_kitti)
    return obj_pose[..., :, :3] @ corners + obj_pose[..., :, 3:4]


def pts_in_box_3d(pts_3d, corners_3d, keep_top_portion: float = 1.0):
    """Boolean mask (..., N) of the points (..., 3, N) inside the box of
    corners (..., 3, 8) in nuScenes corner order, its height axis shrunk to
    keep_top_portion."""
    c0 = corners_3d[..., :, 0:1]
    v_test = pts_3d - c0
    inside = None
    for v in (corners_3d[..., :, 1:2] - c0, (corners_3d[..., :, 3:4] - c0) * keep_top_portion,
              corners_3d[..., :, 4:5] - c0):
        proj = (v * v_test).sum(-2)
        ok = (proj > 0) & (proj < (v * v).sum(-2))
        inside = ok if inside is None else inside & ok
    return inside


def _change_frame(obj_pose, obj_h, basis, dy_sign):
    R = obj_pose[..., :, :3] @ torch.tensor(basis, dtype=obj_pose.dtype, device=obj_pose.device)
    dy = dy_sign * torch.as_tensor(obj_h, dtype=obj_pose.dtype, device=obj_pose.device) / 2
    t = obj_pose[..., :, 3] + torch.stack([torch.zeros_like(dy), dy, torch.zeros_like(dy)], -1)
    return torch.cat([R, t[..., :, None]], -1)


def obj_pose_kitti2nusc(obj_pose, obj_h):
    """KITTI-frame object poses (..., 3, 4) -> nuScenes frame: the frame
    rotated and the centre lifted from the ground by h / 2 (obj_h (...))."""
    return _change_frame(obj_pose, obj_h, _R_K2N, -1.0)


def obj_pose_nusc2kitti(obj_pose, obj_h):
    """nuScenes-frame object poses (..., 3, 4) -> KITTI frame."""
    return _change_frame(obj_pose, obj_h, _R_N2K, 1.0)


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
