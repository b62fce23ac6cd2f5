"""Random initial poses and pose errors on torch tensors; the port of
supnerf_tpu/geometry/poses.py (get_random_pose2 in the nuScenes and KITTI
frames, get_random_pose, calc_pose_err). Random draws come from an explicit
torch.Generator, so they are reproducible but are not the JAX package's
draws."""
from __future__ import annotations

import math

import torch

from supnerf_tpu_torch.geometry.rotations import axis_angle_to_matrix, rot_dist

# camera-facing unit orientation of a nuScenes-frame object
_R_UNIT_NUSC = ((0.0, -1.0, 0.0), (0.0, 0.0, -1.0), (1.0, 0.0, 0.0))
_R_UNIT_KITTI = ((0.0, 0.0, -1.0), (0.0, 1.0, 0.0), (1.0, 0.0, 0.0))


def _yaw_nusc(yaw):
    c, s = torch.cos(yaw), torch.sin(yaw)
    z, o = torch.zeros_like(yaw), torch.ones_like(yaw)
    return torch.stack([torch.stack([c, -s, z], -1), torch.stack([s, c, z], -1),
                        torch.stack([z, z, o], -1)], -2)


def _yaw_kitti(yaw):
    """A yaw about the KITTI object frame's vertical axis (y)."""
    c, s = torch.cos(yaw), torch.sin(yaw)
    z, o = torch.zeros_like(yaw), torch.ones_like(yaw)
    return torch.stack([torch.stack([c, z, s], -1), torch.stack([z, o, z], -1),
                        torch.stack([-s, z, c], -1)], -2)


def uv_depth_to_xyz(K, u, v, Z):
    """Back-project pixels (u, v) at depth Z through K: (B,) each -> (B, 3)."""
    pts = torch.stack([u * Z, v * Z, Z], -1)
    return (torch.linalg.inv(K) @ pts[..., None])[..., 0]


def _uniform(shape, generator, device):
    return torch.rand(shape, generator=generator, device=device) * 2 - 1


def get_random_pose2(K, roi, generator, yaw_lim=math.pi, angle_lim=math.pi / 9,
                     trans_lim=0.4, depth_fix=20.0, is_kitti: bool = False, draws=None):
    """Random test-time initial object poses (reference utils.py:1300): the
    projected centre jittered around the ROI centre by +-trans_lim of its
    size, depth fixed at depth_fix, yaw uniform in +-yaw_lim about the
    camera-facing orientation of the nuScenes (or with is_kitti the KITTI)
    object frame, plus a rotation with per-axis angles in +-angle_lim.
    K (B, 3, 3), roi (B, 4). draws: (B, 6) uniform draws in [0, 1) (centre
    shift 2, yaw 1, rotation 3) in place of the generator's. Returns (B, 3, 4)."""
    B, dev = len(K), K.device
    if draws is None:     # three draws, in the order of the JAX function's keys
        draws = torch.cat([torch.rand(shape, generator=generator, device=dev).reshape(B, -1)
                           for shape in ((B, 2), (B,), (B, 3))], 1)
    u = draws.to(torch.float32) * 2 - 1
    roi = roi.to(torch.float32)
    roi_c = (roi[:, 2:4] + roi[:, 0:2]) / 2
    roi_wh = roi[:, 2:4] - roi[:, 0:2]
    v_xy = u[:, 0:2] * roi_wh * trans_lim
    T = uv_depth_to_xyz(K, roi_c[:, 0] + v_xy[:, 0], roi_c[:, 1] + v_xy[:, 1],
                        torch.full((B,), depth_fix, device=dev))
    yaw = u[:, 2] * yaw_lim
    rotvec = u[:, 3:6] * angle_lim
    R_unit = torch.tensor(_R_UNIT_KITTI if is_kitti else _R_UNIT_NUSC, device=dev)
    R = R_unit @ axis_angle_to_matrix(rotvec) @ (_yaw_kitti(yaw) if is_kitti else _yaw_nusc(yaw))
    return torch.cat([R, T[..., None]], -1)


def get_random_pose(tgt_pose, K, roi, generator, yaw_lim=math.pi / 2,
                    angle_lim=math.pi / 9, trans_lim=0.3, depth_lim=0.3):
    """Training-time perturbation around ground-truth poses (reference
    utils.py:1260): projected centre shifted by +-trans_lim of the ROI size,
    depth scaled by 1 +- depth_lim, rotation right-multiplied by a small
    random rotation and a yaw in +-yaw_lim. tgt_pose (B, 3, 4). Returns (B, 3, 4)."""
    B, dev = len(K), K.device
    roi = roi.to(torch.float32)
    tgt_T = tgt_pose[:, :, 3]
    tgt_uv = (K[:, :2, :2] @ (tgt_T[:, :2] / tgt_T[:, 2:3])[..., None])[..., 0] + K[:, :2, 2]
    roi_wh = roi[:, 2:4] - roi[:, 0:2]
    v_xy = _uniform((B, 2), generator, dev) * roi_wh * trans_lim
    v_z = 1.0 + _uniform((B,), generator, dev) * depth_lim
    T = uv_depth_to_xyz(K, tgt_uv[:, 0] + v_xy[:, 0], tgt_uv[:, 1] + v_xy[:, 1],
                        tgt_T[:, 2] * v_z)
    yaw = _uniform((B,), generator, dev) * yaw_lim
    rotvec = _uniform((B, 3), generator, dev) * angle_lim
    R = tgt_pose[:, :, :3] @ axis_angle_to_matrix(rotvec) @ _yaw_nusc(yaw)
    return torch.cat([R, T[..., None]], -1)


def calc_pose_err(est_poses, tgt_poses):
    """Rotation geodesic error (rad) and translation L2 error for (..., 3, 4)
    poses (reference utils.py:675)."""
    err_R = rot_dist(est_poses[..., :, :3], tgt_poses[..., :, :3])
    err_T = torch.linalg.norm(est_poses[..., :, 3] - tgt_poses[..., :, 3], dim=-1)
    return err_R, err_T
