"""SO(3) conversions on torch tensors; the port of supnerf_tpu/geometry/rotations.py.

Batched over leading dimensions, pytorch3d conventions: matrices act on
column vectors, axis-angle magnitude is the angle in radians.
"""
from __future__ import annotations

import torch


def hat(v):
    """Skew-symmetric matrices of (..., 3) vectors."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zero, -z, y], -1),
        torch.stack([z, zero, -x], -1),
        torch.stack([-y, x, zero], -1),
    ], -2)


def axis_angle_to_matrix(axis_angle):
    """Rodrigues' formula, (..., 3) -> (..., 3, 3); Taylor branch near angle 0."""
    angle = torch.linalg.norm(axis_angle, dim=-1, keepdim=True)
    small = angle < 1e-6
    a = torch.where(small, torch.ones_like(angle), angle)
    sin_a = torch.where(small, 1.0 - angle ** 2 / 6.0, torch.sin(a) / a)
    cos_t = torch.where(small, 0.5 - angle ** 2 / 24.0, (1.0 - torch.cos(a)) / (a * a))
    K = hat(axis_angle)
    eye = torch.eye(3, dtype=axis_angle.dtype, device=axis_angle.device).expand(K.shape)
    return eye + sin_a[..., None] * K + cos_t[..., None] * (K @ K)


def matrix_to_quaternion(matrix):
    """(..., 3, 3) -> (..., 4) unit quaternion (w, x, y, z) with w >= 0."""
    m = matrix
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

    def sqrt_pos(x):
        return torch.sqrt(torch.clamp(x, min=1e-12))

    qw = sqrt_pos(1.0 + m00 + m11 + m22)
    qx = sqrt_pos(1.0 + m00 - m11 - m22)
    qy = sqrt_pos(1.0 - m00 + m11 - m22)
    qz = sqrt_pos(1.0 - m00 - m11 + m22)
    cand = torch.stack([
        torch.stack([qw * qw, m21 - m12, m02 - m20, m10 - m01], -1) / (2.0 * qw[..., None]),
        torch.stack([m21 - m12, qx * qx, m01 + m10, m02 + m20], -1) / (2.0 * qx[..., None]),
        torch.stack([m02 - m20, m01 + m10, qy * qy, m12 + m21], -1) / (2.0 * qy[..., None]),
        torch.stack([m10 - m01, m02 + m20, m12 + m21, qz * qz], -1) / (2.0 * qz[..., None]),
    ], -2)
    best = torch.argmax(torch.stack([qw, qx, qy, qz], -1), dim=-1)
    q = torch.gather(cand, -2, best[..., None, None].expand(*best.shape, 1, 4))[..., 0, :]
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quaternion_to_axis_angle(quat):
    """(..., 4) (w, x, y, z) -> (..., 3)."""
    w, v = quat[..., 0], quat[..., 1:]
    norm_v = torch.linalg.norm(v, dim=-1)
    angle = 2.0 * torch.atan2(norm_v, w)
    small = norm_v < 1e-9
    scale = torch.where(small, torch.full_like(angle, 2.0),
                        angle / torch.where(small, torch.ones_like(norm_v), norm_v))
    return v * scale[..., None]


def matrix_to_axis_angle(matrix):
    """(..., 3, 3) -> (..., 3) with angle in [0, pi]."""
    return quaternion_to_axis_angle(matrix_to_quaternion(matrix))


def rot_dist(R1, R2):
    """Geodesic distance on SO(3) in radians, trace clamped to [-1, 3]."""
    trace = torch.diagonal(R1 @ R2.transpose(-1, -2), dim1=-2, dim2=-1).sum(-1)
    return torch.acos((torch.clamp(trace, -1.0, 3.0) - 1.0) / 2.0)


def _axis_rot(angle, axis: str):
    """Rotations by (...,) angles about one coordinate axis -> (..., 3, 3)."""
    c, s = torch.cos(angle), torch.sin(angle)
    one, zero = torch.ones_like(angle), torch.zeros_like(angle)
    rows = {"X": ((one, zero, zero), (zero, c, -s), (zero, s, c)),
            "Y": ((c, zero, s), (zero, one, zero), (-s, zero, c)),
            "Z": ((c, -s, zero), (s, c, zero), (zero, zero, one))}
    if axis not in rows:
        raise ValueError(axis)
    return torch.stack([torch.stack(r, -1) for r in rows[axis]], -2)


def euler_angles_to_matrix(euler, convention: str = "XYZ"):
    """(..., 3) intrinsic Euler angles -> (..., 3, 3), pytorch3d's rule
    R = R_axis0(e0) @ R_axis1(e1) @ R_axis2(e2)."""
    mats = [_axis_rot(euler[..., i], axis) for i, axis in enumerate(convention)]
    return mats[0] @ mats[1] @ mats[2]


def matrix_to_euler_angles(matrix, convention: str = "XYZ"):
    """(..., 3, 3) -> (..., 3) intrinsic XYZ Euler angles, the only
    convention the configs can ask for (euler_rot): for R = Rx(a) Ry(b)
    Rz(c), R[0,2] = sin b, R[1,2] = -sin a cos b, R[2,2] = cos a cos b,
    R[0,1] = -cos b sin c, R[0,0] = cos b cos c."""
    if convention != "XYZ":
        raise NotImplementedError(convention)
    b = torch.asin(torch.clamp(matrix[..., 0, 2], -1.0, 1.0))
    a = torch.atan2(-matrix[..., 1, 2], matrix[..., 2, 2])
    c = torch.atan2(-matrix[..., 0, 1], matrix[..., 0, 0])
    return torch.stack([a, b, c], -1)
