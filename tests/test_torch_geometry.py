"""The port's numpy/torch building blocks against their JAX counterparts on
the same inputs (float32 both; tolerances are float32 rounding of a few
operations): rotations, boxes, rays and sampling with injected jitter, the
refiner's delta composition, pose errors, compositing and losses, the
positional encodings, and the host-side object prep."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import torch_threads  # noqa: F401
from supnerf_tpu.data.synthetic import make_synthetic_object as jax_make_object
from supnerf_tpu.data.synthetic import prepare_object_inputs as jax_prepare
from supnerf_tpu.geometry import boxes as jb
from supnerf_tpu.geometry import poses as jp
from supnerf_tpu.geometry import rays as jr
from supnerf_tpu.geometry import rotations as jrot
from supnerf_tpu.models import nerf_mlp as jmlp
from supnerf_tpu.ops import volume_render as jvr
from supnerf_tpu.tto import refiner as jref
from supnerf_tpu_torch.data.synthetic import make_synthetic_object, prepare_object_inputs
from supnerf_tpu_torch.geometry import boxes, poses, rays, rotations
from supnerf_tpu_torch.models import nerf_mlp
from supnerf_tpu_torch.ops import volume_render as vr
from supnerf_tpu_torch.tto import refiner

rng = np.random.default_rng(0)
ROTVECS = (rng.normal(size=(6, 3)) * 0.8).astype(np.float32)
ROTVECS[0] = 0.0                                       # the small-angle branch
K = np.array([[800.0, 0, 640], [0, 800, 360], [0, 0, 1]], np.float32)


def _poses(n=6):
    R = np.asarray(jrot.axis_angle_to_matrix(jnp.asarray(ROTVECS[:n])))
    t = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1, 1, n), rng.uniform(12, 30, n)], -1)
    return np.concatenate([R, t[..., None]], -1).astype(np.float32)


def _close(a, b, atol=1e-5):
    np.testing.assert_allclose(np.asarray(a.detach() if torch.is_tensor(a) else a),
                               np.asarray(b), atol=atol, rtol=1e-5)


J = jnp.asarray


def T(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("fn", ["axis_angle_to_matrix", "matrix_to_axis_angle", "rot_dist"])
def test_rotations(fn):
    R = np.asarray(jrot.axis_angle_to_matrix(J(ROTVECS)))
    args = {"axis_angle_to_matrix": (ROTVECS,), "matrix_to_axis_angle": (R,),
            "rot_dist": (R, R[::-1].copy())}[fn]
    _close(getattr(rotations, fn)(*map(T, args)), getattr(jrot, fn)(*map(J, args)), 2e-5)


def test_boxes_and_refiner_composition():
    P = _poses()
    wlh = np.tile(np.float32([1.9, 4.6, 1.7]), (6, 1))
    roi = np.tile(np.float32([500, 200, 760, 420]), (6, 1))
    Ks = np.tile(K, (6, 1, 1))
    _close(boxes.corners_of_box(T(P), T(wlh), 1.1), jb.corners_of_box(J(P), J(wlh), scale=1.1))
    _close(boxes.invert_pose(T(P)), jb.invert_pose(J(P)))
    uv, dim = refiner.project_box_corners_normalized(T(P), T(wlh), T(roi), T(Ks))
    for i in range(6):
        uv_j, dim_j = jref.project_box_corners_normalized(J(P[i]), J(wlh[i]), J(roi[i]), J(K))
        _close(uv[i], uv_j, 1e-4)
        _close(dim[i], dim_j)
    delta = (rng.normal(size=(6, 6)) * 0.05).astype(np.float32)
    out = refiner.compose_pose_delta(T(P), T(delta), dim, T(Ks), T(np.linalg.inv(Ks)))
    for i in range(6):
        ref = jref.compose_pose_delta(J(P[i]), J(delta[i]), J(float(dim[i])), J(K),
                                      J(np.linalg.inv(K)))
        _close(out[i], ref, 1e-4)
    eR, eT = poses.calc_pose_err(T(P), T(P[::-1].copy()))
    eR_j, eT_j = jp.calc_pose_err(J(P), J(P[::-1].copy()))
    _close(eR, eR_j, 2e-5)
    _close(eT, eT_j)


def test_rays_and_sampling_with_injected_jitter():
    c2w = np.asarray(jb.invert_pose(J(_poses(2))))
    roi = np.float32([[500, 200, 760, 420], [600, 300, 700, 380]])
    o, d = rays.get_rays(T(np.tile(K, (2, 1, 1))), T(c2w), T(roi), (5, 4))
    jitter = rng.uniform(size=(2, 7)).astype(np.float32)
    near, far = np.float32([17.0, 20.0]), np.float32([22.0, 26.0])
    xyz, z = rays.sample_from_rays(o, d, T(near), T(far), 7, jitter=T(jitter))
    u, v = rng.uniform(0, 1200, (2, 2, 9)).astype(np.float32)
    o2, d2 = rays.get_rays_specified(T(np.tile(K, (2, 1, 1))), T(c2w), T(u), T(v))
    for b in range(2):
        oj, dj = jr.get_rays(J(K), J(c2w[b]), J(roi[b]), (5, 4))
        _close(o[b], oj)
        _close(d[b], dj)
        # the JAX sampler draws its jitter from a key; rebuild its formula
        # with the same draws to hold the port's sampler to it
        n, f, S = near[b], far[b], 7
        dist = (f - n) / (2 * S)
        zj = (np.linspace(0, 1, S) * (f - n - 2 * dist) + n + dist
              + jitter[b] * (f - n) / (2 * S))
        _close(z[b], zj, 1e-4)
        _close(xyz[b], np.asarray(oj)[:, None] + np.asarray(dj)[:, None] * zj[None, :, None], 1e-4)
        o2j, d2j = jr.get_rays_specified(J(K), J(c2w[b]), J(u[b]), J(v[b]))
        _close(o2[b], o2j)
        _close(d2[b], d2j)


@pytest.mark.parametrize("white", [False, True])
def test_compositing_and_losses(white):
    sig = rng.uniform(0, 3, (3, 5, 8)).astype(np.float32)
    sig[0, 0] = 1e4                                    # opaque: transmittance floor
    rgb = rng.uniform(size=(3, 5, 8, 3)).astype(np.float32)
    z = np.sort(rng.uniform(2, 6, (3, 1, 8)), -1).astype(np.float32)
    for a, b in zip(vr.volume_render(T(sig), T(rgb), T(z), white),
                    jvr.volume_render(J(sig), J(rgb), J(z), white)):
        _close(a, b)
    pred, tgt = rng.uniform(size=(2, 3, 5, 3)).astype(np.float32)
    occ = rng.choice([-1.0, 0.0, 1.0], (3, 5, 1)).astype(np.float32)
    acc = rng.uniform(size=(3, 5)).astype(np.float32)
    _close(vr.rgb_loss_masked(T(pred), T(tgt), T(occ), dim=(1, 2)),
           jvr.rgb_loss_masked(J(pred), J(tgt), J(occ), axis=(1, 2)))
    _close(vr.occupancy_loss(T(acc), T(occ), dim=(1, 2)),
           jvr.occupancy_loss(J(acc), J(occ), axis=(1, 2)))
    _close(vr.masked_psnr(T(pred), T(tgt), T(occ), dim=(1, 2)),
           jvr.masked_psnr(J(pred), J(tgt), J(occ), axis=(1, 2)), 1e-4)


@pytest.mark.parametrize("degree,atol", [(4, 1e-6), (10, 2e-4)])
def test_positional_encodings(degree, atol):
    x = rng.uniform(-1, 1, (16, 3)).astype(np.float32)
    _close(nerf_mlp.positional_encoding(T(x), degree), jmlp.positional_encoding(J(x), degree), 1e-5)
    _close(nerf_mlp.positional_encoding_doubling(T(x), degree),
           jmlp.positional_encoding(J(x), degree), atol)


def test_random_initial_poses_follow_the_protocol():
    """get_random_pose2 draws from a torch.Generator (not the JAX keys): check
    the protocol instead — depth fixed, projected centre inside the jittered
    ROI, proper rotations — and that one seed repeats."""
    roi = T(np.float32([[500, 200, 760, 420]] * 64))
    Ks = T(np.tile(K, (64, 1, 1)))
    p1 = poses.get_random_pose2(Ks, roi, torch.Generator().manual_seed(3), trans_lim=0.3)
    p2 = poses.get_random_pose2(Ks, roi, torch.Generator().manual_seed(3), trans_lim=0.3)
    assert torch.equal(p1, p2)
    _close(p1[:, 2, 3], np.full(64, 20.0))
    uv = (Ks @ p1[:, :, 3:])[..., 0]
    u, v = uv[:, 0] / uv[:, 2], uv[:, 1] / uv[:, 2]
    assert ((u >= 630 - 78 - 1e-3) & (u <= 630 + 78 + 1e-3)).all()
    assert ((v >= 310 - 66 - 1e-3) & (v <= 310 + 66 + 1e-3)).all()
    R = p1[:, :, :3]
    _close(R @ R.transpose(1, 2), np.broadcast_to(np.eye(3), (64, 3, 3)), 1e-5)
    # the training-time perturbation keeps depth within +-depth_lim of the target's
    p3 = poses.get_random_pose(p1, Ks, roi, torch.Generator().manual_seed(4))
    ratio = p3[:, 2, 3] / p1[:, 2, 3]
    assert ((ratio >= 0.7 - 1e-5) & (ratio <= 1.3 + 1e-5)).all()
    R3 = p3[:, :, :3]
    _close(R3 @ R3.transpose(1, 2), np.broadcast_to(np.eye(3), (64, 3, 3)), 1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_object_prep_matches_jax(seed):
    """On the JAX package's own sample, the port's prep (bilinear resize by
    torch.nn.functional.interpolate instead of OpenCV) gives the same
    arrays; the port's own sample differs from it only on polygon edges."""
    sample = jax_make_object(seed)
    ours, ref = prepare_object_inputs(sample), jax_prepare(sample)
    assert set(ours) == set(ref)
    for k in ref:
        np.testing.assert_allclose(np.asarray(ours[k], np.float64), np.asarray(ref[k], np.float64),
                                   atol=1e-5, err_msg=k)
    own = make_synthetic_object(seed)
    assert np.mean(own["masks_occ"] != sample["masks_occ"]) < 2e-4
    for k in ("rois", "obj_poses", "wlh", "cam_intrinsics", "color"):
        np.testing.assert_array_equal(own[k], sample[k])
