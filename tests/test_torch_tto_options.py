"""The TTO options of the port against the JAX package on the CPU, at the
tiny shapes of tests/test_torch_tto.py: the XYZ Euler pair, run_tto_batch at
opt_pose False, euler_rot with opt_cam_pose, pred_wlh 2 and at full length
(100 iterations of the codes across lr_half_interval 40's optimizer reset),
the driver's code_level storage against the JAX driver's bookkeeping, the
numpy PnP-RANSAC against cv2, and the driver at opt_pose 2 against the JAX
driver on exact corner predictions."""
import contextlib
import dataclasses
import types
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from supnerf_tpu.data.synthetic import make_object_batch
from supnerf_tpu.geometry import poses as jax_poses
from supnerf_tpu.geometry import rotations as jax_rot
from supnerf_tpu.geometry.boxes import invert_pose as jax_invert_pose
from supnerf_tpu.models import build_model as jax_build_model
from supnerf_tpu.models import init_model_variables
from supnerf_tpu.ops.volume_render import occupancy_loss as jax_occ_loss
from supnerf_tpu.ops.volume_render import rgb_loss_masked as jax_rgb_loss
from supnerf_tpu.render.renderer import render_rays_frustum as jax_render_frustum
from supnerf_tpu.tto import ObjectBatch as JaxBatch
from supnerf_tpu.tto import TTOConfig as JaxTTOConfig
from supnerf_tpu.tto import run_tto_batch as jax_run_tto_batch
from supnerf_tpu.tto.core import TTOParams as JaxTTOParams
from supnerf_tpu.tto.core import _make_optimizer as jax_make_optimizer
from supnerf_tpu.tto.core import pose_param_fns as jax_pose_param_fns
from supnerf_tpu.tto.driver import TTODriver as JaxTTODriver
from supnerf_tpu_torch.data.synthetic import make_synthetic_object
from supnerf_tpu_torch.geometry import rotations
from supnerf_tpu_torch.models.convert import convert_supnerf_variables
from supnerf_tpu_torch.models.factory import build_model
from supnerf_tpu_torch.ops.render import pack_decoder_params
from supnerf_tpu_torch.optim import AdamW
from supnerf_tpu_torch.tto import core, pnp
from supnerf_tpu_torch.tto.core import CODE_SAVE_ITERS
from supnerf_tpu_torch.tto.driver import TTODriver
from torch_memory import release_memory_after_module  # noqa: F401

TINY_HP = {"shape_blocks": 1, "texture_blocks": 1, "latent_dim": 32,
           "pose_shortcut": 1, "pred_wlh": 1}
REG, B = 2, 2
COMMON = dict(reg_iters=REG, n_samples=8, render_im_sz=8, in_img_sz=32, n_lidar=16,
              shapenet_obj_cood=True)
# case: (num_opts, TTOConfig keys shared by both packages). The full-length
# case optimizes the codes alone: with the pose too, 100 float32 iterations
# at these random weights are chaotic in either package (the port's own run
# with pose_init moved by 1e-7 of its size ends up to 0.061 rad of rotation
# error and 0.028 dB of PSNR apart, tests/tto_drift_witness.py), so no two
# implementations hold 1e-3 there.
CASES = {
    "opt_pose_0": (5, {"opt_pose": False}),
    "euler_cam": (5, {"euler_rot": True, "opt_cam_pose": True}),
    "pred_wlh_2": (5, {"pred_wlh_mode": 2}),
    "lr_half_40": (100, {"opt_pose": False, "lr_half_interval": 40}),
}
FULL_LENGTH = "lr_half_40"
OPTIONS = [c for c in CASES if c != FULL_LENGTH]
CURVES = ("loss", "psnr", "rot_err", "trans_err", "depth_err")
# the saved codes held to JAX's loop at full length: up to iteration 5 (see
# test_option_curves_and_final_state_match)
FULL_LENGTH_CODE_ITERS = 2


def test_euler_pair_round_trips_and_matches_jax():
    rng = np.random.default_rng(0)
    euler = rng.uniform([-3.0, -1.5, -3.0], [3.0, 1.5, 3.0], (16, 3)).astype(np.float64)
    R = rotations.euler_angles_to_matrix(torch.from_numpy(euler))
    np.testing.assert_allclose(R.numpy(), np.asarray(jax_rot.euler_angles_to_matrix(
        jnp.asarray(euler, jnp.float32))), atol=1e-6)
    back = rotations.matrix_to_euler_angles(R)
    np.testing.assert_allclose(back.numpy(), euler, atol=1e-9)
    np.testing.assert_allclose(rotations.euler_angles_to_matrix(back).numpy(), R.numpy(),
                               atol=1e-12)
    np.testing.assert_allclose(back.float().numpy(), np.asarray(jax_rot.matrix_to_euler_angles(
        jnp.asarray(R.numpy(), jnp.float32))), atol=1e-6)
    np.testing.assert_allclose((R @ R.transpose(-1, -2)).numpy(), np.broadcast_to(np.eye(3),
                                                                                  R.shape),
                               atol=1e-12)


@pytest.fixture(scope="module")
def tiny():
    jmodel = jax_build_model("supnerf", TINY_HP)
    variables = jax.tree.map(np.asarray, init_model_variables(
        jmodel, jax.random.PRNGKey(0), img_size=32))
    raw, _ = make_object_batch(B, seed=3, in_img_sz=32, render_im_sz=8, n_lidar=16)
    keys = jax.random.split(jax.random.PRNGKey(7), B)
    raw["pose_init"] = np.asarray(jax.vmap(
        lambda k, K, roi: jax_poses.get_random_pose2(k, K, roi.astype(jnp.float32)))(
        keys, jnp.asarray(raw["K"]), jnp.asarray(raw["roi_nerf"])))
    tmodel = build_model("supnerf", TINY_HP)
    tmodel.load_state_dict(convert_supnerf_variables(variables, TINY_HP), strict=True)
    return jmodel, variables, raw, tmodel


def _jax_jitter(T):
    """The JAX loop's draws: fold_in(obj_key, t) for the loss render,
    fold_in(it_key, 1) for the depth render, obj_key = split(key, B)[b]."""
    obj_keys = jax.random.split(jax.random.PRNGKey(0), B)
    it_keys = [[jax.random.fold_in(obj_keys[b], t) for b in range(B)] for t in range(T)]
    loss = np.asarray([[jax.random.uniform(k, (8,)) for k in row] for row in it_keys])
    depth = np.asarray([[jax.random.uniform(jax.random.fold_in(k, 1), (8,)) for k in row]
                        for row in it_keys])
    return loss, depth


@pytest.fixture(scope="module")
def case_cache():
    """The cases' runs by name: pytest sets case_runs up again for a case
    whose tests an indirect parametrization orders apart."""
    cache = {}
    yield cache
    cache.clear()


@pytest.fixture(scope="module", params=list(CASES))
def case_runs(request, tiny, case_cache):
    """Both loops on the same inputs; the port's optimizer steps are
    recorded: (t, parameters, gradients) of every updating iteration."""
    if request.param not in case_cache:
        case_cache[request.param] = _run_case(request.param, tiny)
    return case_cache[request.param]


def _run_case(name, tiny):
    jmodel, variables, raw, tmodel = tiny
    T, opts = CASES[name]
    jcfg = JaxTTOConfig(num_opts=T, field_impl="flax", **COMMON, **opts)
    pcfg = core.TTOConfig(num_opts=T, **COMMON, **opts)
    jres = jax.tree.map(np.asarray, jax_run_tto_batch(
        jmodel, variables, JaxBatch(**{k: jnp.asarray(v) for k, v in raw.items()}),
        jnp.zeros(32), jnp.zeros(32), jcfg, jax.random.PRNGKey(0)))
    jit_loss, jit_depth = _jax_jitter(T)
    batch = core.ObjectBatch.from_numpy(raw, "cpu")
    wts = pack_decoder_params(tmodel)
    steps, adamw_step = [], AdamW.step

    def recording_step(opt, grads, scale):
        grads = list(grads)
        steps.append((REG + 1 + len(steps), [p.detach().numpy().copy() for p in opt.params],
                      [g.numpy().copy() for g in grads]))
        adamw_step(opt, grads, scale)

    with mock.patch.object(AdamW, "step", recording_step):
        pres = core.run_tto_batch(tmodel, wts, batch, torch.zeros(32), torch.zeros(32), pcfg,
                                  jitter=(torch.from_numpy(jit_loss),
                                          torch.from_numpy(jit_depth)))
    pres = {k: v.detach().numpy() for k, v in pres.items()}
    return name, jres, pres, jcfg, pcfg, jit_loss, batch, wts, steps


def test_option_curves_and_final_state_match(case_runs):
    """Curves atol/rtol 1e-3 (1e-4 on the replayed iterations), the saved
    codes and poses and the final pose and codes atol 1e-3 against the JAX
    loop, test_torch_tto.py's tolerances. opt_pose 0: the final pose is the
    refined pose itself. pred_wlh 2: the JAX box size. At full length the
    codes are held to JAX's loop up to iteration 5 and along the whole run
    by test_full_length_gradients_match_at_every_step: from iteration 10 on
    JAX's loop is as far from JAX itself as from the port (ROADMAP C.14,
    tests/tto_drift_witness.py: optax on jax.grad of the same loss, step by
    step outside the loop, is 0.015 from the loop's codes at iteration 10
    and 0.16 at 100, where the port is 0.015 and 0.15 from them and the port
    moved by 1e-7 is 0.035 from itself at 100)."""
    name, jres, pres, *_ = case_runs
    np.testing.assert_allclose(pres["pose_traj"], jres["pose_traj"], atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(pres["wlh_used"], jres["wlh_used"], atol=1e-5, rtol=1e-5)
    for curve in CURVES:
        np.testing.assert_allclose(pres[curve][:, :REG + 1], jres[curve][:, :REG + 1],
                                   atol=1e-4, rtol=1e-4, err_msg=f"{name} {curve}")
        np.testing.assert_allclose(pres[curve], jres[curve], atol=1e-3, rtol=1e-3,
                                   err_msg=f"{name} {curve}")
    np.testing.assert_allclose(pres["final_pose"], jres["final_pose"], atol=1e-3)
    np.testing.assert_allclose(pres["poses_saved"], jres["poses_saved"], atol=1e-3)
    n_codes = FULL_LENGTH_CODE_ITERS if name == FULL_LENGTH else len(CODE_SAVE_ITERS)
    for key in ("shapecodes_saved", "texturecodes_saved"):
        np.testing.assert_allclose(pres[key][:, :n_codes], jres[key][:, :n_codes], atol=1e-3,
                                   err_msg=f"{name} {key}")
    if name != FULL_LENGTH:
        for key in ("final_shapecode", "final_texturecode"):
            np.testing.assert_allclose(pres[key], jres[key], atol=1e-3, err_msg=f"{name} {key}")
    if name in ("opt_pose_0", FULL_LENGTH):
        np.testing.assert_array_equal(pres["final_pose"], pres["pose_traj"][:, -1])
        assert not np.array_equal(pres["final_shapecode"], pres["shapecodes_saved"][:, 0])
    if name == "pred_wlh_2":
        mean = np.array([1.9446588, 4.641784, 1.7103361], np.float32)
        np.testing.assert_allclose(pres["wlh_used"][:, [0, 2]], np.tile(mean[[0, 2]], (B, 1)))
        np.testing.assert_allclose(pres["wlh_used"].prod(1), pres["wlh_pred"].prod(1),
                                   rtol=1e-5)


def _check_steps(tiny, case_runs, steps):
    """The port's gradients of the given optimizer steps (t, parameters,
    gradients) against jax.grad of the JAX loop's loss on the flax field at
    the same parameters and draws; atol 2e-4. A gradient that misses sits
    at a kink (a ReLU gate that float32 rounding puts on either side): the
    port's own gradient at four points 1e-7 of the parameters' size away
    must move by more than the tolerance, and one of them must be JAX's
    (pred_wlh 2's object 1 does so at its first update)."""
    jmodel, variables, raw, _ = tiny
    name, jres, _, jcfg, pcfg, jit_loss, batch, wts, _ = case_runs
    _, from_params = jax_pose_param_fns(jcfg)
    refined = jres["pose_traj"][:, -1]
    obj_keys = jax.random.split(jax.random.PRNGKey(0), B)
    diag = np.linalg.norm(jres["wlh_used"], axis=-1)
    n_params = 4 if pcfg.opt_pose else 2

    def jloss(b, t, sc, tc, rot=None, trans=None):
        pose = from_params(rot, trans) if jcfg.opt_pose else refined[b]
        out = jax_render_frustum(
            lambda x, v: jmodel.apply(variables, x, v, sc, tc),
            jax.random.fold_in(obj_keys[b], t), jax_invert_pose(pose), raw["K"][b],
            raw["roi_nerf"][b].astype(np.float32), diag[b], n_samples=8, im_sz=8,
            shapenet_obj_cood=True)
        return (jax_rgb_loss(out["rgb"], raw["rgb_tgt"][b], raw["occ_tgt"][b])
                + 0.1 * jax_occ_loss(out["acc_trans"], raw["occ_tgt"][b]))

    jax_value_and_grad = jax.jit(jax.value_and_grad(jloss, argnums=tuple(range(2, 2 + n_params))),
                                 static_argnums=0)

    def port_grads(t, start, seed):
        gen = torch.Generator().manual_seed(seed)
        params = [torch.from_numpy(p) for p in start]
        params = [(p + 1e-7 * p.abs().clamp(min=1e-3) * torch.randn(p.shape, generator=gen))
                  .requires_grad_(True) for p in params]
        pose = (core.pose_param_fns(pcfg)[1](params[2], params[3]) if pcfg.opt_pose
                else torch.from_numpy(refined.copy()))
        loss, _, _ = core.tto_loss(wts, params[0], params[1], pose, batch,
                                   torch.from_numpy(diag), pcfg,
                                   jitter=torch.from_numpy(jit_loss[t]),
                                   wlh=torch.from_numpy(jres["wlh_used"]))
        return [g.numpy() for g in torch.autograd.grad(loss.sum(), params)]

    def close(a, b):
        return np.allclose(a, b, atol=2e-4, rtol=2e-4)

    for t, params, grads in steps:
        nearby = None
        for b in range(B):
            loss, ref = jax_value_and_grad(b, t, *(p[b] for p in params))
            for i, (g, r) in enumerate(zip(grads, ref)):
                if close(g[b], r):
                    continue
                nearby = nearby or [port_grads(t, params, seed) for seed in range(4)]
                sides = [n[i][b] for n in nearby]
                assert any(not close(s, g[b]) for s in sides), f"{name} t={t} b={b}: {g[b]} {r}"
                assert any(close(s, np.asarray(r)) for s in sides), (
                    f"{name} t={t} b={b}: {sides} {r}")


@pytest.mark.parametrize("case_runs", OPTIONS, indirect=True)
def test_option_first_update_gradients_match(tiny, case_runs):
    """The first updating iteration's gradients (t = reg_iters + 1) at the
    same parameters: the port's tto_loss through its pose_param_fns against
    jax.grad of the JAX loop's loss (_check_steps)."""
    steps = case_runs[-1]
    assert steps[0][0] == REG + 1
    _check_steps(tiny, case_runs, steps[:1])


@pytest.mark.parametrize("case_runs", [FULL_LENGTH], indirect=True)
def test_full_length_gradients_match_at_every_step(tiny, case_runs):
    """All 97 updating iterations of the 100-iteration run across the
    optimizer reset at iteration 40: at each, the gradient the port's loop
    stepped with against jax.grad of the JAX loop's loss at the port's own
    parameters (_check_steps); and each of the port's AdamW steps, with the
    reset and lr halving, against the JAX loop's optax optimizer and update
    rule on the same parameters and gradients, 1e-6 (optax raises b2 to the
    step count in float32, which moves an update by up to ~1e-7). So the
    port follows JAX's objective and optimizer along the whole run."""
    name, jres, pres, jcfg, *_, steps = case_runs
    assert [s[0] for s in steps] == list(range(REG + 1, 100))
    _check_steps(tiny, case_runs, steps)
    tx, zero = jax_make_optimizer(jcfg), np.zeros((B, 3), np.float32)
    state = tx.init(JaxTTOParams(*steps[0][1], zero, zero))
    after = [s[1] for s in steps[1:]] + [[pres["final_shapecode"], pres["final_texturecode"]]]
    for (t, before, grads), stepped in zip(steps, after):
        params = JaxTTOParams(*before, zero, zero)
        if t % jcfg.lr_half_interval == 0:
            state = tx.init(params)
        updates, state = tx.update(JaxTTOParams(*grads, zero, zero), state, params)
        scale = 2.0 ** -(t // jcfg.lr_half_interval)
        ref = optax.apply_updates(params, jax.tree.map(lambda u: u * scale, updates))
        np.testing.assert_allclose(stepped[0], ref.shapecode, atol=1e-6, err_msg=f"t={t}")
        np.testing.assert_allclose(stepped[1], ref.texturecode, atol=1e-6, err_msg=f"t={t}")


# --------------------------------------------------------------------------
# the driver: code_level storage, opt_pose 2
# --------------------------------------------------------------------------

DRIVER_HPAMS = {"arch": "supnerf", "net_hyperparams": TINY_HP, "n_samples": 8,
                "render_im_sz": 8, "in_img_sz": 32, "roi_margin": 5,
                "optimize": {"num_opts": 5}}


class Views:
    """2 synthetic objects, one instance seen twice (the JAX tests' SynthDataset)."""

    def __init__(self, n=2):
        self.samples = []
        for i in range(n):
            s = make_synthetic_object(seed=60 + i)
            s.update(instoken=f"ins_{i // 2}", anntoken=f"ann_{i}", cam_ids="CAM_FRONT")
            self.samples.append(s)

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]


def _jax_stub(level):
    """An object carrying what JaxTTODriver._postprocess_batch and
    results_dict read, with the device fetch as the identity."""
    return types.SimpleNamespace(
        code_level=level, vis=0, _tto=types.SimpleNamespace(fetch=lambda r: r),
        timer=types.SimpleNamespace(phase=lambda name: contextlib.nullcontext()),
        _log_idx=lambda s, i: JaxTTODriver._log_idx(None, s, i),
        **{k: {} for k in ("psnr_eval", "ssim_eval", "optimized_shapecodes",
                           "optimized_texturecodes", "optimized_poses", "R_eval", "T_eval",
                           "depth_err_mean", "lidar_pts_cnt", "ood_flags")})


def _assert_same_tree(ours, ref, path="results"):
    if isinstance(ref, dict):
        assert isinstance(ours, dict) and set(ours) == set(ref), path
        for k in ref:
            _assert_same_tree(ours[k], ref[k], f"{path}[{k!r}]")
    elif isinstance(ref, (np.ndarray, list)):
        np.testing.assert_array_equal(np.asarray(ours), np.asarray(ref), err_msg=path)
    else:
        assert ours == ref, path


@pytest.mark.parametrize("level", [0, 1, 2])
def test_driver_code_levels_match_jax_bookkeeping(tiny, tmp_path, level):
    """One batch's results, bookkept by the port's driver at code_level and
    by the JAX driver's _postprocess_batch on the same numbers: the same
    results_dict, keys, nesting and values (JAX tests/test_eval_interop.py
    test_code_level_storage_roundtrip); the .pth twin's codes flat at
    levels 0 and 1."""
    tmodel = tiny[3]
    drv = TTODriver(tmodel, np.zeros(32, np.float32), np.zeros(32, np.float32), DRIVER_HPAMS,
                    Views(), str(tmp_path), device="cpu", reg_iters=REG, batch_size=2,
                    code_level=level)
    samples, prepped, batch = drv._prep([0, 1])
    res = core.run_tto_batch(tmodel, drv.wts, batch, drv.mean_shape, drv.mean_texture, drv.cfg,
                             generator=drv.render_gen)
    drv._bookkeep([0, 1], samples, prepped, res)
    stub = _jax_stub(level)
    JaxTTODriver._postprocess_batch(stub, [0, 1], samples, prepped,
                                    {k: v.detach().numpy() for k, v in res.items()})
    _assert_same_tree(drv.results_dict(), JaxTTODriver.results_dict(stub))
    drv.save_results_pth()
    saved = torch.load(tmp_path / "codes+poses.pth", weights_only=False)
    codes = saved["optimized_shapecodes"]
    assert set(codes) == ({"ins_0"} if level == 0 else {"ann_0", "ann_1"})
    first = next(iter(codes.values()))
    assert isinstance(first, dict) if level == 2 else first.shape == (6, 32)
    assert saved["optimized_poses"]["ann_0"]["CAM_FRONT"].shape == (6, 3, 4)


def _exact_uv16(sample, roi):
    """The direct corner prediction that denormalises onto the exact
    projected box corners of the sample's pose (the inverse of
    pnp.denormalize_uv_direct)."""
    pose = np.asarray(sample["obj_poses"], np.float64)
    uv = pnp.project(pnp._box_corners_3d(np.asarray(sample["wlh"], np.float64)), pose[:, :3],
                     pose[:, 3], np.asarray(sample["cam_intrinsics"], np.float64)).T
    roi = np.asarray(roi, np.float64)
    dim = max(roi[2] - roi[0], roi[3] - roi[1])
    centre = np.array([(roi[0] + roi[2]) / 2, (roi[1] + roi[3]) / 2])[:, None]
    return ((uv - centre) / (dim / 2)).reshape(-1)


def test_driver_opt_pose_2_matches_jax_driver(tiny, tmp_path, monkeypatch):
    """opt_pose 2 on exact corner predictions (both drivers' encoder corners
    replaced by them, so RANSAC has one answer): the PnP pose is the ground
    truth in both drivers, and the refiner's trajectory from it (iteration
    0's saved pose, the rotation and translation errors of iterations
    0..reg_iters) agrees to 1e-4."""
    pytest.importorskip("cv2")      # the JAX driver's PnP
    jmodel, variables, _, tmodel = tiny
    views = Views()
    drv = TTODriver(tmodel, np.zeros(32, np.float32), np.zeros(32, np.float32), DRIVER_HPAMS,
                    views, str(tmp_path / "port"), device="cpu", reg_iters=REG, batch_size=2,
                    opt_pose=2)
    _, prepped, _ = drv._prep([0, 1])
    uv = np.stack([_exact_uv16(views[i], prepped[i]["roi_refine"]) for i in range(2)])
    monkeypatch.setattr(TTODriver, "_corner_uv", lambda self, uv_direct: uv)
    monkeypatch.setattr(JaxTTODriver, "_encode_uv", lambda self, img_in: uv)
    ours = drv.run()
    assert drv.pnp_translations == 2
    jdrv = JaxTTODriver(jmodel, variables, np.zeros(32, np.float32), np.zeros(32, np.float32),
                        DRIVER_HPAMS, views, str(tmp_path / "jax"), opt_pose=2, reg_iters=REG,
                        batch_size=2, field_impl="flax")
    jres = jdrv.optimize_object_batch([0, 1])
    for i in range(2):
        ann, log_idx = f"ann_{i}", f"ann_{i}_CAM_FRONT"
        pose0 = ours["optimized_poses"][ann]["CAM_FRONT"][0]
        np.testing.assert_allclose(pose0, jres["poses_saved"][i][0], atol=1e-4)
        np.testing.assert_allclose(pose0, views[i]["obj_poses"], atol=1e-4)
        for key, curve in (("R_eval", "rot_err"), ("T_eval", "trans_err")):
            np.testing.assert_allclose(ours[key][log_idx][:REG + 1],
                                       jres[curve][i][:REG + 1], atol=1e-4)


# --------------------------------------------------------------------------
# PnP against cv2
# --------------------------------------------------------------------------

K_NUSC = np.array([[1266.4, 0.0, 816.3], [0.0, 1266.4, 491.5], [0.0, 0.0, 1.0]])


def _pose_case(seed):
    rng = np.random.default_rng(seed)
    wlh = np.array([1.9, 4.6, 1.7]) * rng.uniform(0.9, 1.1, 3)
    R = rotations.axis_angle_to_matrix(torch.from_numpy(rng.normal(size=3))).numpy()
    t = np.array([rng.uniform(-4, 4), rng.uniform(-1, 2), rng.uniform(10, 35)])
    P = pnp._box_corners_3d(wlh)
    return P, pnp.project(P, R, t, K_NUSC), R, t


def _cv2_pnp(P, uv):
    cv2 = pytest.importorskip("cv2")
    ok, rvec, tvec, inliers = cv2.solvePnPRansac(
        P, uv, K_NUSC, np.zeros(4, np.float32), iterationsCount=5000, reprojectionError=1,
        flags=cv2.SOLVEPNP_P3P)
    return ok, cv2.Rodrigues(rvec)[0], tvec[:, 0], inliers


@pytest.mark.parametrize("outlier", [None, 3])
def test_pnp_matches_cv2_on_exact_and_one_outlier(outlier):
    """Exact corners, then one corner 40 px off: both solvers keep the same
    inliers (8, then 7), recover the pose, and agree to 1e-4."""
    P, uv, R, t = _pose_case(5)
    if outlier is not None:
        uv[outlier] += [40.0, 0.0]
    ok, R_cv, t_cv, inl_cv = _cv2_pnp(P, uv)
    ok2, R2, t2, inl = pnp.solve_pnp_ransac(P, uv, K_NUSC)
    assert ok and ok2
    assert sorted(inl) == sorted(inl_cv[:, 0]) == [i for i in range(8) if i != outlier]
    np.testing.assert_allclose(R2, R_cv, atol=1e-4)
    np.testing.assert_allclose(t2, t_cv, atol=1e-4)
    np.testing.assert_allclose(R2, R, atol=1e-4)
    np.testing.assert_allclose(t2, t, atol=1e-3)


def test_pnp_bootstrap_contract():
    """Through pnp_bootstrap (ROI-normalised corners): the pose recovered on
    exact corners as cv2 recovers it; src_pose back where RANSAC fails; the
    rotation alone where the depth leaves (0, 60) m."""
    P, uv, R, t = _pose_case(9)
    roi = np.array([500.0, 300.0, 900.0, 600.0])
    dim, centre = 400.0, np.array([[700.0], [450.0]])
    uv16 = ((uv.T - centre) / (dim / 2)).reshape(-1)
    src = np.concatenate([np.eye(3), [[0.0], [0.0], [30.0]]], 1).astype(np.float32)
    wlh = np.array([np.linalg.norm(P[0] - P[1]), np.linalg.norm(P[0] - P[4]),
                    np.linalg.norm(P[0] - P[3])])
    out = pnp.pnp_bootstrap(uv16, roi, wlh, K_NUSC, src)
    _, R_cv, t_cv, _ = _cv2_pnp(P, pnp.denormalize_uv_direct(uv16, roi).T)
    np.testing.assert_allclose(out[:, :3], R_cv, atol=1e-4)
    np.testing.assert_allclose(out[:, 3], t_cv, atol=1e-4)
    np.testing.assert_allclose(out[:, 3], t, atol=1e-3)
    noise = np.random.default_rng(0).uniform(-1, 1, 16)     # no 4 corners agree
    np.testing.assert_array_equal(pnp.pnp_bootstrap(noise, roi, wlh, K_NUSC, src), src)
    gated = pnp.pnp_bootstrap(uv16, roi, wlh, K_NUSC, src, depth_range=(0.0, t[2] - 1.0))
    np.testing.assert_allclose(gated[:, :3], R_cv, atol=1e-4)
    np.testing.assert_array_equal(gated[:, 3], src[:, 3])


def test_p3p_returns_the_pose_among_its_solutions():
    P, uv, R, t = _pose_case(11)
    sols = pnp.solve_p3p(P[:3], uv[:3], K_NUSC)
    assert 1 <= len(sols) <= 4
    assert min(max(np.abs(Rs - R).max(), np.abs(ts - t).max()) for Rs, ts in sols) < 1e-6
    R_e, t_e = pnp.solve_epnp(P, uv, K_NUSC)
    np.testing.assert_allclose(R_e, R, atol=1e-8)
    np.testing.assert_allclose(t_e, t, atol=1e-6)


def test_config_reads_the_pose_options():
    """tto_config_from_hpams reads euler_rot, optimize.opt_cam_pose,
    opt_pose and pred_wlh 0-2 into the TTOConfig, as the JAX one does."""
    from supnerf_tpu.tto.driver import tto_config_from_hpams as jax_config
    from supnerf_tpu_torch.tto.driver import tto_config_from_hpams

    hp = {"euler_rot": 1, "optimize": {"opt_cam_pose": 1}}
    for opt_pose in (0, 1, 2):
        for pred_wlh in (0, 1, 2):
            ours = tto_config_from_hpams(hp, opt_pose=opt_pose, pred_wlh=pred_wlh)
            ref = jax_config(hp, opt_pose=opt_pose, pred_wlh=pred_wlh)
            for f in dataclasses.fields(ours):
                assert getattr(ours, f.name) == getattr(ref, f.name), f.name
    with pytest.raises(ValueError):
        tto_config_from_hpams({}, pred_wlh=3)
