"""The port's model weights and its whole TTO slice against the JAX package
on the CPU, at the tiny shapes of tests/test_tto.py: the converter
(supnerf_tpu_torch/models/convert.py) against torch_import.export_state_dict,
the encoder, refiner and decoder against the flax modules, and
run_tto_batch against the JAX run_tto_batch on its flax path with the same
batch, weights and sampling jitter."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from supnerf_tpu.data.synthetic import make_object_batch
from supnerf_tpu.geometry import poses as jax_poses
from supnerf_tpu.geometry.boxes import invert_pose as jax_invert_pose
from supnerf_tpu.models import SUPNeRF as JaxSUPNeRF
from supnerf_tpu.models import build_model as jax_build_model
from supnerf_tpu.models import init_model_variables
from supnerf_tpu.models.torch_import import export_state_dict
from supnerf_tpu.ops.volume_render import occupancy_loss as jax_occ_loss
from supnerf_tpu.ops.volume_render import rgb_loss_masked as jax_rgb_loss
from supnerf_tpu.render.renderer import render_rays_frustum as jax_render_frustum
from supnerf_tpu.tto import ObjectBatch as JaxBatch
from supnerf_tpu.tto import TTOConfig as JaxTTOConfig
from supnerf_tpu.tto import run_tto_batch as jax_run_tto_batch
from supnerf_tpu.tto.core import pose_param_fns as jax_pose_param_fns
from supnerf_tpu_torch.models.convert import convert_supnerf_variables
from supnerf_tpu_torch.models.factory import build_model
from supnerf_tpu_torch.ops.render import pack_decoder_params
from supnerf_tpu_torch.tto import core
from torch_memory import release_memory_after_module  # noqa: F401

TINY_HP = {"shape_blocks": 1, "texture_blocks": 1, "latent_dim": 32,
           "pose_shortcut": 1, "pred_wlh": 0}
REG, T, B = 2, 5, 2     # reg_iters + 3 iterations, 2 objects
JAX_CFG = JaxTTOConfig(num_opts=T, reg_iters=REG, n_samples=8, render_im_sz=8, in_img_sz=32,
                       n_lidar=16, shapenet_obj_cood=True, field_impl="flax")
PORT_CFG = core.TTOConfig(num_opts=T, reg_iters=REG, n_samples=8, render_im_sz=8,
                          in_img_sz=32, n_lidar=16, shapenet_obj_cood=True)


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


def test_converter_matches_export_state_dict(tiny):
    jmodel, variables, _, tmodel = tiny
    ours = convert_supnerf_variables(variables, TINY_HP)
    ref = export_state_dict(jmodel, variables)
    assert set(ours) == set(ref) == set(tmodel.state_dict())
    for k, v in ref.items():
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(v), err_msg=k)


def test_encoder_matches_flax(tiny):
    """One image per BatchNorm batch, batch statistics (train=True)."""
    jmodel, variables, raw, tmodel = tiny
    img = raw["img_in"][:1]
    (ref, _) = jmodel.apply(variables, jnp.asarray(img), True, method=JaxSUPNeRF.encode_img,
                            mutable=["batch_stats"])
    with torch.no_grad():
        ours = tmodel.encode_img(torch.from_numpy(img))
    for name, a, b in zip(("shape", "texture", "pose", "uv"), ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=1e-4, err_msg=name)


def test_refiner_and_decoder_match_flax(tiny):
    jmodel, variables, _, tmodel = tiny
    rng = np.random.default_rng(1)
    feat = rng.normal(size=(3, 32)).astype(np.float32)
    uv = rng.normal(size=(3, 16)).astype(np.float32)
    ref = jmodel.apply(variables, jnp.asarray(feat), jnp.asarray(uv), method=JaxSUPNeRF.pose_update)
    xyz = (rng.normal(size=(4, 6, 3)) * 0.4).astype(np.float32)
    vd = rng.normal(size=(4, 6, 3)).astype(np.float32)
    sc, tc = (rng.normal(size=(2, 32)) * 0.3).astype(np.float32)
    sig_r, rgb_r = jmodel.apply(variables, *map(jnp.asarray, (xyz, vd, sc, tc)))
    with torch.no_grad():
        delta = tmodel.pose_update(torch.from_numpy(feat), torch.from_numpy(uv))
        sig, rgb = tmodel(*map(torch.from_numpy, (xyz, vd, sc, tc)))
    np.testing.assert_allclose(delta.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(sig.numpy(), np.asarray(sig_r), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(rgb_r), atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def both_runs(tiny):
    jmodel, variables, raw, tmodel = tiny
    key = jax.random.PRNGKey(0)
    jres = jax.tree.map(np.asarray, jax_run_tto_batch(
        jmodel, variables, JaxBatch(**{k: jnp.asarray(v) for k, v in raw.items()}),
        jnp.zeros(32), jnp.zeros(32), JAX_CFG, key))
    # the JAX loop's jitter: fold_in(obj_key, t) for the loss render and
    # fold_in(it_key, 1) for the depth render, obj_key = split(key, B)[b]
    obj_keys = jax.random.split(key, B)
    it_keys = [[jax.random.fold_in(obj_keys[b], t) for b in range(B)] for t in range(T)]
    jit_loss = np.asarray([[jax.random.uniform(k, (8,)) for k in row] for row in it_keys])
    jit_depth = np.asarray([[jax.random.uniform(jax.random.fold_in(k, 1), (8,)) for k in row]
                            for row in it_keys])
    batch = core.ObjectBatch.from_numpy(raw, "cpu")
    wts = pack_decoder_params(tmodel)
    pres = core.run_tto_batch(tmodel, wts, batch, torch.zeros(32), torch.zeros(32), PORT_CFG,
                              jitter=(torch.from_numpy(jit_loss), torch.from_numpy(jit_depth)))
    pres = {k: v.detach().numpy() for k, v in pres.items()}
    return jres, pres, jit_loss, batch, wts


def test_refiner_trajectory_matches(both_runs):
    jres, pres, *_ = both_runs
    np.testing.assert_allclose(pres["pose_traj"], jres["pose_traj"], atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(pres["shapecodes_saved"][:, 0], jres["shapecodes_saved"][:, 0],
                               atol=1e-4, rtol=1e-4)


def test_first_update_gradients_match(tiny, both_runs):
    """Gradients of the first updating iteration (t = reg_iters + 1) at the
    same parameters: the port's tto_loss (fused render through the
    autograd.Function) against jax.grad of the JAX loop's loss on the flax
    field; atol 2e-4 as tests/test_pallas_render.py."""
    jmodel, variables, raw, _ = tiny
    jres, _, jit_loss, batch, wts = both_runs
    t = REG + 1
    to_params, from_params = jax_pose_param_fns(JAX_CFG)
    sc0, tc0 = jres["shapecodes_saved"][:, 0], jres["texturecodes_saved"][:, 0]
    rot0, trans0 = jax.vmap(to_params)(jnp.asarray(jres["pose_traj"][:, -1]))
    obj_keys = jax.random.split(jax.random.PRNGKey(0), B)

    def jloss(sc, tc, rot, trans, b):
        pose = from_params(rot, trans)
        out = jax_render_frustum(
            lambda x, v: jmodel.apply(variables, x, v, sc, tc),
            jax.random.fold_in(obj_keys[b], t), jax_invert_pose(pose), raw["K"][b],
            raw["roi_nerf"][b].astype(np.float32), np.linalg.norm(raw["wlh"][b]),
            n_samples=8, im_sz=8, shapenet_obj_cood=True)
        return (jax_rgb_loss(out["rgb"], raw["rgb_tgt"][b], raw["occ_tgt"][b])
                + 0.1 * jax_occ_loss(out["acc_trans"], raw["occ_tgt"][b]))

    params = [torch.tensor(np.asarray(a)).requires_grad_(True) for a in (sc0, tc0, rot0, trans0)]
    diag = torch.linalg.norm(batch.wlh, dim=-1)
    pose = core.pose_param_fns(PORT_CFG)[1](params[2], params[3])
    loss, _, _ = core.tto_loss(wts, params[0], params[1], pose, batch, diag, PORT_CFG,
                            jitter=torch.from_numpy(jit_loss[t]))
    grads = torch.autograd.grad(loss.sum(), params)
    for b in range(B):
        ref = jax.grad(jloss, argnums=(0, 1, 2, 3))(sc0[b], tc0[b], rot0[b], trans0[b], b)
        np.testing.assert_allclose(float(loss[b].detach()), float(jloss(sc0[b], tc0[b], rot0[b],
                                                               trans0[b], b)), rtol=1e-5)
        for name, g, r in zip(("shapecode", "texturecode", "rot_vec", "trans_vec"), grads, ref):
            np.testing.assert_allclose(g[b].numpy(), np.asarray(r), atol=2e-4, rtol=2e-4,
                                       err_msg=f"{name} object {b}")


@pytest.mark.parametrize("curve", ["loss", "psnr", "rot_err", "trans_err", "depth_err"])
def test_tto_curves_match(both_runs, curve):
    """Replay iterations (t <= reg_iters) match to float32 rounding (1e-4).
    Once AdamW steps, 1e-3: Adam divides each gradient component by its own
    magnitude, so a component near zero whose float32 rounding differs
    between the packages can move its parameter by up to lr instead of by
    the rounding (measured here: ~1e-6, no such component)."""
    jres, pres, *_ = both_runs
    np.testing.assert_allclose(pres[curve][:, :REG + 1], jres[curve][:, :REG + 1],
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(pres[curve], jres[curve], atol=1e-3, rtol=1e-3)


def test_snapshots_and_final_pose(both_runs):
    """Saved codes and poses follow the JAX loop's snapshot rule: iteration 0
    before any update, everything at or past num_opts the final values; the
    final pose is the last rendered one."""
    jres, pres, *_ = both_runs
    assert pres["shapecodes_saved"].shape == jres["shapecodes_saved"].shape == (B, 6, 32)
    np.testing.assert_allclose(pres["poses_saved"][:, 0], jres["poses_saved"][:, 0], atol=1e-4)
    np.testing.assert_allclose(pres["shapecodes_saved"][:, -1], pres["final_shapecode"])
    np.testing.assert_allclose(pres["poses_saved"][:, -1], pres["final_pose"])
    np.testing.assert_allclose(pres["final_pose"], jres["final_pose"], atol=1e-3)
    np.testing.assert_allclose(pres["final_shapecode"], jres["final_shapecode"], atol=1e-3)
