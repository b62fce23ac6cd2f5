"""The port's TTO regularisers against the JAX package on the CPU, at the
tiny shapes of tests/test_torch_tto.py: the object-size samples and loss
and the symmetry loss (supnerf_tpu_torch/tto/regularizers.py) on replayed
draws, the symmetry flip and the per-point loss render of the renderers,
and run_tto_batch with sym_aug, obj_sz_reg and sym_loss_coef 1.0 against the
JAX run_tto_batch on its flax path with JAX's jitter, flips and object-size
draws injected. The port's field is ops.field.field_apply (the plain
versions of K5/K6 inside FieldApply on CPU tensors)."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_threads  # noqa: F401
from supnerf_tpu.data.synthetic import make_object_batch
from supnerf_tpu.geometry import poses as jax_poses
from supnerf_tpu.geometry.boxes import invert_pose as jax_invert_pose
from supnerf_tpu.models import build_model as jax_build_model
from supnerf_tpu.models import init_model_variables
from supnerf_tpu.ops.volume_render import occupancy_loss as jax_occ_loss
from supnerf_tpu.ops.volume_render import rgb_loss_masked as jax_rgb_loss
from supnerf_tpu.render import renderer as jax_renderer
from supnerf_tpu.tto import ObjectBatch as JaxBatch
from supnerf_tpu.tto import TTOConfig as JaxTTOConfig
from supnerf_tpu.tto import regularizers as jax_reg
from supnerf_tpu.tto import run_tto_batch as jax_run_tto_batch
from supnerf_tpu.tto.core import pose_param_fns as jax_pose_param_fns
from supnerf_tpu_torch.geometry.boxes import invert_pose
from supnerf_tpu_torch.geometry.rotations import axis_angle_to_matrix
from supnerf_tpu_torch.models.convert import convert_supnerf_variables
from supnerf_tpu_torch.models.factory import build_model
from supnerf_tpu_torch.ops import render
from supnerf_tpu_torch.ops.field import field_apply
from supnerf_tpu_torch.render import renderer
from supnerf_tpu_torch.tto import core, regularizers
from supnerf_tpu_torch.tto.driver import tto_config_from_hpams
from torch_memory import release_memory_after_module  # noqa: F401

TINY_HP = {"shape_blocks": 1, "texture_blocks": 1, "latent_dim": 32,
           "pose_shortcut": 1, "pred_wlh": 0}
REG, T, B, S, IM = 2, 5, 2, 8, 8     # reg_iters + 3 iterations, 2 objects
P = regularizers.SAMPLES_PER_PLANE
REGULARISERS = dict(sym_aug=True, obj_sz_reg=True, sym_loss_coef=1.0)
JAX_CFG = JaxTTOConfig(num_opts=T, reg_iters=REG, n_samples=S, render_im_sz=IM, in_img_sz=32,
                       n_lidar=16, shapenet_obj_cood=True, field_impl="flax", **REGULARISERS)
PORT_CFG = core.TTOConfig(num_opts=T, reg_iters=REG, n_samples=S, render_im_sz=IM,
                          in_img_sz=32, n_lidar=16, shapenet_obj_cood=True, **REGULARISERS)


@pytest.fixture(scope="module")
def tiny():
    jmodel = jax_build_model("supnerf", TINY_HP)
    variables = jax.tree.map(np.asarray, init_model_variables(
        jmodel, jax.random.PRNGKey(0), img_size=32))
    raw, _ = make_object_batch(B, seed=3, in_img_sz=32, render_im_sz=IM, n_lidar=16)
    keys = jax.random.split(jax.random.PRNGKey(7), B)
    raw["pose_init"] = np.asarray(jax.vmap(
        lambda k, K, roi: jax_poses.get_random_pose2(k, K, roi.astype(jnp.float32)))(
        keys, jnp.asarray(raw["K"]), jnp.asarray(raw["roi_nerf"])))
    tmodel = build_model("supnerf", TINY_HP)
    tmodel.load_state_dict(convert_supnerf_variables(variables, TINY_HP), strict=True)
    return jmodel, variables, raw, tmodel, render.pack_decoder_params(tmodel)


def _codes(seed=5):
    return (np.random.default_rng(seed).normal(size=(2, B, 32)) * 0.3).astype(np.float32)


def _obj_sz_draws(key):
    """JAX's obj_sz_reg_samples draws: split(key, 3) -> uniform(P) per axis."""
    return np.stack([np.asarray(jax.random.uniform(k, (P,))) for k in jax.random.split(key, 3)])


def _torch_field(wts, codes):
    sc, tc = (torch.from_numpy(c).requires_grad_(True) for c in codes)
    return sc, tc, (lambda x, v: field_apply(wts, x, v, sc, tc))


@pytest.mark.parametrize("shapenet", [True, False])
def test_obj_sz_reg_samples_match_jax(shapenet):
    """The box-plane samples from JAX's own draws, exactly up to float32
    rounding, for two boxes."""
    wlh = np.asarray([[1.9, 4.6, 1.7], [1.6, 3.9, 1.5]], np.float32)
    diag = np.linalg.norm(wlh, axis=-1)
    keys = jax.random.split(jax.random.PRNGKey(11), B)
    draws = np.stack([_obj_sz_draws(k) for k in keys])
    out, inn = regularizers.obj_sz_reg_samples(torch.from_numpy(draws), torch.from_numpy(wlh),
                                               torch.from_numpy(diag), shapenet)
    assert out.shape == inn.shape == (B, 3, 2 * P, 3)
    for b in range(B):
        ref = jax_reg.obj_sz_reg_samples(keys[b], wlh[b], diag[b], shapenet)
        np.testing.assert_allclose(out[b].numpy(), np.asarray(ref[0]), atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(inn[b].numpy(), np.asarray(ref[1]), atol=1e-6, rtol=1e-6)


def test_obj_sz_loss_matches_jax(tiny):
    """The object-size loss per object and its gradients with respect to
    both codes, against the JAX loss on the flax field with the same draws:
    the loss at rtol 1e-5, the gradients at 2e-4."""
    jmodel, variables, raw, _, wts = tiny
    codes = _codes()
    wlh = raw["wlh"].astype(np.float32)
    diag = np.linalg.norm(wlh, axis=-1)
    keys = jax.random.split(jax.random.PRNGKey(12), B)
    draws = torch.from_numpy(np.stack([_obj_sz_draws(k) for k in keys]))
    sc, tc, field_fn = _torch_field(wts, codes)
    loss = regularizers.obj_sz_loss(field_fn, draws, torch.from_numpy(wlh),
                                    torch.from_numpy(diag))
    grads = torch.autograd.grad(loss.sum(), (sc, tc))
    for b in range(B):
        def jloss(s, t):
            return jax_reg.obj_sz_loss(lambda x, v: jmodel.apply(variables, x, v, s, t), keys[b],
                                       wlh[b], diag[b])

        ref, gref = jax.value_and_grad(jloss, argnums=(0, 1))(codes[0, b], codes[1, b])
        np.testing.assert_allclose(float(loss[b].detach()), float(ref), rtol=1e-5)
        for name, g, r in zip(("shapecode", "texturecode"), grads, gref):
            np.testing.assert_allclose(g[b].numpy(), np.asarray(r), atol=2e-4, rtol=2e-4,
                                       err_msg=f"{name} object {b}")


@pytest.mark.parametrize("shapenet", [True, False])
def test_sym_loss_matches_jax(tiny, shapenet):
    """The symmetry loss per object on the samples of rays (B, R, S) and its
    gradients with respect to the points, the directions and both codes
    (the sigmas held fixed, as they enter from the loss render): the loss at
    rtol 1e-5, the gradients at 2e-4."""
    jmodel, variables, _, _, wts = tiny
    codes = _codes(6)
    rng = np.random.default_rng(8)
    xyz = (rng.normal(size=(B, 6, S, 3)) * 0.4).astype(np.float32)
    vd = rng.normal(size=(B, 6, 3)).astype(np.float32)
    vd = np.broadcast_to((vd / np.linalg.norm(vd, axis=-1, keepdims=True))[:, :, None],
                         xyz.shape).copy()
    sigmas = np.abs(rng.normal(size=(B, 6, S, 1))).astype(np.float32)
    sc, tc, field_fn = _torch_field(wts, codes)
    x, v = (torch.from_numpy(a).requires_grad_(True) for a in (xyz, vd))
    loss = regularizers.sym_loss(field_fn, x, v, torch.from_numpy(sigmas), shapenet)
    grads = torch.autograd.grad(loss.sum(), (x, v, sc, tc))
    for b in range(B):
        def jloss(xx, vv, s, t):
            return jax_reg.sym_loss(lambda p, d: jmodel.apply(variables, p, d, s, t), xx, vv,
                                    sigmas[b], shapenet)

        ref, gref = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3))(xyz[b], vd[b], codes[0, b],
                                                                    codes[1, b])
        np.testing.assert_allclose(float(loss[b].detach()), float(ref), rtol=1e-5)
        for name, g, r in zip(("xyz", "viewdir", "shapecode", "texturecode"), grads, gref):
            np.testing.assert_allclose(g[b].numpy(), np.asarray(r), atol=2e-4, rtol=2e-4,
                                       err_msg=f"{name} object {b}")


@pytest.mark.parametrize("shapenet", [True, False])
def test_coord_transform_with_sym_flip_matches_jax(shapenet):
    """apply_obj_coord_transform with a per-object flip (one object flipped,
    one not) against the JAX transform object by object, exactly."""
    rng = np.random.default_rng(9)
    xyz = rng.normal(size=(B, 4, S, 3)).astype(np.float32)
    vd = rng.normal(size=(B, 4, 3)).astype(np.float32)
    flips = np.asarray([True, False])
    out = renderer.apply_obj_coord_transform(torch.from_numpy(xyz), torch.from_numpy(vd),
                                             shapenet, torch.from_numpy(flips))
    for b in range(B):
        ref = jax_renderer.apply_obj_coord_transform(jnp.asarray(xyz[b]), jnp.asarray(vd[b]),
                                                     shapenet, sym_flip=jnp.asarray(flips[b]))
        for a, r in zip(out, ref):
            np.testing.assert_array_equal(a[b].numpy(), np.asarray(r))


def test_frustum_render_with_samples_matches_jax(tiny):
    """render_rays_frustum with a flip for one object and a per-point field
    (the JAX renderer's return_samples) against the JAX renderer on its
    flax field, the JAX draws injected: rgb, acc, the samples and their
    sigmas at 1e-4, depth at 1e-3 (metric)."""
    jmodel, variables, raw, _, wts = tiny
    codes = _codes(7)
    keys = jax.random.split(jax.random.PRNGKey(13), B)
    jitter = np.stack([np.asarray(jax.random.uniform(k, (S,))) for k in keys])
    flips = np.asarray([True, False])
    cam = np.stack([np.asarray(jax_invert_pose(p)) for p in raw["obj_pose_gt"]])
    diag = np.linalg.norm(raw["wlh"], axis=-1).astype(np.float32)
    roi = raw["roi_nerf"].astype(np.float32)
    t = torch.from_numpy
    with torch.no_grad():
        out = renderer.render_rays_frustum(
            None, t(cam), t(raw["K"]), t(roi), t(diag), n_samples=S, im_sz=IM,
            shapenet_obj_cood=True, sym_flip=t(flips),
            field_fn=lambda x, v: field_apply(wts, x, v, t(codes[0]), t(codes[1])),
            jitter=t(jitter))
    assert out["sigmas"].shape == (B, IM * IM, S, 1) and out["viewdir"].shape == (B, IM * IM, S, 3)
    for b in range(B):
        ref = jax_renderer.render_rays_frustum(
            lambda x, v: jmodel.apply(variables, x, v, codes[0, b], codes[1, b]), keys[b],
            cam[b], raw["K"][b], roi[b], diag[b], n_samples=S, im_sz=IM, shapenet_obj_cood=True,
            sym_flip=jnp.asarray(flips[b]), return_samples=True)
        for k, atol in (("rgb", 1e-4), ("acc_trans", 1e-4), ("depth", 1e-3), ("xyz", 1e-4),
                        ("viewdir", 1e-4), ("sigmas", 1e-4)):
            np.testing.assert_allclose(out[k][b].numpy(), np.asarray(ref[k]), atol=atol,
                                       rtol=1e-4, err_msg=f"{k} object {b}")


def test_aabb_render_with_sym_flip_matches_jax(tiny):
    """render_rays_aabb with a flip for one object against the JAX renderer
    on its flax field, the JAX draws injected: rgb and acc at 1e-4, depth
    at 1e-3 (metric), hit exactly."""
    jmodel, variables, raw, _, wts = tiny
    codes = _codes(8)
    keys = jax.random.split(jax.random.PRNGKey(14), B)
    jitter = np.stack([np.asarray(jax.random.uniform(k, (IM * IM, S))) for k in keys])
    flips = np.asarray([True, False])
    cam = np.stack([np.asarray(jax_invert_pose(p)) for p in raw["obj_pose_gt"]])
    wlh, roi = raw["wlh"].astype(np.float32), raw["roi_nerf"].astype(np.float32)
    t = torch.from_numpy
    with torch.no_grad():
        out = renderer.render_rays_aabb(
            lambda x, v, z, h: render.field_composite_aabb(wts, x, v, z, h, t(codes[0]),
                                                           t(codes[1])),
            t(cam), t(raw["K"]), t(roi), t(wlh), n_samples=S, im_sz=IM, shapenet_obj_cood=True,
            sym_flip=t(flips), jitter=t(jitter))
    assert out["hit"].any()
    for b in range(B):
        ref = jax_renderer.render_rays_aabb(
            lambda x, v: jmodel.apply(variables, x, v, codes[0, b], codes[1, b]), keys[b],
            cam[b], raw["K"][b], roi[b], wlh[b], n_samples=S, im_sz=IM, shapenet_obj_cood=True,
            sym_flip=jnp.asarray(flips[b]), adjust_scale=renderer.AABB_FIELD_SCALE)
        np.testing.assert_array_equal(out["hit"][b].numpy(), np.asarray(ref["hit"]))
        for k, atol in (("rgb", 1e-4), ("acc_trans", 1e-4), ("depth", 1e-3)):
            np.testing.assert_allclose(out[k][b].numpy(), np.asarray(ref[k]), atol=atol,
                                       rtol=1e-4, err_msg=f"{k} object {b}")


# --------------------------------------------------------------------------
# TTO with the three regularisers
# --------------------------------------------------------------------------

def _jax_draws(key):
    """The JAX loop's draws per iteration and object (obj_key = split(key,
    B)[b], it_key = fold_in(obj_key, t)): the loss render's jitter from
    it_key, the lidar render's from fold_in(it_key, 1), the flip
    bernoulli(fold_in(it_key, 3)), the object-size draws from
    fold_in(it_key, 7)."""
    obj_keys = jax.random.split(key, B)
    it_keys = [[jax.random.fold_in(obj_keys[b], t) for b in range(B)] for t in range(T)]

    def each(fn):
        return np.asarray([[np.asarray(fn(k)) for k in row] for row in it_keys])

    return (each(lambda k: jax.random.uniform(k, (S,))),
            each(lambda k: jax.random.uniform(jax.random.fold_in(k, 1), (S,))),
            each(lambda k: jax.random.bernoulli(jax.random.fold_in(k, 3))),
            each(lambda k: _obj_sz_draws(jax.random.fold_in(k, 7))))


@pytest.fixture(scope="module")
def both_runs(tiny):
    jmodel, variables, raw, tmodel, wts = tiny
    key = jax.random.PRNGKey(0)
    jres = jax.tree.map(np.asarray, jax_run_tto_batch(
        jmodel, variables, JaxBatch(**{k: jnp.asarray(v) for k, v in raw.items()}),
        jnp.zeros(32), jnp.zeros(32), JAX_CFG, key))
    draws = _jax_draws(key)
    t = torch.from_numpy
    batch = core.ObjectBatch.from_numpy(raw, "cpu")
    pres = core.run_tto_batch(tmodel, wts, batch, torch.zeros(32), torch.zeros(32), PORT_CFG,
                              jitter=(t(draws[0]), t(draws[1])), sym_flips=t(draws[2]),
                              obj_sz_draws=t(draws[3]))
    pres = {k: v.detach().numpy() for k, v in pres.items()}
    return jres, pres, draws, batch


def test_replayed_flips_cover_both_sides(both_runs):
    """The draws replayed from the JAX loop flip some loss renders and not
    others, so the parity below covers both."""
    flips = both_runs[2][2]
    assert flips.shape == (T, B) and flips.any() and not flips.all()


def test_first_update_gradients_with_regularisers_match(tiny, both_runs):
    """Gradients of the first updating iteration (t = reg_iters + 1) at the
    same parameters: the port's tto_loss with the three regularisers
    (per-point loss render, mirror and box samples through FieldApply)
    against jax.grad of the JAX loop's loss on the flax field with the same
    draws; atol 2e-4."""
    jmodel, variables, raw, _, wts = tiny
    jres, _, draws, batch = both_runs
    t = REG + 1
    to_params, from_params = jax_pose_param_fns(JAX_CFG)
    sc0, tc0 = jres["shapecodes_saved"][:, 0], jres["texturecodes_saved"][:, 0]
    rot0, trans0 = jax.vmap(to_params)(jnp.asarray(jres["pose_traj"][:, -1]))
    obj_keys = jax.random.split(jax.random.PRNGKey(0), B)
    diag = np.linalg.norm(raw["wlh"], axis=-1)

    def jloss(sc, tc, rot, trans, b):
        it_key = jax.random.fold_in(obj_keys[b], t)
        pose = from_params(rot, trans)

        def field_fn(x, v):
            return jmodel.apply(variables, x, v, sc, tc)

        out = jax_renderer.render_rays_frustum(
            field_fn, it_key, jax_invert_pose(pose), raw["K"][b],
            raw["roi_nerf"][b].astype(np.float32), diag[b], n_samples=S, im_sz=IM,
            shapenet_obj_cood=True, sym_flip=jnp.asarray(draws[2][t, b]), return_samples=True)
        return (jax_rgb_loss(out["rgb"], raw["rgb_tgt"][b], raw["occ_tgt"][b])
                + 0.1 * jax_occ_loss(out["acc_trans"], raw["occ_tgt"][b])
                + jax_reg.obj_sz_loss(field_fn, jax.random.fold_in(it_key, 7), raw["wlh"][b],
                                      diag[b])
                + jax_reg.sym_loss(field_fn, out["xyz"], out["viewdir"], out["sigmas"]))

    params = [torch.tensor(np.asarray(a)).requires_grad_(True) for a in (sc0, tc0, rot0, trans0)]
    pose = core.pose_param_fns(PORT_CFG)[1](params[2], params[3])
    loss, _, _ = core.tto_loss(wts, params[0], params[1], pose, batch,
                               torch.linalg.norm(batch.wlh, dim=-1), PORT_CFG,
                               jitter=torch.from_numpy(draws[0][t]), wlh=batch.wlh,
                               sym_flip=torch.from_numpy(draws[2][t]),
                               obj_sz_draws=torch.from_numpy(draws[3][t]))
    grads = torch.autograd.grad(loss.sum(), params)
    for b in range(B):
        args = (sc0[b], tc0[b], rot0[b], trans0[b], b)
        ref = jax.grad(jloss, argnums=(0, 1, 2, 3))(*args)
        np.testing.assert_allclose(float(loss[b].detach()), float(jloss(*args)), rtol=1e-5)
        for name, g, r in zip(("shapecode", "texturecode", "rot_vec", "trans_vec"), grads, ref):
            np.testing.assert_allclose(g[b].numpy(), np.asarray(r), atol=2e-4, rtol=2e-4,
                                       err_msg=f"{name} object {b}")


@pytest.mark.parametrize("curve", ["loss", "psnr", "rot_err", "trans_err", "depth_err"])
def test_tto_curves_with_regularisers_match(both_runs, curve):
    """As tests/test_torch_tto.py::test_tto_curves_match: 1e-4 through the
    replay iterations, 1e-3 once AdamW steps."""
    jres, pres, *_ = both_runs
    np.testing.assert_allclose(pres[curve][:, :REG + 1], jres[curve][:, :REG + 1],
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(pres[curve], jres[curve], atol=1e-3, rtol=1e-3)


def test_final_codes_and_pose_with_regularisers_match(both_runs):
    jres, pres, *_ = both_runs
    for k in ("final_pose", "final_shapecode", "final_texturecode"):
        np.testing.assert_allclose(pres[k], jres[k], atol=1e-3, err_msg=k)


def test_tto_config_from_hpams_reads_the_regularisers():
    """The hpams keys reach TTOConfig as in the JAX driver; sym_loss_coef has
    no hpams key (the reference never calls loss_sym) and stays 0."""
    cfg = tto_config_from_hpams({"sym_aug": 1, "obj_sz_reg": 1, "loss_obj_sz_coef": 0.5})
    assert (cfg.sym_aug, cfg.obj_sz_reg, cfg.loss_obj_sz_coef, cfg.sym_loss_coef) == (
        True, True, 0.5, 0.0)
    assert not tto_config_from_hpams({}).sym_aug


def test_aabb_render_refuses_the_symmetry_loss(tiny):
    """The symmetry loss reuses the frustum render's samples; with the AABB
    render run_tto_batch refuses it with the JAX package's message."""
    _, _, raw, tmodel, wts = tiny
    cfg = dataclasses.replace(PORT_CFG, use_aabb_render=True)
    with pytest.raises(ValueError, match="frustum renderer"):
        core.run_tto_batch(tmodel, wts, core.ObjectBatch.from_numpy(raw, "cpu"),
                           torch.zeros(32), torch.zeros(32), cfg)


def test_pose_gradients_reach_the_flipped_render(tiny):
    """A flipped loss render depends on the pose through the flipped points:
    the gradient of its rgb with respect to the object pose is finite and
    not zero, and differs from the unflipped render's."""
    _, _, raw, _, wts = tiny
    codes = [torch.from_numpy(c) for c in _codes(9)]
    t = torch.from_numpy
    grads = []
    for flip in (True, False):
        rot = torch.tensor([[0.1, 0.2, 0.3]] * B, requires_grad=True)
        pose = torch.cat([axis_angle_to_matrix(rot), t(raw["obj_pose_gt"][:, :, 3:])], -1)
        out = renderer.render_rays_frustum(
            lambda x, v, z: render.field_composite(wts, x, v, z, *codes), invert_pose(pose),
            t(raw["K"]), t(raw["roi_nerf"].astype(np.float32)),
            t(np.linalg.norm(raw["wlh"], axis=-1).astype(np.float32)), n_samples=S, im_sz=IM,
            shapenet_obj_cood=True, sym_flip=torch.tensor([flip] * B),
            jitter=torch.full((B, S), 0.5))
        grads.append(torch.autograd.grad(out["rgb"].sum(), rot)[0])
    assert all(torch.isfinite(g).all() and g.abs().max() > 0 for g in grads)
    assert not torch.allclose(grads[0], grads[1])
