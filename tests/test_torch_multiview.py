"""The port's multiview TTO (tto/multiview.py) against the JAX package's
run_multiview_tto on the CPU, at the tiny shapes of tests/test_torch_tto.py:
shared codes over 2 views, with and without slack_tex, opt_pose and
opt_model (the decoder through field_composite_train's plain versions), on
the same views, weights and sampling jitter; opt_model's first-update
gradients (codes, poses, every decoder leaf) against jax.grad, for SUP-NeRF
and for the original AutoRF (its decoder through decoder_composite); and
the optimize CLI's --opt_multiview."""
import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401
from supnerf_tpu.data.synthetic import make_object_batch
from supnerf_tpu.geometry import poses as jax_poses
from supnerf_tpu.models import build_model as jax_build_model
from supnerf_tpu.models import init_model_variables
from supnerf_tpu.tto import TTOConfig as JaxTTOConfig
from supnerf_tpu.tto.driver import TTODriver as JaxTTODriver
from supnerf_tpu.tto.multiview import MultiviewBatch as JaxMultiviewBatch
from supnerf_tpu.tto.multiview import run_multiview_tto as jax_run_multiview_tto
from supnerf_tpu.geometry.boxes import invert_pose as jax_invert_pose
from supnerf_tpu.ops.volume_render import occupancy_loss as jax_occ_loss
from supnerf_tpu.ops.volume_render import rgb_loss_masked as jax_rgb_loss
from supnerf_tpu.render.renderer import render_rays_frustum as jax_render_frustum
from supnerf_tpu.tto.core import pose_param_fns as jax_pose_param_fns
from supnerf_tpu_torch.cli import optimize
from supnerf_tpu_torch.models.convert import (convert_autorf_decoder, convert_decoder,
                                               convert_supnerf_variables, convert_variables)
from supnerf_tpu_torch.models.factory import build_model
from supnerf_tpu_torch.ops.render import pack_decoder_params
from supnerf_tpu_torch.tto.core import render_decoder
from supnerf_tpu_torch.tto import core
from supnerf_tpu_torch.tto.multiview import (MultiviewBatch, decoder_copy, multiview_loss,
                                              run_multiview_tto)
from torch_memory import release_memory_after_module  # noqa: F401

TINY_HP = {"shape_blocks": 1, "texture_blocks": 1, "latent_dim": 32,
           "pose_shortcut": 1, "pred_wlh": 0}
V, T = 2, 6
COMMON = dict(num_opts=T, reg_iters=2, n_samples=8, render_im_sz=8, in_img_sz=32, n_lidar=16,
              shapenet_obj_cood=True)
CASES = {"codes": {}, "slack_tex": {"slack_tex": True}, "opt_pose": {"opt_pose": True},
         "opt_model": {"opt_model": True, "opt_pose": True}}
AUTORF_HP = {"shape_blocks": 3, "texture_blocks": 3, "latent_dim": 32}


@pytest.fixture(scope="module")
def tiny():
    jmodel = jax_build_model("supnerf", TINY_HP)
    variables = jax.tree.map(np.asarray, init_model_variables(
        jmodel, jax.random.PRNGKey(0), img_size=32))
    raw, _ = make_object_batch(V, seed=5, in_img_sz=32, render_im_sz=8, n_lidar=16)
    keys = jax.random.split(jax.random.PRNGKey(9), V)
    raw["pose_init"] = np.asarray(jax.vmap(
        lambda k, K, roi: jax_poses.get_random_pose2(k, K, roi.astype(jnp.float32)))(
        keys, jnp.asarray(raw["K"]), jnp.asarray(raw["roi_nerf"])))
    tmodel = build_model("supnerf", TINY_HP)
    tmodel.load_state_dict(convert_supnerf_variables(variables, TINY_HP), strict=True)
    return jmodel, variables, raw, tmodel


@pytest.fixture(scope="module", params=list(CASES))
def runs(request, tiny):
    jmodel, variables, raw, tmodel = tiny
    opts = CASES[request.param]
    key = jax.random.PRNGKey(0)
    fields = [f for f in JaxMultiviewBatch.__dataclass_fields__ if f != "view_valid"]
    jbatch = JaxMultiviewBatch(view_valid=jnp.ones(V), **{k: jnp.asarray(raw[k]) for k in fields})
    jres = jax.tree.map(np.asarray, jax_run_multiview_tto(
        jmodel, variables, jbatch, jnp.zeros(32), jnp.zeros(32),
        JaxTTOConfig(field_impl="flax", **COMMON), key, **opts))
    # the JAX loop's draws: fold_in(fold_in(key, t), v) for view v's render
    jitter = np.asarray([[jax.random.uniform(jax.random.fold_in(jax.random.fold_in(key, t), v),
                                             (8,)) for v in range(V)] for t in range(T)])
    before = {k: v.clone() for k, v in tmodel.state_dict().items()}
    pres = run_multiview_tto(tmodel, pack_decoder_params(tmodel),
                             MultiviewBatch.from_numpy(raw, "cpu"), torch.zeros(32),
                             torch.zeros(32), core.TTOConfig(**COMMON),
                             jitter=torch.from_numpy(jitter), **opts)
    unchanged = all(torch.equal(v, before[k]) for k, v in tmodel.state_dict().items())
    return request.param, jres, {k: v.numpy() for k, v in pres.items()}, unchanged


def test_multiview_matches_jax(runs):
    """Loss and PSNR curves atol/rtol 1e-3 (iteration 0 1e-4) in every case;
    the model given never changes. Where the poses stay (no opt_pose), the
    saved codes, final codes and poses atol 1e-3 too. With opt_pose the
    trajectories cross a gradient discontinuity (a ReLU gate or mask edge
    that float32 rounding puts on either side): perturbing the port's
    parameters after step 1 by 1e-7 of their size moves view 0's y
    translation gradient at step 2 from 3.7e-5 to 2.7e-4, and JAX's own run
    takes 4.8e-5; so there the curves carry the comparison, and opt_model's
    decoder update is held by test_opt_model_first_update_gradients_match."""
    name, jres, pres, unchanged = runs
    assert unchanged, name
    for curve in ("loss", "psnr"):
        np.testing.assert_allclose(pres[curve][0], jres[curve][0], atol=1e-4, rtol=1e-4,
                                   err_msg=f"{name} {curve}")
        np.testing.assert_allclose(pres[curve], jres[curve], atol=1e-3, rtol=1e-3,
                                   err_msg=f"{name} {curve}")
    assert pres["shapecodes_saved"].shape == (6, 32)
    assert not np.array_equal(pres["final_shapecode"], pres["shapecodes_saved"][0])
    if not CASES[name].get("opt_pose"):
        for key in ("shapecodes_saved", "texturecodes_saved", "final_shapecode",
                    "final_texturecode"):
            np.testing.assert_allclose(pres[key], jres[key], atol=1e-3, err_msg=f"{name} {key}")
        np.testing.assert_allclose(pres["final_poses"], jres["final_poses"], atol=1e-6)


def _check_first_update(jmodel, variables, raw, tmodel, jres, dec_names):
    """The first-update gradient check of opt_model (see
    test_opt_model_first_update_gradients_match) for the model pair; the
    JAX decoder gradients become the port's leaves through dec_names."""
    key = jax.random.PRNGKey(0)
    to_params, from_params = jax_pose_param_fns(JaxTTOConfig(**COMMON))
    rot0, trans0 = jax.vmap(to_params)(jnp.asarray(raw["pose_init"]))
    start = [np.asarray(a) for a in (jres["shapecodes_saved"][0], jres["texturecodes_saved"][0],
                                     rot0, trans0)]
    diag = np.linalg.norm(raw["wlh"], axis=-1)

    def jloss(sc, tc, rot, trans, decoder):
        field_vars = dict(variables, params=dict(variables["params"], decoder=decoder))
        total = 0.0
        for v in range(V):
            out = jax_render_frustum(
                lambda x, d: jmodel.apply(field_vars, x, d, sc, tc),
                jax.random.fold_in(jax.random.fold_in(key, 0), v),
                jax_invert_pose(from_params(rot[v], trans[v])), raw["K"][v],
                raw["roi_nerf"][v].astype(np.float32), diag[v], n_samples=8, im_sz=8,
                shapenet_obj_cood=True)
            total = total + (jax_rgb_loss(out["rgb"], raw["rgb_tgt"][v], raw["occ_tgt"][v])
                             + 0.1 * jax_occ_loss(out["acc_trans"], raw["occ_tgt"][v]))
        return total / V

    jl, jgrads = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2, 3, 4)))(
        *start, variables["params"]["decoder"])
    dec_ref = dec_names(jgrads[4])
    names = [n for n, _ in decoder_copy(tmodel).named_parameters()]
    ref = [np.asarray(g) for g in jgrads[:4]] + [dec_ref[n].numpy() for n in names]
    jitter0 = torch.from_numpy(np.asarray([jax.random.uniform(
        jax.random.fold_in(jax.random.fold_in(key, 0), v), (8,)) for v in range(V)]))
    cfg, batch = core.TTOConfig(**COMMON), MultiviewBatch.from_numpy(raw, "cpu")
    wts = render_decoder(tmodel)

    def port_grads(seed=None):
        dec = decoder_copy(tmodel)
        params = [torch.from_numpy(a.copy()) for a in start] + list(dec.parameters())
        if seed is not None:
            gen = torch.Generator().manual_seed(seed)
            with torch.no_grad():
                for p in params:
                    p.add_(1e-7 * p.abs().clamp(min=1e-3) * torch.randn(p.shape, generator=gen))
        params = [p.requires_grad_(True) for p in params]
        loss, _ = multiview_loss(wts, params[0], params[1],
                                 core.pose_param_fns(cfg)[1](params[2], params[3]), batch, cfg,
                                 dec=dec, jitter=jitter0)
        return loss.detach(), [g.numpy() for g in torch.autograd.grad(loss, params)]

    def close(a, b):
        return np.allclose(a, b, atol=2e-4, rtol=2e-4)

    loss, grads = port_grads()
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    assert len(grads) == len(ref) == 4 + len(names)
    nearby = None
    for i, (name, g, r) in enumerate(zip(["shapecode", "texturecode", "rot", "trans"] + names,
                                         grads, ref)):
        assert g.shape == r.shape, name
        if close(g, r):
            continue
        nearby = nearby or [port_grads(seed)[1] for seed in range(4)]
        sides = [n[i] for n in nearby]
        assert any(not close(s, g) for s in sides), f"{name}: {g} {r}"
        assert any(close(s, r) for s in sides), f"{name}: {sides} {r}"
    return names


@pytest.mark.parametrize("runs", ["opt_model"], indirect=True)
def test_opt_model_first_update_gradients_match(tiny, runs):
    """opt_model's first update (iteration 0) at the same parameters: the
    gradients of the port's multiview_loss for the codes, the per-view
    poses and every leaf of the decoder copy (K3's data mode and K4 on the
    card, their plain versions here) against jax.grad of the JAX loop's
    loss with the decoder as a parameter; atol 2e-4. A gradient that misses
    sits at a kink: the port's own gradient at four points 1e-7 of the
    parameters' size away must move by more than the tolerance, and one of
    them must be JAX's (tests/test_torch_tto_options.py's rule)."""
    jmodel, variables, raw, tmodel = tiny
    _, jres, *_ = runs
    names = _check_first_update(
        jmodel, variables, raw, tmodel, jres,
        lambda g: convert_decoder(g, TINY_HP["shape_blocks"], TINY_HP["texture_blocks"]))
    assert len(names) == 20     # the decoder's 20 leaves


def test_opt_model_on_the_original_autorf(tiny):
    """opt_model on the original AutoRF, whose decoder no kernel takes: the
    port's run (its decoder copy through decoder_composite under autograd)
    against JAX's flax path on the same views and jitter: loss and PSNR
    curves as test_multiview_matches_jax, the model given unchanged, and
    the first update's gradients (codes, poses, the decoder's 14 leaves)
    as test_opt_model_first_update_gradients_match."""
    _, _, raw, _ = tiny
    jmodel = jax_build_model("autorf_original", AUTORF_HP)
    variables = jax.tree.map(np.asarray, init_model_variables(
        jmodel, jax.random.PRNGKey(0), img_size=32))
    tmodel = build_model("autorf_original", AUTORF_HP)
    tmodel.load_state_dict(convert_variables("autorf_original", variables, AUTORF_HP),
                           strict=True)
    key = jax.random.PRNGKey(0)
    fields = [f for f in JaxMultiviewBatch.__dataclass_fields__ if f != "view_valid"]
    jbatch = JaxMultiviewBatch(view_valid=jnp.ones(V), **{k: jnp.asarray(raw[k]) for k in fields})
    opts = CASES["opt_model"]
    jres = jax.tree.map(np.asarray, jax_run_multiview_tto(
        jmodel, variables, jbatch, jnp.zeros(32), jnp.zeros(32),
        JaxTTOConfig(field_impl="flax", **COMMON), key, **opts))
    jitter = np.asarray([[jax.random.uniform(jax.random.fold_in(jax.random.fold_in(key, t), v),
                                             (8,)) for v in range(V)] for t in range(T)])
    before = {k: v.clone() for k, v in tmodel.state_dict().items()}
    pres = run_multiview_tto(tmodel, render_decoder(tmodel),
                             MultiviewBatch.from_numpy(raw, "cpu"), torch.zeros(32),
                             torch.zeros(32), core.TTOConfig(**COMMON),
                             jitter=torch.from_numpy(jitter), **opts)
    assert all(torch.equal(v, before[k]) for k, v in tmodel.state_dict().items())
    for curve in ("loss", "psnr"):
        got = pres[curve].numpy()
        np.testing.assert_allclose(got[0], jres[curve][0], atol=1e-4, rtol=1e-4, err_msg=curve)
        np.testing.assert_allclose(got, jres[curve], atol=1e-3, rtol=1e-3, err_msg=curve)
    assert float(pres["loss"][-1]) < float(pres["loss"][0])
    names = _check_first_update(
        jmodel, variables, raw, tmodel, jres,
        lambda g: convert_autorf_decoder(g, AUTORF_HP["shape_blocks"],
                                         AUTORF_HP["texture_blocks"]))
    assert len(names) == 14


def test_cli_opt_multiview(tmp_path):
    """--opt_multiview 1: the instances' shared codes stored flat per
    instance (code_level 0) in codes_multiview.pkl with the JAX driver's
    result keys; the folder name carries _multiview."""
    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps({"arch": "supnerf", "net_hyperparams": TINY_HP,
                               "render_im_sz": 8, "n_samples": 8, "in_img_sz": 32,
                               "optimize": {"num_opts": 6},
                               "model_dir": str(tmp_path / "no_checkpoint")}))
    summary = optimize.main(["--config_file", str(cfg), "--dataset", "synthetic",
                             "--num_objects", "4", "--device", "cpu", "--opt_multiview", "1",
                             "--opt_pose", "0"])
    assert "_multiview_opt_pose_0" in summary["save_dir"]
    with open(f"{summary['save_dir']}/codes_multiview.pkl", "rb") as f:
        res = pickle.load(f)
    stub = type("Stub", (), {"code_level": 0, **{k: {} for k in (
        "psnr_eval", "ssim_eval", "optimized_shapecodes", "optimized_texturecodes",
        "optimized_poses", "R_eval", "T_eval", "depth_err_mean", "lidar_pts_cnt",
        "ood_flags")}})()
    assert set(res) == set(JaxTTODriver.results_dict(stub))
    assert res["code_level"] == 0 and res["num_obj"] == 2
    assert set(res["optimized_shapecodes"]) == {"ins_0", "ins_1"}
    assert res["optimized_texturecodes"]["ins_1"].shape == (6, 32)
    assert all(len(v) == 6 and np.isfinite(v).all() for v in res["psnr_eval"].values())
    assert summary["aggregate"] is None and summary["multiview"]["num_obj"] == 2


def test_decoder_copy_routes_on_kernel_compatibility():
    """opt_model's decoder copy: a CodeNeRFDecoder for a model the kernels
    take, rendered through field_composite_train; an AutoRFDecoder for the
    original AutoRF, through decoder_composite; a CodeNeRF-style decoder
    the kernels refuse (no texture block) raises ValueError naming the
    gate, before any render."""
    from supnerf_tpu_torch.models.nerf_mlp import AutoRFDecoder, CodeNeRFDecoder
    from supnerf_tpu_torch.ops.render import decoder_kernel_compatible

    for arch, hp, kind in (("supnerf", TINY_HP, CodeNeRFDecoder),
                           ("autorf_original", AUTORF_HP, AutoRFDecoder)):
        model = build_model(arch, hp)
        dec = decoder_copy(model)
        assert type(dec) is kind, arch
        assert decoder_kernel_compatible(dec) == (kind is CodeNeRFDecoder), arch
        own = model.state_dict()
        assert all(torch.equal(v, own[k]) for k, v in dec.state_dict().items()), arch
    with pytest.raises(ValueError, match="decoder_kernel_compatible"):
        decoder_copy(CodeNeRFDecoder(1, 0, 16, 8))
