"""The port's baseline architectures (AutoRFMix for "autorf"/"autorfmix", the
original AutoRF, CodeNeRF) against the JAX package on the CPU, at the tiny
sizes of tests/test_tto_baselines.py (latent 32): the factory, the
converter (models/convert.py) against torch_import.export_state_dict, the
two-head encoder and the decoders against the flax modules on the same
weights, the kernel gate (ops.render.decoder_kernel_compatible) against
pallas_field.decoder_kernel_compatible, and run_tto_batch against the JAX
run_tto_batch on its flax path with the same batch, weights and jitter.

Tolerances: the converted weights bit for bit; encoder codes 1e-4 and field
outputs 1e-5 (tests/test_torch_tto.py's); TTO curves 1e-4 over the replay
iterations and 1e-3 once AdamW steps, saved codes and poses 1e-3 (also
tests/test_torch_tto.py's, for the reason given there)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_threads  # noqa: F401
from supnerf_tpu.data.synthetic import make_object_batch
from supnerf_tpu.geometry import poses as jax_poses
from supnerf_tpu.models import build_model as jax_build_model
from supnerf_tpu.models import init_model_variables
from supnerf_tpu.models.torch_import import export_state_dict
from supnerf_tpu.ops.pallas_field import decoder_kernel_compatible as jax_kernel_compatible
from supnerf_tpu.tto import ObjectBatch as JaxBatch
from supnerf_tpu.tto import TTOConfig as JaxTTOConfig
from supnerf_tpu.tto import run_tto_batch as jax_run_tto_batch
from supnerf_tpu_torch.models.convert import convert_variables
from supnerf_tpu_torch.models.factory import build_model
from supnerf_tpu_torch.ops import render
from supnerf_tpu_torch.tto import core
from torch_memory import release_memory_after_module  # noqa: F401

HP = {"autorf": {"shape_blocks": 2, "texture_blocks": 1, "latent_dim": 32},
      "autorf_original": {"shape_blocks": 3, "texture_blocks": 3, "latent_dim": 32},
      "codenerf": {"shape_blocks": 2, "texture_blocks": 1, "latent_dim": 32}}
REG, T, B = 2, 6, 2     # tests/test_tto_baselines.py's CFG: reg_iters 2, 6 iterations
JAX_CFG = JaxTTOConfig(num_opts=T, reg_iters=REG, n_samples=8, render_im_sz=8, in_img_sz=32,
                       n_lidar=16, field_impl="flax")
PORT_CFG = core.TTOConfig(num_opts=T, reg_iters=REG, n_samples=8, render_im_sz=8, in_img_sz=32,
                          n_lidar=16)


@pytest.fixture(scope="module")
def models():
    """Per arch: the JAX model, its variables (numpy leaves) and the port's
    model strict-loaded with the converted variables."""
    out = {}
    for arch, hp in HP.items():
        jmodel = jax_build_model(arch, hp)
        variables = jax.tree.map(np.asarray, init_model_variables(
            jmodel, jax.random.PRNGKey(0), img_size=32))
        tmodel = build_model(arch, hp)
        tmodel.load_state_dict(convert_variables(arch, variables, hp), strict=True)
        out[arch] = (jmodel, variables, tmodel)
    return out


@pytest.mark.parametrize("arch", ["supnerf", "autorf", "autorfmix", "autorf_original",
                                  "codenerf"])
@pytest.mark.parametrize("hp", [{}, {"shape_blocks": 2, "texture_blocks": 3, "latent_dim": 64}],
                         ids=["defaults", "given"])
def test_factory_matches_jax(arch, hp):
    """The JAX factory's class, name mapping (autorf -> AutoRFMix) and
    defaults: block counts, widths and encodings."""
    jm, tm = jax_build_model(arch, hp), build_model(arch, hp)
    assert type(tm).__name__ == type(jm).__name__
    for name in ("shape_blocks", "texture_blocks", "latent_dim", "num_xyz_freq", "num_dir_freq"):
        assert getattr(tm, name) == getattr(jm, name), name
    if arch == "codenerf":
        assert tm.encoding_xyz[0].out_features == jm.W
    assert hasattr(tm, "encode_img") == hasattr(type(jm), "encode_img")
    assert hasattr(tm, "pose_update") == hasattr(type(jm), "pose_update")


def test_factory_refuses_instancenorm_encoders():
    """Once refused, InstanceNorm2d encoders now build for every arch with
    an encoder, as the JAX factory: every norm an InstanceNorm, no norm
    entry in the state_dict, which the converted JAX variables fill
    exactly (a strict load); net_hyperparams' field_dtype sets SUPNeRF's
    field precision and the baselines ignore it, as in the JAX factory
    (ROADMAP C.28)."""
    from supnerf_tpu_torch.models.layers import BatchStatNorm2d, InstanceNorm2d

    for arch in ("supnerf", "autorfmix", "autorf_original"):
        hp = dict(HP.get(arch, {"shape_blocks": 1, "texture_blocks": 1, "latent_dim": 32}),
                  norm_layer_type="InstanceNorm2d")
        model = build_model(arch, hp)
        norms = [m for m in model.modules() if isinstance(m, (BatchStatNorm2d, InstanceNorm2d))]
        assert norms and all(isinstance(m, InstanceNorm2d) for m in norms), arch
        assert not any(".bn" in k or "downsample.1" in k for k in model.state_dict()), arch
        jmodel = jax_build_model(arch, hp)
        variables = jax.tree.map(np.asarray, init_model_variables(
            jmodel, jax.random.PRNGKey(0), img_size=32))
        assert "batch_stats" not in variables
        model.load_state_dict(convert_variables(arch, variables, hp), strict=True)
    with pytest.raises(ValueError, match="norm_layer_type"):
        build_model("supnerf", {"norm_layer_type": "GroupNorm"})
    # field_dtype as the JAX factory takes it: SUPNeRF's field precision, a
    # key the baselines ignore; an unknown value raises (JAX: KeyError)
    assert build_model("supnerf", {"field_dtype": "bfloat16"}).field_dtype == "bfloat16"
    for value in ("float32", None):
        assert build_model("supnerf", {"field_dtype": value}).field_dtype == "float32"
    assert build_model("autorfmix", {"field_dtype": "bfloat16"}).field_dtype == "float32"
    assert not hasattr(build_model("autorf_original", {"field_dtype": "bfloat16"}),
                       "field_dtype")
    with pytest.raises(ValueError, match="float16"):
        build_model("supnerf", {"field_dtype": "float16"})


@pytest.mark.parametrize("arch", list(HP))
def test_converter_matches_export_state_dict(models, arch):
    """convert_variables gives export_state_dict's keys and values, which are
    the port model's state_dict keys (a strict load)."""
    jmodel, variables, tmodel = models[arch]
    ours = convert_variables(arch, variables, HP[arch])
    ref = export_state_dict(jmodel, variables)
    assert set(ours) == set(ref) == set(tmodel.state_dict())
    for k, v in ref.items():
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(v), err_msg=k)
    if arch == "codenerf":
        assert not any(k.startswith("img_encoder.") for k in ours)


@pytest.mark.parametrize("arch", ["autorf", "autorf_original"])
def test_two_head_encoder_matches_flax(models, arch):
    """The two-head encoder on per-object batch statistics (one image per
    BatchNorm batch, as TTO encodes), on two images; shape and texture
    codes only. (Across a batch of images at this 32-pixel size the last
    stage's 1 x 1 maps normalise each channel over a few values, which
    turns float32 noise into differences of order 1: test_torch_train_step.py
    holds batched encoding through the losses instead.)"""
    jmodel, variables, tmodel = models[arch]
    img = make_object_batch(2, seed=21, in_img_sz=32, render_im_sz=8, n_lidar=16)[0]["img_in"]
    assert tmodel.img_encoder.heads == ("shape", "texture")
    for x in (img[:1], img[1:]):
        ref, _ = jmodel.apply(variables, jnp.asarray(x), True, method=type(jmodel).encode_img,
                              mutable=["batch_stats"])
        with torch.no_grad():
            ours = tmodel.encode_img(torch.from_numpy(x))
        assert len(ours) == len(ref) == 2
        for name, a, b in zip(("shape", "texture"), ours, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=1e-4,
                                       err_msg=f"{name}, batch of {len(x)}")


@pytest.mark.parametrize("arch", list(HP))
def test_decoder_matches_flax(models, arch):
    """The field (CodeNeRF-style for AutoRFMix and CodeNeRF, the
    feature-averaging AutoRFDecoder for the original AutoRF) on the same
    points, directions and codes; per-object codes broadcast as the renders
    give them (ops.render.decoder_field)."""
    jmodel, variables, tmodel = models[arch]
    rng = np.random.default_rng(1)
    xyz = (rng.normal(size=(2, 4, 6, 3)) * 0.4).astype(np.float32)
    vd = rng.normal(size=(2, 4, 6, 3)).astype(np.float32)
    sc, tc = (rng.normal(size=(2, 2, 32)) * 0.3).astype(np.float32)
    sig_r, rgb_r = jmodel.apply(variables, *map(jnp.asarray, (xyz, vd, sc[:, None, None],
                                                             tc[:, None, None])))
    with torch.no_grad():
        sig, rgb = render.decoder_field(tmodel, *map(torch.from_numpy, (xyz, vd, sc, tc)))
    np.testing.assert_allclose(sig.numpy(), np.asarray(sig_r), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(rgb_r), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("arch", ["supnerf"] + list(HP))
def test_kernel_gate_matches_jax(models, arch):
    """decoder_kernel_compatible equals JAX's on every arch: the original
    AutoRF alone has no kernel, and pack_decoder_params and the training
    render refuse it with that reason."""
    if arch == "supnerf":
        hp = {"shape_blocks": 1, "texture_blocks": 1, "latent_dim": 32}
        jmodel = jax_build_model(arch, hp)
        variables = init_model_variables(jmodel, jax.random.PRNGKey(0), img_size=32)
        tmodel = build_model(arch, hp)
    else:
        jmodel, variables, tmodel = models[arch]
    want = jax_kernel_compatible(jmodel, variables)
    assert render.decoder_kernel_compatible(tmodel) == want == (arch != "autorf_original")
    if want:
        assert isinstance(core.render_decoder(tmodel), render.DecoderWeights)
        return
    assert core.render_decoder(tmodel) is tmodel
    with pytest.raises(ValueError, match="no render kernel"):
        render.pack_decoder_params(tmodel)
    z = torch.zeros(1, 8)
    with pytest.raises(ValueError, match="no render kernel"):
        render.field_composite_train(tmodel, torch.zeros(1, 4, 8, 3), torch.ones(1, 4, 3), z,
                                     torch.zeros(1, 32), torch.zeros(1, 32))


@pytest.fixture(scope="module", params=list(HP))
def both_runs(request, models):
    """run_tto_batch of one arch in both packages on make_object_batch(seed=21)
    with random initial poses and nonzero mean codes, the port given the JAX
    loop's jitter."""
    arch = request.param
    jmodel, variables, tmodel = models[arch]
    raw, _ = make_object_batch(B, seed=21, in_img_sz=32, render_im_sz=8, n_lidar=16)
    keys = jax.random.split(jax.random.PRNGKey(7), B)
    raw["pose_init"] = np.asarray(jax.vmap(
        lambda k, K, roi: jax_poses.get_random_pose2(k, K, roi.astype(jnp.float32)))(
        keys, jnp.asarray(raw["K"]), jnp.asarray(raw["roi_nerf"])))
    mean = (np.random.default_rng(5).normal(size=(2, 32)) * 0.1).astype(np.float32)
    key = jax.random.PRNGKey(0)
    jres = jax.tree.map(np.asarray, jax_run_tto_batch(
        jmodel, variables, JaxBatch(**{k: jnp.asarray(v) for k, v in raw.items()}),
        jnp.asarray(mean[0]), jnp.asarray(mean[1]), JAX_CFG, key))
    obj_keys = jax.random.split(key, B)
    it_keys = [[jax.random.fold_in(obj_keys[b], t) for b in range(B)] for t in range(T)]
    jit_loss = np.asarray([[jax.random.uniform(k, (8,)) for k in row] for row in it_keys])
    jit_depth = np.asarray([[jax.random.uniform(jax.random.fold_in(k, 1), (8,)) for k in row]
                            for row in it_keys])
    batch = core.ObjectBatch.from_numpy(raw, "cpu")
    pres = core.run_tto_batch(tmodel, core.render_decoder(tmodel), batch,
                              torch.from_numpy(mean[0]), torch.from_numpy(mean[1]), PORT_CFG,
                              jitter=(torch.from_numpy(jit_loss), torch.from_numpy(jit_depth)))
    return arch, raw, mean, jres, {k: v.detach().numpy() for k, v in pres.items()}


def test_tto_curves_match(both_runs):
    arch, _, _, jres, pres = both_runs
    for curve in ("loss", "psnr", "rot_err", "trans_err", "depth_err"):
        np.testing.assert_allclose(pres[curve][:, :REG + 1], jres[curve][:, :REG + 1],
                                   atol=1e-4, rtol=1e-4, err_msg=f"{arch}: {curve}")
        np.testing.assert_allclose(pres[curve], jres[curve], atol=1e-3, rtol=1e-3,
                                   err_msg=f"{arch}: {curve}")


def test_tto_start_and_trajectory(both_runs):
    """No refiner: the trajectory is pose_init, reg_iters + 1 times, and the
    replay iterations render it (constant pose errors). CodeNeRF has no
    encoder: its snapshot at iteration 0 is the mean code."""
    arch, raw, mean, jres, pres = both_runs
    assert pres["pose_traj"].shape == jres["pose_traj"].shape == (B, REG + 1, 3, 4)
    np.testing.assert_array_equal(pres["pose_traj"],
                                  np.broadcast_to(raw["pose_init"][:, None], (B, REG + 1, 3, 4)))
    np.testing.assert_allclose(jres["pose_traj"], pres["pose_traj"], atol=1e-6)
    for curve in ("rot_err", "trans_err"):
        np.testing.assert_array_equal(pres[curve][:, :REG + 1],
                                      np.repeat(pres[curve][:, :1], REG + 1, 1))
    np.testing.assert_allclose(pres["shapecodes_saved"][:, 0], jres["shapecodes_saved"][:, 0],
                               atol=1e-4, rtol=1e-4)
    if arch == "codenerf":
        np.testing.assert_array_equal(pres["shapecodes_saved"][:, 0],
                                      np.broadcast_to(mean[0], (B, 32)))
        np.testing.assert_array_equal(pres["texturecodes_saved"][:, 0],
                                      np.broadcast_to(mean[1], (B, 32)))
    np.testing.assert_array_equal(pres["uv_direct"], np.zeros((B, 16)))


def test_tto_snapshots_and_final_pose(both_runs):
    arch, _, _, jres, pres = both_runs
    assert pres["shapecodes_saved"].shape == jres["shapecodes_saved"].shape == (B, 6, 32)
    np.testing.assert_allclose(pres["poses_saved"][:, 0], jres["poses_saved"][:, 0], atol=1e-4)
    np.testing.assert_allclose(pres["final_pose"], jres["final_pose"], atol=1e-3,
                               err_msg=arch)
    for k in ("final_shapecode", "final_texturecode"):
        np.testing.assert_allclose(pres[k], jres[k], atol=1e-3, err_msg=f"{arch}: {k}")
