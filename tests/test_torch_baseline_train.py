"""The port's NeRF-only training of the baselines (AutoRFMix, CodeNeRF)
against the JAX package on the CPU at tiny sizes (latent 32), and the
baseline configs through the port's CLIs: one train step of each against
make_train_step(loss_mode="nerf_only") on its flax path, the port's step
starting from the JAX TrainState before it (models/convert
.convert_train_state), on the same batch with a duplicate instance; the
trainer's loss modes; cli.optimize and cli.train with "arch": "autorfmix"
and "codenerf" writing the JAX result and checkpoint schemas, their
checkpoints strict-loaded back; the results folder's name against JAX's.

Tolerances, as tests/test_torch_train_step.py states them: losses rtol
1e-4; parameters and code tables rtol 5e-3 / atol 3e-4; each tensor's mean
update rtol 1e-2; the first moments (0.1 x the gradient after one step) to
1e-2 of each tensor's largest value (the ResNet trunk's, float32 noise of
BatchNorm over a batch's 1 x 1 maps, not compared); BatchNorm running
statistics rtol 1e-5 with a 5e-5 floor; optimized_idx and the counts
exactly."""
import copy
import json
import os
import pickle
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from supnerf_tpu.cli.optimize import _auto_save_postfix as jax_auto_save_postfix
from supnerf_tpu.data.synthetic import make_synthetic_object
from supnerf_tpu.models import build_model as jax_build_model
from supnerf_tpu.models.initialization import make_init_fn
from supnerf_tpu.training import TrainBatch as JaxBatch
from supnerf_tpu.training import TrainConfig as JaxConfig
from supnerf_tpu.training import init_train_state as jax_init_state
from supnerf_tpu.training import make_train_step
from supnerf_tpu.training.checkpoints import export_reference_checkpoint
from supnerf_tpu.training.ray_prep import prepare_train_sample as jax_prepare
from supnerf_tpu.tto.driver import TTODriver as JaxTTODriver
from supnerf_tpu_torch.cli import optimize, train
from supnerf_tpu_torch.cli.common import load_model_and_codes
from supnerf_tpu_torch.config import load_hpams
from supnerf_tpu_torch.models.convert import convert_train_state
from supnerf_tpu_torch.models.factory import build_model
from supnerf_tpu_torch.training import train_step as port
from supnerf_tpu_torch.training.trainer import UnifiedTrainer
from torch_memory import release_memory_after_module  # noqa: F401

HP = {"autorfmix": {"shape_blocks": 2, "texture_blocks": 1, "latent_dim": 32},
      "codenerf": {"shape_blocks": 2, "texture_blocks": 1, "latent_dim": 32}}
CODE_IDX = (0, 1, 0, 2)        # instance 0 twice: its row gradients add up
PORT_CFG = port.TrainConfig(latent_dim=32, lr_interval_model=1, lr_interval_codes=1)
LOSSES = ("loss_total", "loss_rgb", "loss_occ", "psnr", "loss_reg", "loss_code")


def _arrays():
    """The batch: synthetic objects through the JAX prep (compact rays); the
    refiner's fields, which the NeRF-only loss does not read, at ground
    truth."""
    rng = np.random.default_rng(0)
    rows = []
    for i, idx in enumerate(CODE_IDX):
        s = make_synthetic_object(seed=20 + i)
        rows.append(jax_prepare(s, n_rays=32, n_samples=8, in_img_sz=32, rng=rng,
                                src_pose=np.asarray(s["obj_poses"], np.float32), code_idx=idx,
                                compact_rays=True, tgt_uv=np.zeros((2, 8), np.float32)))
    return {k: np.stack([r[k] for r in rows]) for k in rows[0]}


@pytest.fixture(scope="module", params=list(HP))
def step(request):
    """One JAX nerf_only step from its initial state and the port's step from
    the converted initial state; both states after it in the port's types."""
    arch = request.param
    hpams = {"arch": arch, "net_hyperparams": HP[arch]}
    jmodel = jax_build_model(arch, HP[arch])
    jcfg = JaxConfig(latent_dim=32, im_enc_rate=1.0, lr_interval_model=1, lr_interval_codes=1,
                     field_impl="flax")
    state = jax.tree.map(np.asarray, jax_init_state(jmodel, jax.random.PRNGKey(0), n_instances=3,
                                                    cfg=jcfg, img_size=32))
    arrays = _arrays()
    after, jm = make_train_step(jmodel, jcfg, donate=False, loss_mode="nerf_only")(
        state, JaxBatch(**{k: jnp.asarray(v) for k, v in arrays.items()}), jax.random.PRNGKey(0))
    before = convert_train_state(state, hpams, cfg=PORT_CFG)
    ours = copy.deepcopy(before)
    pm = port.train_step(ours, port.TrainBatch.from_numpy(arrays, "cpu"), PORT_CFG,
                         loss_mode="nerf_only")
    return (arch, before, ours, convert_train_state(jax.tree.map(np.asarray, after), hpams,
                                                   cfg=PORT_CFG),
            pm, jax.device_get(jm))


def test_nerf_only_metrics_match_jax(step):
    """The metric names are JAX's (sorted, no pose terms), the losses its
    values; CodeNeRF, with no encoder, has loss_code 0."""
    arch, _, _, _, pm, jm = step
    assert list(pm) == sorted(jm) == list(port.METRIC_NAMES["nerf_only"])
    for k in LOSSES:
        np.testing.assert_allclose(pm[k], float(jm[k]), rtol=1e-4, err_msg=f"{arch}: {k}")
    assert pm["enc_active"] == float(jm["enc_active"]) == 1.0
    if arch == "codenerf":
        assert pm["loss_code"] == 0.0


def test_nerf_only_step_matches_jax(step):
    """Parameters, BatchNorm buffers, code tables, first moments,
    optimized_idx and counts after the step."""
    arch, before, p, j, _, _ = step
    ours, ref, start = (s.model.state_dict() for s in (p, j, before))
    assert set(ours) == set(ref)
    for k, v in ref.items():
        if k.endswith("num_batches_tracked"):
            assert int(ours[k]) == 1, k
            continue
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(ours[k], v, rtol=1e-5, atol=5e-5, err_msg=f"{arch}: {k}")
            continue
        np.testing.assert_allclose(ours[k], v, rtol=5e-3, atol=3e-4, err_msg=f"{arch}: {k}")
        np.testing.assert_allclose((ours[k] - start[k]).abs().mean(), (v - start[k]).abs().mean(),
                                   rtol=1e-2, err_msg=f"{arch}: mean update of {k}")
    for got, want, first in ((p.shape_codes, j.shape_codes, before.shape_codes),
                             (p.texture_codes, j.texture_codes, before.texture_codes)):
        np.testing.assert_allclose(got, want, rtol=5e-3, atol=3e-4, err_msg=arch)
        np.testing.assert_allclose((got - first).abs().mean(), (want - first).abs().mean(),
                                   rtol=1e-2, err_msg=f"{arch}: mean update of a table")
    names = [n for n, _ in p.model.named_parameters()] + ["shape_codes", "texture_codes"]
    for name, a, b in zip(names, p.opt_model.m + p.opt_codes.m, j.opt_model.m + j.opt_codes.m):
        if name.startswith("img_encoder.") and not name.startswith("img_encoder.fc_"):
            continue
        err, scale = float((a - b).abs().max()), float(b.abs().max())
        assert err <= 1e-2 * scale, f"{arch}: first moment of {name}: {err:.3e} of {scale:.3e}"
    assert p.opt_model.count == j.opt_model.count == p.opt_codes.count == 1
    np.testing.assert_array_equal(p.optimized_idx, j.optimized_idx)
    np.testing.assert_array_equal(p.optimized_idx, [1.0, 1.0, 1.0])
    assert p.niter == j.niter == 1


def test_trainer_refuses_a_loss_mode_for_the_wrong_arch(tmp_path):
    """The unified loss trains the refiner of SUP-NeRF; the NeRF-only loss
    the baselines, which have none."""
    hp = {"shape_blocks": 1, "texture_blocks": 1, "latent_dim": 32}
    for arch, mode in (("supnerf", "nerf_only"), ("autorfmix", "unified"),
                       ("codenerf", "unified"), ("codenerf", "joint")):
        with pytest.raises(ValueError, match="loss_mode"):
            UnifiedTrainer(build_model(arch, hp), {"arch": arch, "net_hyperparams": hp}, [],
                           str(tmp_path / "run"), device="cpu", loss_mode=mode)


# --------------------------------------------------------------------------
# the baseline configs through the CLIs
# --------------------------------------------------------------------------

TINY = {"render_im_sz": 8, "n_samples": 8, "n_rays": 32, "in_img_sz": 32,
        "optimize": {"num_opts": 6}}


def _jax_result_keys():
    stub = types.SimpleNamespace(code_level=None, **{k: {} for k in (
        "psnr_eval", "ssim_eval", "optimized_shapecodes", "optimized_texturecodes",
        "optimized_poses", "R_eval", "T_eval", "depth_err_mean", "lidar_pts_cnt", "ood_flags")})
    return set(JaxTTODriver.results_dict(stub))


@pytest.fixture(scope="module", params=list(HP))
def cli_runs(request, tmp_path_factory):
    """Per arch: a tiny config; cli.train on 4 synthetic objects (2
    instances), batch 4, 2 epochs; then cli.optimize on 2 objects from that
    run's models.pth."""
    arch = request.param
    d = tmp_path_factory.mktemp(arch)
    cfg = d / "tiny.json"
    cfg.write_text(json.dumps(dict(TINY, arch=arch, net_hyperparams=HP[arch],
                                   model_dir=str(d / "run"))))
    trained = train.main(["--config_file", str(cfg), "--dataset", "synthetic", "--num_objects",
                          "4", "--batch_size", "4", "--epochs", "2", "--device", "cpu",
                          "--save_dir", str(d / "run"), "--check_iter", "1"])
    tto = optimize.main(["--config_file", str(cfg), "--dataset", "synthetic", "--num_objects",
                         "2", "--batch_size", "2", "--device", "cpu", "--save_dir",
                         str(d / "tto")])
    return arch, cfg, d, trained, tto


def test_cli_train_writes_the_reference_schema(cli_runs, tmp_path):
    """Two NeRF-only steps with finite losses and the nerf_only metrics;
    epoch_1.pth holds exactly the keys, model_params names and shapes that
    the JAX package's export_reference_checkpoint writes for the arch (no
    encoder keys for CodeNeRF); load_model_and_codes strict-loads it."""
    arch, cfg, d, trained, _ = cli_runs
    assert trained["steps"] == 2
    for m in trained["metrics"]:
        assert set(port.METRIC_NAMES["nerf_only"]) <= set(m)
        assert "loss_pose_direct" not in m
        assert all(np.isfinite(m[k]) for k in LOSSES)
    jmodel = jax_build_model(arch, HP[arch])
    shapes = jax.eval_shape(lambda k: jmodel.init(k, method=make_init_fn(jmodel, 32)),
                            jax.random.PRNGKey(0))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    state = types.SimpleNamespace(params=zeros["params"], batch_stats=zeros.get("batch_stats", {}),
                                  shape_codes=np.zeros((2, 32), np.float32),
                                  texture_codes=np.zeros((2, 32), np.float32), niter=0,
                                  optimized_idx=np.zeros(2, np.float32))
    export_reference_checkpoint(jmodel, state, {"ins_0": 0, "ins_1": 1}, str(tmp_path / "ref.pth"))
    ref = torch.load(tmp_path / "ref.pth", weights_only=False)
    ours = torch.load(d / "run" / "epoch_1.pth", weights_only=False)
    assert set(ours) == set(ref)
    assert {k: tuple(v.shape) for k, v in ours["model_params"].items()} == \
        {k: tuple(v.shape) for k, v in ref["model_params"].items()}
    assert any(k.startswith("img_encoder.") for k in ours["model_params"]) == (arch != "codenerf")
    assert ours["optimized_idx"].tolist() == [1.0, 1.0]
    model, mean_shape, _ = load_model_and_codes(load_hpams(str(cfg)), "cpu", model_epoch=1)
    for k, v in model.state_dict().items():
        assert torch.equal(v, ours["model_params"][k]), k
    assert torch.allclose(torch.from_numpy(mean_shape), ours["shape_code_params"]["weight"].mean(0))


def test_cli_optimize_writes_the_jax_schema(cli_runs):
    """TTO of the trained checkpoint through the optimize CLI: the JAX
    driver's result keys, finite curves of num_opts entries, the cross-view
    evaluation."""
    arch, _, d, _, tto = cli_runs
    with open(d / "tto" / "codes+poses.pkl", "rb") as f:
        res = pickle.load(f)
    assert set(res) == _jax_result_keys()
    assert res["num_obj"] == 2
    assert res["optimized_shapecodes"]["ann_0"]["CAM_FRONT"].shape == (6, 32)
    assert all(len(v) == 6 and np.isfinite(v).all() for v in res["psnr_eval"].values())
    # no refiner: the replayed iterations 0..reg_iters render pose_init
    assert all(len(set(v[:4])) == 1 for v in res["R_eval"].values())
    with open(d / "tto" / "cross_eval.pkl", "rb") as f:
        assert pickle.load(f)["psnr_eval_mat_per_ins"]["ins_0"][0].shape == (2, 2)
    assert os.path.exists(d / "tto" / "codes+poses.pth")
    assert {"encode_refine", "tto_loop", "cross_view"} <= set(tto["phase_seconds"])


@pytest.mark.parametrize("arch", ["autorfmix", "autorf_original", "codenerf"])
def test_auto_save_postfix_matches_jax(arch):
    """The baselines' results folder leaves reg_iters out, as JAX's does."""
    hp = {"arch": arch, "net_hyperparams": {}}
    for ds in ("nusc", "kitti", "synthetic"):
        for mode in (0, 1, 2, 3):
            args = types.SimpleNamespace(
                opt_pose=1, add_pose_err=mode, init_rot_err=0.4, init_trans_err=None,
                reg_iters=5, pred_wlh=1, pred_box2d=0, nusc_version=None, num_subset=1,
                id_subset=0, opt_multiview=False)
            ours = optimize._auto_save_postfix(args, hp, ds)
            assert ours == jax_auto_save_postfix(args, hp, ds)
            assert "reg_iters" not in ours
