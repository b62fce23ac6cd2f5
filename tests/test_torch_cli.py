"""The port's optimize and train CLIs end to end on the CPU at a tiny size,
their result files and checkpoints against the JAX package's schemas, the
device rule of their entry points, and the import isolation of the port and
chip_smoke.py."""
import json
import math
import os
import pickle
import subprocess
import sys
import types

import pytest
import torch

import torch_threads  # noqa: F401
from supnerf_tpu.tto.driver import TTODriver as JaxTTODriver
from supnerf_tpu_torch.cli import optimize
from supnerf_tpu_torch.device import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_CONFIG = {
    "arch": "supnerf",
    "net_hyperparams": {"shape_blocks": 1, "texture_blocks": 1, "latent_dim": 32,
                        "pose_shortcut": 1, "pred_wlh": 0},
    "render_im_sz": 8, "n_samples": 8, "in_img_sz": 32, "optimize": {"num_opts": 6},
}


def _jax_result_keys():
    """Keys of the JAX driver's results_dict, read off the method itself."""
    stub = types.SimpleNamespace(code_level=None, **{k: {} for k in (
        "psnr_eval", "ssim_eval", "optimized_shapecodes", "optimized_texturecodes",
        "optimized_poses", "R_eval", "T_eval", "depth_err_mean", "lidar_pts_cnt", "ood_flags")})
    return set(JaxTTODriver.results_dict(stub))


def test_cli_writes_jax_schema_results(tmp_path):
    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps(dict(TINY_CONFIG, model_dir=str(tmp_path / "no_checkpoint"))))
    out = tmp_path / "run"
    summary = optimize.main(["--config_file", str(cfg), "--dataset", "synthetic",
                             "--num_objects", "2", "--batch_size", "2", "--device", "cpu",
                             "--save_dir", str(out)])
    with open(out / "codes+poses.pkl", "rb") as f:
        res = pickle.load(f)
    assert set(res) == _jax_result_keys()
    assert res["num_obj"] == 2 and res["code_level"] == 2
    assert res["optimized_shapecodes"]["ann_0"]["CAM_FRONT"].shape == (6, 32)
    assert res["optimized_poses"]["ann_1"]["CAM_FRONT"].shape == (6, 3, 4)
    assert all(len(v) == 6 for v in res["psnr_eval"].values())
    pth = torch.load(out / "codes+poses.pth", weights_only=False)
    assert set(pth["psnr_eval"]) == set(res["psnr_eval"])
    with open(out / "cross_eval.pkl", "rb") as f:
        cross = pickle.load(f)
    assert cross["psnr_eval_mat_per_ins"]["ins_0"][0].shape == (2, 2)
    assert summary["aggregate"]["psnr"].shape == (6,)
    assert {"encode_refine", "tto_loop", "cross_view"} <= set(summary["phase_seconds"])


def test_entry_points_refuse_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        optimize.main(["--dataset", "synthetic", "--num_objects", "1"])
    assert resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("option", ["training InstanceNorm2d"])
def test_unported_options_raise(tmp_path, option):
    """Once refused, a SUP-NeRF config whose encoder normalises with
    InstanceNorm2d (no published config does) now trains through the train
    CLI: finite losses on every step, and a checkpoint with no norm entry
    that strict-loads into the model the config builds."""
    from supnerf_tpu_torch.cli import train
    from supnerf_tpu_torch.models.factory import build_model

    hp = dict(TRAIN_CONFIG["net_hyperparams"], norm_layer_type="InstanceNorm2d")
    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps(dict(TRAIN_CONFIG, net_hyperparams=hp, in_img_sz=64)))
    out = train.main(_train_argv(cfg, tmp_path / "run"))
    assert out["steps"] == 2
    assert all(math.isfinite(m[k]) for m in out["metrics"]
               for k in ("loss_total", "loss_rgb", "loss_occ", "psnr"))
    saved = torch.load(tmp_path / "run" / "models.pth", weights_only=False)
    assert not any(".bn" in k for k in saved["model_params"])
    build_model("supnerf", hp).load_state_dict(saved["model_params"], strict=True)


@pytest.mark.parametrize("cli,argv", [
    ("optimize", ["--devices", "1", "--gpu", "0", "--num_workers", "2"]),
    ("train", ["--gpus", "1", "--gpu", "3"]),
    ("train", ["--devices", "1", "--gpus", "2"])], ids=["optimize", "train gpus", "train devices"])
def test_device_flags_run(tmp_path, monkeypatch, cli, argv):
    """The JAX CLIs' device flags as one device takes them: --devices 1,
    --gpu (ignored), the optimize CLIs' --num_workers (unused) and the train
    CLI's --gpus (taken as --devices unless --devices is given) run on the
    CPU to their results."""
    from supnerf_tpu_torch.cli import train

    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
    cfg = tmp_path / "tiny.json"
    if cli == "optimize":
        cfg.write_text(json.dumps(dict(TINY_CONFIG, model_dir=str(tmp_path / "no_checkpoint"))))
        summary = optimize.main(["--config_file", str(cfg), "--dataset", "synthetic",
                                 "--num_objects", "1", "--device", "cpu",
                                 "--save_dir", str(tmp_path / "run"), *argv])
        assert summary["n_objects"] == 1
    else:
        cfg.write_text(json.dumps(TRAIN_CONFIG))
        out = train.main(_train_argv(cfg, tmp_path / "run", *argv)[:-2] + ["--epochs", "1"])
        assert out["steps"] == 1


def test_device_flags_refuse_more_than_one_device(tmp_path, monkeypatch):
    """The device requests that cannot run as asked raise ValueError on
    every CLI that takes them, before any work and before any file is
    written, and nothing carries on with fewer cards or on the CPU:
    --devices 0; a batch that the ranks do not divide (--batch_size 4 over
    3 ranks, the demo's 3 cars over 2; also through --gpus); more than one
    rank for --opt_multiview or --cross_eval_folder, which split nothing,
    as in JAX; --devices 2 on
    --device cuda where torch.cuda.device_count() is 1; a coordinator
    (--coordinator or JAX_COORDINATOR_ADDRESS) without JAX_NUM_PROCESSES
    and JAX_PROCESS_ID. --devices 2, --gpus 2 and --coordinator run in
    tests/test_torch_parallel.py."""
    from supnerf_tpu_torch.cli import demo, train

    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
    monkeypatch.delenv("JAX_NUM_PROCESSES", raising=False)
    monkeypatch.delenv("JAX_PROCESS_ID", raising=False)
    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps(TRAIN_CONFIG))
    run = tmp_path / "run"
    base = {"optimize": ["--dataset", "synthetic", "--num_objects", "1", "--batch_size", "4",
                         "--device", "cpu", "--save_dir", str(run)],
            "train": _train_argv(cfg, run),
            "demo": ["--device", "cpu", "--save_dir", str(run)]}
    mains = {"optimize": optimize.main, "train": train.main, "demo": demo.main}
    indivisible = {"optimize": "3", "train": "3", "demo": "2"}
    for name, fn in mains.items():
        for extra, match in ((["--devices", "0"], "one rank or more"),
                             (["--devices", indivisible[name]], "does not split"),
                             (["--coordinator", "10.0.0.1:1234"], "JAX_NUM_PROCESSES")):
            with pytest.raises(ValueError, match=match):
                fn(base[name] + extra)
    with pytest.raises(ValueError, match="does not split"):
        train.main(base["train"] + ["--gpus", "3"])
    for extra in (["--opt_multiview", "1"], ["--cross_eval_folder", str(run)]):
        with pytest.raises(ValueError, match="split nothing over ranks"):
            optimize.main(base["optimize"] + extra + ["--devices", "2"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    for name, fn in mains.items():
        argv = [a if a != "cpu" else "cuda" for a in base[name]]
        with pytest.raises(ValueError, match="2 ranks on this host and 1 cards"):
            fn(argv + ["--devices", "2"])
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "10.0.0.1:1234")
    with pytest.raises(ValueError, match="JAX_NUM_PROCESSES"):
        optimize.main(base["optimize"])
    assert not os.path.exists(run)


def test_profile_dir_writes_a_trace(tmp_path):
    """--profile_dir on a tiny CPU TTO run: a Chrome trace (trace.json) that
    parses and holds the TTO's operator events; the run's results as
    without it."""
    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps(dict(TINY_CONFIG, model_dir=str(tmp_path / "no_checkpoint"))))
    optimize.main(["--config_file", str(cfg), "--dataset", "synthetic", "--num_objects", "1",
                   "--device", "cpu", "--save_dir", str(tmp_path / "run"),
                   "--profile_dir", str(tmp_path / "trace")])
    with open(tmp_path / "trace" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert len(events) > 100 and "aten::linear" in names
    with open(tmp_path / "run" / "codes+poses.pkl", "rb") as f:
        assert pickle.load(f)["num_obj"] == 1


@pytest.mark.parametrize("option", ["opt_pose 0", "opt_pose 2", "euler_rot", "opt_cam_pose",
                                    "pred_wlh 2"])
def test_formerly_queued_options_run(tmp_path, option):
    """The TTO options that once refused to run go through the optimize CLI
    on the CPU on 1 synthetic object to the JAX schema's result file and
    finite curves: --opt_pose 0 and 2, --pred_wlh 2 (on a config whose net
    predicts wlh), and euler_rot and optimize.opt_cam_pose in the config."""
    config = dict(TINY_CONFIG, model_dir=str(tmp_path / "no_checkpoint"))
    argv = []
    if option.startswith(("opt_pose", "pred_wlh")):
        flag, value = option.split()
        argv = [f"--{flag}", value]
        if flag == "pred_wlh":
            config["net_hyperparams"] = dict(config["net_hyperparams"], pred_wlh=1)
    elif option == "euler_rot":
        config[option] = 1
    else:
        config["optimize"] = dict(config["optimize"], opt_cam_pose=1)
    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps(config))
    summary = optimize.main(["--config_file", str(cfg), "--dataset", "synthetic",
                             "--num_objects", "1", "--device", "cpu",
                             "--save_dir", str(tmp_path / "run"), *argv])
    with open(tmp_path / "run" / "codes+poses.pkl", "rb") as f:
        res = pickle.load(f)
    assert set(res) == _jax_result_keys()
    assert res["num_obj"] == 1 and res["code_level"] == 2
    assert res["optimized_shapecodes"]["ann_0"]["CAM_FRONT"].shape == (6, 32)
    assert all(len(v) == 6 and all(math.isfinite(x) for x in v)
               for key in ("psnr_eval", "R_eval", "T_eval") for v in res[key].values())
    assert (summary["pnp_translations"] is not None) == (option == "opt_pose 2")


def test_regularisers_run_through_the_cli(tmp_path):
    """The TTO regularisers arrive through --config_file, as in the JAX CLI:
    "sym_aug": 1 and "obj_sz_reg": 1 run to finite curves on the CPU, and
    the CLI returns the per-iteration loss of each object."""
    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps(dict(TINY_CONFIG, model_dir=str(tmp_path / "no_checkpoint"),
                                   sym_aug=1, obj_sz_reg=1)))
    summary = optimize.main(["--config_file", str(cfg), "--dataset", "synthetic",
                             "--num_objects", "2", "--batch_size", "2", "--device", "cpu",
                             "--save_dir", str(tmp_path / "run")])
    assert len(summary["loss"]) == 2
    assert all(len(v) == 6 and all(math.isfinite(x) for x in v) for v in summary["loss"].values())
    assert all(math.isfinite(x) for x in summary["aggregate"]["psnr"])


_BLOCKED = ("jax", "jaxlib", "flax", "optax", "supnerf_tpu", "cv2", "PIL", "matplotlib",
            "imageio")
_ISOLATION = r"""
import importlib, pkgutil, sys
blocked = %r
def hit(name):
    return any(name == b or name.startswith(b + ".") for b in blocked)
for name in [m for m in sys.modules if hit(m)]:     # e.g. preloaded by sitecustomize
    del sys.modules[name]
class Block:
    def find_spec(self, name, path=None, target=None):
        if hit(name):
            raise ImportError("blocked import: " + name)
sys.meta_path.insert(0, Block())
import supnerf_tpu_torch
names = [m.name for m in pkgutil.walk_packages(supnerf_tpu_torch.__path__, "supnerf_tpu_torch.")]
for name in names + ["chip_smoke"]:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules if hit(m))
assert not leaked, leaked
print(" ".join(names))
"""


def test_port_imports_nothing_of_the_jax_world():
    """Every module of supnerf_tpu_torch and chip_smoke.py imports in a fresh
    interpreter where jax, flax, optax, supnerf_tpu, cv2, PIL, matplotlib
    and imageio raise on import."""
    proc = subprocess.run([sys.executable, "-c", _ISOLATION % (_BLOCKED,)], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    imported = proc.stdout.split()
    assert len(imported) >= 20
    for name in ("cli.demo", "render.compositor", "utils.image_io", "ops.field",
                 "tto.regularizers", "tto.pnp", "tto.multiview", "cli.eval_saved_result",
                 "cli.evaluate_all", "utils.draw", "utils.glyphs", "utils.vis", "eval.metrics",
                 "bench.train_loop_ab", "data.debug", "utils.colormaps", "utils.gif",
                 "utils.profiling", "cli.generate_video_vis", "parallel", "parallel.mesh"):
        assert f"supnerf_tpu_torch.{name}" in imported


_VIS_ISOLATION = _ISOLATION.split("import supnerf_tpu_torch\n")[0] + r"""
import json, os, pickle, shutil, sys, tempfile
from supnerf_tpu_torch.cli import optimize, train
d = tempfile.mkdtemp()
cfg = os.path.join(d, "tiny.json")
with open(cfg, "w") as f:
    json.dump(dict(config, model_dir=os.path.join(d, "none")), f)
common = ["--config_file", cfg, "--dataset", "synthetic", "--device", "cpu"]
optimize.main(common + ["--num_objects", "1", "--batch_size", "1", "--vis", "2",
                        "--save_dir", os.path.join(d, "tto")])
with open(os.path.join(d, "tto", "codes+poses.pkl"), "rb") as f:
    ssim = pickle.load(f)["ssim_eval"]["ann_0_CAM_FRONT"]
train.main(common + ["--num_objects", "2", "--batch_size", "2", "--epochs", "1",
                     "--check_iter", "1", "--save_dir", os.path.join(d, "train")])
leaked = sorted(m for m in sys.modules if hit(m))
assert not leaked, leaked
out = {"tto": sorted(os.listdir(os.path.join(d, "tto", "ann_0_CAM_FRONT"))),
       "runs": sorted(os.listdir(os.path.join(d, "train", "runs"))), "ssim": ssim}
shutil.rmtree(d)
print(json.dumps(out))
"""


def test_vis_path_imports_nothing_of_the_jax_world():
    """The visualisation at run time (the optimize CLI's --vis 2 panels,
    sheet and SSIM, through tto/driver, utils/vis, utils/draw and
    eval/metrics; the trainer's log sink) in a fresh interpreter where jax,
    flax, optax, supnerf_tpu, cv2, PIL, matplotlib and imageio raise on
    import."""
    config = dict(TINY_CONFIG, n_rays=32)
    script = _VIS_ISOLATION.replace("blocked = %r", f"blocked = %r\nconfig = {config!r}")
    proc = subprocess.run([sys.executable, "-c", script % (_BLOCKED,)], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["tto"] == [f"opt{t:03d}.png" for t in range(6)] + ["virt_final.png"]
    assert out["runs"] == ["metrics.jsonl", "train_panel_0000001.png"]
    assert len(out["ssim"]) == 1


# --------------------------------------------------------------------------
# the training entry point (supnerf_tpu_torch.cli.train)
# --------------------------------------------------------------------------

TRAIN_CONFIG = {
    "arch": "supnerf",
    "net_hyperparams": {"shape_blocks": 1, "texture_blocks": 1, "latent_dim": 32,
                        "pose_shortcut": 1, "pred_wlh": 0},
    "n_rays": 32, "n_samples": 8, "in_img_sz": 32,
}


def _train_argv(cfg, out, *extra):
    return ["--config_file", str(cfg), "--dataset", "synthetic", "--num_objects", "4",
            "--batch_size", "4", "--epochs", "2", "--device", "cpu", "--save_dir", str(out),
            "--check_iter", "1", *extra]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A tiny CPU training run: 4 objects (2 instances), batch 4, 2 epochs."""
    from supnerf_tpu_torch.cli import train

    d = tmp_path_factory.mktemp("train")
    cfg = d / "tiny.json"
    cfg.write_text(json.dumps(dict(TRAIN_CONFIG, model_dir=str(d / "no_checkpoint"))))
    return cfg, d / "run", train.main(_train_argv(cfg, d / "run"))


def test_cli_train_runs_resumes_and_loads(trained, tmp_path):
    """Two epochs of one step each write both epochs' checkpoints; a run
    resumed from epoch_0 repeats the second step's loss exactly; the
    optimize CLI's loader strict-loads the result."""
    from supnerf_tpu_torch.cli import train
    from supnerf_tpu_torch.cli.common import load_model_and_codes
    from supnerf_tpu_torch.config import load_hpams

    cfg, out, summary = trained
    assert summary["steps"] == 2
    assert all(math.isfinite(m[k]) for m in summary["metrics"] for k in ("loss_total", "psnr"))
    assert [m["epoch"] for m in summary["metrics"]] == [0, 1]
    for name in ("epoch_0.pth", "epoch_1.pth", "epoch_0_optim.pth", "epoch_1_optim.pth",
                 "models.pth", "instoken2idx.json", "hpam.json"):
        assert (out / name).exists(), name
    assert json.loads((out / "instoken2idx.json").read_text()) == {"ins_0": 0, "ins_1": 1}
    assert {"forward", "render", "backward", "optimizer", "producer_prep", "producer_upload",
            "main_wait_batch"} <= set(summary["phase_seconds"])

    resumed = train.main(_train_argv(cfg, tmp_path / "resumed", "--resume_dir", str(out),
                                     "--resume_from_epoch", "0"))
    assert resumed["steps"] == 1 and resumed["metrics"][0]["niter"] == 2
    for k in ("loss_total", "loss_rgb", "loss_pose_iter3"):
        assert resumed["metrics"][0][k] == pytest.approx(summary["metrics"][1][k], rel=1e-6), k

    hpams = load_hpams(str(cfg))
    model, mean_shape, mean_texture = load_model_and_codes(dict(hpams, model_dir=str(out)),
                                                           "cpu", model_epoch=1)
    saved = torch.load(out / "epoch_1.pth", weights_only=False)
    for k, v in model.state_dict().items():
        assert torch.equal(v, saved["model_params"][k]), k
    assert saved["niter"] == 2 and saved["nepoch"] == 1
    assert torch.allclose(torch.from_numpy(mean_shape),
                          saved["shape_code_params"]["weight"].mean(0))


def test_train_checkpoint_schema_matches_reference(trained, tmp_path):
    """epoch_{n}.pth holds exactly the keys, model_params names and shapes
    that supnerf_tpu.training.checkpoints.export_reference_checkpoint writes
    for the same configuration."""
    import jax
    import numpy as np
    from supnerf_tpu.models import build_model as jax_build_model
    from supnerf_tpu.models.initialization import make_init_fn
    from supnerf_tpu.training.checkpoints import export_reference_checkpoint

    _, out, _ = trained
    jmodel = jax_build_model("supnerf", TRAIN_CONFIG["net_hyperparams"])
    shapes = jax.eval_shape(lambda k: jmodel.init(k, method=make_init_fn(jmodel, 32)),
                            jax.random.PRNGKey(0))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    state = types.SimpleNamespace(params=zeros["params"], batch_stats=zeros["batch_stats"],
                                  shape_codes=np.zeros((2, 32), np.float32),
                                  texture_codes=np.zeros((2, 32), np.float32), niter=0,
                                  optimized_idx=np.zeros(2, np.float32))
    export_reference_checkpoint(jmodel, state, {"ins_0": 0, "ins_1": 1}, str(tmp_path / "ref.pth"))
    ref = torch.load(tmp_path / "ref.pth", weights_only=False)
    ours = torch.load(out / "epoch_1.pth", weights_only=False)
    assert set(ours) == set(ref)
    assert {k: tuple(v.shape) for k, v in ours["model_params"].items()} == \
        {k: tuple(v.shape) for k, v in ref["model_params"].items()}
    for k in ("shape_code_params", "texture_code_params"):
        assert set(ours[k]) == set(ref[k]) == {"weight"}
        assert ours[k]["weight"].shape == ref[k]["weight"].shape
    assert ours["instoken2idx"] == ref["instoken2idx"]
    assert ours["optimized_idx"].shape == ref["optimized_idx"].shape


def test_train_entry_point_refuses_a_missing_card(monkeypatch):
    from supnerf_tpu_torch.cli import train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--dataset", "synthetic", "--num_objects", "1"])


@pytest.mark.parametrize("option", ["pretrained_model_dir", "num_workers", "finetune_wlh",
                                    "im_enc_rate", "dataset"])
def test_train_unported_options_raise(tmp_path, option):
    """What the train CLI refuses, each with its reason: --pretrained_model_dir
    (the JAX CLI reads it nowhere), a negative --num_workers,
    --finetune_wlh on a net without the wlh head, an --im_enc_rate outside
    [0, 1], an unknown dataset."""
    from supnerf_tpu_torch.cli import train

    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps(dict(TRAIN_CONFIG, model_dir=str(tmp_path / "no_checkpoint"))))
    argv = _train_argv(cfg, tmp_path / "run")
    extra, reason = {"pretrained_model_dir": (["--pretrained_model_dir", "x"], "reads it nowhere"),
                     "num_workers": (["--num_workers", "-1"], "0 or more"),
                     "finetune_wlh": (["--finetune_wlh", "true"], "wlh head"),
                     "im_enc_rate": (["--im_enc_rate", "1.5"], r"\[0, 1\]"),
                     "dataset": (["--dataset", "nuscenes-lidarseg"], "Unknown dataset")}[option]
    with pytest.raises(ValueError, match=reason):
        train.main(argv + extra)


_TRAIN_ISOLATION = _ISOLATION.split("import supnerf_tpu_torch\n")[0] + r"""
import supnerf_tpu_torch.training
names = ["supnerf_tpu_torch.cli.train"] + [
    m.name for m in pkgutil.walk_packages(supnerf_tpu_torch.training.__path__,
                                          "supnerf_tpu_torch.training.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules if hit(m))
assert not leaked, leaked
sys.path.insert(0, "tests")
import torch_parallel_worker
from supnerf_tpu_torch.parallel.mesh import launch, plan_launch
ranks = launch(plan_launch(2, None, "cpu"), torch_parallel_worker.rank_imports)
assert ranks == [[], []], ranks
print(" ".join(names + ["spawned-ranks-clean"]))
"""


def test_training_modules_import_nothing_of_the_jax_world():
    """The training entry point and every supnerf_tpu_torch.training module
    import where jax, flax, optax, supnerf_tpu, cv2, PIL and matplotlib
    raise on import; so do the two ranks a data-parallel launch spawns
    (parallel.launch, 2 gloo ranks), whose fresh interpreters hold nothing
    of those once they have imported the port."""
    proc = subprocess.run([sys.executable, "-c", _TRAIN_ISOLATION % (_BLOCKED,)], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    imported = proc.stdout.split()
    for name in ("ray_prep", "train_step", "checkpoints", "trainer", "pixel_prep", "prefetch"):
        assert f"supnerf_tpu_torch.training.{name}" in imported
    assert "spawned-ranks-clean" in imported
