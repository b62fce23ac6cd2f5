"""The port's optimize CLI end to end on the CPU at a tiny size, its result
files against the JAX driver's schema, the device rule of its entry points,
and the import isolation of the port and chip_smoke.py."""
import json
import os
import pickle
import subprocess
import sys
import types

import pytest
import torch

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


@pytest.mark.parametrize("option", ["opt_pose 0", "opt_pose 2", "euler_rot", "opt_cam_pose"])
def test_unported_options_raise(tmp_path, option):
    """Options outside this slice refuse to run instead of taking an
    unverified path."""
    config = dict(TINY_CONFIG, model_dir=str(tmp_path / "no_checkpoint"))
    argv = []
    if option.startswith("opt_pose"):
        argv = ["--opt_pose", option.split()[1]]
    elif option == "euler_rot":
        config["euler_rot"] = 1
    else:
        config["optimize"] = dict(config["optimize"], opt_cam_pose=1)
    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps(config))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        optimize.main(["--config_file", str(cfg), "--dataset", "synthetic", "--num_objects",
                       "1", "--device", "cpu", "--save_dir", str(tmp_path / "run"), *argv])


_BLOCKED = ("jax", "jaxlib", "flax", "optax", "supnerf_tpu", "cv2", "PIL", "matplotlib")
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
print(len(names))
"""


def test_port_imports_nothing_of_the_jax_world():
    """Every module of supnerf_tpu_torch and chip_smoke.py imports in a fresh
    interpreter where jax, flax, optax, supnerf_tpu, cv2, PIL and
    matplotlib raise on import."""
    proc = subprocess.run([sys.executable, "-c", _ISOLATION % (_BLOCKED,)], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 20
