"""CLI plumbing: arguments, model loading, the synthetic dataset; the parts
of supnerf_tpu/cli/common.py the optimize entry point needs."""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from supnerf_tpu_torch.data.synthetic import make_synthetic_object
from supnerf_tpu_torch.models.factory import build_model, init_model


def add_optimize_args(p: argparse.ArgumentParser):
    p.add_argument("--config_file", type=str, default="supnerf.nusc.vehicle.car.json")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="cuda (default; fails without a card) or cpu")
    p.add_argument("--model_epoch", type=int, default=None)
    p.add_argument("--rand_angle_lim", type=float, default=0.0)
    p.add_argument("--add_pose_err", type=int, default=2, choices=[0, 2])
    p.add_argument("--reg_iters", type=int, default=3)
    p.add_argument("--opt_pose", type=int, default=1,
                   help="1: codes and object pose (0 and 2 are queued in ROADMAP.md)")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--save_postfix", type=str, default="")
    p.add_argument("--save_dir", type=str, default=None,
                   help="results folder (default: under the config's model_dir)")
    p.add_argument("--save_freq", type=int, default=100)
    p.add_argument("--dataset", type=str, default=None, help="synthetic (this slice)")
    p.add_argument("--num_objects", type=int, default=32, help="synthetic dataset size")
    return p


def mean_codes(shape_codes, texture_codes, optimized_idx) -> tuple:
    """Mean shape / texture codes (numpy) over the instances that were
    trained (reference load_model :1799-1808), over all of them when none
    was; tensors or arrays of one state or checkpoint."""
    sc, tc, opt = (torch.as_tensor(t).detach().cpu().numpy()
                   for t in (shape_codes, texture_codes, optimized_idx))
    if (opt > 0).any():
        sc, tc = sc[opt > 0], tc[opt > 0]
    return sc.mean(0), tc.mean(0)


def load_model_and_codes(hpams: dict, device, model_epoch=None, seed: int = 0):
    """Build the model and load a reference-format checkpoint
    (model_dir/models.pth or epoch_N.pth: {'model_params', 'shape_code_params',
    'texture_code_params', ...}, reference trainer_unified_nuscenes.py:476-490)
    strictly; without one, fresh weights from `seed` and zero mean codes."""
    model = build_model(hpams["arch"], hpams["net_hyperparams"])
    latent = hpams["net_hyperparams"].get("latent_dim", 256)
    model_dir = hpams.get("model_dir", "")
    names = ([f"epoch_{model_epoch}.pth"] if model_epoch is not None else []) + ["models.pth"]
    path = next((os.path.join(model_dir, n) for n in names
                 if model_dir and os.path.exists(os.path.join(model_dir, n))), None)
    if path is None and model_dir and os.path.exists(os.path.join(model_dir, "latest.json")):
        raise ValueError(f"{model_dir} holds a JAX-package checkpoint; convert its variables "
                         "with supnerf_tpu_torch.models.convert first")
    if path is not None:
        saved = torch.load(path, map_location="cpu", weights_only=False)
        model.load_state_dict(saved["model_params"], strict=True)
        shape_w = saved["shape_code_params"]["weight"]
        mean_shape, mean_texture = mean_codes(
            shape_w, saved["texture_code_params"]["weight"],
            saved.get("optimized_idx", torch.zeros(len(shape_w))))
        print(f"loaded reference checkpoint {path}")
    else:
        init_model(model, seed)
        mean_shape = mean_texture = np.zeros(latent, np.float32)
    return model.to(device), mean_shape, mean_texture


class SyntheticDataset:
    """n synthetic objects, two views per instance (the JAX CLI's synthetic set)."""

    def __init__(self, n: int):
        self.samples = []
        for i in range(n):
            s = make_synthetic_object(seed=1000 + i)
            s.update(instoken=f"ins_{i // 2}", anntoken=f"ann_{i}", cam_ids="CAM_FRONT")
            self.samples.append(s)

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]


def build_dataset(hpams: dict, args):
    name = args.dataset or hpams.get("dataset", {}).get("name", "synthetic")
    if name != "synthetic":
        raise ValueError(f"dataset {name!r} is not ported yet: this slice runs "
                         "--dataset synthetic (the data layer is queued in ROADMAP.md)")
    return SyntheticDataset(args.num_objects)
