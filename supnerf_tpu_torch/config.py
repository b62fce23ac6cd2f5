"""JSON hyperparameter files (the reference's jsonfiles/ schema: arch,
net_hyperparams, dataset block, loss coefficients, optimize block); the
port's own copy of supnerf_tpu/config.py."""
from __future__ import annotations

import json
import os

DEFAULT_HPAMS = {
    "arch": "supnerf",
    "net_hyperparams": {
        "shape_blocks": 3, "texture_blocks": 1, "pose_blocks": 3,
        "regress_blocks": 3, "latent_dim": 256, "num_xyz_freq": 10,
        "num_dir_freq": 4, "norm_layer_type": "BatchNorm2d",
        "pose_shortcut": 1, "pred_wlh": 0,
    },
    "n_rays": 1024,
    "render_im_sz": 32,
    "n_samples": 64,
    "roi_margin": 5,
    "max_img_sz": 320,
    "in_img_sz": 128,
    "loss_reg_coef": 0.001,
    "loss_occ_coef": 0.1,
    "loss_code_coef": 0.1,
    "loss_pose_coef": 0.01,
    "loss_sym_coef": 1.0,
    "loss_obj_sz_coef": 1.0,
    "lr_schedule": [
        {"type": "step", "lr": 1e-4, "interval": 40000},
        {"type": "step", "lr": 1e-4, "interval": 40000},
    ],
    "shapenet_obj_cood": 1,
    "sym_aug": 0,
    "obj_sz_reg": 0,
    "euler_rot": 0,
    "optimize": {
        "num_opts": 100, "opt_cam_pose": 0, "lr_shape": 0.02,
        "lr_texture": 0.02, "lr_pose": 0.01, "lr_half_interval": 1000,
    },
}


def load_hpams(config_file: str | None) -> dict:
    """Load a jsonfiles config, filling defaults for missing keys."""
    hpams = json.loads(json.dumps(DEFAULT_HPAMS))
    if config_file:
        with open(config_file) as f:
            user = json.load(f)
        for k, v in user.items():
            if isinstance(v, dict) and isinstance(hpams.get(k), dict):
                hpams[k].update(v)
            else:
                hpams[k] = v
    return hpams


def find_config(name: str) -> str:
    """Resolve a config name against the repo's jsonfiles/ directory."""
    if os.path.exists(name):
        return name
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cand = os.path.join(here, "jsonfiles", name)
    if os.path.exists(cand):
        return cand
    raise FileNotFoundError(name)
