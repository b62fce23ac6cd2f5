"""Model construction from a config's 'arch' and 'net_hyperparams'; the port
of supnerf_tpu/models/factory.py, with its defaults and its name mapping."""
from __future__ import annotations

import torch

from supnerf_tpu_torch.models.autorf import AutoRF, AutoRFMix
from supnerf_tpu_torch.models.codenerf import CodeNeRF
from supnerf_tpu_torch.models.layers import init_parameters
from supnerf_tpu_torch.models.supnerf import SUPNeRF


def build_model(arch: str, net_hyperparams: dict):
    hp = dict(net_hyperparams)
    if arch != "codenerf" and hp.get("norm_layer_type", "BatchNorm2d") != "BatchNorm2d":
        raise ValueError("only BatchNorm2d encoders are supported (every published config); "
                         "InstanceNorm2d is queued in ROADMAP.md")
    freqs = {"num_xyz_freq": hp.get("num_xyz_freq", 10),
             "num_dir_freq": hp.get("num_dir_freq", 4)}
    if arch == "supnerf":
        return SUPNeRF(
            shape_blocks=hp.get("shape_blocks", 5),
            texture_blocks=hp.get("texture_blocks", 5),
            pose_blocks=hp.get("pose_blocks", 3),
            regress_blocks=hp.get("regress_blocks", 3),
            latent_dim=hp.get("latent_dim", 256),
            pose_shortcut=bool(hp.get("pose_shortcut", 0)),
            pred_wlh=bool(hp.get("pred_wlh", 0)),
            **freqs,
        )
    if arch in ("autorf", "autorfmix", "autorf_original"):
        # the published AutoRF baseline is the mix variant (AutoRF encoder +
        # CodeNeRF decoder); the config files name it "autorfmix"
        cls = AutoRF if arch == "autorf_original" else AutoRFMix
        return cls(shape_blocks=hp.get("shape_blocks", 5),
                   texture_blocks=hp.get("texture_blocks", 5),
                   latent_dim=hp.get("latent_dim", 128), **freqs)
    if arch == "codenerf":
        return CodeNeRF(shape_blocks=hp.get("shape_blocks", 2),
                        texture_blocks=hp.get("texture_blocks", 1),
                        W=hp.get("latent_dim", 256), latent_dim=hp.get("latent_dim", 256),
                        **freqs)
    raise ValueError(f"Unknown arch: {arch}")


def init_model(model, seed: int):
    """Fresh random weights drawn on the CPU from `seed` (the same on every
    device); returns the model."""
    init_parameters(model, torch.Generator().manual_seed(seed))
    return model
