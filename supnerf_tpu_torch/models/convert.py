"""Weights carried across from the JAX package: its variables, as nested dicts
of numpy arrays ({'params': ..., 'batch_stats': ...}), become this package's
state_dict. The port's modules use the reference's torch parameter names, so
the result loads with load_state_dict(strict=True) — and so does a reference
models.pth. This is the port's own copy of the mapping in
supnerf_tpu/models/torch_import.py (export_encoder, export_decoder,
export_pose_refiner, export_autorf_original_decoder, export_state_dict), for
every arch of models/factory.py.

Layouts: flax conv kernels (H, W, I, O) -> torch (O, I, H, W); dense kernels
(I, O) -> (O, I); BatchNorm scale/bias -> weight/bias, batch_stats
mean/var -> running_mean/running_var, plus num_batches_tracked. An
InstanceNorm encoder (norm_layer_type InstanceNorm2d) has neither
parameters nor statistics for its norms, in flax as in torch: only its
convolutions and dense layers are carried.
"""
from __future__ import annotations

import numpy as np
import torch


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))


def _conv(out, name, k):
    out[name] = _t(np.asarray(k).transpose(3, 2, 0, 1))


def _dense(out, name, p):
    out[f"{name}.weight"] = _t(np.asarray(p["kernel"]).T)
    out[f"{name}.bias"] = _t(p["bias"])


def _bn(out, name, p, bs):
    if p is None:                       # an InstanceNorm: nothing to carry
        return
    out[f"{name}.weight"] = _t(p["scale"])
    out[f"{name}.bias"] = _t(p["bias"])
    out[f"{name}.running_mean"] = _t(bs["mean"])
    out[f"{name}.running_var"] = _t(bs["var"])
    out[f"{name}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)


def _stage(out, prefix, params, stats):
    for i in range(len(params)):
        p, bs, pre = params[f"BasicBlock_{i}"], stats.get(f"BasicBlock_{i}", {}), f"{prefix}.{i}"
        _conv(out, f"{pre}.conv1.weight", p["Conv_0"]["kernel"])
        _bn(out, f"{pre}.bn1", p.get("BatchNorm_0"), bs.get("BatchNorm_0"))
        _conv(out, f"{pre}.conv2.weight", p["Conv_1"]["kernel"])
        _bn(out, f"{pre}.bn2", p.get("BatchNorm_1"), bs.get("BatchNorm_1"))
        if "Conv_2" in p:
            _conv(out, f"{pre}.downsample.0.weight", p["Conv_2"]["kernel"])
            _bn(out, f"{pre}.downsample.1", p.get("BatchNorm_2"), bs.get("BatchNorm_2"))


def convert_encoder(params, stats, heads=("shape", "texture", "pose"), pred_wlh=False):
    """flax ImgEncoder subtrees -> state_dict entries under 'img_encoder.'."""
    pre = "img_encoder."
    out = {}
    _conv(out, pre + "conv1.weight", params["conv1"]["kernel"])
    _bn(out, pre + "bn1", params.get("bn1"), stats.get("bn1"))
    for layer in ("layer1", "layer2", "layer3"):
        _stage(out, pre + layer, params[layer], stats.get(layer, {}))
    for h in heads:
        _stage(out, pre + f"layer4_{h}", params[f"layer4_{h}"], stats.get(f"layer4_{h}", {}))
        _dense(out, pre + f"fc_{h}", params[f"fc_{h}"])
    if "pose" in heads:
        _dense(out, pre + "fc_uv", params["fc_uv"])
    if pred_wlh:
        _stage(out, pre + "layer4_wlh", params["layer4_wlh"], stats.get("layer4_wlh", {}))
        _dense(out, pre + "fc_wlh.0", params["fc_wlh_hidden"])
        _dense(out, pre + "fc_wlh.2", params["fc_wlh_out"])
    return out


def _encoder_stats(variables):
    """The encoder's batch_stats subtree; empty for an InstanceNorm encoder,
    whose flax variables have no batch_stats collection."""
    return variables.get("batch_stats", {}).get("img_encoder", {})


def convert_decoder(params, shape_blocks: int, texture_blocks: int):
    """flax CodeNeRFDecoder params -> the reference decoder names."""
    out = {}
    for name, src in (("encoding_xyz.0", "encoding_xyz"), ("encoding_shape", "encoding_shape"),
                      ("sigma.0", "sigma"), ("encoding_viewdir.0", "encoding_viewdir"),
                      ("rgb.0", "rgb_hidden"), ("rgb.2", "rgb_out")):
        _dense(out, name, params[src])
    for j in range(1, shape_blocks + 1):
        _dense(out, f"shape_latent_layer_{j}.0", params[f"shape_latent_layer_{j}"])
        _dense(out, f"shape_layer_{j}.0", params[f"shape_layer_{j}"])
    for j in range(1, texture_blocks + 1):
        _dense(out, f"texture_latent_layer_{j}.0", params[f"texture_latent_layer_{j}"])
        _dense(out, f"texture_layer_{j}.0", params[f"texture_layer_{j}"])
    return out


def convert_autorf_decoder(params, shape_blocks: int, texture_blocks: int):
    """flax AutoRFDecoder params -> the reference's original AutoRF decoder
    names (no latent projections)."""
    out = {}
    for name, src in (("encoding_xyz.0", "encoding_xyz"), ("sigma.0", "sigma"), ("rgb.0", "rgb")):
        _dense(out, name, params[src])
    for j in range(shape_blocks - 1):
        _dense(out, f"shape_layer_{j}.0", params[f"shape_layer_{j}"])
    for j in range(texture_blocks - 1):
        _dense(out, f"texture_layer_{j}.0", params[f"texture_layer_{j}"])
    return out


def convert_pose_refiner(params, pose_blocks: int, regress_blocks: int):
    out = {}
    _dense(out, "out_delta_layer", params["out_delta_layer"])
    for j in range(pose_blocks):
        _dense(out, f"pose_layer_{j}.0", params[f"pose_layer_{j}"])
    for j in range(regress_blocks):
        _dense(out, f"regress_layer_{j}.0", params[f"regress_layer_{j}"])
    return out


def convert_supnerf_variables(variables, net_hyperparams: dict) -> dict:
    """JAX SUPNeRF variables -> this package's SUPNeRF state_dict."""
    hp = net_hyperparams
    params = variables["params"]
    sd = convert_encoder(params["img_encoder"], _encoder_stats(variables),
                         pred_wlh=bool(hp.get("pred_wlh", 0)))
    sd.update(convert_decoder(params["decoder"], hp.get("shape_blocks", 5),
                              hp.get("texture_blocks", 5)))
    sd.update(convert_pose_refiner(params["pose_refiner"], hp.get("pose_blocks", 3),
                                   hp.get("regress_blocks", 3)))
    return sd


def convert_autorfmix_variables(variables, net_hyperparams: dict) -> dict:
    """JAX AutoRFMix variables (arch "autorf" or "autorfmix") -> this
    package's AutoRFMix state_dict."""
    hp = net_hyperparams
    params = variables["params"]
    sd = convert_encoder(params["img_encoder"], _encoder_stats(variables),
                         heads=("shape", "texture"))
    sd.update(convert_decoder(params["decoder"], hp.get("shape_blocks", 5),
                              hp.get("texture_blocks", 5)))
    return sd


def convert_autorf_variables(variables, net_hyperparams: dict) -> dict:
    """JAX AutoRF variables (arch "autorf_original") -> this package's AutoRF
    state_dict."""
    hp = net_hyperparams
    params = variables["params"]
    sd = convert_encoder(params["img_encoder"], _encoder_stats(variables),
                         heads=("shape", "texture"))
    sd.update(convert_autorf_decoder(params["decoder"], hp.get("shape_blocks", 5),
                                     hp.get("texture_blocks", 5)))
    return sd


def convert_codenerf_variables(variables, net_hyperparams: dict) -> dict:
    """JAX CodeNeRF variables -> this package's CodeNeRF state_dict (the
    decoder alone)."""
    hp = net_hyperparams
    return convert_decoder(variables["params"]["decoder"], hp.get("shape_blocks", 2),
                           hp.get("texture_blocks", 1))


CONVERTERS = {"supnerf": convert_supnerf_variables, "autorf": convert_autorfmix_variables,
              "autorfmix": convert_autorfmix_variables,
              "autorf_original": convert_autorf_variables, "codenerf": convert_codenerf_variables}


def convert_variables(arch: str, variables, net_hyperparams: dict) -> dict:
    """JAX variables of the model build_model(arch, net_hyperparams) makes
    -> the state_dict of this package's model of that arch."""
    return CONVERTERS[arch](variables, net_hyperparams)


def _adam_moments(opt_state):
    """The (count, mu, nu) of optax's scale_by_adam inside an adamw state, or
    a chain holding one (gradient clipping first): nested tuples of states,
    found by its fields."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return int(np.asarray(opt_state.count)), opt_state.mu, opt_state.nu
    if isinstance(opt_state, tuple):
        for s in opt_state:
            try:
                return _adam_moments(s)
            except ValueError:
                continue
    raise ValueError("no scale_by_adam state (mu, nu) in the optimizer state")


def convert_train_state(jax_state, hpams: dict, device="cpu", cfg=None):
    """A JAX TrainState (supnerf_tpu/training/train_step.py; its leaves as
    numpy arrays) -> this package's training.train_step.TrainState on
    `device`: the variables into the model of hpams["arch"]
    (load_state_dict strict), both code tables, optimized_idx, niter, and
    both optimizers' counts and moments, so that the two packages continue
    from the same numbers."""
    from supnerf_tpu_torch.models.factory import build_model
    from supnerf_tpu_torch.training.train_step import TrainConfig, init_train_state

    arch, hp = hpams["arch"], hpams["net_hyperparams"]
    model = build_model(arch, hp)
    cfg = cfg or TrainConfig(latent_dim=model.latent_dim)
    stats = jax_state.batch_stats
    model.load_state_dict(convert_variables(
        arch, {"params": jax_state.params, "batch_stats": stats}, hp), strict=True)
    n = np.asarray(jax_state.shape_codes).shape[0]
    state = init_train_state(model, n, cfg, device)
    with torch.no_grad():
        for dst, src in ((state.shape_codes, jax_state.shape_codes),
                         (state.texture_codes, jax_state.texture_codes),
                         (state.optimized_idx, jax_state.optimized_idx)):
            dst.copy_(_t(src))
    state.niter = int(np.asarray(jax_state.niter))

    names = [name for name, _ in state.model.named_parameters()]
    count, mu, nu = _adam_moments(jax_state.opt_state_model)
    moments = [convert_variables(arch, {"params": tree, "batch_stats": stats}, hp)
               for tree in (mu, nu)]
    state.opt_model.load_state_dict({"m": [moments[0][k] for k in names],
                                     "v": [moments[1][k] for k in names], "count": count})
    count, mu, nu = _adam_moments(jax_state.opt_state_codes)
    state.opt_codes.load_state_dict({"m": [_t(a) for a in mu], "v": [_t(a) for a in nu],
                                     "count": count})
    return state
