"""The unified SUP-NeRF training step (joint pose + NeRF); the port of
supnerf_tpu/training/train_step.py (reference trainer_unified_nuscenes.py:
ParallelModel.forward :27-148, pose_regress :150-195, set_optimizers
:414-421, get_learning_rate :423-429, make_codes :437-447).

One step: the encoder (BatchNorm on batch statistics, running buffers moved
by flax's rule), the direct box-corner loss, three unrolled refiner
iterations, the NeRF branch on the fused training render (ops/render.py:
K1 forward, K3 + K4 backward on the card), one backward pass, then AdamW on
the model and, separately, on the two dense per-instance code tables.

Loss terms (coefficients from the config json):
  loss_rgb + occ_coef * loss_occ                 always
  + pose_coef * direct-UV corner loss            (the encoder is active)
  + pose_coef * mean(3 unrolled refiner losses)  (the encoder is active)
loss_code and loss_reg are reported and not added (loss_code enters only
with im_enc_rate < 1, which this port does not run).

Numerics kept from the JAX step: the code tables are dense and every row's
moments and weight decay move on every step; row gradients are scatter-added
(duplicate instances in a batch add up); each optimizer's learning rate is
lr * 2^-(count // interval) at its count before the update; the refiner's
source pose is detached only inside the corner projection.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import torch

from supnerf_tpu_torch.geometry.boxes import corners_of_box, normalize_by_roi, view_points
from supnerf_tpu_torch.models.layers import batch_stat_updates
from supnerf_tpu_torch.ops.render import field_composite_train
from supnerf_tpu_torch.ops.volume_render import occupancy_loss, rgb_loss_masked
from supnerf_tpu_torch.optim import AdamW
from supnerf_tpu_torch.tto.refiner import compose_pose_delta

WEIGHT_DECAY = 0.01
METRIC_NAMES = ("loss_total", "loss_rgb", "loss_occ", "psnr", "loss_reg", "loss_code",
                "loss_pose_direct", "loss_pose_iter1", "loss_pose_iter2", "loss_pose_iter3",
                "enc_active")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr_model: float = 1e-4
    lr_codes: float = 1e-4
    lr_interval_model: int = 40000
    lr_interval_codes: int = 40000
    loss_occ_coef: float = 0.1
    loss_pose_coef: float = 0.01
    im_enc_rate: float = 1.0
    finetune_wlh: bool = False
    latent_dim: int = 256
    grad_clip: float = 0.0
    lr_schedule_type: str = "step"

    def __post_init__(self):
        unported = {"im_enc_rate": self.im_enc_rate != 1.0, "finetune_wlh": self.finetune_wlh,
                    "grad_clip": self.grad_clip > 0,
                    "lr_schedule_type": self.lr_schedule_type != "step"}
        for name, set_ in unported.items():
            if set_:
                raise NotImplementedError(
                    f"{name}={getattr(self, name)!r} is queued in ROADMAP.md; no published "
                    "config sets it and this port trains with im_enc_rate 1, no wlh "
                    "finetuning, no gradient clipping and the step schedule")


@dataclasses.dataclass
class TrainBatch:
    """One training batch, objects along axis 0. xyz/viewdir are compact
    (B, R, 3) rays (diagonal-normalised origin, unit direction) or expanded
    (B, R, S, 3) points and per-sample directions."""

    img_in: torch.Tensor      # (B, S_in, S_in, 3)
    xyz: torch.Tensor
    viewdir: torch.Tensor
    z_vals: torch.Tensor      # (B, S)
    rgb_tgt: torch.Tensor     # (B, R, 3)
    occ_pixels: torch.Tensor  # (B, R, 1)
    src_pose: torch.Tensor    # (B, 3, 4) refiner source pose
    tgt_uv: torch.Tensor      # (B, 2, 8) projected ground-truth corners
    tgt_uv_aug: torch.Tensor  # (B, 2, 8)
    wlh: torch.Tensor         # (B, 3)
    wlh_aug: torch.Tensor     # (B, 3)
    roi: torch.Tensor         # (B, 4)
    K: torch.Tensor           # (B, 3, 3)
    code_idx: torch.Tensor    # (B,) int64 row of the code tables

    @classmethod
    def from_numpy(cls, arrays: dict, device):
        return cls(**{f.name: torch.as_tensor(
            arrays[f.name], dtype=torch.int64 if f.name == "code_idx" else torch.float32
        ).to(device) for f in dataclasses.fields(cls)})


@dataclasses.dataclass
class TrainState:
    """The model (parameters and BatchNorm buffers), the dense code tables,
    one AdamW for the model and one for the tables, the instances trained so
    far and the step count."""

    model: torch.nn.Module
    shape_codes: torch.Tensor     # (N_instances, latent)
    texture_codes: torch.Tensor   # (N_instances, latent)
    opt_model: AdamW
    opt_codes: AdamW
    optimized_idx: torch.Tensor   # (N_instances,) 1.0 once trained
    niter: int = 0


def make_code_table(n_instances: int, latent_dim: int, generator: torch.Generator):
    """randn / sqrt(latent / 2) (reference make_codes :437-447)."""
    return torch.randn((n_instances, latent_dim), generator=generator) / math.sqrt(latent_dim / 2)


def init_train_state(model, n_instances: int, cfg: TrainConfig, device,
                     seed: int = 0) -> TrainState:
    """State around an initialised model (moved to `device`): code tables
    drawn from `seed`, fresh optimizers."""
    model = model.to(device)
    g = torch.Generator().manual_seed(seed)
    sc, tc = (make_code_table(n_instances, cfg.latent_dim, g).to(device) for _ in range(2))
    params = list(model.parameters())
    return TrainState(
        model=model, shape_codes=sc, texture_codes=tc,
        opt_model=AdamW(params, [cfg.lr_model] * len(params), WEIGHT_DECAY),
        opt_codes=AdamW([sc, tc], [cfg.lr_codes] * 2, WEIGHT_DECAY),
        optimized_idx=torch.zeros(n_instances, device=device))


def step_scale(count: int, interval: int) -> float:
    """The step schedule's factor 2^-(count // interval) at the optimizer's
    count before the update (optax evaluates the schedule there)."""
    return 2.0 ** -(count // interval)


def expand_compact_rays(batch: TrainBatch) -> TrainBatch:
    """Points (B, R, S, 3) = origin + direction * z / diag from compact rays,
    and per-ray directions (B, R, 3); an expanded batch keeps its points and
    takes each ray's first direction (constant along the ray)."""
    if batch.xyz.dim() == 4:
        return dataclasses.replace(batch, viewdir=batch.viewdir[:, :, 0].contiguous())
    diag = torch.linalg.norm(batch.wlh, dim=-1)
    scale = batch.z_vals / diag[:, None]
    xyz = batch.xyz[:, :, None, :] + batch.viewdir[:, :, None, :] * scale[:, None, :, None]
    return dataclasses.replace(batch, xyz=xyz.contiguous())


def pose_regress_step(model, posecode, src_pose, tgt_uv, wlh, roi, K):
    """One unrolled refiner iteration (reference pose_regress :150-195).
    Returns (per-corner distance (B, 8), pred_pose (B, 3, 4)). The source
    pose is detached for the corner projection that feeds the refiner only;
    the composition keeps its gradient (iteration k+1 reaches iteration k)."""
    src_uv = view_points(corners_of_box(src_pose.detach(), wlh), K)
    src_uv_norm, dim = normalize_by_roi(src_uv[:, :2], roi)
    delta = model.pose_update(posecode, src_uv_norm.reshape(len(src_pose), -1))
    pred_pose = compose_pose_delta(src_pose, delta, dim, K, torch.linalg.inv(K))
    pred_uv = view_points(corners_of_box(pred_pose, wlh), K)
    # eps inside the sqrt bounds its gradient where corners match exactly
    loss = torch.sqrt(torch.sum((pred_uv[:, :2] - tgt_uv) ** 2, dim=-2) + 1e-8)
    return loss, pred_pose


def unified_loss(model, batch: TrainBatch, code_rows, cfg: TrainConfig, phase=None):
    """The full SUP-NeRF training loss of an expanded batch; code_rows =
    (shape rows, texture rows) of the tables for batch.code_idx. The
    encoder's BatchNorm buffers move. Returns (loss_total, losses dict of
    0-d tensors)."""
    phase = phase or (lambda name: contextlib.nullcontext())
    sc_tbl, tc_tbl = code_rows
    # im_enc_rate 1: the encoder is active on every step (the JAX step's
    # uniform() < 1), so its terms are always added and its codes averaged in
    with batch_stat_updates(model):
        sc_enc, tc_enc, posecode, uv_direct, _ = model.encode_img(batch.img_in)
    losses = {}

    # direct box-corner regression, ROI-normalised corners back to pixels
    uv_direct = uv_direct.reshape(-1, 2, 8)
    roi = batch.roi
    dim = torch.maximum(roi[:, 2] - roi[:, 0], roi[:, 3] - roi[:, 1])
    centre = torch.stack([(roi[:, 0] + roi[:, 2]) / 2, (roi[:, 1] + roi[:, 3]) / 2], -1)
    uv_img = uv_direct * (dim[:, None, None] / 2) + centre[:, :, None]
    loss_uv = torch.sqrt(torch.sum((uv_img - batch.tgt_uv) ** 2, dim=-2) + 1e-8)
    losses["loss_pose_direct"] = loss_uv.mean()
    loss_total = cfg.loss_pose_coef * losses["loss_pose_direct"]

    losses["loss_code"] = torch.mean((sc_enc - sc_tbl) ** 2 + (tc_enc - tc_tbl) ** 2)
    shapecode, texturecode = (sc_tbl + sc_enc) / 2, (tc_tbl + tc_enc) / 2

    pose, pose_losses = batch.src_pose, []
    for _ in range(3):
        l_k, pose = pose_regress_step(model, posecode, pose, batch.tgt_uv_aug, batch.wlh_aug,
                                      roi, batch.K)
        pose_losses.append(l_k.mean())
    for k, v in enumerate(pose_losses, 1):
        losses[f"loss_pose_iter{k}"] = v
    loss_total = loss_total + cfg.loss_pose_coef * (sum(pose_losses) / 3)

    with phase("render"):
        rgb, _, acc = field_composite_train(model, batch.xyz, batch.viewdir, batch.z_vals,
                                            shapecode, texturecode, data_grads=False)
    loss_rgb = rgb_loss_masked(rgb, batch.rgb_tgt, batch.occ_pixels, dim=(-2, -1))
    losses["loss_rgb"] = loss_rgb.mean()
    losses["psnr"] = -10.0 * torch.log10(loss_rgb.mean())
    losses["loss_occ"] = occupancy_loss(acc, batch.occ_pixels, dim=(-2, -1)).mean()
    losses["loss_reg"] = torch.mean(torch.linalg.norm(shapecode, dim=-1)
                                    + torch.linalg.norm(texturecode, dim=-1))
    loss_total = loss_total + losses["loss_rgb"] + cfg.loss_occ_coef * losses["loss_occ"]
    losses["loss_total"] = loss_total
    losses["enc_active"] = torch.ones((), device=rgb.device)
    return loss_total, losses


def train_step(state: TrainState, batch: TrainBatch, cfg: TrainConfig, timer=None) -> dict:
    """One optimisation step in place on `state`; returns the metrics
    (METRIC_NAMES) as floats. timer: optional timing.PhaseTimer, charged
    forward (with the render nested in it as "render"), backward, optimizer."""
    phase = timer.phase if timer is not None else (lambda name: contextlib.nullcontext())
    model = state.model
    with phase("forward"):
        batch = expand_compact_rays(batch)
        idx = batch.code_idx
        rows = [t[idx].detach().requires_grad_(True)
                for t in (state.shape_codes, state.texture_codes)]
        loss, losses = unified_loss(model, batch, rows, cfg, phase)
    with phase("backward"):
        params = list(model.parameters())
        grads = torch.autograd.grad(loss, params + rows, allow_unused=True,
                                    materialize_grads=True)
    with phase("optimizer"):
        g_tables = [torch.zeros_like(t).index_add_(0, idx, g)
                    for t, g in zip((state.shape_codes, state.texture_codes), grads[-2:])]
        state.opt_model.step(grads[:-2], step_scale(state.opt_model.count, cfg.lr_interval_model))
        state.opt_codes.step(g_tables, step_scale(state.opt_codes.count, cfg.lr_interval_codes))
        state.optimized_idx[idx] = 1.0
        state.niter += 1
        values = torch.stack([losses[k].detach().float() for k in METRIC_NAMES]).tolist()
    return dict(zip(METRIC_NAMES, values))
