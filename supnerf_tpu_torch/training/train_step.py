"""The training step: the unified SUP-NeRF loss (joint pose + NeRF) or the
NeRF-only loss of the baselines; the port of
supnerf_tpu/training/train_step.py (reference trainer_unified_nuscenes.py:
ParallelModel.forward :27-148, pose_regress :150-195, set_optimizers
:414-421, get_learning_rate :423-429, make_codes :437-447;
trainer_nerf_nuscenes.py ParallelModel.forward :18-66).

One step: the encoder (BatchNorm on batch statistics, running buffers moved
by flax's rule on every step), the direct box-corner loss, three unrolled
refiner iterations, the NeRF branch on the fused training render
(ops/render.py: K1 forward, K3 + K4 backward on the card), one backward
pass, optional gradient clipping, then AdamW on the model and, separately,
on the two dense per-instance code tables.

Loss terms (coefficients from the config json):
  loss_rgb + occ_coef * loss_occ                 always
  + wlh_coef * loss_wlh                          finetune_wlh (a pred_wlh net)
  + pose_coef * direct-UV corner loss            the encoder is active
  + pose_coef * mean(3 unrolled refiner losses)  the encoder is active
  + code_coef * loss_code                        active, and im_enc_rate < 1
When the encoder is active its codes are averaged with the table rows, else
the rows are rendered alone; loss_reg and the terms not added are reported.

The NeRF-only loss (loss_mode "nerf_only": AutoRF, AutoRFMix, CodeNeRF):
when the encoder is active its codes replace the table rows (they are not
averaged) and
  loss_rgb + occ_coef * loss_occ + code_coef * loss_code
with loss_code the encoder's distance from the rows; inactive, or CodeNeRF,
which has no encoder, the rows are rendered and loss_code is 0. Its NeRF
branch runs on the kernels for a kernel-compatible decoder and on the
original AutoRF's plain decoder under autograd otherwise
(ops.render.decoder_kernel_compatible).

enc_active, whether this step uses the encoder, comes from the caller: the
JAX step draws uniform(key) < im_enc_rate from its PRNG, which torch cannot
reproduce, so the trainer draws it from numpy (training/trainer.py) and the
tests feed JAX's value (ROADMAP C.17).

Numerics kept from the JAX step: the code tables are dense and every row's
moments and weight decay move on every step; row gradients are scatter-added
(duplicate instances in a batch add up, in batch order, the same bits on
every run: scatter_rows); gradient clipping is optax's
clip_by_global_norm, on the model's gradients and on the two tables'
separately; each optimizer's learning rate is its schedule (the step
halving lr * 2^-(t // interval) or optax's cosine decay) at the step count
before the update; the refiner's source pose is detached only inside the
corner projection.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import torch

from supnerf_tpu_torch.geometry.boxes import corners_of_box, normalize_by_roi, view_points
from supnerf_tpu_torch.models.layers import batch_stat_updates, global_batch_stats
from supnerf_tpu_torch.ops.render import (
    decoder_composite,
    decoder_kernel_compatible,
    field_composite_train,
)
from supnerf_tpu_torch.ops.volume_render import occupancy_loss, rgb_loss_masked
from supnerf_tpu_torch.optim import AdamW, clip_by_global_norm
from supnerf_tpu_torch.parallel.mesh import all_reduce_flat, all_reduce_sum
from supnerf_tpu_torch.tto.refiner import compose_pose_delta

WEIGHT_DECAY = 0.01
LR_SCHEDULES = ("step", "cosine")
# each loss mode's metrics, in the JAX step's order (sorted names); with
# finetune_wlh the unified loss adds loss_wlh (metric_names)
METRIC_NAMES = {
    "unified": ("enc_active", "loss_code", "loss_occ", "loss_pose_direct", "loss_pose_iter1",
                "loss_pose_iter2", "loss_pose_iter3", "loss_reg", "loss_rgb", "loss_total",
                "psnr"),
    "nerf_only": ("enc_active", "loss_code", "loss_occ", "loss_reg", "loss_rgb", "loss_total",
                  "psnr"),
}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr_model: float = 1e-4
    lr_codes: float = 1e-4
    lr_interval_model: int = 40000
    lr_interval_codes: int = 40000
    loss_occ_coef: float = 0.1
    loss_code_coef: float = 0.1
    loss_pose_coef: float = 0.01
    loss_wlh_coef: float = 1.0
    im_enc_rate: float = 1.0
    finetune_wlh: bool = False
    latent_dim: int = 256
    grad_clip: float = 0.0          # > 0: clip each gradient set's global norm to it
    lr_schedule_type: str = "step"  # "step" (the reference's halving) or "cosine"
    cosine_total_steps: int = 200000

    def __post_init__(self):
        if self.lr_schedule_type not in LR_SCHEDULES:
            raise ValueError(f"lr_schedule_type {self.lr_schedule_type!r}: one of "
                             f"{LR_SCHEDULES}")
        if self.lr_schedule_type == "cosine" and self.cosine_total_steps <= 0:
            raise ValueError("cosine_total_steps: a positive step count")
        if not 0.0 <= self.im_enc_rate <= 1.0:
            raise ValueError(f"im_enc_rate {self.im_enc_rate}: a rate in [0, 1]")


def metric_names(loss_mode: str, cfg: TrainConfig) -> tuple:
    """The step's metrics for loss_mode under cfg, sorted as the JAX step
    packs them."""
    names = METRIC_NAMES[loss_mode]
    if loss_mode == "unified" and cfg.finetune_wlh:
        names = tuple(sorted(names + ("loss_wlh",)))
    return names


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
    def from_numpy(cls, arrays: dict, device, pinned: bool = False):
        """The batch on `device`; pinned: copied from page-locked host
        memory without waiting (on the caller's current stream)."""
        def put(name):
            t = torch.as_tensor(arrays[name],
                                dtype=torch.int64 if name == "code_idx" else torch.float32)
            return (t.pin_memory() if pinned else t).to(device, non_blocking=pinned)

        return cls(**{f.name: put(f.name) for f in dataclasses.fields(cls)})


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
    """The step schedule's factor 2^-(count // interval) at the count before
    the update (optax evaluates the schedule there)."""
    return 2.0 ** -(count // interval)


def cosine_scale(count: int, total_steps: int) -> float:
    """optax.cosine_decay_schedule(1, total_steps) at `count`:
    0.5 (1 + cos(pi min(count, T) / T)), 0 from T on."""
    return 0.5 * (1.0 + math.cos(math.pi * min(count, total_steps) / total_steps))


def lr_scale(cfg: TrainConfig, count: int, interval: int) -> float:
    """The learning-rate factor of cfg's schedule at the step count before
    the update."""
    if cfg.lr_schedule_type == "cosine":
        return cosine_scale(count, cfg.cosine_total_steps)
    return step_scale(count, interval)


def scatter_rows(table, idx, rows):
    """The dense gradient of `table` from the gradients `rows` of its rows
    idx, an instance's rows summed in batch order (JAX's .at[idx].add).
    index_put_ with accumulate sorts the indices on the card and sums each
    run of one row in order, so a batch with repeated instances (nuScenes
    has them) gives the same bits on every run, where index_add_ adds them
    with atomics."""
    return torch.zeros_like(table).index_put_((idx,), rows, accumulate=True)


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


def unified_loss(model, batch: TrainBatch, code_rows, cfg: TrainConfig, enc_active: bool = True,
                 phase=None):
    """The full SUP-NeRF training loss of an expanded batch; code_rows =
    (shape rows, texture rows) of the tables for batch.code_idx. The
    encoder runs and its BatchNorm buffers move whether or not it is
    active. Returns (loss_total, losses dict of 0-d tensors)."""
    phase = phase or (lambda name: contextlib.nullcontext())
    sc_tbl, tc_tbl = code_rows
    with batch_stat_updates(model):
        sc_enc, tc_enc, posecode, uv_direct, wlh_pred = model.encode_img(batch.img_in)
    losses = {}
    loss_total = 0.0

    if cfg.finetune_wlh:
        if wlh_pred is None:
            raise ValueError("finetune_wlh trains the encoder's wlh head: the net has none "
                             "(pred_wlh 0)")
        losses["loss_wlh"] = torch.mean((wlh_pred - batch.wlh) ** 2)
        loss_total = loss_total + cfg.loss_wlh_coef * losses["loss_wlh"]

    # direct box-corner regression, ROI-normalised corners back to pixels
    uv_direct = uv_direct.reshape(-1, 2, 8)
    roi = batch.roi
    dim = torch.maximum(roi[:, 2] - roi[:, 0], roi[:, 3] - roi[:, 1])
    centre = torch.stack([(roi[:, 0] + roi[:, 2]) / 2, (roi[:, 1] + roi[:, 3]) / 2], -1)
    uv_img = uv_direct * (dim[:, None, None] / 2) + centre[:, :, None]
    loss_uv = torch.sqrt(torch.sum((uv_img - batch.tgt_uv) ** 2, dim=-2) + 1e-8)
    losses["loss_pose_direct"] = loss_uv.mean()
    if enc_active:
        loss_total = loss_total + cfg.loss_pose_coef * losses["loss_pose_direct"]

    losses["loss_code"] = torch.mean((sc_enc - sc_tbl) ** 2 + (tc_enc - tc_tbl) ** 2)
    shapecode, texturecode = sc_tbl, tc_tbl
    if enc_active:
        if cfg.im_enc_rate < 1.0:
            loss_total = loss_total + cfg.loss_code_coef * losses["loss_code"]
        shapecode, texturecode = (sc_tbl + sc_enc) / 2, (tc_tbl + tc_enc) / 2

    pose, pose_losses = batch.src_pose, []
    for _ in range(3):
        l_k, pose = pose_regress_step(model, posecode, pose, batch.tgt_uv_aug, batch.wlh_aug,
                                      roi, batch.K)
        pose_losses.append(l_k.mean())
    for k, v in enumerate(pose_losses, 1):
        losses[f"loss_pose_iter{k}"] = v
    if enc_active:
        loss_total = loss_total + cfg.loss_pose_coef * (sum(pose_losses) / 3)

    losses.update(nerf_losses(model, batch, shapecode, texturecode, phase))
    loss_total = loss_total + (losses["loss_rgb"] + cfg.loss_occ_coef * losses["loss_occ"])
    losses["loss_total"] = loss_total
    return loss_total, losses


def nerf_losses(model, batch: TrainBatch, shapecode, texturecode, phase):
    """The NeRF branch of both losses: the training render of the batch's
    rays (ops.render.field_composite_train, K1 and K3 + K4 on the card, for
    a kernel-compatible decoder; ops.render.decoder_composite under autograd
    for the original AutoRF) and its terms loss_rgb, psnr, loss_occ and
    loss_reg."""
    with phase("render"):
        if decoder_kernel_compatible(model):
            rgb, _, acc = field_composite_train(model, batch.xyz, batch.viewdir, batch.z_vals,
                                                shapecode, texturecode, data_grads=False)
        else:
            rgb, _, acc = decoder_composite(model, batch.xyz, batch.viewdir, batch.z_vals,
                                            shapecode, texturecode)
    loss_rgb = rgb_loss_masked(rgb, batch.rgb_tgt, batch.occ_pixels, dim=(-2, -1))
    return {"loss_rgb": loss_rgb.mean(), "psnr": -10.0 * torch.log10(loss_rgb.mean()),
            "loss_occ": occupancy_loss(acc, batch.occ_pixels, dim=(-2, -1)).mean(),
            "loss_reg": torch.mean(torch.linalg.norm(shapecode, dim=-1)
                                   + torch.linalg.norm(texturecode, dim=-1))}


def nerf_only_loss(model, batch: TrainBatch, code_rows, cfg: TrainConfig,
                   enc_active: bool = True, phase=None):
    """The NeRF-only loss of the baselines (JAX nerf_only_loss) of an
    expanded batch; code_rows as unified_loss's. With an encoder (AutoRF,
    AutoRFMix), which runs and moves its BatchNorm buffers on every step,
    the active encoder's codes replace the rows and loss_code, their mean
    squared distance from the rows, is added times loss_code_coef; with the
    encoder inactive, or none (CodeNeRF), the rows are rendered and
    loss_code is 0. Returns (loss_total, losses dict of 0-d tensors)."""
    phase = phase or (lambda name: contextlib.nullcontext())
    sc_tbl, tc_tbl = code_rows
    shapecode, texturecode = sc_tbl, tc_tbl
    loss_code = sc_tbl.new_zeros(())
    if hasattr(model, "encode_img"):
        with batch_stat_updates(model):
            sc_enc, tc_enc = model.encode_img(batch.img_in)
        if enc_active:
            shapecode, texturecode = sc_enc, tc_enc
            loss_code = torch.mean((sc_enc - sc_tbl) ** 2 + (tc_enc - tc_tbl) ** 2)
    losses = nerf_losses(model, batch, shapecode, texturecode, phase)
    losses["loss_code"] = loss_code
    losses["loss_total"] = (losses["loss_rgb"] + cfg.loss_occ_coef * losses["loss_occ"]
                            + cfg.loss_code_coef * loss_code)
    return losses["loss_total"], losses


LOSSES = {"unified": unified_loss, "nerf_only": nerf_only_loss}


def reduce_over_ranks(group, g_model, g_tables, values, trained, names):
    """The data-parallel step's one all-reduce (parallel.all_reduce_flat):
    the rank means of the gradients and of the metrics (with equal shards,
    the global batch's means and their gradients), psnr then from the
    global loss_rgb, and the rows any rank trained."""
    n = len(g_model)
    *grads, values, trained = all_reduce_flat(g_model + g_tables + [values, trained])
    grads = [g / group.world for g in grads]
    values = values / group.world
    if "psnr" in names:
        values[names.index("psnr")] = -10.0 * torch.log10(values[names.index("loss_rgb")])
    return grads[:n], grads[n:], values, trained > 0


def train_step(state: TrainState, batch: TrainBatch, cfg: TrainConfig, timer=None,
               loss_mode: str = "unified", enc_active: bool = True, group=None) -> dict:
    """One optimisation step in place on `state` with the loss of loss_mode
    ("unified" or "nerf_only", LOSSES), the encoder active or not
    (enc_active); returns that mode's metrics (metric_names) as floats,
    enc_active as 1.0 or 0.0. timer: optional timing.PhaseTimer, charged
    forward (with the render nested in it as "render"), backward,
    optimizer (with a group, the all-reduce nested in it as "all_reduce").

    group: a parallel.Group, whose every rank runs this step on its equal
    share of the global batch from the same state: BatchNorm takes the
    global batch's statistics (layers.global_batch_stats), and one
    all-reduce (reduce_over_ranks) gives every rank the global means'
    gradients, of the model and of both code tables, before clipping and
    AdamW, so every rank's state after the step is the same, and the
    global batch's metrics."""
    phase = timer.phase if timer is not None else (lambda name: contextlib.nullcontext())
    model = state.model
    with phase("forward"):
        batch = expand_compact_rays(batch)
        idx = batch.code_idx
        rows = [t[idx].detach().requires_grad_(True)
                for t in (state.shape_codes, state.texture_codes)]
        with (global_batch_stats(model, all_reduce_sum) if group is not None
              else contextlib.nullcontext()):
            loss, losses = LOSSES[loss_mode](model, batch, rows, cfg, bool(enc_active), phase)
        losses["enc_active"] = loss.new_tensor(float(bool(enc_active)))
    with phase("backward"):
        params = list(model.parameters())
        grads = torch.autograd.grad(loss, params + rows, allow_unused=True,
                                    materialize_grads=True)
    with phase("optimizer"):
        names = metric_names(loss_mode, cfg)
        values = torch.stack([losses[k].detach().float() for k in names])
        g_model = list(grads[:-2])
        g_tables = [scatter_rows(t, idx, g)
                    for t, g in zip((state.shape_codes, state.texture_codes), grads[-2:])]
        trained = idx
        if group is not None:
            with phase("all_reduce"):
                hit = torch.zeros_like(state.optimized_idx).index_fill_(0, idx, 1.0)
                g_model, g_tables, values, trained = reduce_over_ranks(
                    group, g_model, g_tables, values, hit, names)
        if cfg.grad_clip > 0:
            g_model = clip_by_global_norm(g_model, cfg.grad_clip)
            g_tables = clip_by_global_norm(g_tables, cfg.grad_clip)
        # the schedule at the step count: equal to the optimizers' counts in a
        # run from step 0, and past them after a resume that started the
        # moments fresh (training/checkpoints.py)
        state.opt_model.step(g_model, lr_scale(cfg, state.niter, cfg.lr_interval_model))
        state.opt_codes.step(g_tables, lr_scale(cfg, state.niter, cfg.lr_interval_codes))
        state.optimized_idx[trained] = 1.0
        state.niter += 1
        values = values.tolist()
    return dict(zip(names, values))
