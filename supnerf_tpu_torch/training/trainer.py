"""The training loop and its bookkeeping; the port of
supnerf_tpu/training/trainer.py's UnifiedTrainer in its unified (SUP-NeRF)
and NeRF-only (the AutoRF, AutoRFMix and CodeNeRF baselines) modes
(reference trainer_unified_nuscenes.py TrainerUnifiedNuscenes,
trainer_nerf_nuscenes.py TrainerNerfNuscenes): the per-instance code
tables, an epoch loop over shuffled batches, per-row host prep, metrics,
per-epoch checkpoints in the reference's schema for every arch, and resume.

Per row, all randomness derives from (seed, epoch, dataset index) as in the
JAX trainer (trainer.py:273): a numpy stream for the refiner's random source
pose seed and the ray prep's draws, and, for datasets without injected pose
errors, a mode-2 random source pose (geometry/poses.get_random_pose2,
trans_lim 0.3) drawn from a torch.Generator seeded by that stream. The
epoch's order is a permutation drawn from (seed, epoch), so a run resumed
from a checkpoint sees the batches the uninterrupted run saw (the JAX
trainer draws it from one stream that a resume restarts).

Each step's scalars and, every check_iter steps, a [render | target] panel
of the epoch's first sample go to the log sink RunLog, <save_dir>/runs/
(the JAX trainer writes them to tensorboardX, which the card's machine
lacks); log_writer=False turns it off. A failed panel raises (the JAX
trainer prints it and goes on).

A plain per-step loop: the grouped lax.scan dispatch and the threaded
prefetch of the JAX trainer are queued in ROADMAP.md.
"""
from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from supnerf_tpu_torch.geometry.poses import get_random_pose2
from supnerf_tpu_torch.geometry.roi import crop_and_whiten, resize_bilinear_np, roi_process
from supnerf_tpu_torch.render.renderer import render_full_image
from supnerf_tpu_torch.timing import PhaseTimer
from supnerf_tpu_torch.training.checkpoints import restore_checkpoint, save_checkpoint
from supnerf_tpu_torch.training.ray_prep import prepare_train_sample, project_box_corners
from supnerf_tpu_torch.training.train_step import (
    LOSSES,
    METRIC_NAMES,
    TrainBatch,
    TrainConfig,
    init_train_state,
    train_step,
)
from supnerf_tpu_torch.tto.core import make_composite, render_decoder
from supnerf_tpu_torch.utils.image_io import write_png

# side of the training panel's render (the JAX trainer's _log_vis)
PANEL_SZ = 64


class RunLog:
    """The training log under run_dir: metrics.jsonl, one JSON object per
    step ({"step": n, then the scalars by the JAX trainer's tensorboard
    names}), and train_panel_{step:07d}.png."""

    def __init__(self, run_dir: str):
        os.makedirs(run_dir, exist_ok=True)
        self.run_dir = run_dir
        self.metrics_path = os.path.join(run_dir, "metrics.jsonl")

    def scalars(self, step: int, scalars: dict):
        with open(self.metrics_path, "a") as f:
            f.write(json.dumps({"step": int(step), **scalars}) + "\n")

    def panel(self, step: int, img):
        write_png(os.path.join(self.run_dir, f"train_panel_{int(step):07d}.png"), img)


def train_config_from_hpams(hpams: dict, im_enc_rate: float = 1.0) -> TrainConfig:
    lr = hpams.get("lr_schedule", [{"lr": 1e-4, "interval": 40000}] * 2)
    return TrainConfig(
        lr_model=lr[0]["lr"], lr_codes=lr[1]["lr"],
        lr_interval_model=lr[0]["interval"], lr_interval_codes=lr[1]["interval"],
        loss_occ_coef=hpams.get("loss_occ_coef", 0.1),
        loss_code_coef=hpams.get("loss_code_coef", 0.1),
        loss_pose_coef=hpams.get("loss_pose_coef", 0.01),
        im_enc_rate=im_enc_rate,
        latent_dim=hpams.get("net_hyperparams", {}).get("latent_dim", 256),
    )


class UnifiedTrainer:
    """Joint pose + NeRF trainer (loss_mode "unified", SUP-NeRF) or NeRF-only
    trainer (loss_mode "nerf_only", the baselines). model: an initialised
    model of models/factory.py; dataset: indexable, returning the sample
    dicts of data.synthetic with an 'instoken' key for the code-table row.
    log_writer: None for the RunLog under save_dir/runs, False for none."""

    def __init__(self, model, hpams: dict, dataset, save_dir: str, *, device,
                 batch_size: int = 8, loss_mode: str = "unified", im_enc_rate: float = 1.0,
                 seed: int = 0, check_iter: int = 1000, save_every: int = 1,
                 log_writer: bool | None = None):
        if log_writer not in (None, False):
            raise ValueError("log_writer: None (the runs/ directory) or False (no log)")
        if hpams.get("sym_aug", 0) or hpams.get("render_sz") is not None:
            raise NotImplementedError("sym_aug and render_sz are queued in ROADMAP.md; no "
                                      "published config sets them")
        if loss_mode not in LOSSES:
            raise ValueError(f"loss_mode {loss_mode!r}: one of {sorted(LOSSES)}")
        if (loss_mode == "unified") != hasattr(model, "pose_update"):
            raise ValueError(f"loss_mode {loss_mode!r} cannot train {type(model).__name__}: the "
                             "unified loss trains SUP-NeRF's refiner, the NeRF-only loss the "
                             "baselines, which have none")
        self.hpams, self.dataset, self.save_dir = hpams, dataset, save_dir
        self.device = torch.device(device)
        self.batch_size, self.seed, self.loss_mode = batch_size, seed, loss_mode
        self.check_iter, self.save_every = check_iter, max(int(save_every), 1)
        self.cfg = train_config_from_hpams(hpams, im_enc_rate)
        self.nepoch = 0
        # the code table's rows: from the curation index where the reader has
        # one (NuScenesData, as the JAX trainer and the reference,
        # trainer_unified_nuscenes.py:239-243), else from the samples
        if hasattr(dataset, "all_valid_samples") and hasattr(dataset, "instoken_per_ann"):
            toks = (dataset.instoken_per_ann.get(ann, ann) for ann, _ in dataset.all_valid_samples)
        else:
            toks = (self._instoken(i) for i in range(len(dataset)))
        self.instoken2idx = {}
        for tok in toks:
            self.instoken2idx.setdefault(tok, len(self.instoken2idx))
        self.state = init_train_state(model, max(len(self.instoken2idx), 1), self.cfg,
                                      self.device, seed)
        self.timer = PhaseTimer(self.device)
        self.metrics_history = []
        os.makedirs(save_dir, exist_ok=True)
        with open(os.path.join(save_dir, "hpam.json"), "w") as f:
            json.dump(dict(hpams, model_dir=save_dir), f, indent=2)
        self.log = None if log_writer is False else RunLog(os.path.join(save_dir, "runs"))

    def _instoken(self, i):
        s = self.dataset[i]
        return s.get("instoken", str(i)) if isinstance(s, dict) else str(i)

    # -- data ----------------------------------------------------------------
    def prepare_batch_rows(self, idxs, salt: int) -> list:
        """One batch of TrainBatch rows (numpy dicts); row i's randomness
        comes from np.random.default_rng((seed, salt, idxs[i]))."""
        hp = self.hpams
        rngs = [np.random.default_rng((self.seed, salt, int(i))) for i in idxs]
        samples = [self.dataset[int(i)] for i in idxs]
        src = []
        for s, rng in zip(samples, rngs):
            if getattr(self.dataset, "add_pose_err", None) in (1, 3) and "obj_poses_w_err" in s:
                src.append(np.asarray(s["obj_poses_w_err"], np.float32))
                continue
            g = torch.Generator().manual_seed(int(rng.integers(0, 2 ** 31)))
            K = torch.as_tensor(np.asarray(s["cam_intrinsics"], np.float32))[None]
            roi = torch.as_tensor(np.asarray(s["rois"], np.float32))[None]
            src.append(get_random_pose2(K, roi, g, trans_lim=0.3)[0].numpy())
        uvs = project_box_corners(*[np.stack([s[k] for s in samples])
                                    for k in ("obj_poses", "wlh", "cam_intrinsics")])
        return [prepare_train_sample(
            s, n_rays=hp.get("n_rays", 1024), n_samples=hp.get("n_samples", 64),
            in_img_sz=hp.get("in_img_sz", 128), roi_margin=hp.get("roi_margin", 5),
            shapenet_obj_cood=bool(hp.get("shapenet_obj_cood", 1)), rng=rng, src_pose=sp,
            code_idx=self.instoken2idx[s.get("instoken", str(int(i)))], compact_rays=True,
            tgt_uv=uv) for s, rng, sp, uv, i in zip(samples, rngs, src, uvs, idxs)]

    def prepare_batch(self, idxs, salt: int) -> TrainBatch:
        rows = self.prepare_batch_rows(idxs, salt)
        return TrainBatch.from_numpy({k: np.stack([r[k] for r in rows]) for k in rows[0]},
                                     self.device)

    # -- loop ----------------------------------------------------------------
    def epoch_order(self, nepoch: int) -> np.ndarray:
        return np.random.default_rng((self.seed, nepoch)).permutation(len(self.dataset))

    def training_epoch(self):
        """One pass over the dataset in full batches (the remainder is
        dropped); appends each step's metrics, its wall time and its phase
        split to metrics_history and logs them (_log), and every check_iter
        steps the panel of the epoch's first sample (_log_vis)."""
        order, B = self.epoch_order(self.nepoch), self.batch_size
        salt = int(self.nepoch) + 1
        for s in range(len(order) // B):
            t0, before = time.perf_counter(), dict(self.timer.seconds)
            with self.timer.phase("prep"):
                batch = self.prepare_batch([int(i) for i in order[s * B:(s + 1) * B]], salt)
            metrics = train_step(self.state, batch, self.cfg, self.timer, self.loss_mode)
            seconds = time.perf_counter() - t0
            self._log(metrics, seconds, self.state.niter)
            metrics.update(epoch=self.nepoch, niter=self.state.niter, seconds=seconds,
                           phase_seconds={k: v - before.get(k, 0.0)
                                          for k, v in self.timer.seconds.items()})
            self.metrics_history.append(metrics)
            if self.state.niter % self.check_iter == 0:
                print(f"epoch {self.nepoch} step {self.state.niter}: "
                      f"loss {metrics['loss_total']:.5f} rgb {metrics['loss_rgb']:.5f} "
                      f"occ {metrics['loss_occ']:.5f} psnr {metrics['psnr']:.3f}", flush=True)
                self._log_vis(int(order[0]))

    def _log(self, metrics: dict, seconds: float, niter: int):
        """One step's scalars as the JAX trainer's _log names them: the loss
        mode's metrics and time/train, the step's wall time."""
        if self.log is not None:
            scalars = {k: float(metrics[k]) for k in METRIC_NAMES[self.loss_mode]}
            self.log.scalars(niter, dict(scalars, **{"time/train": float(seconds)}))

    @torch.no_grad()
    def _log_vis(self, idx: int):
        """The [render | target] panel of dataset[idx] at the current step
        (JAX trainer _log_vis; reference training_epoch :348-385): the
        model's render of its instance's codes at the sample's camera pose,
        a PANEL_SZ square over the square-padded ROI (render_full_image, K1
        for a kernel-compatible decoder on the card), beside the whitened
        crop resized bilinearly."""
        if self.log is None:
            return
        s = self.dataset[idx]
        code = self.instoken2idx[s.get("instoken", str(idx))]
        sc, tc = (t[code:code + 1] for t in (self.state.shape_codes, self.state.texture_codes))
        roi = roi_process(s["rois"], s["imgs"].shape[0], s["imgs"].shape[1],
                          self.hpams.get("roi_margin", 5), sq_pad=True)

        def dev(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=self.device)[None]

        img, _, _ = render_full_image(
            make_composite(render_decoder(self.state.model), sc, tc), dev(s["cam_poses"]),
            dev(s["cam_intrinsics"]), dev(roi), dev(np.linalg.norm(s["wlh"])),
            n_samples=self.hpams.get("n_samples", 64), im_hw=(PANEL_SZ, PANEL_SZ),
            shapenet_obj_cood=bool(self.hpams.get("shapenet_obj_cood", 1)))
        crop, _ = crop_and_whiten(s["imgs"], s["masks_occ"], roi)
        gt = resize_bilinear_np(crop, (PANEL_SZ, PANEL_SZ))
        panel = np.concatenate([np.clip(img[0].cpu().numpy(), 0, 1), gt], axis=1)
        self.log.panel(self.state.niter, (panel * 255).astype(np.uint8))

    def train(self, epochs: int):
        while self.nepoch < epochs:
            self.training_epoch()
            if (self.nepoch + 1) % self.save_every == 0 or self.nepoch == epochs - 1:
                save_checkpoint(self.save_dir, self.state, self.nepoch, self.instoken2idx)
            self.nepoch += 1
        return self.state

    # -- checkpoints ---------------------------------------------------------
    def resume_from_epoch(self, save_dir: str, epoch: int | None = None):
        nepoch, self.instoken2idx = restore_checkpoint(save_dir, self.state, epoch)
        self.nepoch = nepoch + 1
