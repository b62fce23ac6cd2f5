"""The training loop and its bookkeeping; the port of
supnerf_tpu/training/trainer.py's UnifiedTrainer in its unified (SUP-NeRF)
mode (reference trainer_unified_nuscenes.py TrainerUnifiedNuscenes): the
per-instance code tables, an epoch loop over shuffled batches, per-row host
prep, metrics, per-epoch checkpoints and resume.

Per row, all randomness derives from (seed, epoch, dataset index) as in the
JAX trainer (trainer.py:273): a numpy stream for the refiner's random source
pose seed and the ray prep's draws, and, for datasets without injected pose
errors, a mode-2 random source pose (geometry/poses.get_random_pose2,
trans_lim 0.3) drawn from a torch.Generator seeded by that stream. The
epoch's order is a permutation drawn from (seed, epoch), so a run resumed
from a checkpoint sees the batches the uninterrupted run saw (the JAX
trainer draws it from one stream that a resume restarts).

A plain per-step loop: the grouped lax.scan dispatch and the threaded
prefetch of the JAX trainer, tensorboard logging and the render panels are
queued in ROADMAP.md.
"""
from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from supnerf_tpu_torch.geometry.poses import get_random_pose2
from supnerf_tpu_torch.timing import PhaseTimer
from supnerf_tpu_torch.training.checkpoints import restore_checkpoint, save_checkpoint
from supnerf_tpu_torch.training.ray_prep import prepare_train_sample, project_box_corners
from supnerf_tpu_torch.training.train_step import (
    TrainBatch,
    TrainConfig,
    init_train_state,
    train_step,
)


def train_config_from_hpams(hpams: dict, im_enc_rate: float = 1.0) -> TrainConfig:
    lr = hpams.get("lr_schedule", [{"lr": 1e-4, "interval": 40000}] * 2)
    return TrainConfig(
        lr_model=lr[0]["lr"], lr_codes=lr[1]["lr"],
        lr_interval_model=lr[0]["interval"], lr_interval_codes=lr[1]["interval"],
        loss_occ_coef=hpams.get("loss_occ_coef", 0.1),
        loss_pose_coef=hpams.get("loss_pose_coef", 0.01),
        im_enc_rate=im_enc_rate,
        latent_dim=hpams.get("net_hyperparams", {}).get("latent_dim", 256),
    )


class UnifiedTrainer:
    """Joint pose + NeRF trainer. model: an initialised SUPNeRF; dataset:
    indexable, returning the sample dicts of data.synthetic with an
    'instoken' key for the code-table row."""

    def __init__(self, model, hpams: dict, dataset, save_dir: str, *, device,
                 batch_size: int = 8, im_enc_rate: float = 1.0, seed: int = 0,
                 check_iter: int = 1000, save_every: int = 1):
        if hpams["arch"] != "supnerf":
            raise NotImplementedError(f"arch {hpams['arch']!r}: the NeRF-only trainer of the "
                                      "baselines is queued in ROADMAP.md")
        if hpams.get("sym_aug", 0) or hpams.get("render_sz") is not None:
            raise NotImplementedError("sym_aug and render_sz are queued in ROADMAP.md; no "
                                      "published config sets them")
        self.hpams, self.dataset, self.save_dir = hpams, dataset, save_dir
        self.device = torch.device(device)
        self.batch_size, self.seed = batch_size, seed
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
        split to metrics_history."""
        order, B = self.epoch_order(self.nepoch), self.batch_size
        salt = int(self.nepoch) + 1
        for s in range(len(order) // B):
            t0, before = time.perf_counter(), dict(self.timer.seconds)
            with self.timer.phase("prep"):
                batch = self.prepare_batch([int(i) for i in order[s * B:(s + 1) * B]], salt)
            metrics = train_step(self.state, batch, self.cfg, self.timer)
            metrics.update(epoch=self.nepoch, niter=self.state.niter,
                           seconds=time.perf_counter() - t0,
                           phase_seconds={k: v - before.get(k, 0.0)
                                          for k, v in self.timer.seconds.items()})
            self.metrics_history.append(metrics)
            if self.state.niter % self.check_iter == 0:
                print(f"epoch {self.nepoch} step {self.state.niter}: "
                      f"loss {metrics['loss_total']:.5f} rgb {metrics['loss_rgb']:.5f} "
                      f"occ {metrics['loss_occ']:.5f} psnr {metrics['psnr']:.3f}", flush=True)

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
