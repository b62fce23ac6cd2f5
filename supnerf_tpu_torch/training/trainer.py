"""The training loop and its bookkeeping; the port of
supnerf_tpu/training/trainer.py's UnifiedTrainer in its unified (SUP-NeRF)
and NeRF-only (the AutoRF, AutoRFMix and CodeNeRF baselines) modes
(reference trainer_unified_nuscenes.py TrainerUnifiedNuscenes,
trainer_nerf_nuscenes.py TrainerNerfNuscenes): the per-instance code
tables, an epoch loop over shuffled batches, host prep with the
augmentations (aug_box2d, aug_wlh, the config's sym_aug and render_sz),
metrics, per-epoch checkpoints in the reference's schema for every arch,
and resume.

Per row, all randomness derives from (seed, epoch, dataset index) as in the
JAX trainer (trainer.py:273, :351): one numpy stream draws, in this order,
the aug_box2d scale and shift, the seed of a mode-2 random source pose
(geometry/poses.get_random_pose2, trans_lim 0.3, on a torch.Generator
seeded by it; datasets with injected pose errors give theirs), the ray
ids, the depth jitter, the sym_aug coin and the aug_wlh factors. The
epoch's order is a permutation drawn from (seed, epoch), so a run resumed
from a checkpoint sees the batches the uninterrupted run saw (the JAX
trainer draws it from one stream that a resume restarts). Whether a step
uses the encoder (im_enc_rate) is drawn from (seed, epoch, step).

The epoch's batches come from prepare_batch_arrays (training/pixel_prep.py:
work bounded per row, the whole batch's rays at once), or, with render_sz
set, from the per-row prep (prepare_row), as in the JAX trainer. With
num_workers > 0 a producer thread prepares them ahead of the step
(training/prefetch.py; the per-row prep on a pool of num_workers threads)
and copies each to the card from pinned memory on a stream of its own,
waiting there for the copy to end, so the step takes only whole batches
and the copy overlaps the previous step; num_workers 0 prepares each batch
on the main thread before its step and copies it there. Both give the
same batches in the same order. 0 is the default: the producer's prep
shares the interpreter lock with the step's launches, so the step's
forward runs longer beside it, and on an H100 the threaded loop ran 6-23 %
slower at batch 8 and within 3 % at batch 48
(supnerf_tpu_torch/bench/train_loop_ab.py, 20 steps a run, A B B A).
Each step records its host split by the JAX trainer's names:
producer_prep, producer_upload (of its batch, wherever it was made) and
main_wait_batch (the main thread's wait for it).

Each step's scalars and, every check_iter steps, a [render | target] panel
of the epoch's first sample go to the log sink RunLog, <save_dir>/runs/
(the JAX trainer writes them to tensorboardX, which the card's machine
lacks); log_writer=False turns it off. A failed panel raises (the JAX
trainer prints it and goes on).

Data parallelism (group, a parallel.Group; the JAX trainer's mesh,
trainer.py:159, :173-174, :539-540, :713-714): every rank holds the same
state, and after every step the state a one-card run of the same global
batch reaches. Each rank draws the epoch order and the encoder gate as
every other and prepares its rows [r B / N, (r + 1) B / N) of each global
batch by the per-row streams above, so the rows are a one-card run's; the
step (train_step.train_step) takes BatchNorm's statistics and the
gradients over all ranks. The metrics are the global batch's. Rank 0
alone writes hpam.json, the checkpoints and the log; every rank loads a
resume.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np
import torch

from supnerf_tpu_torch.geometry.poses import get_random_pose2
from supnerf_tpu_torch.geometry.roi import (
    crop_and_whiten,
    resize_bilinear_np,
    roi_process,
    roi_resize,
)
from supnerf_tpu_torch.parallel.mesh import is_main, row_slice
from supnerf_tpu_torch.render.renderer import render_full_image
from supnerf_tpu_torch.timing import PhaseTimer
from supnerf_tpu_torch.training import pixel_prep as pp
from supnerf_tpu_torch.training.checkpoints import restore_checkpoint, save_checkpoint
from supnerf_tpu_torch.training.prefetch import PrefetchBatcher
from supnerf_tpu_torch.training.ray_prep import prepare_train_sample, project_box_corners
from supnerf_tpu_torch.training.train_step import (  # noqa: F401 (METRIC_NAMES re-exported)
    LOSSES,
    METRIC_NAMES,
    TrainBatch,
    TrainConfig,
    init_train_state,
    metric_names,
    train_step,
)
from supnerf_tpu_torch.tto.core import make_composite, render_decoder
from supnerf_tpu_torch.utils.image_io import write_png

# side of the training panel's render (the JAX trainer's _log_vis)
PANEL_SZ = 64
# the fourth seed word of the encoder gate's stream (seed, epoch, step, it),
# apart from the rows' (seed, epoch, index) streams
ENC_STREAM = 1


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


def train_config_from_hpams(hpams: dict, im_enc_rate: float = 1.0,
                            finetune_wlh: bool = False) -> TrainConfig:
    """The step's TrainConfig from the config json: the JAX trainer's keys,
    and the optimizer's options grad_clip, lr_schedule_type and
    cosine_total_steps, which the JAX trainer leaves at TrainConfig's
    defaults (no published config sets them; ROADMAP C.19)."""
    lr = hpams.get("lr_schedule", [{"lr": 1e-4, "interval": 40000}] * 2)
    defaults = TrainConfig()
    return TrainConfig(
        lr_model=lr[0]["lr"], lr_codes=lr[1]["lr"],
        lr_interval_model=lr[0]["interval"], lr_interval_codes=lr[1]["interval"],
        loss_occ_coef=hpams.get("loss_occ_coef", 0.1),
        loss_code_coef=hpams.get("loss_code_coef", 0.1),
        loss_pose_coef=hpams.get("loss_pose_coef", 0.01),
        loss_wlh_coef=hpams.get("loss_wlh_coef", 1.0),
        im_enc_rate=im_enc_rate, finetune_wlh=finetune_wlh,
        latent_dim=hpams.get("net_hyperparams", {}).get("latent_dim", 256),
        **{k: hpams.get(k, getattr(defaults, k))
           for k in ("grad_clip", "lr_schedule_type", "cosine_total_steps")},
    )


class UnifiedTrainer:
    """Joint pose + NeRF trainer (loss_mode "unified", SUP-NeRF) or NeRF-only
    trainer (loss_mode "nerf_only", the baselines). model: an initialised
    model of models/factory.py; dataset: indexable, returning the sample
    dicts of data.synthetic with an 'instoken' key for the code-table row.
    aug_box2d / aug_wlh: the JAX trainer's augmentations; finetune_wlh
    trains the encoder's wlh head (a pred_wlh net). log_writer: None for
    the RunLog under save_dir/runs, False for none. group: a
    parallel.Group to train on with its other ranks (batch_size is the
    global batch, which its world size must divide), or None."""

    def __init__(self, model, hpams: dict, dataset, save_dir: str, *, device,
                 batch_size: int = 8, loss_mode: str = "unified", im_enc_rate: float = 1.0,
                 aug_wlh: bool = False, aug_box2d: bool = False, finetune_wlh: bool = False,
                 seed: int = 0, check_iter: int = 1000, save_every: int = 1,
                 log_writer: bool | None = None, group=None):
        if log_writer not in (None, False):
            raise ValueError("log_writer: None (the runs/ directory) or False (no log)")
        if loss_mode not in LOSSES:
            raise ValueError(f"loss_mode {loss_mode!r}: one of {sorted(LOSSES)}")
        if (loss_mode == "unified") != hasattr(model, "pose_update"):
            raise ValueError(f"loss_mode {loss_mode!r} cannot train {type(model).__name__}: the "
                             "unified loss trains SUP-NeRF's refiner, the NeRF-only loss the "
                             "baselines, which have none")
        if finetune_wlh and not getattr(model, "pred_wlh", False):
            raise ValueError(f"finetune_wlh trains the encoder's wlh head: {type(model).__name__} "
                             "has none (pred_wlh 0)")
        if group is not None and batch_size % group.world:
            raise ValueError(f"batch_size {batch_size} does not split over {group.world} ranks")
        self.group, self.main = group, is_main(group)
        self.hpams, self.dataset, self.save_dir = hpams, dataset, save_dir
        self.device = torch.device(device)
        self.batch_size, self.seed, self.loss_mode = batch_size, seed, loss_mode
        self.aug_wlh, self.aug_box2d = bool(aug_wlh), bool(aug_box2d)
        self.check_iter, self.save_every = check_iter, max(int(save_every), 1)
        self.cfg = train_config_from_hpams(hpams, im_enc_rate, finetune_wlh)
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
        # the host split, summed over the run (each step's is in its record)
        self.host_seconds = {}
        self._copy_stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self.metrics_history = []
        self.log = None
        if self.main:
            os.makedirs(save_dir, exist_ok=True)
            with open(os.path.join(save_dir, "hpam.json"), "w") as f:
                json.dump(dict(hpams, model_dir=save_dir), f, indent=2)
            if log_writer is not False:
                self.log = RunLog(os.path.join(save_dir, "runs"))

    def _instoken(self, i):
        s = self.dataset[i]
        return s.get("instoken", str(i)) if isinstance(s, dict) else str(i)

    def _code_idx(self, s, idx) -> int:
        return self.instoken2idx[s.get("instoken", str(int(idx)))]

    # -- data ----------------------------------------------------------------
    def _row_front(self, idx: int, rng):
        """The row's sample (with aug_box2d: its 2D box scaled about its
        centre by U(0.9, 1.1), then shifted by one U(-5, 5) on all four
        coordinates and truncated to integers, reference
        data_nuscenes.py:620-626) and the refiner's source pose: the
        dataset's injected-error pose in pose-error modes 1 and 3, else a
        random pose from a seed drawn here. Returns (sample, src_pose)."""
        s = self.dataset[idx]
        if self.aug_box2d:
            roi = np.asarray(roi_resize(s["rois"], rng.uniform(0.9, 1.1)))
            s = dict(s, rois=(roi + rng.uniform(-5, 5)).astype(np.int32))
        if getattr(self.dataset, "add_pose_err", None) in (1, 3) and "obj_poses_w_err" in s:
            return s, np.asarray(s["obj_poses_w_err"], np.float32)
        g = torch.Generator().manual_seed(int(rng.integers(0, 2 ** 31)))
        K = torch.as_tensor(np.asarray(s["cam_intrinsics"], np.float32))[None]
        roi = torch.as_tensor(np.asarray(s["rois"], np.float32))[None]
        return s, get_random_pose2(K, roi, g, trans_lim=0.3)[0].numpy()

    def _wlh_factors(self, rng):
        """aug_wlh's factors: U(0.9, 1.1) on w and l, h keeping the volume."""
        fac = rng.uniform(0.9, 1.1, 3).astype(np.float32)
        fac[2] = 1.0 / (fac[0] * fac[1])
        return fac

    def prepare_row(self, idx: int, salt: int) -> dict:
        """One TrainBatch row (numpy dict) by the per-row prep
        (ray_prep.prepare_train_sample), its randomness from
        np.random.default_rng((seed, salt, idx))."""
        hp = self.hpams
        rng = np.random.default_rng((self.seed, salt, int(idx)))
        s, src = self._row_front(int(idx), rng)
        pose, K = (np.asarray(s[k], np.float32)[None] for k in ("obj_poses", "cam_intrinsics"))
        row = prepare_train_sample(
            s, n_rays=hp.get("n_rays", 1024), n_samples=hp.get("n_samples", 64),
            in_img_sz=hp.get("in_img_sz", 128), roi_margin=hp.get("roi_margin", 5),
            shapenet_obj_cood=bool(hp.get("shapenet_obj_cood", 1)),
            sym_aug=bool(hp.get("sym_aug", 0)), rng=rng, render_sz=hp.get("render_sz"),
            src_pose=src, code_idx=self._code_idx(s, idx), compact_rays=True,
            tgt_uv=project_box_corners(pose, np.asarray(s["wlh"], np.float32)[None], K)[0])
        if self.aug_wlh:
            row["wlh_aug"] = row["wlh"] * self._wlh_factors(rng)
            row["tgt_uv_aug"] = project_box_corners(pose, row["wlh_aug"][None], K)[0]
        return row

    def prepare_batch_arrays(self, idxs, salt: int) -> dict:
        """One batch as stacked (B, ...) numpy arrays, the port of the JAX
        trainer's _prepare_batch_arrays: each row's stream as prepare_row's,
        the encoder input by pixel_prep.resize_masked_from_full, the rays of
        the whole batch in one pixel_prep.batched_train_rays. With render_sz
        set (a resampled ray grid) the rows of prepare_row, stacked."""
        hp = self.hpams
        if hp.get("render_sz") is not None:
            rows = [self.prepare_row(i, salt) for i in idxs]
            return {k: np.stack([r[k] for r in rows]) for k in rows[0]}
        n_rays, n_samples = hp.get("n_rays", 1024), hp.get("n_samples", 64)
        in_img_sz, roi_margin = hp.get("in_img_sz", 128), hp.get("roi_margin", 5)
        sym_aug = bool(hp.get("sym_aug", 0))

        rngs = [np.random.default_rng((self.seed, salt, int(i))) for i in idxs]
        fronts = [self._row_front(int(i), r) for i, r in zip(idxs, rngs)]
        B = len(fronts)
        rois = np.empty((B, 4), np.int64)
        idss = np.empty((B, n_rays), np.int64)
        zjs = np.empty((B, n_samples), np.float64)
        flips = np.zeros(B, bool)
        img_ins = np.empty((B, in_img_sz, in_img_sz, 3), np.float32)
        wlh_facs = np.empty((B, 3), np.float32)
        # each row's draws in prepare_pixel_samples' order: ids, depth jitter,
        # flip coin, then the aug_wlh factors
        for b, ((s, _), rng) in enumerate(zip(fronts, rngs)):
            img = np.asarray(s["imgs"], np.float32)
            mask = np.asarray(s["masks_occ"], np.float32)
            roi = roi_process(s["rois"], img.shape[0], img.shape[1], roi_margin, sq_pad=False)
            h, w = int(roi[3] - roi[1]), int(roi[2] - roi[0])
            ids = rng.permutation(h * w)[:n_rays]
            if len(ids) < n_rays:
                ids = np.concatenate([ids, rng.choice(h * w, n_rays - len(ids))])
            zjs[b] = rng.random(n_samples)
            if sym_aug:
                flips[b] = rng.random() > 0.5
            if self.aug_wlh:
                wlh_facs[b] = self._wlh_factors(rng)
            rois[b], idss[b] = roi, ids
            img_ins[b] = pp.resize_masked_from_full(img, mask, roi,
                                                    pp.square_resize_hw(h, w, in_img_sz),
                                                    in_img_sz)

        def stacked(key):
            return np.stack([np.asarray(s[key], np.float32) for s, _ in fronts])

        Ks, wlhs, poses_gt = stacked("cam_intrinsics"), stacked("wlh"), stacked("obj_poses")
        rays, ys, xs = pp.batched_train_rays(rois, idss, Ks, stacked("cam_poses"), wlhs, zjs,
                                             flips, n_samples,
                                             bool(hp.get("shapenet_obj_cood", 1)))
        rgb_tgt = np.empty((B, n_rays, 3), np.float32)
        occ_pixels = np.empty((B, n_rays, 1), np.float32)
        for b, (s, _) in enumerate(fronts):
            rgb_tgt[b], occ_pixels[b] = pp.gather_targets(s["imgs"], s["masks_occ"], ys[b], xs[b])
        tgt_uv = project_box_corners(poses_gt, wlhs, Ks)
        if self.aug_wlh:
            wlh_aug = wlhs * wlh_facs
            tgt_uv_aug = project_box_corners(poses_gt, wlh_aug, Ks)
        else:
            wlh_aug, tgt_uv_aug = wlhs, tgt_uv
        return {
            "img_in": img_ins, **rays, "rgb_tgt": rgb_tgt, "occ_pixels": occ_pixels,
            "src_pose": np.stack([src for _, src in fronts]).astype(np.float32),
            "tgt_uv": tgt_uv, "tgt_uv_aug": tgt_uv_aug, "wlh": wlhs,
            "wlh_aug": wlh_aug.astype(np.float32), "roi": rois.astype(np.float32), "K": Ks,
            "code_idx": np.asarray([self._code_idx(s, i) for (s, _), i in zip(fronts, idxs)],
                                   np.int64),
        }

    def _upload(self, arrays: dict, producer: bool) -> TrainBatch:
        """The batch on the device. From the producer thread on the card:
        from pinned memory on the trainer's copy stream, the thread waiting
        for the copy to end, so the batch it hands on is whole; else on the
        current stream."""
        if not producer or self._copy_stream is None:
            return TrainBatch.from_numpy(arrays, self.device)
        with torch.cuda.stream(self._copy_stream):
            batch = TrainBatch.from_numpy(arrays, self.device, pinned=True)
        self._copy_stream.synchronize()
        return batch

    def _collate(self, prepared, prep_seconds: float, producer: bool):
        """(batch on the device, its host split) from a prepared batch: the
        arrays of prepare_batch_arrays or a list of prepare_row's rows."""
        t0 = time.perf_counter()
        if isinstance(prepared, list):
            prepared = {k: np.stack([r[k] for r in prepared]) for k in prepared[0]}
        t1 = time.perf_counter()
        batch = self._upload(prepared, producer)
        return batch, {"producer_prep": prep_seconds + t1 - t0,
                       "producer_upload": time.perf_counter() - t1}

    def _rank_rows(self, order):
        """This rank's rows of each global batch of the epoch's order, in
        order: all of them without a group."""
        if self.group is None:
            return order
        B = self.batch_size
        sl = row_slice(self.group, B)
        return [i for s in range(len(order) // B) for i in order[s * B:(s + 1) * B][sl]]

    def _batches(self, order, salt: int, num_workers: int):
        """The epoch's batches (this rank's share of each) with their host
        split: prepared on the main thread when num_workers is 0, else on
        PrefetchBatcher's producer."""
        order = self._rank_rows(order)
        B = self.batch_size // (self.group.world if self.group is not None else 1)
        if num_workers == 0:
            for s in range(len(order) // B):
                t0 = time.perf_counter()
                arrays = self.prepare_batch_arrays(order[s * B:(s + 1) * B], salt)
                yield self._collate(arrays, time.perf_counter() - t0, producer=False)
            return
        per_row = self.hpams.get("render_sz") is not None
        yield from PrefetchBatcher(
            lambda i: self.prepare_row(i, salt),
            lambda rows, seconds: self._collate(rows, seconds, producer=True), order, B,
            num_workers=num_workers,
            batch_prepare_fn=None if per_row else
            (lambda idxs: self.prepare_batch_arrays(idxs, salt)))

    # -- loop ----------------------------------------------------------------
    def epoch_order(self, nepoch: int) -> np.ndarray:
        return np.random.default_rng((self.seed, nepoch)).permutation(len(self.dataset))

    def encoder_active(self, salt: int, step: int) -> bool:
        """Whether the epoch's step-th step uses the encoder:
        U[0, 1) < im_enc_rate from the stream (seed, salt, step, ENC_STREAM)
        (the JAX step draws it from its PRNG key; ROADMAP C.17)."""
        rng = np.random.default_rng((self.seed, salt, int(step), ENC_STREAM))
        return bool(rng.random() < self.cfg.im_enc_rate)

    def training_epoch(self, num_workers: int = 0):
        """One pass over the dataset in full batches (the remainder is
        dropped), the batches prepared ahead on num_workers threads or, with
        0, before each step; appends each step's metrics, its wall time and
        its phase split to metrics_history and logs them (_log), and every
        check_iter steps the panel of the epoch's first sample
        (_log_vis)."""
        if num_workers < 0:
            raise ValueError("num_workers: 0 (prepare on the main thread) or more")
        order = [int(i) for i in self.epoch_order(self.nepoch)]
        salt = int(self.nepoch) + 1
        batches = self._batches(order, salt, num_workers)
        try:
            for s in range(len(order) // self.batch_size):
                t0, before = time.perf_counter(), dict(self.timer.seconds)
                batch, host = next(batches)
                host["main_wait_batch"] = time.perf_counter() - t0
                if num_workers > 0 and self._copy_stream is not None:
                    # the batch's memory came from the copy stream: keep it
                    # from reuse until this stream's work on it is done
                    for f in dataclasses.fields(batch):
                        getattr(batch, f.name).record_stream(torch.cuda.current_stream())
                metrics = train_step(self.state, batch, self.cfg, self.timer, self.loss_mode,
                                     enc_active=self.encoder_active(salt, s), group=self.group)
                seconds = time.perf_counter() - t0
                self._log(metrics, seconds, self.state.niter)
                for k, v in host.items():
                    self.host_seconds[k] = self.host_seconds.get(k, 0.0) + v
                metrics.update(epoch=self.nepoch, niter=self.state.niter, seconds=seconds,
                               phase_seconds={**{k: v - before.get(k, 0.0)
                                                 for k, v in self.timer.seconds.items()},
                                              **host})
                self.metrics_history.append(metrics)
                if self.main and self.state.niter % self.check_iter == 0:
                    print(f"epoch {self.nepoch} step {self.state.niter}: "
                          f"loss {metrics['loss_total']:.5f} rgb {metrics['loss_rgb']:.5f} "
                          f"occ {metrics['loss_occ']:.5f} psnr {metrics['psnr']:.3f} "
                          f"enc_active {metrics['enc_active']:.0f}", flush=True)
                    self._log_vis(order[0])
        finally:
            batches.close()

    def _log(self, metrics: dict, seconds: float, niter: int):
        """One step's scalars as the JAX trainer's _log names them: the loss
        mode's metrics and time/train, the step's wall time."""
        if self.log is not None:
            scalars = {k: float(metrics[k]) for k in metric_names(self.loss_mode, self.cfg)}
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

    def train(self, epochs: int, num_workers: int = 0):
        while self.nepoch < epochs:
            self.training_epoch(num_workers)
            if self.main and ((self.nepoch + 1) % self.save_every == 0
                              or self.nepoch == epochs - 1):
                save_checkpoint(self.save_dir, self.state, self.nepoch, self.instoken2idx)
            self.nepoch += 1
        return self.state

    # -- checkpoints ---------------------------------------------------------
    def resume_from_epoch(self, save_dir: str, epoch: int | None = None):
        nepoch, self.instoken2idx = restore_checkpoint(save_dir, self.state, epoch)
        self.nepoch = nepoch + 1
