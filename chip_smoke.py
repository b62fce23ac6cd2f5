#!/usr/bin/env python3
"""On-card smoke test of supnerf_tpu_torch, the PyTorch/CUDA port.

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and nvcc.
Phases, each timed; any failure exits non-zero before the result line:
  1. environment: card name and power limit (nvidia-smi), torch and CUDA;
  2. build: supnerf_tpu_torch/csrc/*.cu, one nvcc per source in parallel,
     with each kernel's registers, shared memory and spills (-Xptxas -v);
  3. kernels: K1 (render_fwd) and K2 (render_bwd) at the TTO path's shapes
     (2 objects, W 256, 1024 rays, 64 samples), K1 again and K3 + K4 (the
     training backward: render_train_bwd_stash, wgrad) at the training
     path's (8 objects), K1 and K2 in their AABB mode (per-ray z, about a
     third of the rays missing their box) at the demo path's (3 objects),
     each against its plain PyTorch version on the same inputs, each error
     beside its tolerance, kernel / plain times beside the card's bound (the
     least time over float32 on the CUDA cores and 3xTF32 on the tensor
     cores, or the bytes' time) and the FMA-only bound; K2 (both modes) and
     K3 + K4 (both modes), here and in the branches, also against a float64
     plain version, a ray at a ReLU kink taken out (take_out_kink_rays; for
     K3 only where its stash shows a gate other than float64's); K2 against
     K3's data mode at the TTO shape with no ray taken out (K2's recompute
     takes K1's gates); K4 twice on one stash, the same bits;
     K5 (field_fwd) and K6 (field_bwd), the per-point field, at the
     regulariser paths' shapes (2 objects x 65,536 points with per-ray
     directions, 2 x 1,200 box-plane samples with directions of ones), K6
     also against a float64 plain version, a point at a ReLU kink taken
     out (take_out_kink_points), and K6's ReLU gates against K5's;
     K3's data mode (A6 with data_grads=True) at the training path's shape,
     its stash, dz_shape, dz_tex and weight gradients bit for bit against
     K3's other mode; at the training field's shape (8 objects x 65,536 points,
     a direction per point) K5 on per-object latents (A9), K7
     (field_train_bwd, A10; against K6 too, with no point taken out: the
     same bits, since K7 runs K6's arithmetic; K6's and K7's ReLU gates
     against K5's, the same words; its weight gradients against the float64
     plain version) and K4 on K7's stash;
     K1 and K2 at the TTO shape, and K1, K3 (both modes) and K4 at the
     training shape, again on CodeNeRF's decoder (2 shape blocks and 1
     texture block: another stash row and K4 problem list), with the same
     tolerances and kink rules;
     then the branches no path takes (white background, S < 64, odd R,
     W 64/128, several stash chunks), in both modes of K1 and K2 and of K3,
     K4 on each branch's stash, and for K5/K6/K7 W 64/128, M not a multiple
     of 64, directions that differ within a block and several stash chunks;
  4. TTO path: the port's CLI test-time optimization at the published
     config (full width, 100 iterations) on 2 synthetic objects, with the
     launch counts, the final metrics and the result file;
  5. training path: the port's CLI training at the published config on 16
     synthetic objects, batch 8, 2 epochs (4 steps), each batch prepared
     on the main thread before its step (--num_workers 0, the default),
     with the launch counts, finite losses, the checkpoints, a resume from
     epoch 0 that repeats step 3's loss, steps/s and the host split
     (producer_prep, producer_upload, main_wait_batch), and the TTO loader
     strict-loading the result;
  6. demo path: the port's demo CLI at hpam_demo.json (full width, 100
     iterations of AABB-bounded TTO on 3 objects of a 900 x 1600 synthetic
     scene, then six composed frames), with the launch counts, finite
     curves and frames, and input.png and the frames decoded by read_png;
  7. regulariser paths at the published config on 2 synthetic objects, 100
     iterations: (a) the CLI with "obj_sz_reg": 1 and "sym_aug": 1 in a copy
     of the config (the object-size loss on K5/K6, the loss render on
     K1/K2), (b) run_tto_batch with sym_loss_coef 1.0 as well (the loss
     render and its mirror on K5/K6 at 65,536 points per object), each with
     its launch counts, finite curves and final metrics;
  8. training-kernel paths at the published config's width and the batch of
     scripts/sweep_train_render_tiles.py and sweep_train_tiles.py (48 objects
     x 1024 rays x 64 samples): field_composite_train at its default
     data_grads=True (K1, K3's data mode, K4) and field_train (K5, K7, K4),
     each with a loss head whose gradient reaches the decoder, the codes and
     the data, its launch counts, its forward's outputs against the forward
     kernel's plain version on the same batch-48 inputs, finite gradients
     and one timed forward + backward;
  9. dataset paths at the published configs (full width, 100 iterations) on
     fixtures written here with numpy: (a) the optimize CLI on a nuScenes
     v1.0-mini dataroot in nuScenes' own schema (4 cars of a day log pass
     curation, a night log's car must not; camera images are the committed
     1600 x 900 JPEG), twice, the second run reading the first run's index;
     (b) cli.optimize_kitti on 1242 x 375 KITTI frames with add_pose_err 1
     and 3; (c) cli.optimize_waymo on the Waymo layout; (d) the demo on one
     nuScenes image; each with its curated count, launch counts, host_prep
     share and final metrics, and the host decoders' seconds
     (supnerf_tpu_torch/bench/decode_seconds.py) and the fixture JPEG's
     pinned sha256;
 10. baseline paths through the CLIs, full width, random weights: (a)
     AutoRFMix TTO at autorfmix.nusc.vehicle.car.json on 2 synthetic
     objects, its iterations 0..3 rendering the replayed pose_init (no
     refiner); (b) cli.optimize_kitti at autorfmix.kitti.car.json on a KITTI
     fixture, add_pose_err 1; (c) AutoRFMix training (16 objects, batch 8, 4
     steps, a resume); (d) CodeNeRF at the factory's (2, 1) decoder, TTO on
     2 objects and 4 training steps; (e) the original AutoRF, TTO on 2
     objects and 2 training steps on its plain decoder (no TPU kernel in
     the JAX package), where no kernel may launch; each with its launch
     counts and objects/min or steps/s;
 11. the rest of the TTO driver at the published config on synthetic
     objects, 100 iterations: (a) the optimize CLI on 2 objects once per
     option, --opt_pose 0 --code_level 1, --opt_pose 2 (the PnP
     bootstrap, with how many objects took its translation), a config with
     euler_rot 1 and optimize.opt_cam_pose 1 at --code_level 0, and
     --pred_wlh 2 on a config
     whose net predicts wlh, each with exact launch counts (K1 202, K2 96),
     finite curves and its result file's code_level schema; (b)
     TTODriver.run_multiview on 2 instances x 2 views and the CLI's
     --opt_multiview 1 (K1 200, K2 200: one launch pair an iteration over
     both views); (c) run_multiview_tto with opt_model on 1 instance x 2
     views (K1, K3's data mode and K4 at every iteration; the model given
     unchanged), its first K3 + K4 call held against the plain version in
     float32 and float64 as K3's data-mode check holds it; (d)
     cli.eval_saved_result on (a)'s files, explicitly and in the folder
     convention, cli.evaluate_all on (a)'s tree and the optimize CLI's
     --cross_eval_folder (K1 2), whose printed metric rows must equal the
     optimize runs'.
 12. the visualisation at the published config: (a) K1 against its plain
     version at the full-image render's shape (2 objects x 128 x 128 rays)
     and the virtual views' (8 views x 64 x 64), timed beside its bound;
     (b) the optimize CLI with --vis 1 on 2 synthetic objects, 100
     iterations (K1 206: an option cell's 202 and 4 vis launches; K2 96),
     each object's opt000.png and opt100.png (128 x 384) and virt_final.png
     (128 x 256) decoded by read_png, a finite SSIM in [-1, 1]; (c) --vis 2
     on 1 object, opt000..opt099 (K1 304); (d) cli.train at the training
     cell's shape with --check_iter 2: runs/metrics.jsonl with a finite
     line per step and the panels of steps 2 and 4 (K1 one launch a step
     and one a panel).
 13. the rest of training through cli.train, each cell with exact launch
     counts (K1 one a step, K3 + K4 one pair a stash chunk a step, K3's
     data mode never), finite losses, steps/s and the host split: (a)
     hpam_demo.json with --finetune_wlh 1 --aug_wlh 1 --aug_box2d 1
     --im_enc_rate 0.5 on 16 synthetic objects, batch 8, 2 epochs, with
     loss_wlh on every metrics.jsonl line and each step's loss_total
     recomposed from its terms under its enc_active (both states drawn),
     then a resume from epoch 0 that repeats step 3's loss; (b) AutoRFMix
     at --im_enc_rate 0.5, the same recomposition (loss_code 0 without the
     encoder); (c) a copy of the published config with sym_aug 1,
     render_sz 64, grad_clip 1 and the cosine schedule over 4 steps (the
     CLI's optimizer line checked), the per-row prep on 2 threads; (d) (a)'s epoch 0 resumed
     after its epoch_0_optim.pth is deleted (moments start fresh, said in a
     line); (e) the published config at batch 48 (1024 rays x 64 samples,
     the paper's training batch) on 144 objects, one epoch of 3 steps, with
     --num_workers 4 and 0, whose losses must agree. First, the code
     tables' scatter-add at batch 48 with repeated instances: two calls
     the same bits, the sums against float64's.
 14. the last modules: (a) run_tto_batch at the published widths with the
     BatchNorm2d and with an InstanceNorm2d encoder on one batch (each
     launches exactly K1 200 and K2 96), and the TTO driver's refusal of the
     InstanceNorm config, as JAX's; (b) training through the CLI with the
     InstanceNorm2d config (the training cell's launches); (c)
     run_multiview_tto with opt_model on the original AutoRF (its decoder
     under autograd, no kernel), finite curves and a loss below its start;
     (d) cli.generate_video_vis on a --vis 2 folder (ffmpeg's mp4 where
     there is ffmpeg, else the port's GIF; the GIF writer timed and its
     frames and delays counted either way); (e) the nuScenes reader on the
     phase-9 fixture with debug=True (a panel per sample) and
     dataset_statistics with a visibility table; (f) the TTO cell without
     and with --profile_dir, the trace's render_fwd_kernel and
     render_bwd_kernel events equal to the launch counters over the traced
     span (TTODriver.run: K1 200, K2 96).
 15. data parallelism (supnerf_tpu_torch/parallel/): (a) cli.train
     --devices 1 (a world-size-1 NCCL group) at the published config,
     batch 48, 2 epochs of one step, against the same run without a
     group: the backend, the world size, the collectives (one gradient
     all-reduce a step and its size, BatchNorm's global statistics),
     K1/K3/K4's launches equal to the run's without a group, the first
     step's loss at 5e-5 and the state after it at the CPU test's
     one-process tolerances (whether bit for bit), the free-running end
     state's differences, the all-reduce's ms a step; (b) cli.optimize --devices 1
     on 2 objects: K1/K2 as phase 4's, one gather, the results against the
     run without a group (whether bit for bit); (c) both on 2 ranks against
     1 where torch.cuda.device_count() is 2 or more, else a line saying so.
 16. the pipelined TTO driver (tto/driver.py TTODriver.run: batch i + 1
     prepared in the worker process while batch i runs, batch i - 1
     bookkept after batch i is dispatched) against its serial order (a loop
     of optimize_object_batch), through cli.optimize at the published
     config: (a) phase 9's nuScenes fixture, 4 objects at --batch_size 2,
     add_pose_err 2; (b) 8 synthetic objects at --batch_size 2; each run
     serial, pipelined, pipelined, serial, and (b) once more pipelined with
     --devices 1 (a world-size-1 NCCL group, a gather a batch):
     codes+poses.pkl, its .pth twin and cross_eval.pkl the same bytes in
     every run (the --devices 1 run's codes+poses.pkl the same values, bit
     for bit), K1/K2 launches equal;
     (c) each run's wall time, objects/min, host_prep seconds, the
     worker's start and stop and the main thread's waits for its preps,
     each batch's tto_loop, and the share of the serial prep the pipeline
     hid;
     (d) the decode seconds of the committed progressive 1600 x 900 JPEG
     beside the baseline one, and its pinned sha256 (the baseline's
     pixels).
The line before the last is a JSON object with one record per kernel; the
last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import functools
import io
import json
import os
import pickle
import re
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# Published dense peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet):
# float32 on the CUDA cores, TF32 on the tensor cores, HBM3 bandwidth. A
# float32-accurate product on the tensor cores costs three TF32 products
# (3xTF32, csrc/tf32.cuh), so the least time of the kernels' float32 work is
# the faster of the two routes, and a kernel's bound is that or its bytes'
# time, whichever is longer.
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
TF32_PASSES = 3
PEAK_BYTES_PER_S = 3.35e12

# Tolerances of kernel vs plain version (float32 both; the kernels sum each
# 256-term dot product in another order than torch's matmul): values as in
# tests/test_pallas_render.py; gradients relative to the largest magnitude,
# since dz_shape / dz_tex / dz are sums over 1024 x 64 points per object.
VALUE_ATOL = {"rgb": 3e-4, "depth": 3e-3, "acc": 3e-4, "sigma": 3e-4}
GRAD_RTOL = 1e-3
# K4 against its plain version (cuBLAS SGEMM, TF32 off) on the same stash:
# float32 sums of up to 262,144 products in another order
WGRAD_RTOL = 1e-4
# A resumed run repeats a step's loss: the same weights, batch and kernels
RESUME_RTOL = 1e-5
# A ReLU pre-activation of a point within this fraction of the largest
# pre-activation of its layer (float64), about float32's rounding of a
# 256-term sum, sits at a kink: float32 sums of its terms in two orders (the
# kernel's, cuBLAS's) can put it on either side, and its gate decides a
# whole gradient row of that point.
KINK_RTOL = 1e-6
# The most points the training field's check, or rays a check of K2, may take
# out as at a kink
KINK_MAX_POINTS = 4
TRAIN_OBJECTS, TRAIN_BATCH = 16, 8
# the batch at which scripts/sweep_train_render_tiles.py and
# scripts/sweep_train_tiles.py time the isolated training render and field
SWEEP_BATCH = 48
DEMO_OBJECTS, DEMO_ITERS = 3, 100
REG_OBJECTS, REG_ITERS = 2, 100

def decoder_macs(W, n_shape, n_tex, d_xyz=63):
    """Multiply-adds per point of the decoder (csrc/render_fwd.cu's count)."""
    return (d_xyz * W + n_shape * W * W + W * W + W + W * W + n_tex * W * W
            + W * (W // 2) + (W // 2) * 3)


def transposed_macs(W, n_shape, n_tex, d_xyz=63):
    """Multiply-adds per point of K2's transposed chain (no sigma/rgb heads)."""
    return (W // 2) * W + n_tex * W * W + W * W + W * W + n_shape * W * W + W * d_xyz


def bound(flops, nbytes):
    """The least time (ms) of `flops` float32-accurate operations moving
    `nbytes`: (ms, "operations" or "bytes", the same on the float32 FMA
    route alone)."""
    t_fma = flops / PEAK_F32_FLOPS * 1e3
    t_ops = min(t_fma, TF32_PASSES * flops / PEAK_TF32_FLOPS * 1e3)
    t_mem = nbytes / PEAK_BYTES_PER_S * 1e3
    return (max(t_ops, t_mem), "operations" if t_ops >= t_mem else "bytes", max(t_fma, t_mem))


def record(name, ports, tpu, src, t_k, t_p, err, b, library_ms=None):
    print(f"   {name}: {t_k:.3f} ms (plain {t_p:.3f} ms, bound {b[0]:.3f} ms by {b[1]}, "
          f"FMA-route bound {b[2]:.3f} ms"
          + (f", library {library_ms:.3f} ms" if library_ms is not None else "") + ")")
    return {"name": name, "route": "cuda", "source": src, "replaces": tpu, "ports": ports,
            "launches": 0, "max_abs_err": err, "ms": t_k, "plain_ms": t_p, "bound_ms": b[0],
            "bound_by": b[1], "bound_fma_ms": b[2], "library_ms": library_ms}


def compare(names, got, ref, tol_of):
    """Print each output's max abs error beside its tolerance; returns
    (worst error, all within tolerance and finite)."""
    import torch

    worst, ok = 0.0, True
    for name, a, b in zip(names, got, ref):
        err = float((a - b).abs().max())
        scale = float(b.abs().max())
        tol = tol_of(name, scale)
        good = err <= tol and bool(torch.isfinite(a).all())
        ok &= good
        worst = max(worst, err)
        print(f"   {name:22s} max_abs_err {err:.3e}  tol {tol:.3e}  (max |plain| {scale:.3e})  "
              f"{'ok' if good else 'FAIL'}")
    return worst, ok


def compare_at_kinks(names, got, ref, ref64, rtol, verbose=True):
    """compare() for gradients of a ReLU network, with a float64 evaluation
    of the plain version as a second reference: an element passes if it is
    within rtol * max |plain| of the float32 plain version or of the float64
    one. Where a pre-activation sits within float32 rounding of zero, the
    gate, and with it a gradient row, is decided by the summation order, and
    the float32 plain version can be the one on the wrong side of the kink.
    Prints, per output, both float32 versions' distance from float64 and, at
    the element where kernel and float32 plain version differ most, all
    three values. Returns (worst error against the nearer reference, worst
    error against the float32 plain version, all within tolerance and
    finite). verbose False prints nothing."""
    import torch

    worst, worst32, ok = 0.0, 0.0, True
    for name, a, b, b64 in zip(names, got, ref, ref64):
        scale = float(b.abs().max())
        tol = rtol * scale
        e32 = (a - b).abs()
        e64 = (a.double() - b64).abs()
        near = torch.minimum(e32.double(), e64)
        err, err32 = float(near.max()), float(e32.max())
        i = int(e32.flatten().argmax())
        good = err <= tol and bool(torch.isfinite(a).all())
        ok &= good
        worst, worst32 = max(worst, err), max(worst32, err32)
        if not verbose:
            continue
        print(f"   {name:22s} max_abs_err {err:.3e}  tol {tol:.3e}  (max |plain| {scale:.3e})  "
              f"{'ok' if good else 'FAIL'}\n"
              f"   {'':22s} float32 plain {err32:.3e} ({int((e32 > tol).sum())} elements "
              f"outside tol); from float64: kernel {float(e64.max()):.3e}, float32 plain "
              f"{float((b.double() - b64).abs().max()):.3e}; at the worst element kernel "
              f"{float(a.flatten()[i]):+.6e}, float32 plain {float(b.flatten()[i]):+.6e}, "
              f"float64 {float(b64.flatten()[i]):+.6e}")
    return worst, worst32, ok


def points_outside_both(got, ref, ref64, rtol):
    """(object, point) pairs at which a per-point output (B, M, 3) is
    outside rtol * max |float32 plain| of both the float32 and the float64
    plain version."""
    import torch

    out = set()
    for a, b, b64 in zip(got, ref, ref64):
        err = torch.minimum((a - b).abs().double(), (a.double() - b64).abs())
        out |= {tuple(i[:2].tolist()) for i in (err > rtol * float(b.abs().max())).nonzero()}
    return sorted(out)


def kink_units(wts, args, cot, obj, pt, stash_gates=True):
    """The ReLU units of one point of a per-point field input (xyz, viewdir,
    zs, zt; cotangents cot) whose float64 pre-activation lies within
    KINK_RTOL of its layer's largest magnitude, each as (layer, unit,
    margin, gate in the kernel, in float32 plain, in float64). With
    stash_gates (K7) the kernel's gate is read from K7's stash row of the
    point (the row depends on no other point): its pre-activation gradient
    is zero where the gate is shut; else (K6, which shows no gates) it is
    None."""
    import torch

    from supnerf_tpu_torch.models.nerf_mlp import positional_encoding
    from supnerf_tpu_torch.ops import field, render

    one = ([t[obj:obj + 1, pt:pt + 1].contiguous() for t in args[:2]]
           + [t[obj:obj + 1].contiguous() for t in args[2:]])
    L = render.stash_layout(wts, per_point=True)
    row = None
    if stash_gates:
        row = torch.empty((1, L["ld_pt"]), device="cuda")
        field.field_train_bwd_stash(wts, *one,
                                    *(c[obj:obj + 1, pt:pt + 1].contiguous() for c in cot), row)
    pres = []
    for w in (wts, as_float64(wts)):
        x = [t.to(w.w_xyz.dtype) for t in one]
        with torch.no_grad():
            _, pre, _, _ = render.stashed_chain(
                w, x[0], positional_encoding(x[1], w.num_dir_freq) @ w.w_vd_b, *x[2:])
        pres.append({k: t.detach().flatten() for k, t in pre.items() if k != "e"})
    W = wts.W
    col = {"xyz": L["g_xyz"], "v": L["g_v"], "hh": L["g_hh"],
           **{f"sh{j}": L["g_sh"] + j * W for j in range(wts.n_shape)},
           **{f"tx{j}": L["g_tx"] + j * W for j in range(wts.n_tex)}}
    units = []
    for k, p64 in pres[1].items():
        margin = p64.abs() / p64.abs().max()
        for u in (margin <= KINK_RTOL).nonzero().flatten().tolist():
            units.append((k, u, float(margin[u]),
                          bool(row[0, col[k] + u] != 0) if row is not None else None,
                          bool(pres[0][k][u] > 0), bool(p64[u] > 0)))
    return units


def gate_flips(units):
    """Whether, at one of kink_units' units, the kernel's gate (where it
    shows it; else any such unit counts) or float32 plain's differs from
    float64's."""
    return any(g_k is None or g_k != g64 or g32 != g64 for _, _, _, g_k, g32, g64 in units)


def take_out_kink_points(label, wts, args, evaluate, cot, stash_gates):
    """A per-point field backward (K6, K7) against its float32 and float64
    plain versions. Its sums run in another order than cuBLAS's, so a point
    whose ReLU pre-activation sits within float32 rounding of zero can get
    the other gate than both references. evaluate(cot) gives (kernel,
    float32 plain, float64 plain) outputs, dxyz and dviewdir (B, M, 3)
    first. A point with a dxyz or dviewdir element outside both references
    is taken out (its cotangents zeroed, every output evaluated again, to be
    compared at the unchanged tolerance) only if a unit of it lies within
    KINK_RTOL of zero in float64 where, with stash_gates (K7's stash shows
    its gates), the kernel's or float32 plain's gate differs from
    float64's, and only up to KINK_MAX_POINTS points. Returns (outputs,
    float32 plain's, float64 plain's, the cotangents compared, [(object,
    point)], their kink_units, whether every point taken out is at a
    kink)."""
    got, ref, ref64 = evaluate(cot)
    kinks = points_outside_both(got[:2], ref[:2], ref64[:2], GRAD_RTOL)
    units = [kink_units(wts, args, cot, o, p, stash_gates) for o, p in kinks]
    at_kinks = all(gate_flips(u) for u in units) and len(kinks) <= KINK_MAX_POINTS
    print(f"   {label}: points outside both references: {len(kinks)} (at most "
          f"{KINK_MAX_POINTS} may be taken out)" + "".join(
              f"; object {o} point {p}: "
              + (", ".join(f"{k}[{i}] |pre| / max {m:.2e}, gate "
                           + (f"kernel {int(gk)} " if gk is not None else "")
                           + f"float32 {int(g32)} float64 {int(g64)}"
                           for k, i, m, gk, g32, g64 in u)
                 or "no unit within KINK_RTOL")
              + f" ({'at a kink' if gate_flips(u) else 'NOT at a kink: FAIL'})"
              for (o, p), u in zip(kinks, units)))
    if kinks:
        cot = tuple(c.clone() for c in cot)
        for o, p in kinks:
            for c in cot:
                c[o, p] = 0.0
        del got, ref, ref64
        print("   again with those points' cotangents zero:")
        got, ref, ref64 = evaluate(cot)
    return got, ref, ref64, cot, kinks, units, at_kinks


def ray_kink_units(wts, args, obj, ray, gate=None):
    """The ReLU units of the samples of one ray of K1/K2/K3's inputs (xyz,
    viewdir, z, zs, zt) whose float64 pre-activation lies within KINK_RTOL
    of the largest magnitude of its layer at that sample, each as (sample,
    layer, unit, margin, gate in the kernel, gate in float32 plain, gate in
    float64). The kernel's gate is gate(sample, layer, unit) where the
    kernel shows it (K3's stash), else None."""
    import torch

    from supnerf_tpu_torch.models.nerf_mlp import positional_encoding
    from supnerf_tpu_torch.ops import render

    xyz, vd, _, zs, zt = args
    pres = []
    for w in (wts, as_float64(wts)):
        dt = w.w_xyz.dtype
        x = xyz[obj:obj + 1, ray].to(dt)                                    # (1, S, 3)
        hdir = positional_encoding(vd[obj:obj + 1, ray:ray + 1].to(dt), w.num_dir_freq) @ w.w_vd_b
        with torch.no_grad():
            _, pre, _, _ = render.stashed_chain(w, x, hdir, zs[obj:obj + 1].to(dt),
                                                zt[obj:obj + 1].to(dt))
        pres.append({k: t.detach().reshape(x.shape[1], -1) for k, t in pre.items() if k != "e"})
    units = []
    for k, p64 in pres[1].items():
        margin = p64.abs() / p64.abs().max(dim=1, keepdim=True).values
        for smp, u in (margin <= KINK_RTOL).nonzero().tolist():
            units.append((smp, k, u, float(margin[smp, u]),
                          gate(smp, k, u) if gate is not None else None,
                          bool(pres[0][k][smp, u] > 0), bool(p64[smp, u] > 0)))
    return units


def stash_gate(wts, args, white, cot, obj, ray):
    """K3's gates at one ray, read from the stash rows it writes for that ray
    alone (a block per ray: the same bits as in a launch over all rays):
    gate(sample, layer, unit) is whether the unit's pre-activation gradient
    is nonzero, i.e. its ReLU open."""
    import torch

    from supnerf_tpu_torch.ops import render

    L = render.stash_layout(wts)
    S = args[0].shape[2]
    one = [t[obj:obj + 1, ray:ray + 1].contiguous() for t in (args[0], args[1])]
    pt = torch.empty((S, L["ld_pt"]), device=args[0].device)
    rrow = torch.empty((1, L["ld_ray"]), device=args[0].device)
    render.render_train_bwd_stash(wts, *one, *(t[obj:obj + 1].contiguous() for t in args[2:]),
                                  white, *(c[obj:obj + 1, ray:ray + 1].contiguous() for c in cot),
                                  pt, rrow)
    W = wts.W
    col = {"xyz": L["g_xyz"], "v": L["g_v"], "hh": L["g_hh"],
           **{f"sh{j}": L["g_sh"] + j * W for j in range(wts.n_shape)},
           **{f"tx{j}": L["g_tx"] + j * W for j in range(wts.n_tex)}}
    rows = pt.cpu()
    return lambda smp, k, u: bool(rows[smp, col[k] + u] != 0)


def take_out_kink_rays(label, wts, args, evaluate, cot, names, gate_of=None, verbose=True):
    """A render backward kernel (K2, K3) against its float32 and float64
    plain versions (compare_at_kinks). The kernels sum every dense layer in
    another order than cuBLAS (3xTF32 products on the tensor cores), so a
    sample whose ReLU pre-activation sits within float32 rounding of zero
    can get the other gate than both references, and with it another
    gradient row. evaluate(cot) gives (kernel, float32 plain, float64 plain)
    outputs in `names` order, dxyz (B,R,S,3) and dviewdir (B,R,3) first. A
    ray with a dxyz element (or its dviewdir) outside both references is
    taken out, its cotangents zeroed and every output compared again at the
    unchanged tolerance, only if that sample (for dviewdir: a sample of the
    ray) has a unit within KINK_RTOL of zero in float64, where the kernel
    shows its gates (gate_of(object, ray), K3) only a unit at which the
    kernel's or float32 plain's gate differs from float64's, and only up to
    KINK_MAX_POINTS rays. Returns (outputs, worst error against the nearer
    reference, worst against the float32 plain version, ok, [(object, ray,
    samples, units, at a kink)], the cotangents compared)."""
    import torch

    got, ref, ref64 = evaluate(cot)
    outside = {}
    for k, (a, b, b64) in enumerate(zip(got[:2], ref[:2], ref64[:2])):
        err = torch.minimum((a - b).abs().double(), (a.double() - b64).abs())
        bad = (err > GRAD_RTOL * float(b.abs().max())).any(-1)   # (B, R, S) or (B, R)
        for idx in bad.nonzero().tolist():
            outside.setdefault(tuple(idx[:2]), set()).add(idx[2] if k == 0 else None)

    def counts(u):
        g_k, g32, g64 = u[4:]
        return g_k is None or g_k != g64 or g32 != g64

    kinks = []
    for (o, r), samples in sorted(outside.items()):
        units = ray_kink_units(wts, args, o, r, gate_of(o, r) if gate_of else None)
        found = all(any(counts(u) for u in units if smp is None or u[0] == smp)
                    for smp in samples)
        kinks.append((o, r, sorted(x for x in samples if x is not None), units, found))
    at_kinks = all(k[-1] for k in kinks) and len(kinks) <= KINK_MAX_POINTS

    def describe(smps, units):
        shown = [u for u in units if u[0] in smps or not smps][:4]
        return ", ".join(f"{k}[{u}] at sample {smp} |pre| / max {m:.2e}, gate "
                         + (f"kernel {int(gk)} " if gk is not None else "")
                         + f"float32 {int(g32)} float64 {int(g64)}"
                         for smp, k, u, m, gk, g32, g64 in shown) or "no unit within KINK_RTOL"

    if verbose or kinks:
        print(f"   {label}: rays outside both references: {len(kinks)} (at most "
              f"{KINK_MAX_POINTS} may be taken out)" + "".join(
                  f"; object {o} ray {r} samples {smps}: {describe(smps, units)} "
                  f"({'at a kink' if found else 'NOT at a kink: FAIL'})"
                  for o, r, smps, units, found in kinks))
    if kinks:
        cot = tuple(c.clone() for c in cot)
        for o, r, *_ in kinks:
            for c in cot:
                c[o, r] = 0.0
        del got, ref, ref64
        if verbose:
            print("   again with those rays' cotangents zero:")
        got, ref, ref64 = evaluate(cot)
    err, err32, ok = compare_at_kinks(names, got, ref, ref64, GRAD_RTOL, verbose)
    return got, err, err32, ok and at_kinks, kinks, cot


def render_bwd_at_kinks(wts, args, white, cot, hit=None, verbose=True):
    """K2 against its float32 and float64 plain versions, a ray at a ReLU
    kink taken out (take_out_kink_rays). Returns (outputs, worst error
    against the nearer reference, worst against the float32 plain version,
    ok, kink rays)."""
    import torch

    from supnerf_tpu_torch.ops import render

    def evaluate(cot):
        got = render.render_bwd(wts, *args, white, *cot, hit)
        torch.cuda.synchronize()
        ref = render.render_bwd_plain(wts, *args, white, *cot, hit)
        ref64 = render.render_bwd_plain(as_float64(wts), *(t.double() for t in args), white,
                                        *(t.double() for t in cot), hit)
        return got, ref, ref64

    return take_out_kink_rays("K2", wts, args, evaluate, cot,
                              ("dxyz", "dviewdir", "dz", "dzs", "dzt"), verbose=verbose)[:5]


def train_bwd_at_kinks(wts, args, white, cot, verbose=True):
    """K3 + K4 (render_train_bwd) in both modes against
    render_train_bwd_plain in float32 and float64, with K2's ray carve-out
    (take_out_kink_rays): the rays outside both references are found from
    the data mode's dxyz and dviewdir, the kernel's gates read from K3's
    stash (stash_gate); with them taken out, every output of the data mode
    (dxyz, dviewdir, dz, dzs, dzt and every weight gradient) and of the
    other mode (dzs, dzt, weight gradients) is compared with
    compare_at_kinks at the unchanged GRAD_RTOL. Also whether the two modes
    give the same dzs, dzt and weight-gradient bits on the given
    cotangents. Returns a dict: data (the data mode's outputs), err, err32,
    ok (data mode), off_err, off_err32, off_ok (the other mode), same,
    kinks."""
    import torch

    from supnerf_tpu_torch.ops import render

    names = ["dxyz", "dviewdir", "dz", "dzs", "dzt"] + ["d" + n for n in _linear_param_names(wts)]

    def flat(o, data):
        return ([o[3], o[4], o[5]] if data else []) + [o[0], o[1], *o[2]]

    def evaluate(cot, data=True):
        got = render.render_train_bwd(wts, *args, white, *cot, data_grads=data)
        torch.cuda.synchronize()
        ref = render.render_train_bwd_plain(wts, *args, white, *cot, data_grads=data)
        ref64 = render.render_train_bwd_plain(as_float64(wts), *(t.double() for t in args), white,
                                              *(t.double() for t in cot), data_grads=data)
        return flat(got, data), flat(ref, data), flat(ref64, data)

    shared = [flat(render.render_train_bwd(wts, *args, white, *cot, data_grads=d), False)
              for d in (True, False)]
    same = all(torch.equal(a, b) for a, b in zip(*shared))
    del shared
    got, err, err32, ok, kinks, cot = take_out_kink_rays(
        "K3", wts, args, evaluate, cot, names,
        lambda o, r, c=cot: stash_gate(wts, args, white, c, o, r), verbose)
    off, off_ref, off_ref64 = evaluate(cot, False)
    off_err, off_err32, off_ok = compare_at_kinks(names[3:], off, off_ref, off_ref64, GRAD_RTOL,
                                                  verbose=False)
    del off, off_ref, off_ref64
    if verbose:
        print(f"   K3's other mode on the same cotangents: max_abs_err {off_err:.3e} (float32 "
              f"plain {off_err32:.3e}) over dzs, dzt and every weight gradient, within "
              f"GRAD_RTOL: {'ok' if off_ok else 'FAIL'}; dzs, dzt and every weight gradient "
              f"the same bits in both modes: {'ok' if same else 'FAIL'}")
    return {"data": got, "err": err, "err32": err32, "ok": ok, "off_err": off_err,
            "off_err32": off_err32, "off_ok": off_ok, "same": same, "kinks": kinks}


def kink_rays_record(kinks):
    """take_out_kink_rays' rays as the kernels line lists them: [object, ray,
    samples, units]."""
    return [[o, r, smps, [list(u) for u in units]] for o, r, smps, units, _ in kinks]


def as_float64(wts):
    """A DecoderWeights with every tensor in float64 (the plain versions
    then compute in float64)."""
    import dataclasses

    import torch

    return dataclasses.replace(wts, **{f.name: getattr(wts, f.name).double()
                                       for f in dataclasses.fields(wts)
                                       if isinstance(getattr(wts, f.name), torch.Tensor)})


def phase(name):
    print(f"== {name}", flush=True)
    return time.perf_counter()


def done(t0, name):
    print(f"   {name}: {time.perf_counter() - t0:.2f} s", flush=True)


def environment():
    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


def _kernel_name(mangled):
    """supnerf::name<template args> of a mangled device symbol, roughly."""
    m = re.search(r"7supnerfL?(\d+)", mangled)
    if not m:
        return mangled
    name = mangled[m.end():m.end() + int(m.group(1))]
    rest = mangled[m.end() + int(m.group(1)):]
    args = re.match(r"I((?:L[a-z]+\d+E)+)E", rest)
    if not args:
        return name
    lits = re.findall(r"L([a-z]+)(\d+)E", args.group(1))
    return name + "<" + ", ".join(("true" if v == "1" else "false") if t == "b" else v
                                  for t, v in lits) + ">"


def ptxas_summary(log):
    """One line per function of nvcc's -Xptxas -v log: each kernel with its
    registers, shared memory and spills, and each non-inlined device
    function that spills or is a tensor-core dense layer."""
    out, props = [], {}
    current = None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\w+)", line)
        if m:
            current = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and current:
            props[current] = tuple(int(x) for x in m.groups())
            continue
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            current = m.group(1)
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and current:
            smem = re.search(r"(\d+) bytes smem", line)
            st, ss, sl = props.pop(current, (0, 0, 0))
            out.append(f"kernel {_kernel_name(current)}: {m.group(1)} registers, "
                       f"{smem.group(1) if smem else 0} bytes static smem, stack {st}, "
                       f"spill stores {ss}, spill loads {sl}")
            current = None
    for fn, (st, ss, sl) in props.items():
        if ss or sl or "dense_mma" in fn or "dense_refine" in fn:
            out.append(f"function {_kernel_name(fn)}: stack {st}, spill stores {ss}, "
                       f"spill loads {sl}")
    return out


def build():
    from supnerf_tpu_torch.ops import render

    info = render.build_kernels()
    print(f"   built {info['path'].name} in {info['seconds']:.1f} s")
    for line in ptxas_summary(info["log"]):
        print("   " + line)
    for line in info["log"].splitlines():
        if "error" in line.lower():
            print("   " + line.strip())
    return info


def _timed(fn, n):
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(n):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / n


def published_model(seed):
    """The published config's SUPNeRF (random weights from `seed`) on the card."""
    from supnerf_tpu_torch.models.factory import build_model, init_model

    hp = {"shape_blocks": 3, "texture_blocks": 1, "latent_dim": 256, "pose_shortcut": 1}
    return init_model(build_model("supnerf", hp), seed).cuda()


def kernel_inputs(seed=0, B=2, R=1024, S=64, model=None):
    """Decoder of the published config (random weights from `seed`, or
    `model`'s) and points on rays through an object at ~20 m, as the loss
    render makes them."""
    import torch
    import torch.nn.functional as F

    from supnerf_tpu_torch.ops import render

    wts = render.pack_decoder_params(model if model is not None else published_model(seed))
    g = torch.Generator(device="cuda").manual_seed(seed)
    diag = 5.3
    origin = torch.tensor([0.0, -20.0, 1.0], device="cuda")
    target = (torch.rand((B, R, 3), generator=g, device="cuda") - 0.5) * torch.tensor(
        [4.6, 1.9, 1.7], device="cuda")
    vd = F.normalize(target - origin, dim=-1)
    near, far = 20.0 - diag / 2, 20.0 + diag / 2
    lin = torch.linspace(0, 1, S, device="cuda")
    z = (near + (far - near) * lin + torch.rand((B, S), generator=g, device="cuda")
         * (far - near) / S).contiguous()
    xyz = ((origin + vd[:, :, None, :] * z[:, None, :, None]) / diag).contiguous()
    codes = torch.randn((2, B, 256), generator=g, device="cuda") * 0.3
    zs, zt = render.conditioned_latents(wts, codes[0], codes[1])
    cot = (torch.randn((B, R, 3), generator=g, device="cuda"),
           torch.randn((B, R), generator=g, device="cuda"),
           torch.randn((B, R), generator=g, device="cuda"))
    return wts, (xyz, vd.contiguous(), z, zs.contiguous(), zt.contiguous()), cot


def check_kernel_branches():
    """K1, K2 and K3 + K4 (K3 in both modes) against their plain versions on
    the branches the main paths do not take: white background, fewer than
    64 samples per ray, odd ray counts, W 64 and 128, a stash budget of one
    object (three chunks). Same tolerances: K2 in both modes with the
    float64 arbitration and its kink carve-out (render_bwd_at_kinks), K3 +
    K4 in both modes the same way (train_bwd_at_kinks: every output, the
    weight gradients too; the data mode's weight and latent gradients the
    same bits as the other mode's), K4 on K3's stash against wgrad_plain at
    WGRAD_RTOL; not timed."""
    import torch
    import torch.nn.functional as F

    from supnerf_tpu_torch.models.layers import init_parameters
    from supnerf_tpu_torch.models.nerf_mlp import CodeNeRFDecoder
    from supnerf_tpu_torch.ops import render

    ok = True
    for W, S, R, white in ((64, 8, 19, True), (128, 33, 7, False), (256, 64, 5, True)):
        g = torch.Generator().manual_seed(W + S)
        hit = torch.rand((3, R), generator=g) > 0.3
        hit[:, 0] = False                       # at least one missed ray per object
        dec = CodeNeRFDecoder(3, 1, W, W)
        init_parameters(dec, g)
        wts = render.pack_decoder_params(dec.cuda())
        vd = F.normalize(torch.randn((3, R, 3), generator=g), dim=-1)
        z = torch.sort(torch.rand((3, S), generator=g) * 4 + 2, dim=-1).values
        xyz = vd[:, :, None, :] * z[:, None, :, None] * 0.3
        z_ray = torch.sort(torch.rand((3, R, S), generator=g) * 4 + 2, dim=-1).values
        z_ray = torch.where(hit[..., None], z_ray, torch.full_like(z_ray, -1.0))
        xyz_ray = vd[:, :, None, :] * z_ray[..., None] * 0.3
        codes = torch.randn((2, 3, W), generator=g) * 0.3
        cot = [torch.randn(s, generator=g).cuda() for s in ((3, R, 3), (3, R), (3, R))]
        xyz, vd, z, codes, xyz_ray, z_ray, hit = (
            t.cuda().contiguous() for t in (xyz, vd, z, codes, xyz_ray, z_ray, hit))
        zs, zt = (t.contiguous() for t in render.conditioned_latents(wts, codes[0], codes[1]))
        args = (xyz, vd, z, zs, zt)
        args_ray = (xyz_ray, vd, z_ray, zs, zt)
        with torch.no_grad():
            fwd = zip(("rgb", "depth", "acc"), render.render_fwd(wts, *args, white),
                      render.render_fwd_plain(wts, *args, white))
            fwd_ray = zip(("rgb(aabb)", "depth(aabb)", "acc(aabb)"),
                          render.render_fwd(wts, *args_ray, white, hit),
                          render.render_fwd_plain(wts, *args_ray, white, hit))
        k2 = [(label, render_bwd_at_kinks(wts, a, white, cot, h, verbose=False))
              for label, a, h in (("K2", args, None), ("K2(aabb)", args_ray, hit))]
        budget = render.STASH_BYTES
        if W == 256:      # one object per chunk: three K3 + K4 rounds, accumulated
            render.STASH_BYTES = R * S * render.stash_layout(wts)["ld_pt"] * 4
        try:
            k3 = train_bwd_at_kinks(wts, args, white, cot, verbose=False)
        finally:
            render.STASH_BYTES = budget
        errs = []
        for label, (_, err, err32, good, kinks) in k2:
            ok &= good
            errs.append(f"{label} {err:.1e} (float32 plain {err32:.1e}, rays out {len(kinks)})"
                        + ("" if good else " FAIL"))
        good = k3["ok"] and k3["off_ok"]
        ok &= good
        errs.append(f"K3(data) {k3['err']:.1e} (float32 plain {k3['err32']:.1e}, rays out "
                    f"{len(k3['kinks'])}), K3 {k3['off_err']:.1e} (float32 plain "
                    f"{k3['off_err32']:.1e})" + ("" if good else " FAIL"))
        for name, a, b in list(fwd) + list(fwd_ray):
            err = float((a - b).abs().max())
            base = name.split("(")[0]
            tol = VALUE_ATOL[base] if base in VALUE_ATOL else GRAD_RTOL * float(b.abs().max())
            good = err <= tol and bool(torch.isfinite(a).all())
            ok &= good
            errs.append(f"{name} {err:.1e}{'' if good else ' FAIL'}")
        ok &= k3["same"]
        errs.append(f"data mode's dW, dzs, dzt the same bits: {'ok' if k3['same'] else 'FAIL'}")
        del k3
        L = render.stash_layout(wts)
        pt = torch.empty((3 * R * S, L["ld_pt"]), device="cuda")
        ray = torch.empty((3 * R, L["ld_ray"]), device="cuda")
        render.render_train_bwd_stash(wts, *args, white, *cot, pt, ray)
        err, good = wgrad_on_stash(wts, pt, ray)
        ok &= good
        errs.append(f"K4 on K3's stash {err:.1e} of max{'' if good else ' FAIL'}")
        print(f"   W {W} S {S} R {R} white {white}: " + ", ".join(errs))
    if not ok:
        raise RuntimeError("a kernel disagrees with its plain version off the main path")


def check_kernels(model=None, seed=0):
    """K1 and K2 against their plain versions at the TTO path's shape, on
    the published config's decoder (random weights) or `model`'s; returns
    the kernel records."""
    import torch

    from supnerf_tpu_torch.ops import render

    wts, args, cot = kernel_inputs(seed=seed, model=model)
    xyz = args[0]
    B, R, S = xyz.shape[:3]
    W, ns, nt = wts.W, wts.n_shape, wts.n_tex
    print(f"   at the TTO path's shape, {B} objects x {R} rays x {S} samples:")
    with torch.no_grad():
        fwd_k = render.render_fwd(wts, *args)
        torch.cuda.synchronize()
        fwd_p = render.render_fwd_plain(wts, *args)
    err_fwd, ok_fwd = compare(("rgb", "depth", "acc"), fwd_k, fwd_p, lambda n, s: VALUE_ATOL[n])

    # K2's recompute rounds its pre-activations otherwise than the float32
    # plain version (3xTF32 products, another summation order): at a ReLU
    # kink either can be on the wrong side, so float64 arbitrates
    _, err_bwd, err_bwd32, ok_bwd, kinks = render_bwd_at_kinks(wts, args, False, cot)
    # K2's recompute takes K1's gates (ROADMAP C.9): against K3's data mode,
    # which runs K1's refined forward, with no carve-out
    err_c9, same_c9, ok_c9 = k2_against_k3_data(wts, args, cot)

    t_fwd = _timed(lambda: render.render_fwd(wts, *args), 10)
    with torch.no_grad():
        t_fwd_p = _timed(lambda: render.render_fwd_plain(wts, *args), 5)
    t_bwd = _timed(lambda: render.render_bwd(wts, *args, False, *cot), 5)
    t_bwd_p = _timed(lambda: render.render_bwd_plain(wts, *args, False, *cot), 3)

    # bytes: each input read once (K1 reads the (in, out) weight copies, K2
    # both layouts), each output written once
    pts = B * R * S
    w_fwd = sum(getattr(wts, f).numel() for f in render._PTR_FIELDS if not f.startswith("wt_"))
    w_all = sum(getattr(wts, f).numel() for f in render._PTR_FIELDS)
    act_bytes = sum(t.numel() for t in args) * 4
    fwd_flops = 2 * pts * decoder_macs(W, ns, nt)
    fwd_bytes = act_bytes + w_fwd * 4 + B * R * 5 * 4
    bwd_flops = fwd_flops + 2 * pts * transposed_macs(W, ns, nt)
    bwd_bytes = (act_bytes + w_all * 4 + B * R * 5 * 4
                 + (pts * 3 + B * R * 3 + B * S + B * (ns + nt) * W) * 4)

    records = [record("render_fwd", ["A1", "A5"], "supnerf_tpu/ops/pallas_render.py:127",
                      "supnerf_tpu_torch/csrc/render_fwd.cu", t_fwd, t_fwd_p, err_fwd,
                      bound(fwd_flops, fwd_bytes)),
               record("render_bwd", ["A2"], "supnerf_tpu/ops/pallas_render.py:478",
                      "supnerf_tpu_torch/csrc/render_bwd.cu", t_bwd, t_bwd_p, err_bwd,
                      bound(bwd_flops, bwd_bytes))]
    records[1]["max_abs_err_float32_plain"] = err_bwd32
    records[1]["kink_rays"] = kink_rays_record(kinks)
    records[1]["against_k3_data"] = {"max_abs_err": err_c9, "same_bits": same_c9}
    if not (ok_fwd and ok_bwd):
        raise RuntimeError("a kernel disagrees with its plain version")
    if not ok_c9:
        raise RuntimeError("K2 disagrees with K3's data mode: its gates are not K1's")
    return records


def k2_against_k3_data(wts, args, cot):
    """K2 against K3's data mode (render_train_bwd_stash with data_grads) on
    the same shared-z inputs and cotangents, with no ray taken out: dxyz,
    dviewdir, dz, dzs and dzt within GRAD_RTOL of K3's largest magnitude.
    K3's recompute is K1's refined forward (kRefine on every ReLU layer),
    and the transposed chains are the same, so this holds at a ReLU kink
    only if K2's recompute takes K1's gates: a gate on the other side turns
    a whole gradient row of a sample. Returns (worst error, the number of
    outputs that are the same bits, ok)."""
    import torch

    from supnerf_tpu_torch.ops import render

    B, R, S = args[0].shape[:3]
    L = render.stash_layout(wts)
    pt = torch.empty((B * R * S, L["ld_pt"]), device="cuda")
    ray = torch.empty((B * R, L["ld_ray"]), device="cuda")
    dzs, dzt, dxyz, dvd, dz = render.render_train_bwd_stash(wts, *args, False, *cot, pt, ray,
                                                            data_grads=True)
    del pt, ray
    k2 = render.render_bwd(wts, *args, False, *cot)
    torch.cuda.synchronize()
    k3 = (dxyz, dvd, dz, dzs, dzt)
    gb = B * R * S * L["ld_pt"] * 4 / 1e9
    print(f"   K2 against K3's data mode ({B * R} rays, their {gb:.2f} GB stash), no ray taken "
          "out:")
    err, ok = compare(("dxyz", "dviewdir", "dz", "dzs", "dzt"), k2, k3,
                      lambda n, s: GRAD_RTOL * s)
    same = sum(bool(torch.equal(a, b)) for a, b in zip(k2, k3))
    print(f"   outputs the same bits as K3's: {same} of 5")
    return err, same, ok


def k7_against_k6(wts, args, cot):
    """K7 (field_train_bwd_stash) against K6 (field_bwd) on the same inputs
    and cotangents, with no point taken out: K7 runs K6's kernel body
    (csrc/render_common.cuh:field_backward, with the stash), so its dxyz,
    dviewdir, dzs and dzt must be the same bits as K6's. Both run on the
    chunks of objects field_train_bwd gives K7, so that the wrappers' sums of
    the per-block partials run on tensors of one shape. Returns (the largest
    difference, the number of outputs that are the same bits, all four
    are)."""
    import torch

    from supnerf_tpu_torch.ops import field, render

    B, M = args[0].shape[:2]
    L = render.stash_layout(wts, per_point=True)
    chunk = max(1, min(B, render.STASH_BYTES // (M * L["ld_pt"] * 4)))
    pt = torch.empty((chunk * M, L["ld_pt"]), device=args[0].device)
    k7, k6 = [], []
    for o in range(0, B, chunk):
        sl = slice(o, min(B, o + chunk))
        part = [t[sl] for t in args] + [c[sl] for c in cot]
        k7.append(field.field_train_bwd_stash(wts, *part, pt[:(sl.stop - o) * M]))
        k6.append(field.field_bwd(wts, *part))
    torch.cuda.synchronize()
    del pt
    k7, k6 = ([torch.cat(parts) for parts in zip(*outs)] for outs in (k7, k6))
    err = max(float((a - b).abs().max()) for a, b in zip(k7, k6))
    same = sum(bool(torch.equal(a, b)) for a, b in zip(k7, k6))
    print(f"   K7 against K6 ({B} objects x {M} points in chunks of {chunk}), no point taken "
          f"out: max_abs_err {err:.3e}, outputs the same bits: {same} of 4 "
          f"{'ok' if same == 4 else 'FAIL'}")
    return err, same, same == 4


def gates_against_k5(wts, args, cot, k7=True):
    """The ReLU gates K6 (field_bwd) and, with k7, K7 (field_train_bwd_stash)
    differentiate, against those K5 (field_fwd) took on the same inputs,
    with no point taken out: the three run one forward chain
    (csrc/render_common.cuh:field_chain, its exact step included), so each
    kernel's gate words (ops/field.py:gate_buffer) must equal K5's. The
    wrappers give the gates from builds of the kernels that also write them
    (csrc/field_gates.cu), so each build's outputs must also be the same
    bits as its kernel's. K7 runs on the chunks of objects field_train_bwd
    gives it, as in k7_against_k6. Returns (the number of gate words apart
    from K5's, none is and every output is its kernel's bits)."""
    import torch

    from supnerf_tpu_torch.ops import field, render

    B, M = args[0].shape[:2]
    g5, g6 = field.gate_buffer(wts, args[0]), field.gate_buffer(wts, args[0])
    with torch.no_grad():
        same = [torch.equal(a, b) for a, b in zip(field.field_fwd(wts, *args, gates=g5),
                                                  field.field_fwd(wts, *args))]
    same += [torch.equal(a, b) for a, b in zip(field.field_bwd(wts, *args, *cot, gates=g6),
                                               field.field_bwd(wts, *args, *cot))]
    apart = {"K6": int((g6 != g5).sum())}
    del g6
    if k7:
        L = render.stash_layout(wts, per_point=True)
        chunk = max(1, min(B, render.STASH_BYTES // (M * L["ld_pt"] * 4)))
        pt = torch.empty((chunk * M, L["ld_pt"]), device=args[0].device)
        g7 = field.gate_buffer(wts, args[0])
        for o in range(0, B, chunk):
            sl = slice(o, min(B, o + chunk))
            part = [t[sl] for t in args] + [c[sl] for c in cot]
            view = pt[:(sl.stop - o) * M]
            out = field.field_train_bwd_stash(wts, *part, view, gates=g7[sl])
            same += [torch.equal(a, b)
                     for a, b in zip(out, field.field_train_bwd_stash(wts, *part, view))]
        apart["K7"] = int((g7 != g5).sum())
        del pt, g7
    words = g5.numel()
    n = sum(apart.values())
    ok = n == 0 and all(same)
    print(f"   gates against K5's ({B} objects x {M} points, {words} words), no point taken "
          f"out: " + ", ".join(f"{k} {v} words apart" for k, v in apart.items())
          + f"; the gate builds' outputs the kernels' bits: {sum(same)} of {len(same)} "
          f"{'ok' if ok else 'FAIL'}")
    return n, ok


def check_wgrad(wts, views, stash_bytes, names, ports, tpu):
    """K4 on a stash written chunk by chunk (views: each chunk's (pt, ray),
    ray None for K7's per-point stash) against wgrad_plain on the last
    chunk's problems; K4, its plain version and one torch.mm per problem
    (the library call) timed over every chunk. Returns (record, ok)."""
    import torch

    from supnerf_tpu_torch.ops import render

    gk, gp = (render._linear_grad_buffers(wts, "cuda") for _ in range(2))
    probs = [render.wgrad_problems(wts, pt, ray, gk) for pt, ray in views]
    probs_p = [render.wgrad_problems(wts, pt, ray, gp) for pt, ray in views]
    render.wgrad(probs[-1])
    torch.cuda.synchronize()
    render.wgrad_plain(probs_p[-1])
    err, ok = compare(names, gk, gp, lambda n, s: WGRAD_RTOL * s)
    # deterministic: a second call on the same stash gives the same bits
    again = render._linear_grad_buffers(wts, "cuda")
    render.wgrad(render.wgrad_problems(wts, *views[-1], again))
    same = all(torch.equal(a, b) for a, b in zip(gk, again))
    print(f"   K4 twice on the same stash, the same bits: {'ok' if same else 'FAIL'}")
    ok &= same
    del again
    t_k4 = _timed(lambda: [render.wgrad(p) for p in probs], 5)
    t_k4_p = _timed(lambda: [render.wgrad_plain(p) for p in probs_p], 5)
    t_lib = _timed(lambda: [torch.mm(p.G.t(), p.A) for ps in probs_p for p in ps], 5)
    flops = sum(2 * p.A.shape[0] * p.A.shape[1] * p.G.shape[1]
                + (p.A.shape[0] * p.G.shape[1] if p.b_out is not None else 0)
                for ps in probs for p in ps)
    nbytes = stash_bytes + sum(t.numel() for t in gk) * 4
    return record("wgrad", ports, tpu, "supnerf_tpu_torch/csrc/wgrad.cu", t_k4, t_k4_p, err,
                  bound(flops, nbytes), library_ms=t_lib), ok


def wgrad_on_stash(wts, pt, ray):
    """K4 against wgrad_plain on one stash (pads left as torch.empty left
    them): the largest error of each gradient over its largest magnitude,
    and whether all are within WGRAD_RTOL and finite."""
    import torch

    from supnerf_tpu_torch.ops import render

    gk, gp = (render._linear_grad_buffers(wts, "cuda") for _ in range(2))
    render.wgrad(render.wgrad_problems(wts, pt, ray, gk))
    render.wgrad_plain(render.wgrad_problems(wts, pt, ray, gp))
    err = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
              for a, b in zip(gk, gp))
    return err, err <= WGRAD_RTOL and all(bool(torch.isfinite(a).all()) for a in gk)


def check_train_kernels(model=None, seed=1):
    """K1 at the training path's shape (8 objects, per-object latents) and
    K3 + K4 in both modes against render_train_bwd_plain in float32 and
    float64 on the same inputs, kink rays taken out (train_bwd_at_kinks);
    K4 alone against its plain version on the stash K3 wrote; on the
    published config's decoder (random weights) or `model`'s. Returns the
    records of K1 (at this shape), K3 and K4, and train_bwd_at_kinks'
    result for check_train_data_kernels."""
    import torch

    from supnerf_tpu_torch.ops import render

    wts, args, cot = kernel_inputs(seed=seed, B=TRAIN_BATCH, model=model)
    B, R, S = args[0].shape[:3]
    W, ns, nt = wts.W, wts.n_shape, wts.n_tex
    names = ["d" + n for n in _linear_param_names(wts)]
    print(f"   at the training path's shape, {B} objects x {R} rays x {S} samples:")
    with torch.no_grad():
        fwd_k = render.render_fwd(wts, *args)
        torch.cuda.synchronize()
        fwd_p = render.render_fwd_plain(wts, *args)
    err_fwd, ok = compare(("rgb", "depth", "acc"), fwd_k, fwd_p, lambda n, s: VALUE_ATOL[n])

    # K3's recompute rounds its pre-activations otherwise than the float32
    # plain version (3xTF32 products, another summation order), as K2's
    print("   K3 + K4 (render_train_bwd) in its data mode against float32 and float64 plain "
          "versions:")
    arb = train_bwd_at_kinks(wts, args, False, cot)
    err_k3, ok_k3 = arb["off_err"], arb["off_ok"] and arb["same"]

    # one stash buffer of a chunk, reused chunk by chunk as render_train_bwd does
    L = render.stash_layout(wts)
    chunk = max(1, min(B, render.STASH_BYTES // (R * S * L["ld_pt"] * 4)))
    pt = torch.empty((chunk * R * S, L["ld_pt"]), device="cuda")
    ray = torch.empty((chunk * R, L["ld_ray"]), device="cuda")
    chunks = [slice(o, min(B, o + chunk)) for o in range(0, B, chunk)]

    def view(sl):
        n = sl.stop - sl.start
        return pt[:n * R * S], ray[:n * R]

    def k3(fn):
        for sl in chunks:
            fn(wts, *(t[sl] for t in args), False, *(c[sl] for c in cot), *view(sl))

    pts, rays = B * R * S, B * R
    # the stash K3 writes and K4 reads: its used columns once
    stash_bytes = (pts * L["width"] + rays * (L["r_gv"] + W)) * 4
    k3(render.render_train_bwd_stash)
    k4_rec, ok_k4 = check_wgrad(wts, [view(sl) for sl in chunks], stash_bytes, names,
                                ["A6"], "supnerf_tpu/ops/pallas_render.py:991")

    t_fwd = _timed(lambda: render.render_fwd(wts, *args), 5)
    with torch.no_grad():
        t_fwd_p = _timed(lambda: render.render_fwd_plain(wts, *args), 3)
    t_k3 = _timed(lambda: k3(render.render_train_bwd_stash), 3)
    t_k3_p = _timed(lambda: k3(render.render_train_bwd_stash_plain), 2)
    t_all = _timed(lambda: render.render_train_bwd(wts, *args, False, *cot), 3)
    t_all_p = _timed(lambda: render.render_train_bwd_plain(wts, *args, False, *cot), 2)
    print(f"   training backward K3 + K4 through render_train_bwd: {t_all:.3f} ms "
          f"(render_train_bwd_plain {t_all_p:.3f} ms; {len(chunks)} chunks of {chunk} objects)")

    w_fwd = sum(getattr(wts, f).numel() for f in render._PTR_FIELDS if not f.startswith("wt_"))
    w_all = sum(getattr(wts, f).numel() for f in render._PTR_FIELDS)
    act_bytes = sum(t.numel() for t in args) * 4
    fwd_flops = 2 * pts * decoder_macs(W, ns, nt)
    fwd_bytes = act_bytes + w_fwd * 4 + rays * 5 * 4
    k3_flops = fwd_flops + 2 * pts * (transposed_macs(W, ns, nt) - W * 63)
    k3_bytes = act_bytes + w_all * 4 + rays * 5 * 4 + stash_bytes + rays * (ns + nt) * W * 4
    records = [
        record("render_fwd", ["A1", "A5"], "supnerf_tpu/ops/pallas_render.py:127",
               "supnerf_tpu_torch/csrc/render_fwd.cu", t_fwd, t_fwd_p, err_fwd,
               bound(fwd_flops, fwd_bytes)),
        record("render_train_bwd", ["A6"], "supnerf_tpu/ops/pallas_render.py:991",
               "supnerf_tpu_torch/csrc/render_train_bwd.cu", t_k3, t_k3_p, err_k3,
               bound(k3_flops, k3_bytes)),
        k4_rec]
    records[1]["max_abs_err_float32_plain"] = arb["off_err32"]
    records[1]["kink_rays"] = kink_rays_record(arb["kinks"])
    if not (ok and ok_k3 and ok_k4):
        raise RuntimeError("a training kernel disagrees with its plain version")
    return records, arb


def check_train_data_kernels(arb):
    """K3's data mode (A6 with data_grads=True) at the training path's shape:
    arb is train_bwd_at_kinks' result on these inputs (every output against
    render_train_bwd_plain(data_grads=True) in float32 and float64, kink
    rays taken out; dzs, dzt and the weight gradients the same bits as K3's
    other mode); here the stash the same bits in both modes, and the
    times. Returns the record of K3's data mode."""
    import torch

    from supnerf_tpu_torch.ops import render

    wts, args, cot = kernel_inputs(seed=1, B=TRAIN_BATCH)
    B, R, S = args[0].shape[:3]
    W, ns, nt = wts.W, wts.n_shape, wts.n_tex
    print(f"   K3's data mode at the training path's shape, {B} objects x {R} rays x {S} "
          "samples:")
    print(f"   every output against float32 and float64 plain versions (above): max_abs_err "
          f"{arb['err']:.3e} (float32 plain {arb['err32']:.3e}) "
          f"{'ok' if arb['ok'] else 'FAIL'}; dzs, dzt and every weight gradient bit-identical to "
          f"K3's other mode: {'ok' if arb['same'] else 'FAIL'}")

    L = render.stash_layout(wts)
    chunk = max(1, min(B, render.STASH_BYTES // (R * S * L["ld_pt"] * 4)))
    chunks = [slice(o, min(B, o + chunk)) for o in range(0, B, chunk)]
    # zero-filled: neither mode writes the rows' padding columns
    bufs = [torch.zeros((2, chunk * R * S, L["ld_pt"]), device="cuda"),
            torch.zeros((2, chunk * R, L["ld_ray"]), device="cuda")]

    def k3(fn, i=0, **kw):
        for sl in chunks:
            n = sl.stop - sl.start
            fn(wts, *(t[sl] for t in args), False, *(c[sl] for c in cot),
               bufs[0][i, :n * R * S], bufs[1][i, :n * R], **kw)

    k3(render.render_train_bwd_stash, 0)
    k3(render.render_train_bwd_stash, 1, data_grads=True)
    torch.cuda.synchronize()
    stash_same = all(torch.equal(b[0], b[1]) for b in bufs)
    print(f"   K3's stash the same bits in both modes: {'ok' if stash_same else 'FAIL'}")
    t_k3 = _timed(lambda: k3(render.render_train_bwd_stash, data_grads=True), 3)
    t_k3_p = _timed(lambda: k3(render.render_train_bwd_stash_plain, data_grads=True), 2)
    t_off = _timed(lambda: k3(render.render_train_bwd_stash), 3)
    print(f"   K3 in its other mode on the same inputs: {t_off:.3f} ms")
    del bufs

    pts, rays = B * R * S, B * R
    w_all = sum(getattr(wts, f).numel() for f in render._PTR_FIELDS)
    act_bytes = sum(t.numel() for t in args) * 4
    stash_bytes = (pts * L["width"] + rays * (L["r_gv"] + W)) * 4
    flops = 2 * pts * (decoder_macs(W, ns, nt) + transposed_macs(W, ns, nt))
    nbytes = (act_bytes + w_all * 4 + rays * 5 * 4 + stash_bytes + rays * (ns + nt) * W * 4
              + (pts * 3 + rays * 3 + B * S) * 4)
    rec = record("render_train_bwd_data", ["A6"], "supnerf_tpu/ops/pallas_render.py:991",
                 "supnerf_tpu_torch/csrc/render_train_bwd.cu", t_k3, t_k3_p, arb["err"],
                 bound(flops, nbytes))
    rec["max_abs_err_float32_plain"] = arb["err32"]
    rec["kink_rays"] = kink_rays_record(arb["kinks"])
    rec["other_mode_ms"] = t_off
    if not (arb["ok"] and arb["same"] and stash_same):
        raise RuntimeError("K3's data mode disagrees with its plain version or its other mode")
    return [rec]


def codenerf_model(seed):
    """CodeNeRF at the factory's defaults (2 shape blocks, 1 texture block,
    W 256; random weights from `seed`) on the card: the decoder shape of the
    baseline paths' CodeNeRF cells."""
    from supnerf_tpu_torch.models.factory import build_model, init_model

    return init_model(build_model("codenerf", {"latent_dim": 256}), seed).cuda()


def check_codenerf_kernels():
    """K1 and K2 at the TTO shape, K1, K3 (both modes) and K4 at the training
    shape, on CodeNeRF's decoder (2 shape blocks, 1 texture block), against
    their plain versions with the (3, 1) checks' tolerances and kink rules
    (check_kernels, check_train_kernels): the stash row and K4's problem list
    change with the block counts. Returns {counter name: its timed numbers
    at this decoder}."""
    model = codenerf_model(7)
    print(f"   CodeNeRF's decoder, {model.shape_blocks} shape blocks and "
          f"{model.texture_blocks} texture block:")
    tto = check_kernels(model=model, seed=5)
    train, arb = check_train_kernels(model=model, seed=6)
    if not arb["ok"]:
        raise RuntimeError("K3's data mode disagrees with its plain version at (2, 1)")
    del arb
    keep = ("ms", "plain_ms", "bound_ms", "bound_by", "bound_fma_ms", "max_abs_err",
            "library_ms")
    return {r["name"]: {k: r[k] for k in keep} for r in train + tto[1:]}


def field_train_inputs(seed=4, B=TRAIN_BATCH, model=None):
    """The per-point training field's inputs at full width: kernel_inputs'
    1024 x 64 points per object as 65,536 points, each with its own
    direction (its ray's, turned by a small random offset, so directions
    differ within every block), and cotangents of sigma and rgb."""
    import torch
    import torch.nn.functional as F

    wts, (xyz, vd, _, zs, zt), _ = kernel_inputs(seed=seed, B=B, model=model)
    g = torch.Generator(device="cuda").manual_seed(seed)
    pts = xyz.reshape(B, -1, 3).contiguous()
    dirs = F.normalize(vd[:, :, None, :].expand_as(xyz).reshape(B, -1, 3)
                       + 0.1 * torch.randn(pts.shape, generator=g, device="cuda"), dim=-1)
    cot = (torch.randn((B, pts.shape[1], 1), generator=g, device="cuda"),
           torch.randn(pts.shape, generator=g, device="cuda"))
    return wts, (pts, dirs.contiguous(), zs, zt), cot


def check_field_train_kernels():
    """The per-point training field at full width, 8 objects x 65,536
    points with per-point directions: K5 on per-object latents (A9) against
    field_fwd_plain; K7 against K6, the same bits (k7_against_k6); K6's and
    K7's gates against K5's (gates_against_k5); K7 + K4 through
    field_train_bwd (A10) against field_train_bwd_plain: the data and latent
    gradients in float32 and float64 (compare_at_kinks), the weight
    gradients in float64 (the float32 plain version's distance a reading);
    K4 alone against wgrad_plain on K7's stash. Returns the records of K7,
    K5 at this shape and K4 on K7's stash."""
    import torch

    from supnerf_tpu_torch.ops import field, render

    wts, args, cot = field_train_inputs()
    B, M = args[0].shape[:2]
    W, ns, nt = wts.W, wts.n_shape, wts.n_tex
    dir_macs = 3 * (2 * wts.num_dir_freq + 1) * W
    names = ["d" + n for n in _linear_param_names(wts)]
    print(f"   the training field's shape, {B} objects x {M} points, a direction per point:")
    with torch.no_grad():
        fwd_k = field.field_fwd(wts, *args)
        torch.cuda.synchronize()
        fwd_p = field.field_fwd_plain(wts, *args)
    err_fwd, ok_fwd = compare(("sigma", "rgb"), fwd_k, fwd_p, lambda n, s: VALUE_ATOL[n])
    del fwd_k, fwd_p
    err_k6, _, same_k6 = k7_against_k6(wts, args, cot)
    gates_apart, same_gates = gates_against_k5(wts, args, cot)

    def evaluate(cot):
        got = field.field_train_bwd(wts, *args, *cot)
        torch.cuda.synchronize()
        ref = field.field_train_bwd_plain(wts, *args, *cot)
        ref64 = field.field_train_bwd_plain(as_float64(wts), *(t.double() for t in args),
                                            *(t.double() for t in cot))
        return got, ref, ref64

    # A point whose float32 gate sits across a kink from both references
    # fails however right the kernel is: take_out_kink_points. With those
    # points' cotangents zero, all other points are held to the unchanged
    # tolerances, through the weight gradients too. Each weight gradient is
    # a sum over every point, which the float32 plain version's own gates at
    # kinks move too, so the weight gradients are held against the float64
    # plain version, the float32 one's distance from it printed beside them.
    got, ref, ref64, cot, kinks, units, at_kinks = take_out_kink_points(
        "K7", wts, args, evaluate, cot, stash_gates=True)
    err_k7, err_k7_32, ok_k7 = compare_at_kinks(("dxyz", "dviewdir", "dzs", "dzt"), got[:4],
                                                ref[:4], ref64[:4], GRAD_RTOL)
    err_w, ok_w = compare([n + " (float64)" for n in names], got[4], ref64[4],
                          lambda n, s: GRAD_RTOL * s)
    err_w32 = max(float((a - b).abs().max()) for a, b in zip(got[4], ref[4]))
    rel_w32 = max(float((b.double() - b64).abs().max()) / float(b64.abs().max())
                  for b, b64 in zip(ref[4], ref64[4]))
    print(f"   weight gradients, a reading: kernel from float32 plain max_abs_err "
          f"{err_w32:.3e}; float32 plain from float64 at most {rel_w32:.3e} of the largest")
    ok_k7 &= at_kinks
    del got, ref, ref64

    L = render.stash_layout(wts, per_point=True)
    chunk = max(1, min(B, render.STASH_BYTES // (M * L["ld_pt"] * 4)))
    chunks = [slice(o, min(B, o + chunk)) for o in range(0, B, chunk)]
    pt = torch.empty((chunk * M, L["ld_pt"]), device="cuda")

    def view(sl):
        return pt[:(sl.stop - sl.start) * M]

    def k7(fn):
        for sl in chunks:
            fn(wts, *(t[sl] for t in args), *(c[sl] for c in cot), view(sl))

    pts = B * M
    stash_bytes = pts * L["width"] * 4
    k7(field.field_train_bwd_stash)
    k4_rec, ok_k4 = check_wgrad(wts, [(view(sl), None) for sl in chunks], stash_bytes, names,
                                ["A10"], "supnerf_tpu/ops/pallas_field.py:723")

    t_fwd = _timed(lambda: field.field_fwd(wts, *args), 5)
    with torch.no_grad():
        t_fwd_p = _timed(lambda: field.field_fwd_plain(wts, *args), 3)
    t_k7 = _timed(lambda: k7(field.field_train_bwd_stash), 3)
    t_k7_p = _timed(lambda: k7(field.field_train_bwd_stash_plain), 2)
    t_all = _timed(lambda: field.field_train_bwd(wts, *args, *cot), 3)
    t_all_p = _timed(lambda: field.field_train_bwd_plain(wts, *args, *cot), 2)
    print(f"   training field backward K7 + K4 through field_train_bwd: {t_all:.3f} ms "
          f"(field_train_bwd_plain {t_all_p:.3f} ms; {len(chunks)} chunks of {chunk} objects)")

    w_fwd = sum(getattr(wts, f).numel() for f in render._PTR_FIELDS if not f.startswith("wt_"))
    w_all = sum(getattr(wts, f).numel() for f in render._PTR_FIELDS)
    act_bytes = sum(t.numel() for t in args) * 4
    fwd_flops = 2 * pts * (decoder_macs(W, ns, nt) + dir_macs)
    fwd_bytes = act_bytes + w_fwd * 4 + pts * 4 * 4
    k7_flops = fwd_flops + 2 * pts * (transposed_macs(W, ns, nt) + dir_macs)
    k7_bytes = (act_bytes + w_all * 4 + pts * 4 * 4 + (pts * 6 + B * (ns + nt) * W) * 4
                + stash_bytes)
    k7_rec = record("field_train_bwd", ["A10"], "supnerf_tpu/ops/pallas_field.py:723",
                    "supnerf_tpu_torch/csrc/field_train_bwd.cu", t_k7, t_k7_p, err_k7,
                    bound(k7_flops, k7_bytes))
    k7_rec["max_abs_err_float32_plain"] = err_k7_32
    k7_rec["weights_max_abs_err"] = err_w
    k7_rec["weights_max_abs_err_float32_plain"] = err_w32
    k7_rec["weights_float32_plain_rel_err_from_float64"] = rel_w32
    k7_rec["kink_points"] = [[o, p, [list(x) for x in u]] for (o, p), u in zip(kinks, units)]
    k7_rec["against_k6"] = {"same_bits": same_k6, "max_abs_err": err_k6}
    k7_rec["gate_words_apart_from_k5"] = gates_apart
    k7_rec["with_k4_ms"], k7_rec["with_k4_plain_ms"] = t_all, t_all_p
    k5_rec = record("field_fwd", ["A9"], "supnerf_tpu/ops/pallas_field.py:704",
                    "supnerf_tpu_torch/csrc/field_fwd.cu", t_fwd, t_fwd_p, err_fwd,
                    bound(fwd_flops, fwd_bytes))
    if not same_k6:
        raise RuntimeError("K7 disagrees with K6: its arithmetic is not K6's")
    if not same_gates:
        raise RuntimeError("K6 or K7 differentiates at other gates than K5 took")
    if not (ok_fwd and ok_k7 and ok_w and ok_k4):
        raise RuntimeError("a training-field kernel disagrees with its plain version")
    return [k7_rec], {"field_fwd": k5_rec, "wgrad": k4_rec}


def aabb_inputs(seed=2, B=DEMO_OBJECTS, R=1024, S=64):
    """kernel_inputs' decoder, directions and codes with per-ray z rows, each
    its own stratified draw between its own bounds, and about a third of the
    rays missing their box: constant z at -diag/2 and hit False, as
    render_rays_aabb makes them (bounds (-1, -1) in units of diag/2)."""
    import torch

    wts, (_, vd, _, zs, zt), cot = kernel_inputs(seed=seed, B=B, R=R, S=S)
    g = torch.Generator(device="cuda").manual_seed(seed)
    diag = 5.3
    hit = torch.rand((B, R), generator=g, device="cuda") >= 1 / 3
    near = 20.0 - diag / 2 + torch.rand((B, R, 1), generator=g, device="cuda")
    far = near + 1.5 + 2.0 * torch.rand((B, R, 1), generator=g, device="cuda")
    frac = (torch.arange(S, device="cuda") + torch.rand((B, R, S), generator=g, device="cuda")) / S
    z = torch.where(hit[..., None], near + (far - near) * frac,
                    torch.full((B, R, S), -diag / 2, device="cuda"))
    origin = torch.tensor([0.0, -20.0, 1.0], device="cuda")
    xyz = ((origin + vd[:, :, None, :] * z[..., None]) / diag).contiguous()
    return wts, (xyz, vd, z.contiguous(), zs, zt), hit, cot


def check_aabb_kernels():
    """K1 and K2 in their AABB mode (A3, A4) against their plain versions at
    the demo path's shape; missed rays must get exactly the constant outputs
    and zero gradients. Returns the records of both modes."""
    import torch

    from supnerf_tpu_torch.ops import render

    wts, args, hit, cot = aabb_inputs()
    xyz = args[0]
    B, R, S = xyz.shape[:3]
    W, ns, nt = wts.W, wts.n_shape, wts.n_tex
    miss = ~hit
    print(f"   AABB mode at the demo path's shape, {B} objects x {R} rays x {S} samples, "
          f"{int(miss.sum())} of {B * R} rays missing their box:")
    with torch.no_grad():
        fwd_k = render.render_fwd(wts, *args, False, hit)
        torch.cuda.synchronize()
        fwd_p = render.render_fwd_plain(wts, *args, False, hit)
    err_fwd, ok_fwd = compare(("rgb", "depth", "acc"), fwd_k, fwd_p, lambda n, s: VALUE_ATOL[n])
    bwd_k, err_bwd, err_bwd32, ok_bwd, kinks = render_bwd_at_kinks(wts, args, False, cot, hit)
    exact = (bool((fwd_k[0][miss] == 0).all()) and bool((fwd_k[1][miss] == 0).all())
             and bool((fwd_k[2][miss] == 1).all())
             and all(bool((t[miss] == 0).all()) for t in bwd_k[:3]))
    print(f"   missed rays: rgb 0, depth 0, acc 1, zero dxyz / dviewdir / dz: "
          f"{'ok' if exact else 'FAIL'}")

    t_fwd = _timed(lambda: render.render_fwd(wts, *args, False, hit), 10)
    with torch.no_grad():
        t_fwd_p = _timed(lambda: render.render_fwd_plain(wts, *args, False, hit), 5)
    t_bwd = _timed(lambda: render.render_bwd(wts, *args, False, *cot, hit), 5)
    t_bwd_p = _timed(lambda: render.render_bwd_plain(wts, *args, False, *cot, hit), 3)

    # operations: the decoder on the rays that hit (a missed ray's outputs
    # are constants); bytes: each input read once, each output written once
    hit_pts = int(hit.sum()) * S
    w_fwd = sum(getattr(wts, f).numel() for f in render._PTR_FIELDS if not f.startswith("wt_"))
    w_all = sum(getattr(wts, f).numel() for f in render._PTR_FIELDS)
    act_bytes = sum(t.numel() for t in args) * 4 + B * R * 4
    fwd_flops = 2 * hit_pts * decoder_macs(W, ns, nt)
    fwd_bytes = act_bytes + w_fwd * 4 + B * R * 5 * 4
    bwd_flops = fwd_flops + 2 * hit_pts * transposed_macs(W, ns, nt)
    bwd_bytes = (act_bytes + w_all * 4 + B * R * 5 * 4
                 + (B * R * S * 3 + B * R * 3 + B * R * S + B * (ns + nt) * W) * 4)
    records = [record("render_fwd_aabb", ["A3"], "supnerf_tpu/ops/pallas_render.py:127",
                      "supnerf_tpu_torch/csrc/render_fwd.cu", t_fwd, t_fwd_p, err_fwd,
                      bound(fwd_flops, fwd_bytes)),
               record("render_bwd_aabb", ["A4"], "supnerf_tpu/ops/pallas_render.py:478",
                      "supnerf_tpu_torch/csrc/render_bwd.cu", t_bwd, t_bwd_p, err_bwd,
                      bound(bwd_flops, bwd_bytes))]
    records[1]["max_abs_err_float32_plain"] = err_bwd32
    records[1]["kink_rays"] = kink_rays_record(kinks)
    if not (ok_fwd and ok_bwd and exact):
        raise RuntimeError("an AABB-mode kernel disagrees with its plain version")
    return records


def field_inputs(seed=3, B=REG_OBJECTS):
    """The regulariser paths' two shapes on kernel_inputs' decoder: the
    loss render's 1024 x 64 points per object with their rays' directions
    (the symmetry loss), and the object-size loss's 2 x 600 box-plane
    samples per object with directions of ones. Returns (wts, [(label,
    (xyz, viewdir, zs, zt), cotangents)])."""
    import torch

    from supnerf_tpu_torch.tto.regularizers import SAMPLES_PER_PLANE, obj_sz_reg_samples

    wts, (xyz, vd, _, zs, zt), _ = kernel_inputs(seed=seed, B=B)
    g = torch.Generator(device="cuda").manual_seed(seed)
    pts = xyz.reshape(B, -1, 3).contiguous()
    vds = vd[:, :, None, :].expand_as(xyz).reshape(B, -1, 3).contiguous()
    wlh = torch.tensor([[1.9, 4.6, 1.7]], device="cuda").repeat(B, 1)
    draws = torch.rand((B, 3, SAMPLES_PER_PLANE), generator=g, device="cuda")
    s_out, s_in = obj_sz_reg_samples(draws, wlh, torch.linalg.norm(wlh, dim=-1))
    box = torch.cat([s_out, s_in], 1).reshape(B, -1, 3).contiguous()
    out = []
    for label, p, v in (("sym", pts, vds), ("objsz", box, torch.ones_like(box))):
        cot = (torch.randn(p.shape[:2] + (1,), generator=g, device="cuda"),
               torch.randn(p.shape, generator=g, device="cuda"))
        out.append((label, (p, v, zs, zt), cot))
    return wts, out


def check_field_kernels():
    """K5 and K6 against their plain versions at both shapes of the
    regulariser paths (K6 also against a float64 plain version: near a
    ReLU kink the float32 one is not the truth, see compare_at_kinks; a
    point at a kink taken out as take_out_kink_points allows).
    Returns the records of K5 and K6, the loss render's shape as the main
    numbers and the object-size shape beside them."""
    import torch

    from supnerf_tpu_torch.ops import field, render

    wts, cases = field_inputs()
    W, ns, nt = wts.W, wts.n_shape, wts.n_tex
    dir_macs = 3 * (2 * wts.num_dir_freq + 1) * W     # K5's per-point direction term
    w_fwd = sum(getattr(wts, f).numel() for f in render._PTR_FIELDS if not f.startswith("wt_"))
    w_all = sum(getattr(wts, f).numel() for f in render._PTR_FIELDS)
    by_shape = {}
    ok = True
    for label, args, cot in cases:
        B, M = args[0].shape[:2]
        print(f"   K5/K6 at the {label} shape, {B} objects x {M} points:")
        with torch.no_grad():
            fwd_k = field.field_fwd(wts, *args)
            torch.cuda.synchronize()
            fwd_p = field.field_fwd_plain(wts, *args)
        err_fwd, ok_fwd = compare(("sigma", "rgb"), fwd_k, fwd_p, lambda n, s: VALUE_ATOL[n])

        def evaluate(c, args=args):
            got = field.field_bwd(wts, *args, *c)
            torch.cuda.synchronize()
            return (got, field.field_bwd_plain(wts, *args, *c),
                    field.field_bwd_plain(as_float64(wts), *(t.double() for t in args),
                                          *(t.double() for t in c)))

        bwd_k, bwd_p, bwd_64, _, kinks, units, at_kinks = take_out_kink_points(
            "K6", wts, args, evaluate, cot, stash_gates=False)
        err_bwd, err_bwd32, ok_bwd = compare_at_kinks(("dxyz", "dviewdir", "dzs", "dzt"), bwd_k,
                                                      bwd_p, bwd_64, GRAD_RTOL)
        del bwd_k, bwd_p, bwd_64
        gates_apart, same_gates = gates_against_k5(wts, args, cot, k7=False)
        ok &= ok_fwd and ok_bwd and at_kinks and same_gates
        n = 10 if M > 10000 else 50
        t_fwd = _timed(lambda: field.field_fwd(wts, *args), n)
        with torch.no_grad():
            t_fwd_p = _timed(lambda: field.field_fwd_plain(wts, *args), max(n // 2, 3))
        t_bwd = _timed(lambda: field.field_bwd(wts, *args, *cot), max(n // 2, 3))
        t_bwd_p = _timed(lambda: field.field_bwd_plain(wts, *args, *cot), max(n // 4, 3))
        # bytes: each input read once, each output written once
        pts = B * M
        act_bytes = sum(t.numel() for t in args) * 4
        fwd_flops = 2 * pts * (decoder_macs(W, ns, nt) + dir_macs)
        fwd_bytes = act_bytes + w_fwd * 4 + pts * 4 * 4
        bwd_flops = fwd_flops + 2 * pts * (transposed_macs(W, ns, nt) + dir_macs)
        bwd_bytes = act_bytes + w_all * 4 + pts * 4 * 4 + (pts * 6 + B * (ns + nt) * W) * 4
        by_shape[label] = [
            record("field_fwd", ["A7", "A11b"], "supnerf_tpu/ops/pallas_field.py:183",
                   "supnerf_tpu_torch/csrc/field_fwd.cu", t_fwd, t_fwd_p, err_fwd,
                   bound(fwd_flops, fwd_bytes)),
            record("field_bwd", ["A8"], "supnerf_tpu/ops/pallas_field.py:384",
                   "supnerf_tpu_torch/csrc/field_bwd.cu", t_bwd, t_bwd_p, err_bwd,
                   bound(bwd_flops, bwd_bytes))]
        by_shape[label][1]["max_abs_err_float32_plain"] = err_bwd32
        by_shape[label][1]["gate_words_apart_from_k5"] = gates_apart
        by_shape[label][1]["kink_points"] = [[o, p, [list(x) for x in u]]
                                             for (o, p), u in zip(kinks, units)]
    if not ok:
        raise RuntimeError("a field kernel disagrees with its plain version")
    records = by_shape["sym"]
    for r, small in zip(records, by_shape["objsz"]):
        r["objsz_shape"] = {k: small[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                   "max_abs_err", "kink_points",
                                                   "gate_words_apart_from_k5") if k in small}
    return records


def check_field_branches():
    """K5, K6 and K7 + K4 against their plain versions off the main paths:
    W 64 and 128 (and 256 with 2 shape blocks), M not a multiple of 64 (one
    block of a few rows, 600 and 1,000 points), a different direction per
    point, and at W 256 a stash budget of one object (two K7 + K4 chunks).
    Same tolerances, K6's and K7's data and latent cotangents with the
    float64 arbitration, K6's and K7's gates against K5's; not timed."""
    import torch
    import torch.nn.functional as F

    from supnerf_tpu_torch.models.layers import init_parameters
    from supnerf_tpu_torch.models.nerf_mlp import CodeNeRFDecoder
    from supnerf_tpu_torch.ops import field, render

    ok = True
    for W, ns, M in ((64, 3, 19), (128, 3, 1000), (256, 2, 600)):
        g = torch.Generator().manual_seed(W + M)
        dec = CodeNeRFDecoder(ns, 1, W, W)
        init_parameters(dec, g)
        wts = render.pack_decoder_params(dec.cuda())
        xyz = torch.randn((2, M, 3), generator=g) * 0.4
        vd = F.normalize(torch.randn((2, M, 3), generator=g), dim=-1)
        codes = torch.randn((2, 2, W), generator=g) * 0.3
        cot = (torch.randn((2, M, 1), generator=g), torch.randn((2, M, 3), generator=g))
        xyz, vd, codes, *cot = (t.cuda().contiguous() for t in (xyz, vd, codes, *cot))
        zs, zt = (t.contiguous() for t in render.conditioned_latents(wts, codes[0], codes[1]))
        args = (xyz, vd, zs, zt)
        with torch.no_grad():
            fwd = list(zip(("sigma", "rgb"), field.field_fwd(wts, *args),
                           field.field_fwd_plain(wts, *args)))
        bwd_k = field.field_bwd(wts, *args, *cot)
        bwd_p = field.field_bwd_plain(wts, *args, *cot)
        bwd_64 = field.field_bwd_plain(as_float64(wts), *(t.double() for t in args),
                                       *(t.double() for t in cot))
        budget = render.STASH_BYTES
        if W == 256:      # one object per chunk: two K7 + K4 rounds, accumulated
            render.STASH_BYTES = M * render.stash_layout(wts, per_point=True)["ld_pt"] * 4
        try:
            tr_k = field.field_train_bwd(wts, *args, *cot)
        finally:
            render.STASH_BYTES = budget
        tr_p = field.field_train_bwd_plain(wts, *args, *cot)
        errs = []
        for name, a, b in fwd:
            err = float((a - b).abs().max())
            good = err <= VALUE_ATOL[name] and bool(torch.isfinite(a).all())
            ok &= good
            errs.append(f"{name} {err:.1e}{'' if good else ' FAIL'}")
        train = list(zip(("dxyz(train)", "dviewdir(train)", "dzs(train)", "dzt(train)"),
                         tr_k[:4], tr_p[:4], bwd_64))
        for name, a, b, b64 in list(zip(("dxyz", "dviewdir", "dzs", "dzt"), bwd_k, bwd_p,
                                         bwd_64)) + train:
            tol = GRAD_RTOL * float(b.abs().max())
            err = float(torch.minimum((a - b).abs().double(), (a.double() - b64).abs()).max())
            good = err <= tol and bool(torch.isfinite(a).all())
            ok &= good
            errs.append(f"{name} {err:.1e}{'' if good else ' FAIL'}")
        err = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                  for a, b in zip(tr_k[4], tr_p[4]))
        good = err <= GRAD_RTOL and all(bool(torch.isfinite(a).all()) for a in tr_k[4])
        ok &= good
        errs.append(f"dW(train) {err:.1e} of max{'' if good else ' FAIL'}")
        pt = torch.empty((2 * M, render.stash_layout(wts, per_point=True)["ld_pt"]), device="cuda")
        field.field_train_bwd_stash(wts, *args, *cot, pt)
        err, good = wgrad_on_stash(wts, pt, None)
        ok &= good
        errs.append(f"K4 on K7's stash {err:.1e} of max{'' if good else ' FAIL'}")
        del pt
        print(f"   field W {W} shape blocks {ns} M {M}: " + ", ".join(errs))
        ok &= gates_against_k5(wts, args, cot)[1]
    if not ok:
        raise RuntimeError("a field kernel disagrees with its plain version off the main path")


def _linear_param_names(wts):
    from supnerf_tpu_torch.ops import render

    return [f"{n}.{k}" for n in render.linear_names(wts.n_shape, wts.n_tex)
            for k in ("weight", "bias")]


TTO_KERNELS = ("render_fwd", "render_bwd")
TRAIN_KERNELS = ("render_fwd", "render_train_bwd", "wgrad")
TRAIN_RENDER_DATA_KERNELS = ("render_fwd", "render_train_bwd_data", "wgrad")
TRAIN_FIELD_KERNELS = ("field_fwd", "field_train_bwd", "wgrad")
DEMO_KERNELS = ("render_fwd", "render_fwd_aabb", "render_bwd_aabb")
REG_CLI_KERNELS = ("render_fwd", "render_bwd", "field_fwd", "field_bwd")
REG_LIB_KERNELS = ("render_fwd", "field_fwd", "field_bwd")
# the hand-written kernel behind each counter
KERNEL_OF = {"render_fwd": "K1", "render_fwd_aabb": "K1", "render_bwd": "K2",
             "render_bwd_aabb": "K2", "render_train_bwd": "K3", "render_train_bwd_data": "K3",
             "wgrad": "K4", "field_fwd": "K5", "field_bwd": "K6", "field_train_bwd": "K7"}


def _in_temp_dir(fn):
    out_dir = tempfile.mkdtemp(prefix="supnerf_smoke_")
    try:
        return fn(out_dir)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def _path_counts(name, kernels):
    from supnerf_tpu_torch.ops import render

    counts = {k: render.LAUNCHES[k] for k in kernels}
    print(f"   launches on the {name} path: {counts}")
    if min(counts.values()) == 0:
        raise RuntimeError(f"a kernel of the {name} path never launched: {counts}")
    return counts


def _plain_counts(name):
    """The launch counts of a path on the plain decoder (the original
    AutoRF, which has no TPU kernel in the JAX package): every one 0."""
    from supnerf_tpu_torch.ops import render

    counts = dict(render.LAUNCHES)
    print(f"   launches on the {name} path: none (route: plain, no TPU kernel in the JAX "
          "package)")
    if any(counts.values()):
        raise RuntimeError(f"the {name} path launched a kernel: {counts}")
    return counts


def tto_path(out_dir, config=None, label="TTO", replay=False, kernels=TTO_KERNELS):
    """The port's CLI TTO at the published config (or `config`) on 2
    synthetic objects, writing into out_dir. With replay (an arch without a
    refiner) the pose errors of iterations 0..3 must be equal: those
    iterations render the replayed pose_init. Returns the launch counts
    (kernels None: the plain decoder's route, where no kernel may launch)."""
    import numpy as np
    import torch

    from supnerf_tpu_torch.cli import optimize
    from supnerf_tpu_torch.ops import render

    config = config or os.path.join(HERE, "jsonfiles", "supnerf.nusc.vehicle.car.json")
    render.reset_launch_counts()
    t0 = time.perf_counter()
    summary = optimize.main([
        "--config_file", config, "--dataset", "synthetic", "--num_objects", "2",
        "--batch_size", "2", "--device", "cuda", "--seed", "0", "--save_dir", out_dir])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = _path_counts(label, kernels) if kernels else _plain_counts(label)
    print(f"   {label} path: {seconds:.2f} s for 2 objects, {2 * 60 / seconds:.1f} objects/min "
          "end to end through the CLI; phases: " + ", ".join(
        f"{k} {v:.2f} s" for k, v in summary["phase_seconds"].items()))
    result_file = os.path.join(out_dir, "codes+poses.pkl")
    if not os.path.exists(result_file):
        raise RuntimeError("codes+poses.pkl was not written")
    with open(result_file, "rb") as f:
        res = pickle.load(f)
    curves = [np.asarray(v, np.float64) for key in ("psnr_eval", "R_eval", "T_eval",
                                                     "depth_err_mean")
              for v in res[key].values()]
    if len(res["psnr_eval"]) != 2 or not all(np.isfinite(c).all() and len(c) == 100
                                               for c in curves):
        raise RuntimeError("the result curves are missing or not finite")
    if replay:
        errs = [v[:4] for key in ("R_eval", "T_eval") for v in res[key].values()]
        if not all(len(set(e)) == 1 for e in errs):
            raise RuntimeError(f"{label}: iterations 0..3 did not render one pose: {errs}")
        print(f"   {label}: iterations 0..3 render pose_init (the replayed trajectory: rotation "
              f"and translation errors constant over them)")
    agg = summary["aggregate"]
    print(f"   final: psnr {agg['psnr'][-1]:.3f} dB, rot err {agg['rot_err_deg'][-1]:.3f} deg, "
          f"trans err {agg['trans_err'][-1]:.4f} m, depth err {agg['depth_err'][-1]:.4f} m "
          f"(iteration 0: psnr {agg['psnr'][0]:.3f}, rot {agg['rot_err_deg'][0]:.3f}, "
          f"trans {agg['trans_err'][0]:.4f})")
    return counts


def train_path(out_dir, config=None, label="training", epochs=2, kernels=TRAIN_KERNELS):
    """The port's CLI training at the published config (or `config`): 16
    synthetic objects, batch 8, `epochs` epochs (2: 4 steps), then with 2
    epochs a run resumed from epoch_0, and the TTO loader on the last
    checkpoint. Returns the launch counts of the run (kernels None: the
    plain decoder's route, where no kernel may launch)."""
    import math

    import numpy as np
    import torch

    from supnerf_tpu_torch.cli import train
    from supnerf_tpu_torch.cli.common import load_model_and_codes
    from supnerf_tpu_torch.config import load_hpams
    from supnerf_tpu_torch.ops import render

    config = config or os.path.join(HERE, "jsonfiles", "supnerf.nusc.vehicle.car.json")
    run_dir, resume_dir = os.path.join(out_dir, "run"), os.path.join(out_dir, "resumed")
    argv = ["--config_file", config, "--dataset", "synthetic",
            "--num_objects", str(TRAIN_OBJECTS), "--batch_size", str(TRAIN_BATCH),
            "--epochs", str(epochs), "--device", "cuda", "--seed", "0", "--check_iter", "1"]
    render.reset_launch_counts()
    summary = train.main(argv + ["--save_dir", run_dir])
    torch.cuda.synchronize()
    counts = _path_counts(label, kernels) if kernels else _plain_counts(label)
    if render.LAUNCHES["render_train_bwd_data"] != 0:
        raise RuntimeError("the training step ran K3's data mode: its batches are data")
    steps = summary["metrics"]
    n_steps = epochs * TRAIN_OBJECTS // TRAIN_BATCH
    if len(steps) != n_steps:
        raise RuntimeError(f"{len(steps)} training steps instead of {n_steps}")
    if not all(math.isfinite(m[k]) for m in steps for k in ("loss_total", "loss_rgb",
                                                            "loss_occ", "psnr")):
        raise RuntimeError(f"a training loss is not finite: {steps}")
    last = epochs - 1
    for name in ("epoch_0.pth", f"epoch_{last}.pth", f"epoch_{last}_optim.pth", "models.pth"):
        if not os.path.exists(os.path.join(run_dir, name)):
            raise RuntimeError(f"{name} was not written")
    ph = summary["phase_seconds"]
    loop = sum(m["seconds"] for m in steps)
    print(f"   {label} path: {len(steps)} steps of {TRAIN_BATCH} objects in "
          f"{summary['seconds']:.2f} s end to end through the CLI (checkpoints included): "
          f"{len(steps) / summary['seconds']:.2f} steps/s, "
          f"{len(steps) * TRAIN_BATCH / summary['seconds']:.1f} objects/s; "
          f"the step loop alone {len(steps) / loop:.2f} steps/s")
    print(f"   phase split (s, {len(steps)} steps; forward includes render): " + ", ".join(
        f"{k} {v:.3f}" for k, v in ph.items()))
    print("   per step (s): " + ", ".join(f"{m['seconds']:.3f}" for m in steps))
    print("   last step's split (s; forward includes render): " + ", ".join(
        f"{k} {v:.4f}" for k, v in steps[-1]["phase_seconds"].items()))
    print("   losses: " + ", ".join(f"{m['loss_total']:.4f}" for m in steps))
    _host_split(f"{label} (--num_workers 0)", summary, TRAIN_BATCH)

    if epochs == 2:
        resumed = train.main(argv + ["--save_dir", resume_dir, "--resume_dir", run_dir,
                                     "--resume_from_epoch", "0"])["metrics"]
        want, got = steps[2]["loss_total"], resumed[0]["loss_total"]
        print(f"   resumed from epoch_0: step 3 loss {got:.7f} against {want:.7f} "
              f"(rel diff {abs(got - want) / abs(want):.2e}, tol {RESUME_RTOL:.0e})")
        if not abs(got - want) <= RESUME_RTOL * abs(want):
            raise RuntimeError("the resumed run does not repeat step 3's loss")

    hpams = dict(load_hpams(config), model_dir=run_dir)
    model, mean_shape, mean_texture = load_model_and_codes(hpams, "cuda", model_epoch=last)
    if not (np.isfinite(mean_shape).all() and np.isfinite(mean_texture).all()):
        raise RuntimeError("the checkpoint's mean codes are not finite")
    print(f"   load_model_and_codes strict-loaded epoch_{last}.pth "
          f"({sum(p.numel() for p in model.parameters()) / 1e6:.1f} M parameters)")
    return counts


def read_png(path):
    """Decode an 8-bit RGB PNG (colour type 2, no interlace, scanline
    filters None and Up) with numpy and zlib; (H, W, 3) uint8. Independent
    of the port's writer (supnerf_tpu_torch/utils/image_io.py, filter None
    only), so a round trip checks it."""
    import struct
    import zlib

    import numpy as np

    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos, idat, hdr = 8, b"", None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0] != zlib.crc32(kind + body):
            raise ValueError(f"{path}: bad CRC in {kind!r}")
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    w, h, depth, ctype, _, _, interlace = hdr
    if (depth, ctype, interlace) != (8, 2, 0):
        raise ValueError(f"{path}: only 8-bit RGB without interlace is read")
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    if not np.isin(raw[:, 0], (0, 2)).all():
        raise ValueError(f"{path}: only the scanline filters None and Up are read")
    out = np.zeros((h, 3 * w), np.uint8)
    for y in range(h):
        up = out[y - 1] if y > 0 and raw[y, 0] == 2 else 0
        out[y] = raw[y, 1:] + up                # uint8 arithmetic wraps mod 256
    return out.reshape(h, w, 3)


def demo_path(out_dir):
    """The port's demo CLI at hpam_demo.json: AABB-bounded TTO of the three
    cars of a 900 x 1600 synthetic scene, then the six composed frames.
    Returns the launch counts."""
    import numpy as np
    import torch

    from supnerf_tpu_torch.cli import demo
    from supnerf_tpu_torch.ops import render
    from supnerf_tpu_torch.utils.image_io import image_float_to_uint8

    render.reset_launch_counts()
    t0 = time.perf_counter()
    summary = demo.main([
        "--config_file", os.path.join(HERE, "jsonfiles", "hpam_demo.json"),
        "--dataset", "synthetic", "--n_objects", str(DEMO_OBJECTS),
        "--num_opts", str(DEMO_ITERS), "--device", "cuda", "--seed", "0", "--save_dir", out_dir])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = _path_counts("demo", DEMO_KERNELS)
    if (counts["render_fwd_aabb"] != DEMO_ITERS
            or counts["render_bwd_aabb"] != DEMO_ITERS - 4):
        raise RuntimeError(f"expected {DEMO_ITERS} AABB forwards and {DEMO_ITERS - 4} "
                           f"backwards (reg_iters 3 replays make no update): {counts}")
    res = summary["results"]
    curves = [np.asarray(v, np.float64) for key in ("psnr_eval", "R_eval", "T_eval",
                                                     "depth_err_mean")
              for v in res[key].values()]
    if len(res["psnr_eval"]) != DEMO_OBJECTS or not all(
            np.isfinite(c).all() and len(c) == DEMO_ITERS for c in curves):
        raise RuntimeError("the demo's TTO curves are missing or not finite")
    if not all(np.isfinite(img).all() for img in summary["images"]):
        raise RuntimeError("a composed frame is not finite")
    inp = read_png(os.path.join(out_dir, "input.png"))
    if inp.shape != (900, 1600, 3):
        raise RuntimeError(f"input.png decodes to {inp.shape}")
    for path, img in zip(summary["frames"], summary["images"]):
        if not np.array_equal(read_png(path), image_float_to_uint8(img)):
            raise RuntimeError(f"{path} does not decode to its frame")
    win_w, win_h = summary["win_hw"]
    fs = summary["frame_seconds"]
    print(f"   demo CLI: {seconds:.2f} s end to end; TTO {summary['tto_seconds']:.2f} s for "
          f"{DEMO_OBJECTS} objects ({DEMO_OBJECTS * 60 / summary['tto_seconds']:.1f} objects/min, "
          "host prep and result files included); phases: " + ", ".join(
              f"{k} {v:.2f} s" for k, v in summary["phase_seconds"].items()))
    print(f"   {len(fs)} scene frames of {win_w} x {win_h} = {win_w * win_h} rays x "
          f"{DEMO_OBJECTS} objects x 64 samples: " + ", ".join(f"{t:.3f}" for t in fs)
          + " s (the first includes the allocator's warm-up)")
    print("   wlh_used (the untrained wlh head's output at random weights): " + "; ".join(
        f"{k} {np.round(v, 4).tolist()}" for k, v in summary["wlh_used"].items()))
    # the AABB kernels run the decoder only on rays that hit the box, so the
    # hit share says how much decoder work the demo path's launches did
    share = np.asarray(list(summary["hit_share"].values()), np.float64)   # (objects, iters)
    if share.shape != (DEMO_OBJECTS, DEMO_ITERS) or not np.isfinite(share).all():
        raise RuntimeError(f"the demo's hit-share curves are missing: {share.shape}")
    print("   loss rays in the box per object, mean (min .. max) over the iterations: "
          + "; ".join(f"{k} {s.mean():.4f} ({s.min():.4f} .. {s.max():.4f})"
                      for k, s in zip(summary["hit_share"], share))
          + f"; all objects and iterations {share.mean():.4f}")
    for k in res["psnr_eval"]:
        print(f"   {k}: psnr {res['psnr_eval'][k][0]:.3f} -> {res['psnr_eval'][k][-1]:.3f}, "
              f"rot err {res['R_eval'][k][0]:.3f} -> {res['R_eval'][k][-1]:.3f}, "
              f"trans err {res['T_eval'][k][0]:.4f} -> {res['T_eval'][k][-1]:.4f}, "
              f"depth err {res['depth_err_mean'][k][-1]:.4f}")
    print(f"   input.png {inp.shape} and {len(fs)} frames decode with read_png")
    return counts


def _reg_config(out_dir):
    """A copy of the published config with the two regulariser keys on."""
    with open(os.path.join(HERE, "jsonfiles", "supnerf.nusc.vehicle.car.json")) as f:
        config = json.load(f)
    config.update(obj_sz_reg=1, sym_aug=1)
    path = os.path.join(out_dir, "supnerf.nusc.vehicle.car.reg.json")
    with open(path, "w") as f:
        json.dump(config, f)
    return path


def _check_curves(name, curves, n_objects, n_iters):
    import numpy as np

    curves = [np.asarray(c, np.float64) for c in curves]
    if len(curves) % n_objects or not all(c.shape == (n_iters,) and np.isfinite(c).all()
                                          for c in curves):
        raise RuntimeError(f"the {name} path's curves are missing or not finite")


def reg_cli_path(out_dir):
    """(a) The port's CLI TTO with "obj_sz_reg": 1 and "sym_aug": 1 in a
    copy of the published config, 2 synthetic objects, 100 iterations:
    the loss render on K1/K2, the object-size loss on K5/K6. Returns the
    launch counts."""
    import torch

    from supnerf_tpu_torch.cli import optimize
    from supnerf_tpu_torch.ops import render

    config = _reg_config(out_dir)
    render.reset_launch_counts()
    t0 = time.perf_counter()
    summary = optimize.main([
        "--config_file", config, "--dataset", "synthetic", "--num_objects", str(REG_OBJECTS),
        "--batch_size", str(REG_OBJECTS), "--device", "cuda", "--seed", "0",
        "--save_dir", os.path.join(out_dir, "run")])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = _path_counts("regulariser CLI", REG_CLI_KERNELS)
    with open(os.path.join(out_dir, "run", "codes+poses.pkl"), "rb") as f:
        res = pickle.load(f)
    _check_curves("regulariser CLI", [v for key in ("psnr_eval", "R_eval", "T_eval",
                                                     "depth_err_mean")
                                      for v in res[key].values()]
                  + list(summary["loss"].values()), REG_OBJECTS, REG_ITERS)
    agg = summary["aggregate"]
    print(f"   regulariser CLI (obj_sz_reg 1, sym_aug 1): {seconds:.2f} s for {REG_OBJECTS} "
          f"objects end to end; phases: " + ", ".join(
              f"{k} {v:.2f} s" for k, v in summary["phase_seconds"].items()))
    print(f"   final: psnr {agg['psnr'][-1]:.3f} dB, rot err {agg['rot_err_deg'][-1]:.3f} deg, "
          f"trans err {agg['trans_err'][-1]:.4f} m (iteration 0: psnr {agg['psnr'][0]:.3f}, "
          f"rot {agg['rot_err_deg'][0]:.3f}, trans {agg['trans_err'][0]:.4f}); loss first -> "
          "last: " + "; ".join(f"{k} {v[0]:.5f} -> {v[-1]:.5f}"
                               for k, v in summary["loss"].items()))
    return counts


def reg_lib_path(out_dir):
    """(b) run_tto_batch with sym_aug, obj_sz_reg and sym_loss_coef 1.0 at
    the published config on 2 synthetic objects, 100 iterations: the loss
    render goes through the per-point field (K5/K6 at 65,536 points per
    object) and volume_render, its mirror for the symmetry loss too, and the
    object-size loss. Returns the launch counts."""
    import dataclasses

    import numpy as np
    import torch

    from supnerf_tpu_torch.cli.common import SyntheticDataset, load_model_and_codes
    from supnerf_tpu_torch.config import load_hpams
    from supnerf_tpu_torch.ops import render
    from supnerf_tpu_torch.tto.core import run_tto_batch
    from supnerf_tpu_torch.tto.driver import TTODriver, tto_config_from_hpams

    hpams = load_hpams(_reg_config(out_dir))
    cfg = dataclasses.replace(tto_config_from_hpams(hpams), sym_loss_coef=1.0)
    if not (cfg.sym_aug and cfg.obj_sz_reg and cfg.num_opts == REG_ITERS):
        raise RuntimeError(f"the regulariser config did not reach TTOConfig: {cfg}")
    model, mean_shape, mean_texture = load_model_and_codes(hpams, "cuda", seed=0)
    driver = TTODriver(model, mean_shape, mean_texture, hpams, SyntheticDataset(REG_OBJECTS),
                       out_dir, device="cuda", cfg=cfg, batch_size=REG_OBJECTS)
    _, _, batch = driver._prep(list(range(REG_OBJECTS)))
    render.reset_launch_counts()
    t0 = time.perf_counter()
    res = run_tto_batch(model, driver.wts, batch, driver.mean_shape, driver.mean_texture, cfg,
                        generator=driver.render_gen)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = _path_counts("regulariser library", REG_LIB_KERNELS)
    res = {k: v.detach().cpu().numpy() for k, v in res.items()}
    _check_curves("regulariser library", [c for k in ("psnr", "rot_err", "trans_err",
                                                       "depth_err", "loss") for c in res[k]],
                  REG_OBJECTS, REG_ITERS)
    print(f"   run_tto_batch (sym_aug, obj_sz_reg, sym_loss_coef 1.0): {seconds:.2f} s for "
          f"{REG_OBJECTS} objects x {REG_ITERS} iterations ({seconds / REG_ITERS * 1e3:.1f} ms "
          "per iteration)")
    for b in range(REG_OBJECTS):
        print(f"   object {b}: psnr {res['psnr'][b, 0]:.3f} -> {res['psnr'][b, -1]:.3f}, rot err "
              f"{np.degrees(res['rot_err'][b, 0]):.3f} -> {np.degrees(res['rot_err'][b, -1]):.3f} "
              f"deg, trans err {res['trans_err'][b, 0]:.4f} -> {res['trans_err'][b, -1]:.4f} m, "
              f"loss {res['loss'][b, 0]:.5f} -> {res['loss'][b, -1]:.5f}")
    return counts


def _decoder_params(model):
    """The decoder's layers and its latent projections, weight and bias each."""
    from supnerf_tpu_torch.ops import render

    ns, nt = model.shape_blocks, model.texture_blocks
    names = (render.linear_names(ns, nt) + [f"shape_latent_layer_{j}.0" for j in range(1, ns + 1)]
             + [f"texture_latent_layer_{j}.0" for j in range(1, nt + 1)])
    return [getattr(model.get_submodule(n), k) for n in names for k in ("weight", "bias")]


def _training_kernel_path(name, kernels, step, out_names, plain):
    """Drives `step` (forward, loss, backward; returns the loss, the
    gradients, the data's gradients and the forward's outputs) once with
    the launch counts set to 0 just before and read just after, holds the
    forward's outputs against `plain()` (the forward kernel's plain version
    on the same inputs) within VALUE_ATOL, checks that every gradient is
    finite and that the data's are not all zero, then times one more call
    with CUDA events. Returns the launch counts, the timed call's ms and the
    forward's max abs error."""
    import torch

    from supnerf_tpu_torch.ops import render

    render.reset_launch_counts()
    loss, grads, data, outs = step()
    torch.cuda.synchronize()
    counts = _path_counts(name, kernels)
    with torch.no_grad():
        ref = plain()
    err_fwd, ok_fwd = compare(out_names, [o.detach() for o in outs], ref,
                              lambda n, s: VALUE_ATOL[n])
    del outs, ref
    if not ok_fwd:
        raise RuntimeError(f"the {name} path's forward kernel disagrees with its plain version")
    if not (torch.isfinite(loss) and all(bool(torch.isfinite(g).all()) for g in grads)):
        raise RuntimeError(f"the {name} path's loss or a gradient is not finite")
    if not all(float(g.abs().max()) > 0 for g in data):
        raise RuntimeError(f"a data gradient of the {name} path is zero")
    print(f"   loss {float(loss.detach()):.6f}; {len(grads)} gradients finite, of them "
          + ", ".join(f"{k} max |.| {float(g.abs().max()):.3e}" for k, g in zip(
              ("dxyz", "dviewdir", "dz"), data)))
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    step()
    t1.record()
    torch.cuda.synchronize()
    ms = t0.elapsed_time(t1)
    print(f"   one forward + backward at batch {SWEEP_BATCH}: {ms:.1f} ms")
    return counts, ms, err_fwd


def train_render_data_path():
    """field_composite_train at its default data_grads=True at the published
    config's width and the sweep scripts' batch 48 x 1024 rays x 64
    samples, with a loss head on rgb, depth and acc whose gradient reaches
    every decoder weight, the latent projections, the codes, and xyz,
    viewdir and z: K1, then K3's data mode and K4 per stash chunk. Returns
    the launch counts and the timed call's ms."""
    import torch

    from supnerf_tpu_torch.ops import render

    model = published_model(5)
    _, (xyz, vd, z, _, _), _ = kernel_inputs(seed=5, B=SWEEP_BATCH, model=model)
    g = torch.Generator(device="cuda").manual_seed(5)
    codes = torch.randn((2, SWEEP_BATCH, 256), generator=g, device="cuda") * 0.3
    target = torch.rand((SWEEP_BATCH, xyz.shape[1], 3), generator=g, device="cuda")
    params = _decoder_params(model)

    def step():
        data = [t.detach().requires_grad_(True) for t in (xyz, vd, z)]
        sc, tc = (c.detach().requires_grad_(True) for c in codes)
        rgb, depth, acc = render.field_composite_train(model, *data, sc, tc)
        loss = ((rgb - target) ** 2).mean() + (acc ** 2).mean() + 1e-3 * depth.mean()
        grads = torch.autograd.grad(loss, params + [sc, tc] + data)
        return loss, grads, grads[-3:], (rgb, depth, acc)

    def plain():
        return render.render_fwd_plain(render.pack_decoder_params(model), xyz, vd, z,
                                       *render.conditioned_latents_of(model, *codes))

    print(f"   field_composite_train(data_grads=True), {SWEEP_BATCH} objects x {xyz.shape[1]} "
          f"rays x {xyz.shape[2]} samples:")
    out = _training_kernel_path("training render with data gradients",
                                TRAIN_RENDER_DATA_KERNELS, step, ("rgb", "depth", "acc"), plain)
    if render.LAUNCHES["render_train_bwd"] != 0:
        raise RuntimeError("the data-gradient path ran K3's other mode")
    return out


def train_field_path():
    """field_train at the published config's width and the sweep scripts'
    batch 48 x 65,536 points (1024 rays x 64 samples each, a direction per
    point), with test_pallas_field.py's loss head on sigma and rgb, whose
    gradient reaches every decoder weight, the latent projections, the
    codes, and xyz and viewdir: K5, then K7 and K4 per stash chunk. Returns
    the launch counts and the timed call's ms."""
    import torch

    from supnerf_tpu_torch.ops import field, render

    model = published_model(6)
    _, (pts, dirs, _, _), _ = field_train_inputs(seed=6, B=SWEEP_BATCH, model=model)
    g = torch.Generator(device="cuda").manual_seed(6)
    codes = torch.randn((2, SWEEP_BATCH, 256), generator=g, device="cuda") * 0.3
    params = _decoder_params(model)

    def step():
        data = [t.detach().requires_grad_(True) for t in (pts, dirs)]
        sc, tc = (c.detach().requires_grad_(True) for c in codes)
        sigma, rgb = field.field_train(model, *data, sc, tc)
        loss = (sigma * 0.7).mean() + ((rgb - 0.2) ** 2).mean()
        grads = torch.autograd.grad(loss, params + [sc, tc] + data)
        return loss, grads, grads[-2:], (sigma, rgb)

    def plain():
        return field.field_fwd_plain(render.pack_decoder_params(model), pts, dirs,
                                     *render.conditioned_latents_of(model, *codes))

    print(f"   field_train, {SWEEP_BATCH} objects x {pts.shape[1]} points:")
    return _training_kernel_path("training field", TRAIN_FIELD_KERNELS, step,
                                 ("sigma", "rgb"), plain)


# --------------------------------------------------------------------------
# phase 9: the dataset paths (nuScenes, KITTI, Waymo readers; the demo's
# nuScenes input), on fixtures written here with numpy
# --------------------------------------------------------------------------

NUSC_FIXTURE_JPEG = os.path.join(HERE, "tests", "fixtures", "nusc_cam_1600x900.jpg")
# sha256 of the port JPEG decoder's output on NUSC_FIXTURE_JPEG (pinned in
# tests/test_torch_image_io.py too)
NUSC_FIXTURE_SHA256 = "f6fb7108f44ca32a052627fc004188009e20f3de1b5a4cc5d1940f0942d3f078"
NUSC_K = [[1266.417203046554, 0.0, 816.2670197447984], [0.0, 1266.417203046554, 491.50706579294757],
          [0.0, 0.0, 1.0]]
NUSC_WLH = [1.95, 4.6, 1.72]
# KITTI's published calibration of training frame 000000 (P2, R0_rect, Tr_velo_to_cam)
KITTI_P2 = [[721.5377, 0.0, 609.5593, 44.85728], [0.0, 721.5377, 172.854, 0.2163791],
            [0.0, 0.0, 1.0, 0.002745884]]
KITTI_R0 = [[0.9999239, 0.00983776, -0.007445048], [-0.009869795, 0.9999421, -0.004278459],
            [0.007402527, 0.004351614, 0.9999631]]
KITTI_V2C = [[7.533745e-03, -9.999714e-01, -6.166020e-04, -4.069766e-03],
             [1.480249e-02, 7.280733e-04, -9.998902e-01, -7.631618e-02],
             [9.998621e-01, 7.523790e-03, 1.480755e-02, -2.717806e-01]]
DATASET_ITERS = 100


def _rot_z(a):
    import numpy as np

    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def _quat(R):
    """[w, x, y, z] of a rotation matrix."""
    import numpy as np

    m = np.asarray(R, np.float64)
    t = np.trace(m)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        q = [s / 4, (m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s, (m[1, 0] - m[0, 1]) / s]
    else:
        i = int(np.argmax(np.diag(m)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(1.0 + m[i, i] - m[j, j] - m[k, k]) * 2
        q = [0.0] * 4
        q[0] = (m[k, j] - m[j, k]) / s
        q[1 + i] = s / 4
        q[1 + j] = (m[j, i] + m[i, j]) / s
        q[1 + k] = (m[k, i] + m[i, k]) / s
    return [float(v) for v in q]


def _hull_mask(shape, uv):
    """uint8 mask (255 inside) of the convex hull of the pixels uv (2, N)."""
    import numpy as np

    from supnerf_tpu_torch.data.synthetic import _convex_hull, _fill_convex

    return np.where(_fill_convex(shape, np.round(_convex_hull(uv.T))), 255, 0).astype(np.uint8)


def write_nusc_fixture(root):
    """A v1.0-mini nuScenes dataroot in nuScenes' own schema: scene-0103 (a
    day log, val) with 2 key frames of 2 cars each, and scene-0916 (a night
    log, val) with 1 car that curation must drop. Ego poses at the camera's
    and the lidar's times differ, and sensor calibrations are not the
    identity; camera images are copies of the committed 1600 x 900 JPEG;
    each image has the segmentation's car masks (convex hulls of the
    projected boxes), a pedestrian mask and its prediction JSON; each sweep a
    .pcd.bin with points on the cars and on the ground. Returns the camera
    file names."""
    import numpy as np

    from supnerf_tpu_torch.utils.image_io import write_png

    rng = np.random.default_rng(0)
    K = np.asarray(NUSC_K)
    r_base = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])   # camera -> ego
    pitch = np.array([[1.0, 0, 0], [0, np.cos(0.01), -np.sin(0.01)], [0, np.sin(0.01),
                                                                        np.cos(0.01)]])
    cam_cs = (r_base @ pitch, np.array([1.70079, 0.0159, 1.51095]))
    lidar_cs = (_rot_z(-np.pi / 2 + 0.003), np.array([0.943713, 0.0, 1.84023]))
    upright = np.array([[1.0, 0, 0], [0, 0, -1.0], [0, 1.0, 0]])              # object -> camera
    t = {k: [] for k in ("category", "sensor", "calibrated_sensor", "ego_pose", "log", "scene",
                         "sample", "sample_data", "sample_annotation", "instance")}
    t["category"] = [{"token": "cat_car", "name": "vehicle.car", "description": ""}]
    t["sensor"] = [{"token": "s_cam", "channel": "CAM_FRONT", "modality": "camera"},
                   {"token": "s_lidar", "channel": "LIDAR_TOP", "modality": "lidar"}]
    t["calibrated_sensor"] = [
        {"token": "cs_cam", "sensor_token": "s_cam", "rotation": _quat(cam_cs[0]),
         "translation": cam_cs[1].tolist(), "camera_intrinsic": NUSC_K},
        {"token": "cs_lidar", "sensor_token": "s_lidar", "rotation": _quat(lidar_cs[0]),
         "translation": lidar_cs[1].tolist(), "camera_intrinsic": []}]
    scenes = [("scene-0103", 11, [[(-2.8, 0.9, 13.0, 0.4), (3.0, 0.85, 17.0, -0.6)],
                                  [(-2.6, 0.9, 14.0, 0.45), (2.8, 0.85, 18.5, -0.55)]]),
              ("scene-0916", 19, [[(0.5, 0.9, 15.0, 1.1)]])]
    jpeg = open(NUSC_FIXTURE_JPEG, "rb").read()
    for d in ("samples/CAM_FRONT", "samples/LIDAR_TOP", "pred_instance/CAM_FRONT", "v1.0-mini"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    names = []
    for si, (scene, hour, samples) in enumerate(scenes):
        log = f"n015-2018-07-24-{hour:02d}-22-45+0800"
        t["log"].append({"token": f"log{si}", "logfile": log, "vehicle": "n015",
                         "date_captured": "2018-07-24", "location": "singapore-onenorth"})
        t["scene"].append({"token": f"sc{si}", "name": scene, "log_token": f"log{si}",
                           "description": "", "nbr_samples": len(samples)})
        for k in range(len(samples[0])):
            t["instance"].append({"token": f"ins{si}_{k}", "category_token": "cat_car"})
        for j, cars in enumerate(samples):
            smp, stamp = f"smp{si}_{j}", 1532402927612460 + 500000 * (2 * si + j)
            t["sample"].append({"token": smp, "scene_token": f"sc{si}", "timestamp": stamp})
            ego = {"cam": (_rot_z(0.7 + 0.02 * j), np.array([411.3 + 3 * j, 1180.9, 0.0])),
                   "lidar": (_rot_z(0.69 + 0.02 * j), np.array([411.0 + 3 * j, 1180.7, 0.0]))}
            stem = f"{log}__CAM_FRONT__{stamp}"
            names.append(stem + ".jpg")
            for ch, cs, fn in (("cam", "cs_cam", f"samples/CAM_FRONT/{stem}.jpg"),
                               ("lidar", "cs_lidar", f"samples/LIDAR_TOP/{stem}.pcd.bin")):
                sd = f"sd_{ch}{si}_{j}"
                t["ego_pose"].append({"token": f"ep_{sd}", "rotation": _quat(ego[ch][0]),
                                      "translation": ego[ch][1].tolist(), "timestamp": stamp})
                t["sample_data"].append({
                    "token": sd, "sample_token": smp, "ego_pose_token": f"ep_{sd}",
                    "calibrated_sensor_token": cs, "filename": fn, "is_key_frame": True,
                    "timestamp": stamp, "width": 1600 if ch == "cam" else 0,
                    "height": 900 if ch == "cam" else 0, "prev": "", "next": "",
                    "fileformat": "jpg" if ch == "cam" else "pcd"})
            with open(os.path.join(root, "samples/CAM_FRONT", stem + ".jpg"), "wb") as f:
                f.write(jpeg)

            def to_global(p):
                return ego["cam"][0] @ (cam_cs[0] @ p + cam_cs[1][:, None]) + ego["cam"][1][:, None]

            preds, cam_pts = {"labels": [], "boxes": []}, []
            for k, (x, y, z, yaw) in enumerate(cars):
                R = upright @ _rot_z(yaw)
                w, l, h = NUSC_WLH
                local = np.vstack([l / 2 * np.array([1, 1, 1, 1, -1, -1, -1, -1]),
                                   w / 2 * np.array([1, -1, -1, 1, 1, -1, -1, 1]),
                                   h / 2 * np.array([1, 1, -1, -1, 1, 1, -1, -1])])
                corners = R @ local + np.array([[x], [y], [z]])
                uv = K @ corners
                uv = uv[:2] / uv[2:]
                mask = _hull_mask((900, 1600), uv)
                write_png(os.path.join(root, "pred_instance/CAM_FRONT",
                                       f"{stem}_{len(preds['boxes'])}.png"), mask)
                preds["labels"].append("car")
                preds["boxes"].append([float(v) for v in (uv[0].min(), uv[1].min(),
                                                          uv[0].max(), uv[1].max())])
                c_g = to_global(np.array([[x], [y], [z]]))[:, 0]
                t["sample_annotation"].append({
                    "token": f"ann{si}_{j}_{k}", "sample_token": smp,
                    "instance_token": f"ins{si}_{k}", "size": NUSC_WLH,
                    "translation": c_g.tolist(),
                    "rotation": _quat(ego["cam"][0] @ cam_cs[0] @ R), "visibility_token": "4",
                    "attribute_tokens": [], "num_lidar_pts": 60, "num_radar_pts": 0,
                    "prev": "", "next": ""})
                pts = rng.uniform(-0.35, 0.35, (3, 60)) * np.array([[l], [w], [h]])
                cam_pts.append(R @ pts + np.array([[x], [y], [z]]))
            person = np.zeros((900, 1600), np.uint8)
            person[420:600, 1400:1460] = 255
            write_png(os.path.join(root, "pred_instance/CAM_FRONT",
                                   f"{stem}_{len(preds['boxes'])}.png"), person)
            preds["labels"].append("person")
            preds["boxes"].append([1400.0, 420.0, 1460.0, 600.0])
            with open(os.path.join(root, "pred_instance/CAM_FRONT", stem + ".json"), "w") as f:
                json.dump(preds, f)
            ground = np.vstack([rng.uniform(-12, 12, 400), np.full(400, 1.55),
                                rng.uniform(4, 45, 400)])
            p_g = to_global(np.concatenate(cam_pts + [ground], 1))
            p_l = lidar_cs[0].T @ (ego["lidar"][0].T @ (p_g - ego["lidar"][1][:, None])
                                   - lidar_cs[1][:, None])
            sweep = np.zeros((p_l.shape[1], 5), np.float32)
            sweep[:, :3] = p_l.T
            sweep[:, 3] = rng.uniform(0, 100, p_l.shape[1])
            sweep.tofile(os.path.join(root, "samples/LIDAR_TOP", stem + ".pcd.bin"))
    for name, rows in t.items():
        with open(os.path.join(root, "v1.0-mini", name + ".json"), "w") as f:
            json.dump(rows, f)
    return names


def write_kitti_fixture(root, layout, frames):
    """A KITTI-format training split under root (layout 'kitti': image_2/
    label_2/, 'waymo': image/ label/) with calib/, velodyne/, pred/ (the
    third-party detections of mode 3: each car moved 0.3 m and turned 0.08
    rad), pred_instance/ (the segmentation's masks and JSONs) and
    ImageSets/val.txt. frames: per frame, the cars as (x, z, ry) on the
    ground at y 1.65 in the rectified camera frame; each frame also labels
    an occluded car (occlusion 3) that curation must drop. Images are
    1242 x 375 crops of the committed street scene."""
    import numpy as np

    from supnerf_tpu_torch.data.jpeg import read_jpeg
    from supnerf_tpu_torch.utils.image_io import write_png

    rng = np.random.default_rng(1)
    P = np.asarray(KITTI_P2)
    K = P[:, :3]
    img_d, lbl_d = ("image_2", "label_2") if layout == "kitti" else ("image", "label")
    tr = os.path.join(root, "training")
    for d in ("calib", img_d, lbl_d, "velodyne", "pred", "pred_instance"):
        os.makedirs(os.path.join(tr, d), exist_ok=True)
    os.makedirs(os.path.join(root, "ImageSets"), exist_ok=True)
    street = read_jpeg(NUSC_FIXTURE_JPEG)[450:825, 179:1421]
    velo_to_rect = np.asarray(KITTI_R0) @ np.asarray(KITTI_V2C)
    ids = []
    for f, cars in enumerate(frames):
        idx = "%06d" % f
        ids.append(idx)
        with open(os.path.join(tr, "calib", idx + ".txt"), "w") as fh:
            for key, m in (("P0", P), ("P1", P), ("P2", P), ("P3", P), ("R0_rect", KITTI_R0),
                           ("Tr_velo_to_cam", KITTI_V2C)):
                fh.write(f"{key}: " + " ".join(repr(float(v)) for v in np.ravel(m)) + "\n")
        write_png(os.path.join(tr, img_d, idx + ".png"), np.ascontiguousarray(street))
        labels, dets, preds, masks, rect_pts = [], [], {"labels": [], "boxes": []}, [], []
        for x, z, ry in cars:
            h, w, l = 1.52, 1.68, 4.15
            c, s = np.cos(ry), np.sin(ry)
            R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
            T = np.array([x, 1.65, z]) + np.linalg.inv(K) @ P[:, 3]   # the readers' pose
            local = np.vstack([l / 2 * np.array([1, 1, 1, 1, -1, -1, -1, -1]),
                               h / 2 * np.array([-2, -2, 0, 0, -2, -2, 0, 0]),
                               w / 2 * np.array([1, -1, -1, 1, 1, -1, -1, 1])])
            uv = K @ (R @ local + T[:, None])
            uv = uv[:2] / uv[2:]
            box = [uv[0].min(), uv[1].min(), uv[0].max(), uv[1].max()]
            labels.append(f"Car 0.00 0 {ry - np.arctan2(x, z):.2f} " + " ".join(
                f"{v:.2f}" for v in box) + f" {h} {w} {l} {x} 1.65 {z} {ry}")
            dets.append(f"Car -1 -1 {ry:.2f} " + " ".join(f"{v:.2f}" for v in box)
                        + f" {h} {w} {l} {x + 0.3} 1.65 {z + 0.3} {ry + 0.08} 0.93")
            masks.append(_hull_mask((375, 1242), uv))
            preds["labels"].append("car")
            preds["boxes"].append([float(v) for v in box])
            pts = np.vstack([rng.uniform(-0.4 * l, 0.4 * l, 80),
                             rng.uniform(-0.85 * h, -0.2 * h, 80),
                             rng.uniform(-0.4 * w, 0.4 * w, 80)])
            rect_pts.append(R @ pts + T[:, None])
        labels.append("Car 0.00 3 0.00 20.00 150.00 60.00 190.00 1.5 1.6 4.0 -14.0 1.65 45.0 0.0")
        with open(os.path.join(tr, lbl_d, idx + ".txt"), "w") as fh:
            fh.write("\n".join(labels) + "\n")
        with open(os.path.join(tr, "pred", idx + ".txt"), "w") as fh:
            fh.write("\n".join(dets) + "\n")
        with open(os.path.join(tr, "pred_instance", idx + ".json"), "w") as fh:
            json.dump(preds, fh)
        for i, m in enumerate(masks):
            write_png(os.path.join(tr, "pred_instance", f"{idx}_{i}.png"), m)
        ground = np.vstack([rng.uniform(-10, 10, 600), np.full(600, 1.7), rng.uniform(5, 40, 600)])
        rect = np.concatenate(rect_pts + [ground], 1)
        velo = np.linalg.solve(velo_to_rect[:, :3], rect - velo_to_rect[:, 3:])
        scan = np.concatenate([velo.T, rng.uniform(0, 1, (velo.shape[1], 1))], 1)
        scan.astype(np.float32).tofile(os.path.join(tr, "velodyne", idx + ".bin"))
    with open(os.path.join(root, "ImageSets", "val.txt"), "w") as fh:
        fh.write("\n".join(ids) + "\n")


def _config_copy(out_dir, name, dataset=None, **keys):
    """A copy of jsonfiles/<name> with its dataset block updated and the
    top-level `keys` set, written into out_dir under its arch's name."""
    with open(os.path.join(HERE, "jsonfiles", name)) as f:
        config = json.load(f)
    config["dataset"].update(dataset or {})
    config.update(keys)
    path = os.path.join(out_dir, f"{config['arch']}_{name}")
    with open(path, "w") as f:
        json.dump(config, f)
    return path


def _run_dataset_cli(label, main_fn, argv, n_expected):
    """One optimize CLI run on the card; checks its result file and curves,
    prints its throughput, host prep share and final metrics. Returns (launch
    counts, summary)."""
    import numpy as np
    import torch

    from supnerf_tpu_torch.ops import render

    render.reset_launch_counts()
    t0 = time.perf_counter()
    summary = main_fn(argv + ["--device", "cuda", "--seed", "0"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = _path_counts(label, TTO_KERNELS)
    n = summary["n_objects"]
    if n < n_expected:
        raise RuntimeError(f"{label}: curation kept {n} objects, expected {n_expected}")
    with open(os.path.join(summary["save_dir"], "codes+poses.pkl"), "rb") as f:
        res = pickle.load(f)
    curves = [np.asarray(v, np.float64) for key in ("psnr_eval", "R_eval", "T_eval",
                                                     "depth_err_mean")
              for v in res[key].values()]
    if len(res["psnr_eval"]) != n or not all(np.isfinite(c).all() and len(c) == DATASET_ITERS
                                             for c in curves):
        raise RuntimeError(f"{label}: the result curves are missing or not finite")
    if any(int(v) == 0 for v in res["lidar_pts_cnt"].values()):
        raise RuntimeError(f"{label}: an object has no lidar pixels: {res['lidar_pts_cnt']}")
    ph = summary["phase_seconds"]
    agg = summary["aggregate"]
    print(f"   {label}: {n} objects curated; {seconds:.2f} s end to end through the CLI, "
          f"{n * 60 / seconds:.1f} objects/min; host_prep {ph.get('host_prep', 0.0):.2f} s "
          f"({ph.get('host_prep', 0.0) / seconds:.3f} of the run); phases: "
          + ", ".join(f"{k} {v:.2f} s" for k, v in ph.items()))
    print(f"   {label} final: psnr {agg['psnr'][-1]:.3f} dB, rot err {agg['rot_err_deg'][-1]:.3f} "
          f"deg, trans err {agg['trans_err'][-1]:.4f} m, depth err {agg['depth_err'][-1]:.4f} m "
          f"(iteration 0: psnr {agg['psnr'][0]:.3f}, rot {agg['rot_err_deg'][0]:.3f}, trans "
          f"{agg['trans_err'][0]:.4f}); lidar pixels per object "
          f"{sorted(res['lidar_pts_cnt'].values())}; result file "
          f"{os.path.join(summary['save_dir'], 'codes+poses.pkl')}")
    return counts, summary


def dataset_paths(out_dir):
    """Phase 9: (a) the optimize CLI on a nuScenes v1.0-mini fixture at the
    published config, twice (the second run reads the index the first
    wrote); (b) cli.optimize_kitti with add_pose_err 1 and 3 on a KITTI
    fixture; (c) cli.optimize_waymo on the Waymo layout; (d) the demo on
    one nuScenes fixture image. Full width, 100 iterations, on the card.
    Returns the launch counts per path."""
    import hashlib

    import numpy as np
    import torch

    from supnerf_tpu_torch.bench.decode_seconds import measure
    from supnerf_tpu_torch.cli import demo, optimize, optimize_kitti, optimize_waymo
    from supnerf_tpu_torch.data import nuscenes as nusc_data
    from supnerf_tpu_torch.data.jpeg import read_jpeg
    from supnerf_tpu_torch.ops import render

    digest = hashlib.sha256(read_jpeg(NUSC_FIXTURE_JPEG).tobytes()).hexdigest()
    if digest != NUSC_FIXTURE_SHA256:
        raise RuntimeError(f"the fixture JPEG decodes to sha256 {digest}, pinned "
                           f"{NUSC_FIXTURE_SHA256}")
    decode = measure(repeats=3)
    print(f"   fixture JPEG decodes to the pinned sha256; host decode seconds (median of 3) "
          f"on this machine: {json.dumps(decode)}")
    counts = {}

    t0 = time.perf_counter()
    nusc_root = os.path.join(out_dir, "nuscenes")
    names = write_nusc_fixture(nusc_root)
    kitti_root, waymo_root = os.path.join(out_dir, "kitti"), os.path.join(out_dir, "waymo")
    write_kitti_fixture(kitti_root, "kitti", [[(-3.0, 14.0, 0.3), (3.6, 19.0, -1.2)],
                                              [(-2.6, 15.5, 0.5), (3.2, 20.0, -1.0)]])
    write_kitti_fixture(waymo_root, "waymo", [[(-3.0, 14.0, 0.3), (3.6, 19.0, -1.2)]])
    print(f"   fixtures written in {time.perf_counter() - t0:.2f} s")

    # (a) nuScenes, twice: the second run must read the first run's index
    nusc = {"test_data_dir": nusc_root, "test_nusc_version": "v1.0-mini"}
    cfg = _config_copy(out_dir, "supnerf.nusc.vehicle.car.json", nusc)
    index = os.path.join(nusc_root, "nusc.v1.0-mini.val.vehicle.car.json")
    curations = []
    real_curate = nusc_data.NuScenesData.preprocess_dataset

    def curate(self, *a, **k):
        curations.append(1)
        return real_curate(self, *a, **k)

    nusc_data.NuScenesData.preprocess_dataset = curate
    try:
        for run in (1, 2):
            counts[f"nusc_run{run}"], summary = _run_dataset_cli(
                f"nuScenes run {run}", optimize.main,
                ["--config_file", cfg, "--dataset", "nusc", "--batch_size", "4",
                 "--save_dir", os.path.join(out_dir, f"nusc_run{run}")], 4)
            if len(curations) != 1:
                raise RuntimeError(f"nuScenes run {run}: {len(curations)} curations so far")
            cross = summary["cross"]
            if cross is None or not np.isfinite(cross["psnr_cross"]).all():
                raise RuntimeError("the nuScenes cross-view evaluation is missing or not finite")
    finally:
        nusc_data.NuScenesData.preprocess_dataset = real_curate
    with open(index) as f:
        kept = json.load(f)["all_valid_samples"]
    if any(a.startswith("ann1_") for a, _ in kept):
        raise RuntimeError("the night scene passed curation")
    print(f"   nuScenes: run 2 read the index run 1 wrote ({len(kept)} samples, none of the "
          f"night log); cross-view psnr {np.round(cross['psnr_cross'], 3).tolist()}")

    # (b) KITTI, add_pose_err 1 and 3; (c) Waymo
    kitti_cfg = _config_copy(out_dir, "supnerf.kitti.car.json", {
        "data_dir": kitti_root, "split_dir": os.path.join(kitti_root, "ImageSets")})
    for mode in (1, 3):
        counts[f"kitti_mode{mode}"], summary = _run_dataset_cli(
            f"KITTI add_pose_err {mode}", optimize_kitti.main,
            ["--config_file", kitti_cfg, "--add_pose_err", str(mode), "--batch_size", "4",
             "--save_dir", os.path.join(out_dir, f"kitti_mode{mode}")], 4)
        if summary["cross"] is not None:
            raise RuntimeError("KITTI ran a cross-view evaluation")
    waymo_cfg = _config_copy(out_dir, "supnerf.waymo.car.json", {
        "data_dir": waymo_root, "split_dir": os.path.join(waymo_root, "ImageSets")})
    counts["waymo"], _ = _run_dataset_cli(
        "Waymo add_pose_err 2", optimize_waymo.main,
        ["--config_file", waymo_cfg, "--add_pose_err", "2", "--batch_size", "2",
         "--save_dir", os.path.join(out_dir, "waymo")], 2)

    # (d) the demo on one nuScenes image
    demo_cfg = _config_copy(out_dir, "hpam_demo.json", nusc)
    render.reset_launch_counts()
    t0 = time.perf_counter()
    out = demo.main(["--config_file", demo_cfg, "--dataset", "nusc", "--img_name", names[0],
                     "--num_opts", str(DATASET_ITERS), "--device", "cuda", "--seed", "0",
                     "--save_dir", os.path.join(out_dir, "demo_nusc")])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts["demo_nusc"] = _path_counts("nuScenes demo", DEMO_KERNELS)
    n_obj = len(out["results"]["psnr_eval"])
    if n_obj != 2 or not all(np.isfinite(img).all() for img in out["images"]):
        raise RuntimeError(f"the nuScenes demo optimized {n_obj} cars or wrote a frame that is "
                           "not finite")
    print(f"   nuScenes demo on {names[0]}: {n_obj} cars, {seconds:.2f} s end to end, TTO "
          f"{out['tto_seconds']:.2f} s; {len(out['frames'])} finite frames of "
          f"{out['win_hw'][0]} x {out['win_hw'][1]}")
    return counts


def baseline_paths(out_dir):
    """Phase 10, the baselines on the card through the CLIs, full width,
    random weights: (a) AutoRFMix TTO at autorfmix.nusc.vehicle.car.json
    (W 256, 3 shape and 1 texture block, the two-head ResNet34) on 2
    synthetic objects; (b) cli.optimize_kitti at autorfmix.kitti.car.json on
    a KITTI fixture, add_pose_err 1; (c) AutoRFMix training, 16 objects,
    batch 8, 4 steps, then a resume; (d) CodeNeRF (the factory's 2 shape and
    1 texture block, W 256) TTO on 2 objects and 4 training steps; (e) the
    original AutoRF (the factory's 5 and 5 blocks, W 128) TTO on 2 objects
    and 2 training steps on its plain decoder, where no kernel may launch.
    Returns the launch counts per path."""
    from supnerf_tpu_torch.cli import optimize_kitti

    mix = os.path.join(HERE, "jsonfiles", "autorfmix.nusc.vehicle.car.json")
    counts = {}
    t0 = time.perf_counter()
    counts["autorfmix_tto"] = tto_path(os.path.join(out_dir, "mix_tto"), mix, "AutoRFMix TTO",
                                       replay=True)
    print(f"   (a) AutoRFMix TTO: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    kitti_root = os.path.join(out_dir, "kitti")
    write_kitti_fixture(kitti_root, "kitti", [[(-3.0, 14.0, 0.3), (3.6, 19.0, -1.2)],
                                              [(-2.6, 15.5, 0.5), (3.2, 20.0, -1.0)]])
    cfg = _config_copy(out_dir, "autorfmix.kitti.car.json", {
        "data_dir": kitti_root, "split_dir": os.path.join(kitti_root, "ImageSets")})
    counts["autorfmix_kitti"], _ = _run_dataset_cli(
        "AutoRFMix KITTI add_pose_err 1", optimize_kitti.main,
        ["--config_file", cfg, "--add_pose_err", "1", "--batch_size", "4",
         "--save_dir", os.path.join(out_dir, "mix_kitti")], 4)
    print(f"   (b) AutoRFMix KITTI: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    counts["autorfmix_train"] = train_path(os.path.join(out_dir, "mix_train"), mix,
                                           "AutoRFMix training")
    print(f"   (c) AutoRFMix training: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    cfg = _config_copy(out_dir, "autorfmix.nusc.vehicle.car.json", arch="codenerf",
                       net_hyperparams={"latent_dim": 256},
                       model_dir=os.path.join(out_dir, "no_checkpoint"))
    counts["codenerf_tto"] = tto_path(os.path.join(out_dir, "codenerf_tto"), cfg,
                                      "CodeNeRF TTO", replay=True)
    counts["codenerf_train"] = train_path(os.path.join(out_dir, "codenerf_train"), cfg,
                                          "CodeNeRF training")
    print(f"   (d) CodeNeRF TTO and training: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    # latent_dim is the factory's default, given because the trainer's code
    # tables read it from the config (default 256, as in the JAX trainer)
    cfg = _config_copy(out_dir, "autorfmix.nusc.vehicle.car.json", arch="autorf_original",
                       net_hyperparams={"latent_dim": 128},
                       model_dir=os.path.join(out_dir, "no_checkpoint"))
    counts["autorf_original_tto"] = tto_path(os.path.join(out_dir, "orig_tto"), cfg,
                                             "original AutoRF TTO", replay=True, kernels=None)
    counts["autorf_original_train"] = train_path(os.path.join(out_dir, "orig_train"), cfg,
                                                 "original AutoRF training", epochs=1,
                                                 kernels=None)
    print(f"   (e) original AutoRF TTO and training (route: plain, no TPU kernel in the JAX "
          f"package): {time.perf_counter() - t0:.2f} s")
    return counts


# --------------------------------------------------------------------------
# phase 11: the rest of the TTO driver: the protocol options, multiview TTO
# (the library and the CLI, and with opt_model), the re-scoring CLIs
# --------------------------------------------------------------------------

PUBLISHED = os.path.join(HERE, "jsonfiles", "supnerf.nusc.vehicle.car.json")
OPTION_ITERS = 100
# an option cell's launches on 2 objects, 100 iterations: K1 100 loss and 100
# lidar renders and the cross-view evaluation's 2, K2 at every updating
# iteration (4..99); the codes are optimized at every opt_pose
OPTION_COUNTS = {"render_fwd": 202, "render_bwd": 96}
# multiview on 2 instances x 2 views: one K1/K2 pair an iteration, all views
MULTIVIEW_COUNTS = {"render_fwd": 200, "render_bwd": 200}
MULTIVIEW_MODEL_KERNELS = ("render_fwd", "render_train_bwd_data", "wgrad")
TABLE_ROWS = ("psnr:", "depth err:", "R err:", "T err:")


class _Tee(io.TextIOBase):
    """Standard output, and a copy of what went through it."""

    def __init__(self, out):
        self.out, self.copy = out, io.StringIO()

    def write(self, text):
        self.copy.write(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()


def _printed(fn):
    """fn()'s result and what it printed (printed through as well)."""
    tee = _Tee(sys.stdout)
    sys.stdout = tee
    try:
        return fn(), tee.copy.getvalue()
    finally:
        sys.stdout = tee.out


def _tables(text):
    """{result file: its metric table rows} from collect_eval_results' prints."""
    tables, current = {}, None
    for line in text.splitlines():
        if line.startswith("Processing "):
            current = tables.setdefault(line[len("Processing "):].strip(), [])
        elif current is not None and line.strip().startswith(TABLE_ROWS):
            current.append(line.strip())
    return tables


def _exact_counts(name, expect):
    """The launch counts of a path, which must be `expect` exactly (every
    other counter 0)."""
    from supnerf_tpu_torch.ops import render

    counts = _path_counts(name, tuple(expect))
    others = {k: v for k, v in render.LAUNCHES.items() if k not in expect and v}
    if counts != expect or others:
        raise RuntimeError(f"{name}: launches {counts}, others {others}; expected {expect}")
    return counts


def _option_config(out_dir, tag, **blocks):
    """A copy of the published config with `blocks` merged into its keys
    (dicts key by key), written as out_dir/tag.json."""
    with open(PUBLISHED) as f:
        config = json.load(f)
    for key, value in blocks.items():
        config[key] = dict(config[key], **value) if isinstance(value, dict) else value
    path = os.path.join(out_dir, f"{tag}.json")
    with open(path, "w") as f:
        json.dump(config, f)
    return path


def _exact_corner_pnp(pnp_poses):
    """TTODriver._pnp_poses fed, in place of the encoder's corner
    prediction, the exact projected box corners of each object's annotated
    pose, normalised to its roi_refine (the inverse of
    pnp.denormalize_uv_direct): at random weights no 4 predicted corners
    agree, so RANSAC fails every object and the branches that take the
    PnP pose would not run."""
    import numpy as np
    import torch

    from supnerf_tpu_torch.tto import pnp

    def exact(self, uv_direct, batch, taken):
        pose, wlh, K, roi = (t.detach().cpu().double().numpy()
                             for t in (batch.obj_pose_gt, batch.wlh, batch.K, batch.roi_refine))
        uv = []
        for i in range(len(pose)):
            px = pnp.project(pnp._box_corners_3d(wlh[i]), pose[i, :, :3], pose[i, :, 3], K[i]).T
            dim = max(roi[i, 2] - roi[i, 0], roi[i, 3] - roi[i, 1])
            centre = np.array([(roi[i, 0] + roi[i, 2]) / 2, (roi[i, 1] + roi[i, 3]) / 2])
            uv.append(((px - centre[:, None]) / (dim / 2)).reshape(-1))
        return pnp_poses(self, torch.as_tensor(np.stack(uv), dtype=uv_direct.dtype,
                                               device=uv_direct.device), batch, taken)
    return exact


def option_paths(out_dir):
    """(a) The optimize CLI at the published config on 2 synthetic objects,
    100 iterations, once per TTO option: --opt_pose 0 --code_level 1 (the
    pose stays the refined one), --opt_pose 2 (the PnP bootstrap) on exact
    corners (_exact_corner_pnp: both objects must take the PnP pose, and
    their iteration-0 pose is the annotated one) and on the encoder's own
    prediction at random weights (RANSAC's failing case, src_pose back), a
    config with euler_rot 1 and optimize.opt_cam_pose 1 (with --code_level
    0), and --pred_wlh 2 on a config whose net predicts wlh. Each with exact
    launch counts, finite curves and its results file's code_level schema.
    Returns (launch counts per cell, the metric table each run printed per
    result file)."""
    import numpy as np
    import torch

    from supnerf_tpu_torch.cli import optimize
    from supnerf_tpu_torch.ops import render
    from supnerf_tpu_torch.tto.driver import TTODriver

    cells = {
        "opt_pose0_level1": (PUBLISHED, ["--opt_pose", "0", "--code_level", "1"], 1),
        "opt_pose2": (PUBLISHED, ["--opt_pose", "2"], 2),
        "opt_pose2_random": (PUBLISHED, ["--opt_pose", "2"], 2),
        "euler_cam": (_option_config(out_dir, "euler_cam", euler_rot=1,
                                     optimize={"opt_cam_pose": 1}), ["--code_level", "0"], 0),
        "pred_wlh2": (_option_config(out_dir, "pred_wlh", net_hyperparams={"pred_wlh": 1}),
                      ["--pred_wlh", "2"], 2),
    }
    counts, tables = {}, {}
    for key, (config, argv, level) in cells.items():
        save = os.path.join(out_dir, key)
        pnp_poses = TTODriver._pnp_poses
        if key == "opt_pose2":
            TTODriver._pnp_poses = _exact_corner_pnp(pnp_poses)
        render.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            summary, text = _printed(lambda: optimize.main([
                "--config_file", config, "--dataset", "synthetic", "--num_objects", "2",
                "--batch_size", "2", "--device", "cuda", "--seed", "0", "--save_dir", save,
                *argv]))
            torch.cuda.synchronize()
        finally:
            TTODriver._pnp_poses = pnp_poses
        seconds = time.perf_counter() - t0
        counts[key] = _exact_counts(f"TTO {key}", OPTION_COUNTS)
        tables.update(_tables(text))
        with open(os.path.join(save, "codes+poses.pkl"), "rb") as f:
            res = pickle.load(f)
        _check_curves(key, [v for k in ("psnr_eval", "R_eval", "T_eval", "depth_err_mean")
                            for v in res[k].values()], 2, OPTION_ITERS)
        codes = res["optimized_shapecodes"]
        # the 2 objects are 2 annotations of one instance, ins_0
        flat = set(codes) == ({"ins_0"} if level == 0 else {"ann_0", "ann_1"}) and all(
            np.shape(c) == (6, 256) for c in codes.values())
        nested = level == 2 and all(np.shape(c["CAM_FRONT"]) == (6, 256) for c in codes.values())
        if res["code_level"] != level or not (flat and level < 2 or nested):
            raise RuntimeError(f"{key}: the results file's codes are not code_level {level}'s")
        if key == "opt_pose0_level1" and not all(len(set(v[4:])) == 1
                                                 for v in res["R_eval"].values()):
            raise RuntimeError("opt_pose 0 moved the pose after the refiner")
        if key == "opt_pose2":
            start = [(res["R_eval"][k][0], res["T_eval"][k][0]) for k in res["R_eval"]]
            if summary["pnp_translations"] != 2 or max(max(e) for e in start) > 1e-2:
                raise RuntimeError(f"opt_pose 2 on exact corners: PnP translation taken for "
                                   f"{summary['pnp_translations']} of 2 objects, iteration-0 "
                                   f"(rotation, translation) errors {start}")
        agg = summary["aggregate"]
        pnp = (f"; PnP translation taken for {summary['pnp_translations']} of 2 objects"
               if summary["pnp_translations"] is not None else "")
        print(f"   {key}: {seconds:.2f} s for 2 objects ({2 * 60 / seconds:.1f} objects/min), "
              f"code_level {level}; final psnr {agg['psnr'][-1]:.3f} dB, rot err "
              f"{agg['rot_err_deg'][-1]:.3f} deg, trans err {agg['trans_err'][-1]:.4f} m{pnp}")
    return counts, tables


def multiview_paths(out_dir):
    """(b) TTODriver.run_multiview on 2 instances x 2 views (pairs of
    synthetic objects sharing an instoken), codes only with slack_tex, then
    the optimize CLI's --opt_multiview 1 (poses too) on the same set: one
    K1/K2 launch pair an iteration over both views. Returns the launch
    counts per run."""
    import numpy as np
    import torch

    from supnerf_tpu_torch.cli import optimize
    from supnerf_tpu_torch.cli.common import SyntheticDataset, load_model_and_codes
    from supnerf_tpu_torch.config import load_hpams
    from supnerf_tpu_torch.ops import render
    from supnerf_tpu_torch.tto.driver import TTODriver

    hpams = load_hpams(PUBLISHED)
    model, mean_shape, mean_texture = load_model_and_codes(hpams, "cuda", seed=0)
    driver = TTODriver(model, mean_shape, mean_texture, hpams, SyntheticDataset(4),
                       os.path.join(out_dir, "mv_lib"), device="cuda", batch_size=4)
    counts = {}
    render.reset_launch_counts()
    t0 = time.perf_counter()
    res = driver.run_multiview()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts["multiview_lib"] = _exact_counts("multiview (run_multiview)", MULTIVIEW_COUNTS)
    if not (res["code_level"] == 0 and set(res["optimized_shapecodes"]) == {"ins_0", "ins_1"}
            and all(np.shape(c) == (6, 256) for c in res["optimized_shapecodes"].values())
            and os.path.exists(os.path.join(out_dir, "mv_lib", "codes_multiview.pkl"))):
        raise RuntimeError("run_multiview's results are not the per-instance schema")
    _check_curves("multiview", list(res["psnr_eval"].values()), 2, OPTION_ITERS)
    print(f"   run_multiview (codes, slack_tex): {seconds:.2f} s for 2 instances x 2 views "
          f"({seconds / 2 / OPTION_ITERS * 1e3:.2f} ms an iteration); psnr first -> last: "
          + "; ".join(f"{k} {v[0]:.3f} -> {v[-1]:.3f}" for k, v in res["psnr_eval"].items()))

    render.reset_launch_counts()
    t0 = time.perf_counter()
    summary = optimize.main(["--config_file", PUBLISHED, "--dataset", "synthetic",
                             "--num_objects", "4", "--device", "cuda", "--seed", "0",
                             "--opt_multiview", "1", "--save_dir", os.path.join(out_dir, "mv_cli")])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts["multiview_cli"] = _exact_counts("multiview (--opt_multiview 1)", MULTIVIEW_COUNTS)
    mv = summary["multiview"]
    _check_curves("multiview CLI", list(mv["psnr_eval"].values()), 2, OPTION_ITERS)
    print(f"   cli.optimize --opt_multiview 1 (codes and poses): {seconds:.2f} s end to end; "
          "psnr first -> last: " + "; ".join(f"{k} {v[0]:.3f} -> {v[-1]:.3f}"
                                             for k, v in mv["psnr_eval"].items()))
    return counts


def multiview_model_path(out_dir):
    """(c) run_multiview_tto with opt_model (and opt_pose) on one instance
    of 2 views, 100 iterations: the decoder copy renders through
    field_composite_train, K1 then K3's data mode and K4 at every iteration,
    and the model given stays as it was. The first iteration's K3 + K4 call
    is taken (its inputs and cotangents) and held against the plain version
    in float32 and float64 with the K3-data-mode check's tolerances and kink
    carve-out (train_bwd_at_kinks). Returns the launch counts and the
    check's record."""
    import dataclasses

    import torch

    from supnerf_tpu_torch.cli.common import SyntheticDataset, load_model_and_codes
    from supnerf_tpu_torch.config import load_hpams
    from supnerf_tpu_torch.ops import render
    from supnerf_tpu_torch.tto.driver import TTODriver
    from supnerf_tpu_torch.tto.multiview import MultiviewBatch, run_multiview_tto

    hpams = load_hpams(PUBLISHED)
    model, mean_shape, mean_texture = load_model_and_codes(hpams, "cuda", seed=0)
    driver = TTODriver(model, mean_shape, mean_texture, hpams, SyntheticDataset(2), out_dir,
                       device="cuda", batch_size=2)
    _, _, batch = driver._prep([0, 1])
    before = {k: v.clone() for k, v in model.state_dict().items()}
    taken, kernel = {}, render.render_train_bwd

    def take_first(wts, *args):
        if not taken:
            taken["wts"] = dataclasses.replace(wts, **{
                f.name: getattr(wts, f.name).clone() for f in dataclasses.fields(wts)
                if isinstance(getattr(wts, f.name), torch.Tensor)})
            taken["args"] = [a.clone() if isinstance(a, torch.Tensor) else a for a in args]
        return kernel(wts, *args)

    render.render_train_bwd = take_first
    try:
        render.reset_launch_counts()
        t0 = time.perf_counter()
        res = run_multiview_tto(model, driver.wts, MultiviewBatch.from_object_batch(batch),
                                driver.mean_shape, driver.mean_texture, driver.cfg,
                                opt_pose=True, opt_model=True, generator=driver.render_gen)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        render.render_train_bwd = kernel
    counts = _path_counts("multiview opt_model", MULTIVIEW_MODEL_KERNELS)
    if not (counts["render_fwd"] == counts["render_train_bwd_data"] == OPTION_ITERS
            and counts["wgrad"] >= OPTION_ITERS and render.LAUNCHES["render_train_bwd"] == 0
            and render.LAUNCHES["render_bwd"] == 0):
        raise RuntimeError(f"multiview opt_model launched {dict(render.LAUNCHES)}")
    if not all(torch.equal(v, before[k]) for k, v in model.state_dict().items()):
        raise RuntimeError("opt_model changed the model given")
    _check_curves("multiview opt_model", [res["psnr"].cpu(), res["loss"].cpu()], 2, OPTION_ITERS)
    print(f"   run_multiview_tto(opt_model, opt_pose), 1 instance x 2 views: {seconds:.2f} s "
          f"({seconds / OPTION_ITERS * 1e3:.2f} ms an iteration); psnr "
          f"{float(res['psnr'][0]):.3f} -> {float(res['psnr'][-1]):.3f}, loss "
          f"{float(res['loss'][0]):.5f} -> {float(res['loss'][-1]):.5f}")
    xyz, vd, z, zs, zt, white, g_rgb, g_depth, g_acc, data = taken["args"]
    if not data:
        raise RuntimeError("opt_model's first backward did not run K3's data mode")
    print(f"   its first iteration's K3 (data mode) + K4 against the plain version, "
          f"{xyz.shape[0]} views x {xyz.shape[1]} rays x {xyz.shape[2]} samples:")
    arb = train_bwd_at_kinks(taken["wts"], (xyz, vd, z, zs, zt), white, (g_rgb, g_depth, g_acc))
    if not (arb["ok"] and arb["off_ok"] and arb["same"]):
        raise RuntimeError("opt_model's decoder gradient disagrees with the plain version")
    return counts, {"max_abs_err": arb["err"], "max_abs_err_float32_plain": arb["err32"],
                    "kink_rays": kink_rays_record(arb["kinks"])}


def rescoring_paths(out_dir, tables):
    """(d) cli.eval_saved_result on (a)'s result files, explicitly (all of
    them in one call) and in the reference folder convention (one folder with its
    cross_eval), cli.evaluate_all on (a)'s tree, and the optimize CLI's
    --cross_eval_folder on the code_level 1 run's folder (the cross-view
    evaluation again, K1 2 launches, the same matrices): each printed PSNR,
    depth, rotation and translation row must equal the row the optimize run
    printed for that file. Returns the resume's launch counts."""
    import numpy as np
    import torch

    from supnerf_tpu_torch.cli import eval_saved_result, evaluate_all, optimize
    from supnerf_tpu_torch.ops import render

    files = sorted(tables)
    folder = os.path.join(out_dir, "opt_pose0_level1")
    with open(os.path.join(folder, "cross_eval.pkl"), "rb") as f:
        cross_before = pickle.load(f)
    checks = {
        "explicit files": lambda: eval_saved_result.main(
            files + ["--out", os.path.join(out_dir, "eval_all.json")]),
        "folder convention": lambda: eval_saved_result.main(
            ["--model-folder", out_dir, "--test-folder", "opt_pose0_level1", "--legend-name",
             "opt_pose0_level1", "--plot-cross-view", "--save-dir",
             os.path.join(out_dir, "eval_summary")]),
        "evaluate_all": lambda: evaluate_all.main([out_dir]),
        "--cross_eval_folder": lambda: optimize.main([
            "--config_file", PUBLISHED, "--dataset", "synthetic", "--num_objects", "2",
            "--device", "cuda", "--seed", "0", "--cross_eval_folder", folder]),
    }
    counts = None
    for name, fn in checks.items():
        render.reset_launch_counts()
        _, text = _printed(fn)
        torch.cuda.synchronize()
        if name == "--cross_eval_folder":
            counts = _exact_counts("--cross_eval_folder", {"render_fwd": 2})
        got = _tables(text)
        if not got or any(got[f] != tables[f] for f in got):
            raise RuntimeError(f"re-scoring ({name}) printed other rows than the optimize runs: "
                               f"{got} against {tables}")
        print(f"   re-scoring, {name}: the rows of {len(got)} result file(s) equal the "
              "optimize runs'")
    with open(os.path.join(folder, "cross_eval.pkl"), "rb") as f:
        cross_after = pickle.load(f)
    diff = max(float(np.abs(a - b).max()) for key in ("psnr_eval_mat_per_ins",
                                                        "depth_eval_mat_per_ins")
               for ins, mats in cross_before[key].items()
               for a, b in zip(mats, cross_after[key][ins]))
    if diff > 1e-5:
        raise RuntimeError(f"--cross_eval_folder's cross-view matrices moved by {diff}")
    print(f"   --cross_eval_folder: the cross-view matrices again, max abs difference {diff:.3e}")
    return counts


# --------------------------------------------------------------------------
# phase 12: the visualisation: K1 at the full-image and virtual-view shapes,
# --vis 1 and 2 through the optimize CLI, the trainer's log sink
# --------------------------------------------------------------------------

VIS_SZ, VIS_VIEWS = 128, 8
# K1 launches of the vis cells on top of an option cell's (OPTION_COUNTS):
# vis 1 renders the first and last snapshot, the final codes (SSIM) and the
# ring of views, each one launch for the batch; vis 2 every iteration
VIS1_COUNTS = {"render_fwd": OPTION_COUNTS["render_fwd"] + 4, "render_bwd": 96}
VIS2_COUNTS = {"render_fwd": OPTION_COUNTS["render_fwd"] + OPTION_ITERS + 2, "render_bwd": 96}
LOG_CHECK_ITER = 2


def k1_at(label, B, R, seed):
    """K1 against its plain version on B objects x R rays x 64 samples of
    the published decoder (random weights from seed); the record's numbers:
    ms, plain_ms, bound, the worst error."""
    import torch

    from supnerf_tpu_torch.ops import render

    wts, args, _ = kernel_inputs(seed=seed, B=B, R=R)
    with torch.no_grad():
        got = render.render_fwd(wts, *args)
        torch.cuda.synchronize()
        ref = render.render_fwd_plain(wts, *args)
    err, ok = compare(("rgb", "depth", "acc"), got, ref, lambda n, s: VALUE_ATOL[n])
    del ref
    t_k = _timed(lambda: render.render_fwd(wts, *args), 10)
    with torch.no_grad():
        t_p = _timed(lambda: render.render_fwd_plain(wts, *args), 3)
    S = args[0].shape[2]
    w_fwd = sum(getattr(wts, f).numel() for f in render._PTR_FIELDS if not f.startswith("wt_"))
    flops = 2 * B * R * S * decoder_macs(wts.W, wts.n_shape, wts.n_tex)
    nbytes = sum(t.numel() for t in args) * 4 + w_fwd * 4 + B * R * 5 * 4
    b = bound(flops, nbytes)
    print(f"   K1 at {label}, {B} x {R} rays x {S} samples: {t_k:.3f} ms, {t_k * 1e3 / (B * R):.3f} "
          f"us a ray (plain {t_p:.3f} ms, bound {b[0]:.3f} ms by {b[1]}, FMA-route bound "
          f"{b[2]:.3f} ms)")
    if not ok:
        raise RuntimeError(f"K1 disagrees with its plain version at {label}")
    return {"shape": [B, R, S], "ms": t_k, "plain_ms": t_p, "bound_ms": b[0], "bound_by": b[1],
            "bound_fma_ms": b[2], "max_abs_err": err, "library_ms": None}


def check_vis_kernels():
    """(a) K1 at the visualisation's shapes: one launch of 2 objects'
    128 x 128 full-image renders, and one of an object's ring of 8 virtual
    views at 64 x 64."""
    return {"vis_full_image": k1_at("the full-image render", 2, VIS_SZ * VIS_SZ, 5),
            "vis_virtual_views": k1_at("the virtual views", VIS_VIEWS, 64 * 64, 6)}


def _vis_run(out_dir, vis, n_objects, expect):
    """The optimize CLI at the published config with --vis on n synthetic
    objects: exact launch counts, each object's frames decoded by read_png
    at their shapes, a finite SSIM in [-1, 1] an object. Returns the launch
    counts."""
    import numpy as np
    import torch

    from supnerf_tpu_torch.cli import optimize
    from supnerf_tpu_torch.ops import render

    render.reset_launch_counts()
    t0 = time.perf_counter()
    summary = optimize.main(["--config_file", PUBLISHED, "--dataset", "synthetic",
                             "--num_objects", str(n_objects), "--batch_size", str(n_objects),
                             "--device", "cuda", "--seed", "0", "--save_dir", out_dir,
                             "--vis", str(vis)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = _exact_counts(f"--vis {vis}", expect)
    with open(os.path.join(out_dir, "codes+poses.pkl"), "rb") as f:
        res = pickle.load(f)
    frames = [0, 100] if vis == 1 else list(range(OPTION_ITERS))
    want = sorted([f"opt{t:03d}.png" for t in frames] + ["virt_final.png"])
    if len(res["ssim_eval"]) != n_objects:
        raise RuntimeError(f"--vis {vis}: ssim_eval has {len(res['ssim_eval'])} objects")
    for name, values in res["ssim_eval"].items():
        got = sorted(os.listdir(os.path.join(out_dir, name)))
        if got != want:
            raise RuntimeError(f"--vis {vis}, {name}: wrote {got[:4]}... ({len(got)} files), "
                               f"expected {len(want)}")
        for frame in want:
            img = read_png(os.path.join(out_dir, name, frame))
            shape = (VIS_SZ, 2 * VIS_SZ, 3) if frame == "virt_final.png" else (
                VIS_SZ, 3 * VIS_SZ, 3)
            if img.shape != shape:
                raise RuntimeError(f"{name}/{frame} decodes to {img.shape}, not {shape}")
        if len(values) != 1 or not (np.isfinite(values[0]) and -1.0 <= values[0] <= 1.0):
            raise RuntimeError(f"--vis {vis}, {name}: ssim_eval {values}")
    vis_s = summary["phase_seconds"].get("vis", 0.0)
    print(f"   --vis {vis}: {n_objects} objects in {seconds:.2f} s through the CLI, the vis phase "
          f"{vis_s:.2f} s ({vis_s / n_objects:.2f} s an object; TTO loop "
          f"{summary['phase_seconds']['tto_loop']:.2f} s); {len(want)} frames an object decode "
          f"with read_png; ssim_eval " + ", ".join(
              f"{k} {v[0]:.4f}" for k, v in res["ssim_eval"].items()))
    return counts


def train_log_path(out_dir):
    """(d) cli.train at the published config, the training cell's shape (16
    objects, batch 8, 2 epochs: 4 steps), --check_iter 2: runs/metrics.jsonl
    with one finite line per step and panels at steps 2 and 4; K1 launches
    one forward a step and one a panel."""
    import math

    import numpy as np
    import torch

    from supnerf_tpu_torch.cli import train
    from supnerf_tpu_torch.ops import render
    from supnerf_tpu_torch.training.train_step import METRIC_NAMES

    render.reset_launch_counts()
    summary = train.main(["--config_file", PUBLISHED, "--dataset", "synthetic",
                          "--num_objects", str(TRAIN_OBJECTS), "--batch_size", str(TRAIN_BATCH),
                          "--epochs", "2", "--device", "cuda", "--seed", "0",
                          "--check_iter", str(LOG_CHECK_ITER), "--save_dir", out_dir])
    torch.cuda.synchronize()
    counts = _path_counts("training with its log", TRAIN_KERNELS)
    steps = 2 * TRAIN_OBJECTS // TRAIN_BATCH
    panels = [n for n in range(1, steps + 1) if n % LOG_CHECK_ITER == 0]
    if counts["render_fwd"] != steps + len(panels):
        raise RuntimeError(f"K1 launched {counts['render_fwd']} times, not {steps} steps + "
                           f"{len(panels)} panels")
    runs = os.path.join(out_dir, "runs")
    want = sorted(["metrics.jsonl"] + [f"train_panel_{n:07d}.png" for n in panels])
    if sorted(os.listdir(runs)) != want:
        raise RuntimeError(f"runs/ holds {sorted(os.listdir(runs))}, not {want}")
    with open(os.path.join(runs, "metrics.jsonl")) as f:
        lines = [json.loads(x) for x in f]
    names = {"step", "time/train", *METRIC_NAMES["unified"]}
    if [x["step"] for x in lines] != list(range(1, steps + 1)) or not all(
            set(x) == names and all(math.isfinite(v) for v in x.values()) for x in lines):
        raise RuntimeError(f"metrics.jsonl: {lines}")
    for n in panels:
        img = read_png(os.path.join(runs, f"train_panel_{n:07d}.png"))
        if img.shape != (64, 128, 3) or not np.any(img):
            raise RuntimeError(f"train_panel_{n:07d}.png decodes to {img.shape}")
    print(f"   training log: {len(lines)} lines in metrics.jsonl (time/train " + ", ".join(
        f"{x['time/train']:.3f}" for x in lines) + f" s), panels at steps {panels}; "
          f"{steps} steps in {summary['seconds']:.2f} s through the CLI")
    return counts


def vis_paths(out_dir):
    """(b) --vis 1 on 2 objects, (c) --vis 2 on 1 object, (d) the
    trainer's log. Returns the launch counts per cell."""
    return {"vis1": _vis_run(os.path.join(out_dir, "vis1"), 1, 2, VIS1_COUNTS),
            "vis2": _vis_run(os.path.join(out_dir, "vis2"), 2, 1, VIS2_COUNTS),
            "train_log": train_log_path(os.path.join(out_dir, "train_log"))}


# --------------------------------------------------------------------------
# phase 13: the rest of training: the wlh-finetuning cell (finetune_wlh,
# aug_wlh, aug_box2d, im_enc_rate 0.5, the threaded prefetch) and its resume,
# the NeRF-only cell at im_enc_rate 0.5, the per-row prep on the thread pool
# (sym_aug, render_sz), a resume without optimizer state, the published
# batch 48 through the CLI with and without the prefetch thread
# --------------------------------------------------------------------------

HOST_SPLIT = ("producer_prep", "producer_upload", "main_wait_batch")
# an objects-only epoch of 3 steps at the published batch
BATCH48_STEPS = 3


def _host_split(label, summary, batch):
    """Print a training run's steps/s, objects/s and host split (each step's
    producer_prep / producer_upload / main_wait_batch, and their sums)."""
    steps = summary["metrics"]
    loop = sum(m["seconds"] for m in steps)
    split = {k: sum(m["phase_seconds"].get(k, 0.0) for m in steps) for k in HOST_SPLIT}
    print(f"   {label}: {len(steps)} steps of {batch} objects in {summary['seconds']:.2f} s "
          f"through the CLI: {len(steps) / summary['seconds']:.3f} steps/s, "
          f"{len(steps) * batch / summary['seconds']:.2f} objects/s; the step loop alone "
          f"{len(steps) / loop:.3f} steps/s, {len(steps) * batch / loop:.2f} objects/s")
    print(f"   host split (s, summed over {len(steps)} steps): " + ", ".join(
        f"{k} {v:.4f}" for k, v in split.items()))
    for k in HOST_SPLIT:
        print(f"     {k} per step (s): " + ", ".join(
            f"{m['phase_seconds'].get(k, 0.0):.4f}" for m in steps))
    return split


@functools.lru_cache(maxsize=None)
def _stash_chunks(config, batch):
    """K3 + K4 launch pairs a training step makes on `batch` objects of
    `config` (ops.render.render_train_bwd's chunks of STASH_BYTES)."""
    from supnerf_tpu_torch.config import load_hpams
    from supnerf_tpu_torch.models.factory import build_model
    from supnerf_tpu_torch.ops import render
    from supnerf_tpu_torch.tto.core import render_decoder

    hp = load_hpams(config)
    ld_pt = render.stash_layout(render_decoder(build_model(hp["arch"],
                                                           hp["net_hyperparams"])))["ld_pt"]
    per_object = hp.get("n_rays", 1024) * hp.get("n_samples", 64) * ld_pt * 4
    chunk = max(1, min(batch, render.STASH_BYTES // per_object))
    return -(-batch // chunk)


def _train_cell(label, config, argv, n_objects, batch, epochs=1):
    """One cli.train run on the card from a fresh count: the launches
    exactly K1 one a step (no panels), K3 and K4 one pair a stash chunk a
    step, K3's data mode never; every loss finite; steps/s and the host
    split printed. Returns (summary, counts, what it printed)."""
    import math

    import torch

    from supnerf_tpu_torch.cli import train
    from supnerf_tpu_torch.ops import render

    render.reset_launch_counts()
    summary, text = _printed(lambda: train.main(
        ["--config_file", config, "--dataset", "synthetic", "--num_objects", str(n_objects),
         "--batch_size", str(batch), "--epochs", str(epochs), "--device", "cuda", "--seed", "0",
         "--check_iter", "100000"] + argv))
    torch.cuda.synchronize()
    n_steps = len(summary["metrics"])
    pairs = n_steps * _stash_chunks(config, batch)
    counts = _exact_counts(label, {"render_fwd": n_steps, "render_train_bwd": pairs,
                                   "wgrad": pairs})
    if not all(math.isfinite(v) for m in summary["metrics"] for k, v in m.items()
               if k.startswith(("loss", "psnr"))):
        raise RuntimeError(f"{label}: a loss is not finite: {summary['metrics']}")
    _host_split(label, summary, batch)
    return summary, counts, text


def _recompose(label, hp, steps, mode):
    """Each step's loss_total from its reported terms under its enc_active
    (training/train_step.py's loss at an im_enc_rate below 1; loss_wlh where
    reported), to 1e-5 relative of the reported one; both gate states must
    occur."""
    occ, code = hp.get("loss_occ_coef", 0.1), hp.get("loss_code_coef", 0.1)
    pose, wlh = hp.get("loss_pose_coef", 0.01), hp.get("loss_wlh_coef", 1.0)
    for n, m in enumerate(steps, 1):
        on = m["enc_active"] == 1.0
        want = m["loss_rgb"] + occ * m["loss_occ"]
        if mode == "unified":
            want += wlh * m.get("loss_wlh", 0.0)
            if on:
                want += pose * (m["loss_pose_direct"] + (m["loss_pose_iter1"] + m["loss_pose_iter2"]
                                                         + m["loss_pose_iter3"]) / 3)
                want += code * m["loss_code"]
        else:
            if not on and m["loss_code"] != 0.0:
                raise RuntimeError(f"{label}: step {n} ran without the encoder but loss_code is "
                                   f"{m['loss_code']}")
            want += code * m["loss_code"]
        rel = abs(want - m["loss_total"]) / abs(m["loss_total"])
        print(f"   {label} step {n}: enc_active {int(on)}, loss_total {m['loss_total']:.7f}, "
              f"recomposed {want:.7f} (rel diff {rel:.2e})")
        if not rel <= 1e-5:
            raise RuntimeError(f"{label}: step {n}'s loss_total is not its terms under "
                               f"enc_active {int(on)}")
    if {m["enc_active"] for m in steps} != {0.0, 1.0}:
        raise RuntimeError(f"{label}: the steps did not draw both encoder states: "
                           f"{[m['enc_active'] for m in steps]}")


def check_scatter_rows():
    """The code tables' scatter-add (train_step.scatter_rows) on the card at
    the published batch with repeated instances: two calls give the same
    bits, and the sums agree with float64's on the CPU."""
    import torch

    from supnerf_tpu_torch.training.train_step import scatter_rows

    g = torch.Generator().manual_seed(0)
    idx = torch.randint(0, 12, (SWEEP_BATCH,), generator=g)
    rows = torch.randn(SWEEP_BATCH, 256, generator=g)
    table = torch.zeros(BATCH48_STEPS * SWEEP_BATCH // 2, 256)
    a, b = (scatter_rows(table.cuda(), idx.cuda(), rows.cuda()).cpu() for _ in range(2))
    want = torch.zeros(table.shape, dtype=torch.float64).index_add_(0, idx, rows.double())
    err = float((a.double() - want).abs().max())
    print(f"   scatter_rows, {SWEEP_BATCH} rows on {len(set(idx.tolist()))} instances: two calls "
          f"equal bit for bit: {torch.equal(a, b)}; max abs err against float64 {err:.2e} "
          f"(tol 1e-5)")
    if not torch.equal(a, b) or not err <= 1e-5:
        raise RuntimeError("scatter_rows does not repeat itself or disagrees with float64")


def rest_of_training_paths(out_dir):
    """Phase 13. Returns the launch counts per cell."""
    from supnerf_tpu_torch.config import load_hpams

    check_scatter_rows()
    counts = {}
    demo = os.path.join(HERE, "jsonfiles", "hpam_demo.json")
    mix = os.path.join(HERE, "jsonfiles", "autorfmix.nusc.vehicle.car.json")

    # (a) wlh finetuning with the augmentations and the encoder gate, then a
    # resume from epoch 0
    t0 = time.perf_counter()
    run_a = os.path.join(out_dir, "wlh")
    wlh_argv = ["--finetune_wlh", "1", "--aug_wlh", "1", "--aug_box2d", "1",
                "--im_enc_rate", "0.5", "--num_workers", "4"]
    summary, counts["wlh_train"], _ = _train_cell(
        "(a) wlh finetuning", demo, wlh_argv + ["--save_dir", run_a], TRAIN_OBJECTS,
        TRAIN_BATCH, epochs=2)
    steps = summary["metrics"]
    with open(os.path.join(run_a, "runs", "metrics.jsonl")) as f:
        lines = [json.loads(x) for x in f]
    if len(lines) != len(steps) or not all("loss_wlh" in x for x in lines):
        raise RuntimeError(f"(a): metrics.jsonl lacks loss_wlh: {lines}")
    print("   (a) loss_wlh per step: " + ", ".join(f"{x['loss_wlh']:.5f}" for x in lines))
    _recompose("(a)", load_hpams(demo), steps, "unified")
    resumed, counts["wlh_resume"], _ = _train_cell(
        "(a) resumed from epoch_0", demo,
        wlh_argv + ["--save_dir", os.path.join(out_dir, "wlh_resumed"), "--resume_dir", run_a,
                    "--resume_from_epoch", "0"], TRAIN_OBJECTS, TRAIN_BATCH, epochs=2)
    want, got = steps[2]["loss_total"], resumed["metrics"][0]["loss_total"]
    print(f"   (a) resumed: step 3 loss {got:.7f} against {want:.7f} "
          f"(rel diff {abs(got - want) / abs(want):.2e}, tol {RESUME_RTOL:.0e})")
    if not abs(got - want) <= RESUME_RTOL * abs(want):
        raise RuntimeError("(a): the resumed run does not repeat step 3's loss")
    print(f"   (a): {time.perf_counter() - t0:.2f} s")

    # (b) the NeRF-only loss with the encoder gate
    t0 = time.perf_counter()
    summary, counts["nerf_only_enc_rate"], _ = _train_cell(
        "(b) AutoRFMix im_enc_rate 0.5", mix,
        ["--im_enc_rate", "0.5", "--save_dir", os.path.join(out_dir, "mix")], TRAIN_OBJECTS,
        TRAIN_BATCH, epochs=2)
    _recompose("(b)", load_hpams(mix), summary["metrics"], "nerf_only")
    print(f"   (b): {time.perf_counter() - t0:.2f} s")

    # (c) the per-row prep on the pool: sym_aug and render_sz in the config,
    # and the optimizer's options (gradient clipping, the cosine schedule)
    t0 = time.perf_counter()
    cfg = _config_copy(out_dir, "supnerf.nusc.vehicle.car.json", sym_aug=1, render_sz=64,
                       grad_clip=1.0, lr_schedule_type="cosine", cosine_total_steps=4)
    _, counts["per_row_prep"], text = _train_cell(
        "(c) sym_aug + render_sz 64 + grad_clip 1 + cosine, per-row prep on 2 threads", cfg,
        ["--num_workers", "2", "--save_dir", os.path.join(out_dir, "per_row")], TRAIN_OBJECTS,
        TRAIN_BATCH, epochs=2)
    if "schedule cosine over 4 steps, grad_clip 1.0" not in text:
        raise RuntimeError("(c): the run did not take the config's grad_clip and cosine schedule")
    print(f"   (c): {time.perf_counter() - t0:.2f} s")

    # (d) (a)'s epoch 0 without its optimizer file
    t0 = time.perf_counter()
    os.remove(os.path.join(run_a, "epoch_0_optim.pth"))
    _, counts["resume_no_optim"], text = _train_cell(
        "(d) resumed without epoch_0_optim.pth", demo,
        wlh_argv + ["--save_dir", os.path.join(out_dir, "wlh_fresh"), "--resume_dir", run_a,
                    "--resume_from_epoch", "0"], TRAIN_OBJECTS, TRAIN_BATCH, epochs=2)
    if "both optimizers start fresh" not in text:
        raise RuntimeError("(d): the resume did not say its moments start fresh")
    print(f"   (d): {time.perf_counter() - t0:.2f} s")

    # (e) the published batch, with and without the prefetch thread
    losses = {}
    for workers in ("4", "0"):
        t0 = time.perf_counter()
        summary, counts[f"batch48_workers{workers}"], _ = _train_cell(
            f"(e) batch {SWEEP_BATCH}, --num_workers {workers}", PUBLISHED,
            ["--num_workers", workers, "--save_dir", os.path.join(out_dir, f"b48_{workers}")],
            BATCH48_STEPS * SWEEP_BATCH, SWEEP_BATCH)
        losses[workers] = [m["loss_total"] for m in summary["metrics"]]
        print(f"   (e) --num_workers {workers}: losses " + ", ".join(
            f"{x:.7f}" for x in losses[workers]) + f"; {time.perf_counter() - t0:.2f} s")
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["4"], losses["0"]))
    print(f"   (e) the two loops' losses: largest rel diff {rel:.2e} (tol {RESUME_RTOL:.0e})")
    if len(losses["4"]) != BATCH48_STEPS or not rel <= RESUME_RTOL:
        raise RuntimeError("(e): the threaded and the serial loop disagree")
    return counts


# --------------------------------------------------------------------------
# phase 14: the last modules: InstanceNorm encoders (TTO, training),
# opt_model on the original AutoRF, the frame videos, dataset QA and its
# drawing, and --profile_dir
# --------------------------------------------------------------------------

INSTANCE_NORM = {"norm_layer_type": "InstanceNorm2d"}
PROFILED_KERNELS = {"render_fwd": "render_fwd_kernel", "render_bwd": "render_bwd_kernel"}
# run_tto_batch on 2 objects, 100 iterations: K1 100 loss and 100 lidar
# renders, K2 at every updating iteration (4..99)
TTO_BATCH_COUNTS = {"render_fwd": 200, "render_bwd": 96}


def gif_frames(path):
    """(frame count, delays in centiseconds) of a GIF89a file, by walking its
    blocks: independent of the port's writer (supnerf_tpu_torch/utils/gif.py)."""
    import struct

    with open(path, "rb") as f:
        data = f.read()
    if data[:6] != b"GIF89a":
        raise RuntimeError(f"{path}: not a GIF89a file")
    pos, frames, delays = 13, 0, []
    if data[10] & 0x80:
        pos += 3 * (2 << (data[10] & 7))
    while data[pos] != 0x3B:
        if data[pos] == 0x21:
            if data[pos + 1] == 0xF9:
                delays.append(struct.unpack("<H", data[pos + 4:pos + 6])[0])
            pos += 2
        elif data[pos] == 0x2C:
            frames += 1
            packed = data[pos + 9]
            pos += 10 + (3 * (2 << (packed & 7)) if packed & 0x80 else 0) + 1
        else:
            raise RuntimeError(f"{path}: unknown block 0x{data[pos]:02x} at byte {pos}")
        while data[pos]:
            pos += data[pos] + 1
        pos += 1
    return frames, delays


def instance_norm_paths(out_dir, train_counts):
    """(a) run_tto_batch at the published widths on one prepared batch of 2
    synthetic objects, 100 iterations, with the published BatchNorm2d
    encoder and with an InstanceNorm2d one: each launches exactly K1 200
    and K2 96 (the TTO cell's, less the cross-view evaluation's 2), with
    finite curves; the TTO driver, and so every TTO CLI, refuses the
    InstanceNorm config as JAX's does (ROADMAP C.22). (b) training through
    the CLI with the InstanceNorm config: the training cell's launches of
    phase 5. Returns the launch counts."""
    import torch

    from supnerf_tpu_torch.cli.common import SyntheticDataset, load_model_and_codes
    from supnerf_tpu_torch.config import load_hpams
    from supnerf_tpu_torch.ops import render
    from supnerf_tpu_torch.tto.core import render_decoder, run_tto_batch
    from supnerf_tpu_torch.tto.driver import TTODriver

    cfg = _option_config(out_dir, "supnerf_instancenorm", net_hyperparams=INSTANCE_NORM)
    bn_hpams, in_hpams = load_hpams(PUBLISHED), load_hpams(cfg)
    models = {"BatchNorm2d": load_model_and_codes(bn_hpams, "cuda", seed=0),
              "InstanceNorm2d": load_model_and_codes(in_hpams, "cuda", seed=0)}
    try:
        TTODriver(*models["InstanceNorm2d"], in_hpams, SyntheticDataset(2), out_dir,
                  device="cuda", batch_size=2)
    except ValueError as e:
        print(f"   (a) the TTO driver refuses the InstanceNorm2d config, as JAX's: {e}")
    else:
        raise RuntimeError("(a): the TTO driver took an InstanceNorm2d config")
    driver = TTODriver(*models["BatchNorm2d"], bn_hpams, SyntheticDataset(2), out_dir,
                       device="cuda", batch_size=2)
    _, _, batch = driver._prep([0, 1])
    counts = {}
    for norm, (model, mean_shape, mean_texture) in models.items():
        t0 = time.perf_counter()
        render.reset_launch_counts()
        res = run_tto_batch(model, render_decoder(model), batch,
                            torch.as_tensor(mean_shape, device="cuda"),
                            torch.as_tensor(mean_texture, device="cuda"), driver.cfg,
                            generator=torch.Generator(device="cuda").manual_seed(0))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts[f"{norm[:-2].lower()}_tto_batch"] = _exact_counts(f"(a) {norm} run_tto_batch",
                                                      TTO_BATCH_COUNTS)
        res = {k: v.detach().cpu() for k, v in res.items()}
        _check_curves(f"(a) {norm}", [c for k in ("psnr", "rot_err", "trans_err", "depth_err",
                                                   "loss") for c in res[k]], 2, OPTION_ITERS)
        print(f"   (a) {norm}: run_tto_batch {seconds:.3f} s for 2 objects x {OPTION_ITERS} "
              f"iterations, {2 * 60 / seconds:.1f} objects/min; psnr "
              f"{float(res['psnr'][0, 0]):.3f} -> {float(res['psnr'][0, -1]):.3f}")
    t0 = time.perf_counter()
    counts["instancenorm_train"] = train_path(os.path.join(out_dir, "train"), cfg,
                                              "(b) InstanceNorm training")
    if counts["instancenorm_train"] != train_counts:
        raise RuntimeError(f"(b): launches {counts['instancenorm_train']}, the training "
                           f"cell's {train_counts}")
    print(f"   (b): {time.perf_counter() - t0:.2f} s")
    return counts


def autorf_opt_model_path(out_dir):
    """(c) run_multiview_tto with opt_model and opt_pose on the original
    AutoRF (W 128, 5 and 5 blocks), 1 instance x 2 views, 100 iterations:
    its decoder copy under autograd (decoder_composite), no kernel launched,
    the model given unchanged, finite curves and a last loss below the
    first. Returns the launch counts."""
    import torch

    from supnerf_tpu_torch.cli.common import SyntheticDataset, load_model_and_codes
    from supnerf_tpu_torch.config import load_hpams
    from supnerf_tpu_torch.ops import render
    from supnerf_tpu_torch.tto.driver import TTODriver
    from supnerf_tpu_torch.tto.multiview import MultiviewBatch, run_multiview_tto

    cfg = _config_copy(out_dir, "autorfmix.nusc.vehicle.car.json", arch="autorf_original",
                       net_hyperparams={"latent_dim": 128},
                       model_dir=os.path.join(out_dir, "no_checkpoint"))
    hpams = load_hpams(cfg)
    model, mean_shape, mean_texture = load_model_and_codes(hpams, "cuda", seed=0)
    driver = TTODriver(model, mean_shape, mean_texture, hpams, SyntheticDataset(2), out_dir,
                       device="cuda", batch_size=2)
    _, _, batch = driver._prep([0, 1])
    before = {k: v.clone() for k, v in model.state_dict().items()}
    render.reset_launch_counts()
    t0 = time.perf_counter()
    res = run_multiview_tto(model, driver.wts, MultiviewBatch.from_object_batch(batch),
                            driver.mean_shape, driver.mean_texture, driver.cfg,
                            opt_pose=True, opt_model=True, generator=driver.render_gen)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = _plain_counts("(c) original AutoRF multiview opt_model")
    if not all(torch.equal(v, before[k]) for k, v in model.state_dict().items()):
        raise RuntimeError("(c): opt_model changed the model given")
    _check_curves("(c) opt_model", [res["psnr"].cpu(), res["loss"].cpu()], 2, OPTION_ITERS)
    loss = res["loss"].cpu()
    if not float(loss[-1]) < float(loss[0]):
        raise RuntimeError(f"(c): the loss did not fall: {float(loss[0])} -> {float(loss[-1])}")
    print(f"   (c) run_multiview_tto(opt_model, opt_pose) on the original AutoRF, 1 instance x "
          f"2 views: {seconds:.2f} s ({seconds / OPTION_ITERS * 1e3:.2f} ms an iteration); psnr "
          f"{float(res['psnr'][0]):.3f} -> {float(res['psnr'][-1]):.3f}, loss "
          f"{float(loss[0]):.5f} -> {float(loss[-1]):.5f}")
    return counts


def video_path(out_dir):
    """(d) cli.generate_video_vis on a --vis 2 results folder (1 object, 100
    frames): the file it wrote (ffmpeg's mp4, else the port's GIF, whose
    frames and delays are counted); the GIF writer timed on the same frames
    either way. Returns the --vis 2 run's launch counts."""
    from supnerf_tpu_torch.cli import generate_video_vis
    from supnerf_tpu_torch.utils.gif import write_gif
    from supnerf_tpu_torch.utils.image_io import read_png as port_read_png

    run = os.path.join(out_dir, "vis2")
    counts = _vis_run(run, 2, 1, VIS2_COUNTS)
    written, text = _printed(lambda: generate_video_vis.main([run, "--fps", "10"]))
    folders = [d for d in os.listdir(run) if os.path.isdir(os.path.join(run, d))]
    if len(folders) != 1 or len(written) != 1:
        raise RuntimeError(f"(d): wrote {written} for the folders {folders}")
    frame_files = sorted(f for f in os.listdir(os.path.join(run, folders[0]))
                         if f.startswith("opt"))
    path = written[0]
    if path.endswith(".mp4"):
        print(f"   (d) ffmpeg ran: {path}, {os.path.getsize(path)} bytes")
        if os.path.getsize(path) == 0:
            raise RuntimeError("(d): ffmpeg wrote an empty file")
        if shutil.which("ffprobe"):
            n = subprocess.run(["ffprobe", "-v", "error", "-count_frames", "-select_streams",
                                "v:0", "-show_entries", "stream=nb_read_frames", "-of",
                                "csv=p=0", path], capture_output=True, text=True).stdout.strip()
            if n != str(len(frame_files)):
                raise RuntimeError(f"(d): the mp4 holds {n} frames, not {len(frame_files)}")
            print(f"   (d) ffprobe counts {n} frames")
    else:
        print(f"   (d) no ffmpeg here: the GIF writer ran ({path})")
    frames = [port_read_png(os.path.join(run, folders[0], f), mode="RGB") for f in frame_files]
    gif = os.path.join(out_dir, "timed.gif")
    t0 = time.perf_counter()
    write_gif(gif, frames, 10)
    seconds = time.perf_counter() - t0
    for p in [gif] + [p for p in written if p.endswith(".gif")]:
        n, delays = gif_frames(p)
        if n != len(frame_files) or delays != [10] * n:
            raise RuntimeError(f"(d): {p} holds {n} frames with delays {set(delays)}, expected "
                               f"{len(frame_files)} of 10 cs")
    print(f"   (d) the GIF writer: {len(frames)} frames of {frames[0].shape[1]} x "
          f"{frames[0].shape[0]} in {seconds:.2f} s ({seconds / len(frames):.4f} s a frame, "
          f"{os.path.getsize(gif)} bytes), {len(frames)} frames of 10 cs counted")
    return counts


def qa_path(out_dir):
    """(e) The nuScenes reader on the phase-9 fixture (1600 x 900 JPEGs)
    with debug=True: a QA panel per sample at {anntoken}_{camera}.png, one
    decoded by read_png; the panel's seconds a sample; then
    dataset_statistics with a visibility table added to the fixture: the
    JAX function's keys, the levels, and both histograms' JSON."""
    import numpy as np

    from supnerf_tpu_torch.config import load_hpams
    from supnerf_tpu_torch.data.debug import dataset_statistics, debug_sample_panel
    from supnerf_tpu_torch.data.nuscenes import NuScenesData

    root = os.path.join(out_dir, "nuscenes")
    write_nusc_fixture(root)
    tables = os.path.join(root, "v1.0-mini")
    with open(os.path.join(tables, "sample_annotation.json")) as f:
        anns = json.load(f)
    for i, a in enumerate(anns):
        a["visibility_token"] = str(1 + i % 4)
    with open(os.path.join(tables, "sample_annotation.json"), "w") as f:
        json.dump(anns, f)
    with open(os.path.join(tables, "visibility.json"), "w") as f:
        json.dump([{"token": str(k), "level": lvl, "description": ""} for k, lvl in
                   enumerate(["v0-40", "v40-60", "v60-80", "v80-100"], 1)], f)
    cfg = _config_copy(out_dir, "supnerf.nusc.vehicle.car.json",
                       {"test_data_dir": root, "test_nusc_version": "v1.0-mini"})
    dbg = os.path.join(out_dir, "debug_vis")
    ds = NuScenesData(load_hpams(cfg), split="val", add_pose_err=1, debug=True, debug_dir=dbg)
    t0 = time.perf_counter()
    samples = [ds[i] for i in range(len(ds))]
    with_panels = time.perf_counter() - t0
    want = sorted(f"{a}_{c}.png" for a, c in ds.all_valid_samples)
    if not samples or sorted(os.listdir(dbg)) != want:
        raise RuntimeError(f"(e): panels {sorted(os.listdir(dbg))}, expected {want}")
    img = read_png(os.path.join(dbg, want[0]))
    if img.shape != (900, 3200, 3):
        raise RuntimeError(f"(e): the panel decodes to {img.shape}")
    t0 = time.perf_counter()
    panels = [debug_sample_panel(s) for s in samples]
    panel_s = (time.perf_counter() - t0) / len(samples)
    if not all(p.shape == (900, 3200, 3) for p in panels):
        raise RuntimeError("(e): a panel has another shape")
    print(f"   (e) {len(samples)} samples read with debug=True in {with_panels:.2f} s; a QA "
          f"panel alone {panel_s:.3f} s a sample (1600 x 900, the boxes, the ROI and "
          f"{np.mean([len(s['lidar_u']) for s in samples]):.0f} lidar points a sample)")
    ds.debug = False
    stats_dir = os.path.join(out_dir, "stats")
    t0 = time.perf_counter()
    stats = dataset_statistics(ds, stats_dir, print_every=0)
    keys = {"n_samples", "wlh_mean", "wlh_std", "dist_mean", "level_label", "levels"}
    files = sorted(os.listdir(stats_dir))
    if (set(stats) != keys or stats["n_samples"] != len(samples)
            or files != ["nuscenesdata_dist_hist.json", "nuscenesdata_vis_hist.json"]):
        raise RuntimeError(f"(e): statistics {stats}, files {files}")
    with open(os.path.join(stats_dir, "nuscenesdata_vis_hist.json")) as f:
        vis_hist = json.load(f)
    if sum(vis_hist["counts"]) != len(samples):
        raise RuntimeError(f"(e): the visibility histogram {vis_hist}")
    print(f"   (e) dataset_statistics in {time.perf_counter() - t0:.2f} s: wlh mean "
          f"{np.round(stats['wlh_mean'], 3).tolist()}, dist mean {stats['dist_mean']:.3f} m, "
          f"visibility levels {stats['levels']}; {files}")


def profile_path(out_dir):
    """(f) The TTO cell through the CLI without and with --profile_dir: the
    trace's render_fwd_kernel and render_bwd_kernel events must equal the
    launch counters over the traced span (TTODriver.run, the span JAX's
    maybe_profile wraps: K1 200, K2 96; the cross-view evaluation after it
    launches K1 twice more); the traced run's tto_loop beside the untraced
    one's (the profiler's overhead). Returns the launch counts of both
    runs."""
    import torch

    from supnerf_tpu_torch.cli import optimize
    from supnerf_tpu_torch.ops import render
    from supnerf_tpu_torch.tto.driver import TTODriver

    counts, loops, in_span = {}, {}, {}
    cross_view = TTODriver.eval_cross_view

    def after_span(self, *a, **k):
        in_span.update({c: render.LAUNCHES[c] for c in PROFILED_KERNELS})
        return cross_view(self, *a, **k)

    TTODriver.eval_cross_view = after_span
    try:
        for label, extra in (("untraced", []), ("traced", ["--profile_dir",
                                                           os.path.join(out_dir, "trace")])):
            render.reset_launch_counts()
            t0 = time.perf_counter()
            summary = optimize.main(["--config_file", PUBLISHED, "--dataset", "synthetic",
                                     "--num_objects", "2", "--batch_size", "2", "--device",
                                     "cuda", "--seed", "0", "--save_dir",
                                     os.path.join(out_dir, label)] + extra)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts[label] = _exact_counts(f"(f) TTO {label}", OPTION_COUNTS)
            loops[label] = summary["phase_seconds"]["tto_loop"]
            print(f"   (f) TTO {label}: {seconds:.2f} s through the CLI ({2 * 60 / seconds:.1f} "
                  f"objects/min, the trace's export included), tto_loop {loops[label]:.3f} s")
    finally:
        TTODriver.eval_cross_view = cross_view
    t0 = time.perf_counter()
    with open(os.path.join(out_dir, "trace", "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    traced = {c: sum(name in e.get("name", "") for e in kernels)
              for c, name in PROFILED_KERNELS.items()}
    print(f"   (f) trace.json: {len(events)} events, {len(kernels)} kernel events (read in "
          f"{time.perf_counter() - t0:.2f} s); {PROFILED_KERNELS['render_fwd']} "
          f"{traced['render_fwd']}, {PROFILED_KERNELS['render_bwd']} {traced['render_bwd']}; "
          f"the counters over the traced span {in_span}")
    if traced != in_span or min(traced.values()) == 0:
        raise RuntimeError(f"(f): the trace holds {traced} kernel launches, the counters "
                           f"{in_span}")
    print(f"   (f) the profiler's overhead on tto_loop: {loops['traced']:.3f} s against "
          f"{loops['untraced']:.3f} s ({(loops['traced'] / loops['untraced'] - 1) * 100:+.1f} %)")
    return {"profile_untraced": counts["untraced"], "profile_traced": counts["traced"]}


def last_module_paths(train_counts):
    """Phase 14. Returns the launch counts per cell."""
    counts = _in_temp_dir(lambda d: instance_norm_paths(d, train_counts))
    t0 = time.perf_counter()
    counts["autorf_original_opt_model"] = _in_temp_dir(autorf_opt_model_path)
    print(f"   (c): {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    counts["vis2_video"] = _in_temp_dir(video_path)
    print(f"   (d): {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    _in_temp_dir(qa_path)
    print(f"   (e): {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    counts.update(_in_temp_dir(profile_path))
    print(f"   (f): {time.perf_counter() - t0:.2f} s")
    return counts


# --------------------------------------------------------------------------
# phase 15: data parallelism (supnerf_tpu_torch/parallel/): training and TTO
# through a world-size-1 NCCL group against the same runs without one, and on
# 2 ranks where the machine shows a second card
# --------------------------------------------------------------------------

DP_STEPS = 2
DP_TTO_OBJECTS = 2
# --devices runs against the same runs without a group, at
# tests/test_torch_parallel.py's one-process tolerances: the first step
# (one epoch of one batch: both runs start from the seeded state) its loss
# and end state (its parameters may take one AdamW step of either sign on a
# float32-noise gradient component: 2 lr); the later steps run free, and
# float32 runs part there (the CPU test's finding), so their differences
# are printed and the losses held only to DP_FREE_RTOL
DP_LOSS_RTOL = 5e-5
DP_FREE_RTOL = 1e-2
DP_STATE_TOL = {"params": {"rtol": 5e-3, "atol": 2.5e-4},
                "tables": {"rtol": 0.0, "atol": 1e-5}, "stats": {"rtol": 1e-5, "atol": 1e-5}}
DP_TTO_ATOL = {"psnr_eval": 1e-4, "optimized_poses": 1e-5, "optimized_shapecodes": 1e-5,
               "optimized_texturecodes": 1e-5}


def _checkpoint_arrays(path):
    """{name: float64 array} of a checkpoint: the model's state_dict, both
    code tables, optimized_idx."""
    import torch

    saved = torch.load(path, map_location="cpu", weights_only=False)
    out = {f"model.{k}": v.double().numpy() for k, v in saved["model_params"].items()}
    out.update(shape_codes=saved["shape_code_params"]["weight"].double().numpy(),
               texture_codes=saved["texture_code_params"]["weight"].double().numpy(),
               optimized_idx=saved["optimized_idx"].double().numpy())
    return out


def _states_agree(label, got, want, check=True):
    """Raise (with check) unless two checkpoints' arrays agree at
    DP_STATE_TOL (BatchNorm's counts and optimized_idx exactly); returns
    (bit for bit, the largest difference of each group)."""
    import numpy as np

    groups = {"params": [], "tables": ["shape_codes", "texture_codes"], "stats": [],
              "exact": ["optimized_idx"]}
    for k in want:
        if k.endswith(("running_mean", "running_var")):
            groups["stats"].append(k)
        elif k.endswith("num_batches_tracked"):
            groups["exact"].append(k)
        elif k.startswith("model."):
            groups["params"].append(k)
    worst = {}
    for name, keys in groups.items():
        worst[name] = max(float(np.abs(got[k] - want[k]).max()) for k in keys)
        for k in keys:
            tol = DP_STATE_TOL.get(name, {"rtol": 0.0, "atol": 0.0})
            if check and not np.allclose(got[k], want[k], rtol=tol["rtol"], atol=tol["atol"]):
                raise RuntimeError(f"{label}: {k} differs beyond {tol} "
                                   f"(max {float(np.abs(got[k] - want[k]).max()):.3e})")
    bits = all(np.array_equal(got[k], want[k]) for k in want)
    return bits, worst


def _dp_train(out_dir, devices, label, counts_want=None):
    """cli.train at the published config, batch 48, DP_STEPS epochs of one
    step, with --devices `devices` (None: no group); returns (summary,
    launch counts, [each epoch's checkpoint arrays])."""
    import torch

    from supnerf_tpu_torch.cli import train
    from supnerf_tpu_torch.ops import render

    run = os.path.join(out_dir, f"devices_{devices}")
    argv = ["--config_file", PUBLISHED, "--dataset", "synthetic",
            "--num_objects", str(SWEEP_BATCH), "--batch_size", str(SWEEP_BATCH),
            "--epochs", str(DP_STEPS), "--device", "cuda", "--seed", "0", "--check_iter", "100000",
            "--save_dir", run] + (["--devices", str(devices)] if devices else [])
    render.reset_launch_counts()
    t0 = time.perf_counter()
    summary = train.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = summary.get("launches") if devices and devices > 1 else dict(render.LAUNCHES)
    counts = {k: v for k, v in counts.items() if v}
    steps = summary["metrics"]
    loop = sum(m["seconds"] for m in steps)
    reduce_s = summary["phase_seconds"].get("all_reduce", 0.0)
    print(f"   {label}: {len(steps)} steps of {SWEEP_BATCH} in {seconds:.2f} s through the CLI, "
          f"the step loop {len(steps) / loop:.3f} steps/s; launches {counts}"
          + (f"; all_reduce {1e3 * reduce_s / len(steps):.3f} ms a step" if devices else ""))
    print(f"   {label} losses: " + ", ".join(f"{m['loss_total']:.7f}" for m in steps))
    if len(steps) != DP_STEPS:
        raise RuntimeError(f"{label}: {len(steps)} steps instead of {DP_STEPS}")
    if counts_want is not None and counts != counts_want:
        raise RuntimeError(f"{label}: launches {counts}, the run without a group {counts_want}")
    states = [_checkpoint_arrays(os.path.join(run, f"epoch_{e}.pth")) for e in range(DP_STEPS)]
    shutil.rmtree(run)
    return summary, counts, states


def _dp_tto(out_dir, devices, label):
    """cli.optimize at the published config on DP_TTO_OBJECTS synthetic
    objects, with --devices `devices` (None: no group); returns (summary,
    launch counts, the result file's dict)."""
    import torch

    from supnerf_tpu_torch.cli import optimize
    from supnerf_tpu_torch.ops import render

    run = os.path.join(out_dir, f"tto_devices_{devices}")
    render.reset_launch_counts()
    t0 = time.perf_counter()
    summary = optimize.main(
        ["--config_file", PUBLISHED, "--dataset", "synthetic",
         "--num_objects", str(DP_TTO_OBJECTS), "--batch_size", str(DP_TTO_OBJECTS),
         "--device", "cuda", "--seed", "0", "--save_dir", run]
        + (["--devices", str(devices)] if devices else []))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = summary.get("launches") if devices and devices > 1 else dict(render.LAUNCHES)
    counts = {k: v for k, v in counts.items() if v}
    print(f"   {label}: {DP_TTO_OBJECTS} objects in {seconds:.2f} s through the CLI "
          f"({DP_TTO_OBJECTS * 60 / seconds:.1f} objects/min), tto_loop "
          f"{summary['phase_seconds']['tto_loop']:.3f} s; launches {counts}")
    with open(os.path.join(run, "codes+poses.pkl"), "rb") as f:
        return summary, counts, pickle.load(f)


def _results_agree(label, got, want):
    """Raise unless two TTO result dicts hold the same objects within
    DP_TTO_ATOL; returns (bit for bit, the largest difference of each)."""
    import numpy as np

    if set(got["psnr_eval"]) != set(want["psnr_eval"]):
        raise RuntimeError(f"{label}: other objects {sorted(got['psnr_eval'])}")
    worst, bits = {}, True
    for key, atol in DP_TTO_ATOL.items():
        pairs = []
        for k, v in want[key].items():
            a, b = got[key][k], v
            if isinstance(b, dict):
                pairs += [(np.asarray(a[c], np.float64), np.asarray(b[c], np.float64)) for c in b]
            else:
                pairs.append((np.asarray(a, np.float64), np.asarray(b, np.float64)))
        worst[key] = max(float(np.abs(a - b).max()) for a, b in pairs)
        bits = bits and all(np.array_equal(a, b) for a, b in pairs)
        if worst[key] > atol:
            raise RuntimeError(f"{label}: {key} differs by {worst[key]:.3e} (atol {atol})")
    return bits, worst


def data_parallel_paths(out_dir, tto_counts):
    """Phase 15: (a) cli.train --devices 1 (one NCCL rank) against the same
    steps without a group; (b) cli.optimize --devices 1 against the run
    without a group and phase 4's launches; (c) both again on 2 ranks
    where the machine shows a second card. Returns the launch counts per
    cell."""
    import torch

    from supnerf_tpu_torch.config import load_hpams
    from supnerf_tpu_torch.models.factory import build_model
    from supnerf_tpu_torch.training.train_step import TrainConfig, metric_names

    counts = {}
    t0 = time.perf_counter()
    base, counts["dp_train_base"], base_states = _dp_train(out_dir, None, "(a) no group")
    one, counts["dp_train_devices1"], one_states = _dp_train(
        out_dir, 1, "(a) --devices 1", counts["dp_train_base"])
    coll = one["collectives"]
    hp = load_hpams(PUBLISHED)
    n_params = sum(p.numel() for p in build_model(hp["arch"], hp["net_hyperparams"]).parameters())
    n_inst = SWEEP_BATCH // 2
    flat = n_params + 2 * n_inst * hp["net_hyperparams"]["latent_dim"] + n_inst + len(
        metric_names("unified", TrainConfig()))
    print(f"   (a) group: backend {one['backend']}, world {one['world']}; collectives "
          f"{coll}: {coll['grad_all_reduce']} gradient all-reduces of {flat:,} floats "
          f"({flat * 4 / 1e6:.1f} MB) each, one a step; BatchNorm's statistics "
          f"{coll['stat_all_reduce']}")
    if one["backend"] != "nccl" or one["world"] != 1 or coll["grad_all_reduce"] != DP_STEPS:
        raise RuntimeError(f"(a): backend {one['backend']}, world {one['world']}, "
                           f"{coll['grad_all_reduce']} gradient all-reduces for {DP_STEPS} steps")
    if coll["stat_all_reduce"] == 0:
        raise RuntimeError("(a): BatchNorm took no global statistics")
    rel = [abs(a["loss_total"] - b["loss_total"]) / abs(b["loss_total"])
           for a, b in zip(one["metrics"], base["metrics"])]
    bits, worst = _states_agree("(a) --devices 1 against no group, step 1", one_states[0],
                                base_states[0])
    print(f"   (a) against no group: step losses rel diff {', '.join(f'{x:.2e}' for x in rel)} "
          f"(step 1 tol {DP_LOSS_RTOL:.0e}, later {DP_FREE_RTOL:.0e}); the state after step 1 "
          f"bit for bit: {bits}, largest differences {worst} (tol {DP_STATE_TOL})")
    bits, worst = _states_agree("(a) end state", one_states[-1], base_states[-1], check=False)
    print(f"   (a) the end state after {DP_STEPS} steps (free-running, not held): bit for bit "
          f"{bits}, largest differences {worst}")
    if not rel[0] <= DP_LOSS_RTOL or not max(rel) <= DP_FREE_RTOL:
        raise RuntimeError("(a): a step's loss differs from the run without a group")
    print(f"   (a) all_reduce {1e3 * one['phase_seconds']['all_reduce'] / DP_STEPS:.3f} ms a "
          f"step; {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    _, counts["dp_tto_base"], base_res = _dp_tto(out_dir, None, "(b) no group")
    tto_one, counts["dp_tto_devices1"], one_res = _dp_tto(out_dir, 1, "(b) --devices 1")
    if counts["dp_tto_devices1"] != tto_counts or counts["dp_tto_base"] != tto_counts:
        raise RuntimeError(f"(b): launches {counts['dp_tto_devices1']} and "
                           f"{counts['dp_tto_base']}, phase 4's {tto_counts}")
    if tto_one["collectives"]["gather"] != 1 or tto_one["backend"] != "nccl":
        raise RuntimeError(f"(b): {tto_one['collectives']} on {tto_one['backend']}")
    bits, worst = _results_agree("(b) --devices 1 against no group", one_res, base_res)
    print(f"   (b) group: backend {tto_one['backend']}, world {tto_one['world']}, "
          f"{tto_one['collectives']['gather']} gather; launches equal phase 4's {tto_counts}; "
          f"results bit for bit: {bits}; largest differences {worst} (tol {DP_TTO_ATOL}); "
          f"{time.perf_counter() - t0:.2f} s")

    cards = torch.cuda.device_count()
    if cards < 2:
        print(f"   (c) one card (torch.cuda.device_count() {cards}): the 2-rank cells do not run")
        return counts
    t0 = time.perf_counter()
    two, counts["dp_train_devices2"], two_states = _dp_train(out_dir, 2, "(c) --devices 2")
    bits, worst = _states_agree("(c) --devices 2 against 1", two_states[0], one_states[0])
    print(f"   (c) training on {two['world']} ranks ({two['backend']}) against 1: bit for bit "
          f"{bits}, largest differences {worst}")
    _, counts["dp_tto_devices2"], two_res = _dp_tto(out_dir, 2, "(c) TTO --devices 2")
    bits, worst = _results_agree("(c) TTO --devices 2 against 1", two_res, one_res)
    print(f"   (c) TTO on 2 ranks against 1: bit for bit {bits}, largest differences {worst}; "
          f"{time.perf_counter() - t0:.2f} s")
    return counts


# Phase 16: the pipelined TTO driver against its serial order, the decoders
PIPE_BATCH, PIPE_NUSC_OBJECTS, PIPE_SYNTHETIC_OBJECTS = 2, 4, 8
NUSC_FIXTURE_PROGRESSIVE = os.path.join(HERE, "tests", "fixtures",
                                        "nusc_cam_1600x900_progressive.jpg")
# the files a TTO run writes whose bytes must not depend on the order (eval.json
# names its run's folder)
PIPE_RESULT_FILES = ("codes+poses.pkl", "codes+poses.pth", "cross_eval.pkl")


def _serial_run(self):
    """TTODriver.run's serial order: a loop of optimize_object_batch over the
    same batches, then the result files."""
    n = len(self.dataset)
    for start in range(0, n, self.batch_size):
        self.optimize_object_batch(list(range(start, min(start + self.batch_size, n))))
    self.save_results()
    self.save_results_pth()
    return self.results_dict()


def _same_values(a, b):
    """Whether two unpickled results are equal leaf for leaf: arrays of the
    same dtype and shape with the same bits, everything else ==."""
    import numpy as np

    if isinstance(a, dict):
        return (isinstance(b, dict) and list(a) == list(b)
                and all(_same_values(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_same_values(x, y) for x, y in zip(a, b)))
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape
                and a.tobytes() == b.tobytes())
    return type(a) is type(b) and a == b


def _pipeline_cell(label, argv, n_objects, out_dir, group_run=False):
    """cli.optimize with argv four times, serial (TTODriver.run replaced by
    _serial_run), pipelined, pipelined, serial, and with group_run a fifth
    time pipelined with --devices 1 (a world-size-1 NCCL group: the worker
    forked beside NCCL, each batch's gather before the next one's
    launches): every run's result files byte for byte and its K1/K2
    launches equal to the first's. Returns (the pipelined runs' launch
    counts, the cell's times)."""
    import numpy as np
    import torch

    from supnerf_tpu_torch.cli import optimize
    from supnerf_tpu_torch.ops import render
    from supnerf_tpu_torch.tto import driver as driver_mod

    runs, pipelined_run = [], driver_mod.TTODriver.run
    orders = ("serial", "pipelined", "pipelined", "serial")
    orders += ("--devices 1",) if group_run else ()
    for i, order in enumerate(orders):
        save = os.path.join(out_dir, f"{label}_{i}_{order.replace(' ', '')}")
        render.reset_launch_counts()
        if order == "serial":
            driver_mod.TTODriver.run = _serial_run
        try:
            t0 = time.perf_counter()
            summary = optimize.main(argv + ["--device", "cuda", "--seed", "0", "--save_dir", save]
                                    + (order.split() if order == "--devices 1" else []))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            driver_mod.TTODriver.run = pipelined_run
        files = {}
        for name in PIPE_RESULT_FILES:
            with open(os.path.join(save, name), "rb") as f:
                files[name] = f.read()
        shutil.rmtree(save)
        phases = summary["phase_seconds"]
        runs.append({"order": order, "wall_s": wall, "objects_per_min": n_objects * 60 / wall,
                     "host_prep_s": phases["host_prep"],
                     "worker_s": phases.get("worker_start", 0.0) + phases.get("worker_stop", 0.0),
                     "prep_wait_s": phases.get("prep_wait", 0.0),
                     "tto_loop_s": [s for name, s in summary["phase_log"] if name == "tto_loop"],
                     "launches": {k: v for k, v in render.LAUNCHES.items() if v}, "files": files})
        if order == "--devices 1":
            batches = -(-n_objects // PIPE_BATCH)
            if summary["backend"] != "nccl" or summary["collectives"]["gather"] != batches:
                raise RuntimeError(f"{label} --devices 1: {summary['collectives']} on "
                                   f"{summary['backend']}, expected {batches} gathers on nccl")
    first = runs[0]
    for r in runs[1:]:
        differ = [name for name in PIPE_RESULT_FILES if r["files"][name] != first["files"][name]]
        if r["order"] == "--devices 1" and differ == ["codes+poses.pkl"] and _same_values(
                pickle.loads(r["files"][differ[0]]), pickle.loads(first["files"][differ[0]])):
            # the gathered arrays' dtype objects are unpickled copies, so the
            # results pickle to other bytes; their values are the same bits
            differ = []
        if differ:
            raise RuntimeError(f"{label}: the {r['order']} run's {differ} differ from the serial "
                               "run's")
        if r["launches"] != first["launches"]:
            raise RuntimeError(f"{label}: the {r['order']} run launched {r['launches']}, the "
                               f"serial run {first['launches']}")
    mean = {o: {k: float(np.mean([r[k] for r in runs if r["order"] == o]))
                for k in ("wall_s", "objects_per_min", "host_prep_s")}
            for o in ("serial", "pipelined")}
    for o in mean:
        mean[o]["tto_loop_s"] = np.mean([r["tto_loop_s"] for r in runs if r["order"] == o],
                                        0).tolist()
    saved = mean["serial"]["wall_s"] - mean["pipelined"]["wall_s"]
    hidden = saved / mean["serial"]["host_prep_s"]
    times = {"runs": [{k: v for k, v in r.items() if k not in ("files", "launches")}
                      for r in runs], "mean": mean, "prep_hidden_share": hidden,
             "files_bit_for_bit": True}
    same = " (the --devices 1 run's codes+poses.pkl: the same values)" if group_run else ""
    print(f"   {label}: the {len(runs)} runs' {', '.join(PIPE_RESULT_FILES)} the same bytes"
          f"{same}, launches "
          f"{first['launches']} each")
    for r in runs:
        print(f"   {label} {r['order']}: {r['wall_s']:.3f} s, {r['objects_per_min']:.2f} "
              f"objects/min, host_prep {r['host_prep_s']:.3f} s, the worker's start and stop "
              f"{r['worker_s']:.3f} s, waits for its preps {r['prep_wait_s']:.3f} s, tto_loop "
              "per batch "
              + ", ".join(f"{s:.3f}" for s in r["tto_loop_s"]) + " s")
    print(f"   {label} means: serial {mean['serial']['wall_s']:.3f} s "
          f"({mean['serial']['objects_per_min']:.2f} objects/min), pipelined "
          f"{mean['pipelined']['wall_s']:.3f} s ({mean['pipelined']['objects_per_min']:.2f} "
          f"objects/min); host_prep {mean['serial']['host_prep_s']:.3f} s serial, "
          f"{mean['pipelined']['host_prep_s']:.3f} s in the worker; share of the serial prep "
          f"hidden {hidden:.3f}")
    return runs[1]["launches"], times


def pipeline_paths(out_dir):
    """Phase 16: (a) cli.optimize on phase 9's nuScenes fixture (4 objects,
    --batch_size 2, add_pose_err 2) and (b) on 8 synthetic objects at
    --batch_size 2, at the published config, each pipelined against the
    serial loop of optimize_object_batch, A B B A (_pipeline_cell); (d) the
    decode seconds of the progressive fixture beside the baseline one, whose
    pixels are the same. Returns (launch counts per path, the times)."""
    import argparse
    import hashlib

    from supnerf_tpu_torch.bench.decode_seconds import jpeg_seconds
    from supnerf_tpu_torch.cli.common import build_dataset
    from supnerf_tpu_torch.config import load_hpams
    from supnerf_tpu_torch.data.jpeg import read_jpeg

    counts, times = {}, {}
    nusc_root = os.path.join(out_dir, "nuscenes")
    write_nusc_fixture(nusc_root)
    cfg = _config_copy(out_dir, "supnerf.nusc.vehicle.car.json",
                       {"test_data_dir": nusc_root, "test_nusc_version": "v1.0-mini"})
    # curation, once before the timed runs (it writes the index they read)
    n = len(build_dataset(load_hpams(cfg), argparse.Namespace(dataset="nusc", add_pose_err=2)))
    if n != PIPE_NUSC_OBJECTS:
        raise RuntimeError(f"(a): curation kept {n} objects, expected {PIPE_NUSC_OBJECTS}")
    counts["pipelined_nusc"], times["nusc"] = _pipeline_cell(
        "(a) nuScenes", ["--config_file", cfg, "--dataset", "nusc", "--batch_size",
                         str(PIPE_BATCH), "--add_pose_err", "2"], n, out_dir)
    counts["pipelined_synthetic"], times["synthetic"] = _pipeline_cell(
        "(b) synthetic", ["--config_file", PUBLISHED, "--dataset", "synthetic", "--num_objects",
                          str(PIPE_SYNTHETIC_OBJECTS), "--batch_size", str(PIPE_BATCH)],
        PIPE_SYNTHETIC_OBJECTS, out_dir, group_run=True)
    digest = hashlib.sha256(read_jpeg(NUSC_FIXTURE_PROGRESSIVE).tobytes()).hexdigest()
    if digest != NUSC_FIXTURE_SHA256:
        raise RuntimeError(f"the progressive fixture decodes to sha256 {digest}, pinned "
                           f"{NUSC_FIXTURE_SHA256}")
    times["decode"] = jpeg_seconds(repeats=3)
    print(f"   (d) the progressive fixture decodes to the pinned sha256 (the baseline's "
          f"pixels); host decode seconds (median of 3) on this machine: "
          f"{json.dumps(times['decode'])}")
    print("   pipeline: " + json.dumps(times))
    return counts, times


def kernel_records(tto_records, train_records, aabb_records, field_records,
                   train_kernel_records, train_field_extra, codenerf_extra, counts_by_path):
    """One record per launch counter, launches from the path that runs it
    (K1's shared-z mode from the training path; launches_by_path has every
    path, the baselines' too); K1's numbers are the training shape's, with
    the TTO shape's beside them; K5's the symmetry loss's shape, with the
    training field's beside them; K4's K3's stash, with K7's beside them;
    K1-K4's at CodeNeRF's (2, 1) decoder beside theirs (decoder_2_1)."""
    by_name = {r["name"]: r for r in (train_records + aabb_records + field_records
                                      + train_kernel_records)}
    for r in tto_records:
        if r["name"] in by_name:
            by_name[r["name"]]["tto_shape"] = {k: r[k] for k in ("ms", "plain_ms", "bound_ms",
                                                                  "bound_by", "bound_fma_ms",
                                                                  "max_abs_err")}
        else:
            by_name[r["name"]] = r
    keep = ("ms", "plain_ms", "bound_ms", "bound_by", "bound_fma_ms", "max_abs_err",
            "library_ms")
    by_name["field_fwd"]["train_shape"] = {k: train_field_extra["field_fwd"][k] for k in keep}
    by_name["wgrad"]["field_stash"] = {k: train_field_extra["wgrad"][k] for k in keep}
    for name, numbers in codenerf_extra.items():
        by_name[name]["decoder_2_1"] = numbers
    by_name["render_fwd"]["ports"] = ["A1", "A3", "A5"]
    by_name["render_bwd"]["ports"] = ["A2", "A4"]
    by_name["field_fwd"]["ports"] = ["A7", "A11b", "A9"]
    by_name["wgrad"]["ports"] = ["A6", "A10"]
    main_path = {"render_fwd": "train", "render_bwd": "tto", "render_train_bwd": "train",
                 "render_train_bwd_data": "train_render_data", "wgrad": "train",
                 "render_fwd_aabb": "demo", "render_bwd_aabb": "demo", "field_fwd": "reg_lib",
                 "field_bwd": "reg_lib", "field_train_bwd": "train_field"}
    records = [by_name[n] for n in main_path]
    for r in records:
        r["kernel"] = KERNEL_OF[r["name"]]
        r["launches_by_path"] = {p: c.get(r["name"], 0) for p, c in counts_by_path.items()}
        r["launches"] = r["launches_by_path"][main_path[r["name"]]]
    return records


def main():
    try:
        import torch
    except ImportError:
        print("torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA device: this smoke test runs on the card", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "supnerf_tpu_torch")):
        print("supnerf_tpu_torch not found beside chip_smoke.py", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    t_all = time.perf_counter()
    t0 = phase("environment")
    environment()
    done(t0, "environment")
    t0 = phase("build")
    build()
    done(t0, "build")
    t0 = phase("kernels vs plain versions")
    tto_records = check_kernels()
    train_records, arb = check_train_kernels()
    aabb_records = check_aabb_kernels()
    field_records = check_field_kernels()
    train_kernel_records = check_train_data_kernels(arb)
    del arb
    k7_records, train_field_extra = check_field_train_kernels()
    train_kernel_records += k7_records
    codenerf_extra = check_codenerf_kernels()
    check_kernel_branches()
    check_field_branches()
    done(t0, "kernels")
    t0 = phase("TTO path through the CLI")
    tto_counts = _in_temp_dir(tto_path)
    done(t0, "TTO path")
    t0 = phase("training path through the CLI")
    train_counts = _in_temp_dir(train_path)
    done(t0, "training path")
    t0 = phase("demo path through the CLI")
    demo_counts = _in_temp_dir(demo_path)
    done(t0, "demo path")
    t0 = phase("regulariser paths: (a) the CLI, (b) run_tto_batch with sym_loss_coef 1.0")
    reg_cli_counts = _in_temp_dir(reg_cli_path)
    reg_lib_counts = _in_temp_dir(reg_lib_path)
    done(t0, "regulariser paths")
    t0 = phase("training-kernel paths: field_composite_train(data_grads=True), field_train")
    render_data_counts, render_data_ms, render_data_err = train_render_data_path()
    field_train_counts, field_train_ms, field_train_err = train_field_path()
    done(t0, "training-kernel paths")
    t0 = phase("dataset paths: nuScenes (twice), KITTI (add_pose_err 1, 3), Waymo, "
               "the nuScenes demo")
    dataset_counts = _in_temp_dir(dataset_paths)
    done(t0, "dataset paths")
    t0 = phase("baseline paths: AutoRFMix (TTO, KITTI, training), CodeNeRF (TTO, training), "
               "the original AutoRF (TTO, training; plain decoder)")
    baseline_counts = _in_temp_dir(baseline_paths)
    done(t0, "baseline paths")
    t0 = phase("the rest of the TTO driver: (a) the TTO options, (b) multiview, (c) multiview "
               "with opt_model, (d) re-scoring")
    driver_counts = {}

    def driver_paths(out_dir):
        counts, tables = option_paths(out_dir)
        driver_counts.update(counts)
        print(f"   (a) the TTO options: {time.perf_counter() - t0:.2f} s")
        driver_counts.update(_in_temp_dir(multiview_paths))
        model_counts, model_check = _in_temp_dir(multiview_model_path)
        driver_counts["multiview_opt_model"] = model_counts
        driver_counts["cross_eval_folder"] = rescoring_paths(out_dir, tables)
        return model_check

    opt_model_check = _in_temp_dir(driver_paths)
    done(t0, "the rest of the TTO driver")
    t0 = phase("visualisation: (a) K1 at the vis shapes, (b) --vis 1, (c) --vis 2, "
               "(d) the trainer's log")
    vis_kernels = check_vis_kernels()
    vis_counts = _in_temp_dir(vis_paths)
    done(t0, "visualisation")
    t0 = phase("the rest of training: (a) wlh finetuning with the augmentations and "
               "im_enc_rate 0.5, (b) NeRF-only at im_enc_rate 0.5, (c) the per-row prep, "
               "(d) a resume without optimizer state, (e) batch 48")
    training_counts = _in_temp_dir(rest_of_training_paths)
    done(t0, "the rest of training")
    t0 = phase("the last modules: (a) run_tto_batch with BatchNorm and InstanceNorm encoders, "
               "(b) InstanceNorm training, (c) "
               "opt_model on the original AutoRF, (d) the frame video, (e) dataset QA, "
               "(f) --profile_dir")
    last_counts = last_module_paths(train_counts)
    done(t0, "the last modules")
    t0 = phase("data parallelism: (a) training --devices 1 on NCCL, (b) TTO --devices 1, "
               "(c) 2 ranks where there are 2 cards")
    dp_counts = _in_temp_dir(lambda d: data_parallel_paths(d, tto_counts))
    done(t0, "data parallelism")
    t0 = phase("the pipelined TTO driver and the decoders: (a) nuScenes, (b) synthetic, "
               "(c) serial and pipelined A B B A, (d) the progressive JPEG")
    pipeline_counts, _ = _in_temp_dir(pipeline_paths)
    done(t0, "the pipelined TTO driver and the decoders")
    records = kernel_records(tto_records, train_records, aabb_records, field_records,
                             train_kernel_records, train_field_extra, codenerf_extra,
                             {"tto": tto_counts, "train": train_counts, "demo": demo_counts,
                              "reg_cli": reg_cli_counts, "reg_lib": reg_lib_counts,
                              "train_render_data": render_data_counts,
                              "train_field": field_train_counts, **dataset_counts,
                              **baseline_counts, **driver_counts, **vis_counts,
                              **training_counts, **last_counts, **dp_counts,
                              **pipeline_counts})
    records_by_name = {r["name"]: r for r in records}
    records_by_name["render_fwd"].update(vis_kernels)
    records_by_name["render_train_bwd_data"]["batch48_fwd_bwd_ms"] = render_data_ms
    records_by_name["field_train_bwd"]["batch48_fwd_bwd_ms"] = field_train_ms
    records_by_name["render_fwd"]["batch48_max_abs_err"] = render_data_err
    records_by_name["field_fwd"]["batch48_max_abs_err"] = field_train_err
    records_by_name["render_train_bwd_data"]["multiview_opt_model"] = opt_model_check
    print(f"total {time.perf_counter() - t_all:.1f} s")
    print("kernels: " + " ".join(f"{r['kernel']}:{r['name']}({','.join(r['ports'])})"
                                 for r in records))
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
