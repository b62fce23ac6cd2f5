#!/usr/bin/env python3
"""On-card smoke test of supnerf_tpu_torch, the PyTorch/CUDA port.

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and nvcc.
Phases, each timed; any failure exits non-zero before the result line:
  1. environment: card name and power limit (nvidia-smi), torch and CUDA;
  2. build: supnerf_tpu_torch/csrc/*.cu, one nvcc per source in parallel;
  3. kernels: K1 (render_fwd) and K2 (render_bwd) at the TTO path's shapes
     (2 objects, W 256, 1024 rays, 64 samples), K1 again and K3 + K4 (the
     training backward: render_train_bwd_stash, wgrad) at the training
     path's (8 objects), K1 and K2 in their AABB mode (per-ray z, about a
     third of the rays missing their box) at the demo path's (3 objects),
     each against its plain PyTorch version on the same inputs, each error
     beside its tolerance, kernel / plain times beside the card's bound;
     then the branches no path takes (white background, S < 64, odd R,
     W 64/128, several stash chunks), in both modes of K1 and K2;
  4. TTO path: the port's CLI test-time optimization at the published
     config (full width, 100 iterations) on 2 synthetic objects, with the
     launch counts, the final metrics and the result file;
  5. training path: the port's CLI training at the published config on 16
     synthetic objects, batch 8, 2 epochs (4 steps), with the launch counts,
     finite losses, the checkpoints, a resume from epoch 0 that repeats
     step 3's loss, and the TTO loader strict-loading the result;
  6. demo path: the port's demo CLI at hpam_demo.json (full width, 100
     iterations of AABB-bounded TTO on 3 objects of a 900 x 1600 synthetic
     scene, then six composed frames), with the launch counts, finite
     curves and frames, and input.png and the frames decoded by read_png.
The line before the last is a JSON object with one record per kernel; the
last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# Published dense peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet):
# float32 on the CUDA cores and HBM3 bandwidth. The kernels compute in float32
# without tensor cores, so their bound is taken against the float32 rate.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# Tolerances of kernel vs plain version (float32 both; the kernels sum each
# 256-term dot product in another order than torch's matmul): values as in
# tests/test_pallas_render.py; gradients relative to the largest magnitude,
# since dz_shape / dz_tex / dz are sums over 1024 x 64 points per object.
VALUE_ATOL = {"rgb": 3e-4, "depth": 3e-3, "acc": 3e-4}
GRAD_RTOL = 1e-3
# K4 against its plain version (cuBLAS SGEMM, TF32 off) on the same stash:
# float32 sums of up to 262,144 products in another order
WGRAD_RTOL = 1e-4
# A resumed run repeats a step's loss: the same weights, batch and kernels
RESUME_RTOL = 1e-5
TRAIN_OBJECTS, TRAIN_BATCH = 16, 8
DEMO_OBJECTS, DEMO_ITERS = 3, 100

def decoder_macs(W, n_shape, n_tex, d_xyz=63):
    """Multiply-adds per point of the decoder (csrc/render_fwd.cu's count)."""
    return (d_xyz * W + n_shape * W * W + W * W + W + W * W + n_tex * W * W
            + W * (W // 2) + (W // 2) * 3)


def transposed_macs(W, n_shape, n_tex, d_xyz=63):
    """Multiply-adds per point of K2's transposed chain (no sigma/rgb heads)."""
    return (W // 2) * W + n_tex * W * W + W * W + W * W + n_shape * W * W + W * d_xyz


def bound(flops, nbytes):
    """The least time (ms) of `flops` float32 operations moving `nbytes`."""
    t_ops, t_mem = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


def record(name, ports, tpu, src, t_k, t_p, err, b, library_ms=None):
    print(f"   {name}: {t_k:.3f} ms (plain {t_p:.3f} ms, bound {b[0]:.3f} ms by {b[1]}"
          + (f", library {library_ms:.3f} ms" if library_ms is not None else "") + ")")
    return {"name": name, "route": "cuda", "source": src, "replaces": tpu, "ports": ports,
            "launches": 0, "max_abs_err": err, "ms": t_k, "plain_ms": t_p, "bound_ms": b[0],
            "bound_by": b[1], "library_ms": library_ms}


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


def compare_at_kinks(names, got, ref, ref64, rtol):
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
    finite)."""
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
        print(f"   {name:22s} max_abs_err {err:.3e}  tol {tol:.3e}  (max |plain| {scale:.3e})  "
              f"{'ok' if good else 'FAIL'}\n"
              f"   {'':22s} float32 plain {err32:.3e} ({int((e32 > tol).sum())} elements "
              f"outside tol); from float64: kernel {float(e64.max()):.3e}, float32 plain "
              f"{float((b.double() - b64).abs().max()):.3e}; at the worst element kernel "
              f"{float(a.flatten()[i]):+.6e}, float32 plain {float(b.flatten()[i]):+.6e}, "
              f"float64 {float(b64.flatten()[i]):+.6e}")
    return worst, worst32, ok


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


def build():
    from supnerf_tpu_torch.ops import render

    info = render.build_kernels()
    print(f"   built {info['path'].name} in {info['seconds']:.1f} s")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "error" in line.lower():
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


def kernel_inputs(seed=0, B=2, R=1024, S=64):
    """Decoder of the published config (random weights from `seed`) and
    points on rays through an object at ~20 m, as the loss render makes them."""
    import torch
    import torch.nn.functional as F

    from supnerf_tpu_torch.models.factory import build_model, init_model
    from supnerf_tpu_torch.ops import render

    hp = {"shape_blocks": 3, "texture_blocks": 1, "latent_dim": 256, "pose_shortcut": 1}
    model = init_model(build_model("supnerf", hp), seed).cuda()
    wts = render.pack_decoder_params(model)
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
    """K1, K2 and K3 + K4 against their plain versions on the branches the
    main paths do not take: white background, fewer than 64 samples per ray,
    odd ray counts, W 64 and 128, a stash budget of one object (three
    chunks). Same tolerances; not timed."""
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
        bwd = zip(("dxyz", "dviewdir", "dz", "dzs", "dzt"),
                  render.render_bwd(wts, *args, white, *cot),
                  render.render_bwd_plain(wts, *args, white, *cot))
        bwd_ray = zip(("dxyz(aabb)", "dviewdir(aabb)", "dz(aabb)", "dzs(aabb)", "dzt(aabb)"),
                      render.render_bwd(wts, *args_ray, white, *cot, hit),
                      render.render_bwd_plain(wts, *args_ray, white, *cot, hit))
        budget = render.STASH_BYTES
        if W == 256:      # one object per chunk: three K3 + K4 rounds, accumulated
            render.STASH_BYTES = R * S * render.stash_layout(wts)["ld_pt"] * 4
        try:
            k, p = (fn(wts, *args, white, *cot) for fn in (render.render_train_bwd,
                                                          render.render_train_bwd_plain))
        finally:
            render.STASH_BYTES = budget
        train = [("dzs(train)", k[0], p[0]), ("dzt(train)", k[1], p[1]),
                 ("dW(train)", torch.cat([t.flatten() / p_.abs().max().clamp_min(1e-30) for t, p_ in zip(k[2], p[2])]),
                  torch.cat([t.flatten() / t.abs().max().clamp_min(1e-30) for t in p[2]]))]
        errs = []
        for name, a, b in list(fwd) + list(bwd) + train + list(fwd_ray) + list(bwd_ray):
            err = float((a - b).abs().max())
            base = name.split("(")[0]
            tol = VALUE_ATOL[base] if base in VALUE_ATOL else GRAD_RTOL * float(b.abs().max())
            good = err <= tol and bool(torch.isfinite(a).all())
            ok &= good
            errs.append(f"{name} {err:.1e}{'' if good else ' FAIL'}")
        print(f"   W {W} S {S} R {R} white {white}: " + ", ".join(errs))
    if not ok:
        raise RuntimeError("a kernel disagrees with its plain version off the main path")


def check_kernels():
    """K1 and K2 against their plain versions; returns the kernel records."""
    import torch

    from supnerf_tpu_torch.ops import render

    wts, args, cot = kernel_inputs()
    xyz = args[0]
    B, R, S = xyz.shape[:3]
    W, ns, nt = wts.W, wts.n_shape, wts.n_tex
    print(f"   at the TTO path's shape, {B} objects x {R} rays x {S} samples:")
    with torch.no_grad():
        fwd_k = render.render_fwd(wts, *args)
        torch.cuda.synchronize()
        fwd_p = render.render_fwd_plain(wts, *args)
    err_fwd, ok_fwd = compare(("rgb", "depth", "acc"), fwd_k, fwd_p, lambda n, s: VALUE_ATOL[n])

    bwd_k = render.render_bwd(wts, *args, False, *cot)
    torch.cuda.synchronize()
    bwd_p = render.render_bwd_plain(wts, *args, False, *cot)
    err_bwd, ok_bwd = compare(("dxyz", "dviewdir", "dz", "dzs", "dzt"), bwd_k, bwd_p,
                              lambda n, s: GRAD_RTOL * s)

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
    if not (ok_fwd and ok_bwd):
        raise RuntimeError("a kernel disagrees with its plain version")
    return records


def check_train_kernels():
    """K1 at the training path's shape (8 objects, per-object latents) and
    K3 + K4 against render_train_bwd_plain on the same inputs; K4 alone
    against its plain version on the stash K3 wrote. Returns the records of
    K1 (at this shape), K3 and K4."""
    import torch

    from supnerf_tpu_torch.ops import render

    wts, args, cot = kernel_inputs(seed=1, B=TRAIN_BATCH)
    B, R, S = args[0].shape[:3]
    W, ns, nt = wts.W, wts.n_shape, wts.n_tex
    names = ["d" + n for n in _linear_param_names(wts)]
    print(f"   at the training path's shape, {B} objects x {R} rays x {S} samples:")
    with torch.no_grad():
        fwd_k = render.render_fwd(wts, *args)
        torch.cuda.synchronize()
        fwd_p = render.render_fwd_plain(wts, *args)
    err_fwd, ok = compare(("rgb", "depth", "acc"), fwd_k, fwd_p, lambda n, s: VALUE_ATOL[n])

    got = render.render_train_bwd(wts, *args, False, *cot)
    torch.cuda.synchronize()
    ref = render.render_train_bwd_plain(wts, *args, False, *cot)
    err_k3, ok_k3 = compare(("dzs", "dzt"), got[:2], ref[:2], lambda n, s: GRAD_RTOL * s)
    err_w, ok_w = compare(names, got[2], ref[2], lambda n, s: GRAD_RTOL * s)
    del got, ref

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

    k3(render.render_train_bwd_stash)
    gk, gp = (render._linear_grad_buffers(wts, "cuda") for _ in range(2))
    probs = {sl: render.wgrad_problems(wts, *view(sl), gk) for sl in chunks}
    probs_p = {sl: render.wgrad_problems(wts, *view(sl), gp) for sl in chunks}
    render.wgrad(probs[chunks[-1]])
    torch.cuda.synchronize()
    render.wgrad_plain(probs_p[chunks[-1]])
    err_k4, ok_k4 = compare(names, gk, gp, lambda n, s: WGRAD_RTOL * s)

    t_fwd = _timed(lambda: render.render_fwd(wts, *args), 5)
    with torch.no_grad():
        t_fwd_p = _timed(lambda: render.render_fwd_plain(wts, *args), 3)
    t_k3 = _timed(lambda: k3(render.render_train_bwd_stash), 3)
    t_k3_p = _timed(lambda: k3(render.render_train_bwd_stash_plain), 2)
    t_k4 = _timed(lambda: [render.wgrad(probs[sl]) for sl in chunks], 5)
    t_k4_p = _timed(lambda: [render.wgrad_plain(probs_p[sl]) for sl in chunks], 5)
    t_k4_lib = _timed(lambda: [torch.mm(p.G.t(), p.A) for sl in chunks for p in probs_p[sl]], 5)
    t_all = _timed(lambda: render.render_train_bwd(wts, *args, False, *cot), 3)
    t_all_p = _timed(lambda: render.render_train_bwd_plain(wts, *args, False, *cot), 2)
    print(f"   training backward K3 + K4 through render_train_bwd: {t_all:.3f} ms "
          f"(render_train_bwd_plain {t_all_p:.3f} ms; {len(chunks)} chunks of {chunk} objects)")

    pts, rays = B * R * S, B * R
    w_fwd = sum(getattr(wts, f).numel() for f in render._PTR_FIELDS if not f.startswith("wt_"))
    w_all = sum(getattr(wts, f).numel() for f in render._PTR_FIELDS)
    act_bytes = sum(t.numel() for t in args) * 4
    # the stash K3 writes and K4 reads: its used columns once
    stash_bytes = (pts * _stash_width(L, wts) + rays * (L["r_gv"] + W)) * 4
    fwd_flops = 2 * pts * decoder_macs(W, ns, nt)
    fwd_bytes = act_bytes + w_fwd * 4 + rays * 5 * 4
    k3_flops = fwd_flops + 2 * pts * (transposed_macs(W, ns, nt) - W * 63)
    k3_bytes = act_bytes + w_all * 4 + rays * 5 * 4 + stash_bytes + rays * (ns + nt) * W * 4
    k4_flops = sum(2 * p.A.shape[0] * p.A.shape[1] * p.G.shape[1]
                   + (p.A.shape[0] * p.G.shape[1] if p.b_out is not None else 0)
                   for sl in chunks for p in probs[sl])
    k4_bytes = stash_bytes + sum(t.numel() for t in gk) * 4
    records = [
        record("render_fwd", ["A1", "A5"], "supnerf_tpu/ops/pallas_render.py:127",
               "supnerf_tpu_torch/csrc/render_fwd.cu", t_fwd, t_fwd_p, err_fwd,
               bound(fwd_flops, fwd_bytes)),
        record("render_train_bwd", ["A6"], "supnerf_tpu/ops/pallas_render.py:991",
               "supnerf_tpu_torch/csrc/render_train_bwd.cu", t_k3, t_k3_p, err_k3,
               bound(k3_flops, k3_bytes)),
        record("wgrad", ["A6"], "supnerf_tpu/ops/pallas_render.py:991",
               "supnerf_tpu_torch/csrc/wgrad.cu", t_k4, t_k4_p, err_k4,
               bound(k4_flops, k4_bytes), library_ms=t_k4_lib)]
    if not (ok and ok_k3 and ok_w and ok_k4):
        raise RuntimeError("a training kernel disagrees with its plain version")
    return records


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
    bwd_k = render.render_bwd(wts, *args, False, *cot, hit)
    torch.cuda.synchronize()
    bwd_p = render.render_bwd_plain(wts, *args, False, *cot, hit)
    bwd_64 = render.render_bwd_plain(as_float64(wts), *(t.double() for t in args), False,
                                     *(t.double() for t in cot), hit)
    err_bwd, err_bwd32, ok_bwd = compare_at_kinks(("dxyz", "dviewdir", "dz", "dzs", "dzt"), bwd_k,
                                                  bwd_p, bwd_64, GRAD_RTOL)
    del bwd_64
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
    if not (ok_fwd and ok_bwd and exact):
        raise RuntimeError("an AABB-mode kernel disagrees with its plain version")
    return records


def _linear_param_names(wts):
    from supnerf_tpu_torch.ops import render

    return [f"{n}.{k}" for n in render.linear_names(wts.n_shape, wts.n_tex)
            for k in ("weight", "bias")]


def _stash_width(L, wts):
    """Columns of a stash row that K3 writes (ld_pt less its padding)."""
    from supnerf_tpu_torch.ops import render

    last = max(render._STASH_POINT_COLS, key=lambda n: L[n])
    return L[last] + 3          # g_rgb, the last block, is 3 wide


TTO_KERNELS = ("render_fwd", "render_bwd")
TRAIN_KERNELS = ("render_fwd", "render_train_bwd", "wgrad")
DEMO_KERNELS = ("render_fwd", "render_fwd_aabb", "render_bwd_aabb")
# the hand-written kernel behind each counter
KERNEL_OF = {"render_fwd": "K1", "render_fwd_aabb": "K1", "render_bwd": "K2",
             "render_bwd_aabb": "K2", "render_train_bwd": "K3", "wgrad": "K4"}


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


def tto_path(out_dir):
    """The port's CLI TTO at the published config on 2 synthetic objects,
    writing into a temporary directory. Returns the launch counts."""
    import numpy as np
    import torch

    from supnerf_tpu_torch.cli import optimize
    from supnerf_tpu_torch.ops import render

    render.reset_launch_counts()
    t0 = time.perf_counter()
    summary = optimize.main([
        "--config_file", os.path.join(HERE, "jsonfiles", "supnerf.nusc.vehicle.car.json"),
        "--dataset", "synthetic", "--num_objects", "2", "--batch_size", "2",
        "--device", "cuda", "--seed", "0", "--save_dir", out_dir])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = _path_counts("TTO", TTO_KERNELS)
    print(f"   TTO path: {seconds:.2f} s for 2 objects, {2 * 60 / seconds:.1f} objects/min "
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
    agg = summary["aggregate"]
    print(f"   final: psnr {agg['psnr'][-1]:.3f} dB, rot err {agg['rot_err_deg'][-1]:.3f} deg, "
          f"trans err {agg['trans_err'][-1]:.4f} m, depth err {agg['depth_err'][-1]:.4f} m "
          f"(iteration 0: psnr {agg['psnr'][0]:.3f}, rot {agg['rot_err_deg'][0]:.3f}, "
          f"trans {agg['trans_err'][0]:.4f})")
    return counts


def train_path(out_dir):
    """The port's CLI training at the published config: 16 synthetic objects,
    batch 8, 2 epochs (4 steps), then a run resumed from epoch_0 and the TTO
    loader on the checkpoint. Returns the launch counts of the 4 steps."""
    import math

    import numpy as np
    import torch

    from supnerf_tpu_torch.cli import train
    from supnerf_tpu_torch.cli.common import load_model_and_codes
    from supnerf_tpu_torch.config import load_hpams
    from supnerf_tpu_torch.ops import render

    config = os.path.join(HERE, "jsonfiles", "supnerf.nusc.vehicle.car.json")
    run_dir, resume_dir = os.path.join(out_dir, "run"), os.path.join(out_dir, "resumed")
    argv = ["--config_file", config, "--dataset", "synthetic",
            "--num_objects", str(TRAIN_OBJECTS), "--batch_size", str(TRAIN_BATCH),
            "--epochs", "2", "--device", "cuda", "--seed", "0", "--check_iter", "1"]
    render.reset_launch_counts()
    summary = train.main(argv + ["--save_dir", run_dir])
    torch.cuda.synchronize()
    counts = _path_counts("training", TRAIN_KERNELS)
    steps = summary["metrics"]
    if len(steps) != 2 * TRAIN_OBJECTS // TRAIN_BATCH:
        raise RuntimeError(f"{len(steps)} training steps instead of 4")
    if not all(math.isfinite(m[k]) for m in steps for k in ("loss_total", "loss_rgb",
                                                            "loss_occ", "psnr")):
        raise RuntimeError(f"a training loss is not finite: {steps}")
    for name in ("epoch_0.pth", "epoch_1.pth", "epoch_1_optim.pth", "models.pth"):
        if not os.path.exists(os.path.join(run_dir, name)):
            raise RuntimeError(f"{name} was not written")
    ph = summary["phase_seconds"]
    loop = sum(m["seconds"] for m in steps)
    print(f"   training path: {len(steps)} steps of {TRAIN_BATCH} objects in "
          f"{summary['seconds']:.2f} s end to end through the CLI (checkpoints included): "
          f"{len(steps) / summary['seconds']:.2f} steps/s, "
          f"{len(steps) * TRAIN_BATCH / summary['seconds']:.1f} objects/s; "
          f"the step loop alone {len(steps) / loop:.2f} steps/s")
    print("   phase split (s, 4 steps; forward includes render): " + ", ".join(
        f"{k} {v:.3f}" for k, v in ph.items()))
    print("   per step (s): " + ", ".join(f"{m['seconds']:.3f}" for m in steps))
    print("   last step's split (s; forward includes render): " + ", ".join(
        f"{k} {v:.4f}" for k, v in steps[-1]["phase_seconds"].items()))
    print("   losses: " + ", ".join(f"{m['loss_total']:.4f}" for m in steps))

    resumed = train.main(argv + ["--save_dir", resume_dir, "--resume_dir", run_dir,
                                 "--resume_from_epoch", "0"])["metrics"]
    want, got = steps[2]["loss_total"], resumed[0]["loss_total"]
    print(f"   resumed from epoch_0: step 3 loss {got:.7f} against {want:.7f} "
          f"(rel diff {abs(got - want) / abs(want):.2e}, tol {RESUME_RTOL:.0e})")
    if not abs(got - want) <= RESUME_RTOL * abs(want):
        raise RuntimeError("the resumed run does not repeat step 3's loss")

    hpams = dict(load_hpams(config), model_dir=run_dir)
    model, mean_shape, mean_texture = load_model_and_codes(hpams, "cuda", model_epoch=1)
    if not (np.isfinite(mean_shape).all() and np.isfinite(mean_texture).all()):
        raise RuntimeError("the checkpoint's mean codes are not finite")
    print(f"   load_model_and_codes strict-loaded epoch_1.pth "
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


def kernel_records(tto_records, train_records, aabb_records, counts_by_path):
    """One record per launch counter, launches from the path that runs it
    (K1's shared-z mode from the training path; launches_by_path has every
    path); K1's numbers are the training shape's, with the TTO shape's
    beside them."""
    by_name = {r["name"]: r for r in train_records + aabb_records}
    for r in tto_records:
        if r["name"] in by_name:
            by_name[r["name"]]["tto_shape"] = {k: r[k] for k in ("ms", "plain_ms", "bound_ms",
                                                                  "bound_by", "max_abs_err")}
        else:
            by_name[r["name"]] = r
    by_name["render_fwd"]["ports"] = ["A1", "A3", "A5"]
    by_name["render_bwd"]["ports"] = ["A2", "A4"]
    main_path = {"render_fwd": "train", "render_bwd": "tto", "render_train_bwd": "train",
                 "wgrad": "train", "render_fwd_aabb": "demo", "render_bwd_aabb": "demo"}
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
    train_records = check_train_kernels()
    aabb_records = check_aabb_kernels()
    check_kernel_branches()
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
    records = kernel_records(tto_records, train_records, aabb_records,
                             {"tto": tto_counts, "train": train_counts, "demo": demo_counts})
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
