#!/usr/bin/env python3
"""On-card smoke test of supnerf_tpu_torch, the PyTorch/CUDA port.

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and nvcc.
Phases, each timed; any failure exits non-zero before the result line:
  1. environment: card name and power limit (nvidia-smi), torch and CUDA;
  2. build: one nvcc call over supnerf_tpu_torch/csrc/*.cu;
  3. kernels: K1 (render_fwd) and K2 (render_bwd) at the main path's shapes
     (2 objects, W 256, 1024 rays, 64 samples) against their plain PyTorch
     versions on the same inputs, each error beside its tolerance, and
     kernel / plain times beside the card's bound; then the branches the
     main path does not take (white background, S < 64, odd R, W 64/128);
  4. main path: the port's CLI test-time optimization at the published
     config (full width, 100 iterations) on 2 synthetic objects, with the
     launch counts of both kernels, the final metrics and the result file.
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

def decoder_macs(W, n_shape, n_tex, d_xyz=63):
    """Multiply-adds per point of the decoder (csrc/render_fwd.cu's count)."""
    return (d_xyz * W + n_shape * W * W + W * W + W + W * W + n_tex * W * W
            + W * (W // 2) + (W // 2) * 3)


def transposed_macs(W, n_shape, n_tex, d_xyz=63):
    """Multiply-adds per point of K2's transposed chain (no sigma/rgb heads)."""
    return (W // 2) * W + n_tex * W * W + W * W + W * W + n_shape * W * W + W * d_xyz


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
    """K1 and K2 against their plain versions on the branches the main path
    does not take: white background, fewer than 64 samples per ray, odd ray
    counts, W 64 and 128. Same tolerances; not timed."""
    import torch
    import torch.nn.functional as F

    from supnerf_tpu_torch.models.layers import init_parameters
    from supnerf_tpu_torch.models.nerf_mlp import CodeNeRFDecoder
    from supnerf_tpu_torch.ops import render

    ok = True
    for W, S, R, white in ((64, 8, 19, True), (128, 33, 7, False), (256, 64, 5, True)):
        g = torch.Generator().manual_seed(W + S)
        dec = CodeNeRFDecoder(3, 1, W, W)
        init_parameters(dec, g)
        wts = render.pack_decoder_params(dec.cuda())
        vd = F.normalize(torch.randn((3, R, 3), generator=g), dim=-1)
        z = torch.sort(torch.rand((3, S), generator=g) * 4 + 2, dim=-1).values
        xyz = vd[:, :, None, :] * z[:, None, :, None] * 0.3
        codes = torch.randn((2, 3, W), generator=g) * 0.3
        cot = [torch.randn(s, generator=g).cuda() for s in ((3, R, 3), (3, R), (3, R))]
        xyz, vd, z, codes = (t.cuda().contiguous() for t in (xyz, vd, z, codes))
        zs, zt = (t.contiguous() for t in render.conditioned_latents(wts, codes[0], codes[1]))
        args = (xyz, vd, z, zs, zt)
        with torch.no_grad():
            fwd = zip(("rgb", "depth", "acc"), render.render_fwd(wts, *args, white),
                      render.render_fwd_plain(wts, *args, white))
        bwd = zip(("dxyz", "dviewdir", "dz", "dzs", "dzt"),
                  render.render_bwd(wts, *args, white, *cot),
                  render.render_bwd_plain(wts, *args, white, *cot))
        errs = []
        for name, a, b in list(fwd) + list(bwd):
            err = float((a - b).abs().max())
            tol = VALUE_ATOL[name] if name in VALUE_ATOL else GRAD_RTOL * float(b.abs().max())
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
    ok = True
    records = []

    def compare(names, got, ref, tol_of):
        nonlocal ok
        worst = 0.0
        for name, a, b in zip(names, got, ref):
            err = float((a - b).abs().max())
            scale = float(b.abs().max())
            tol = tol_of(name, scale)
            status = "ok" if err <= tol and torch.isfinite(a).all() else "FAIL"
            ok &= status == "ok"
            worst = max(worst, err)
            print(f"   {name:8s} max_abs_err {err:.3e}  tol {tol:.3e}  (max |plain| {scale:.3e})  {status}")
        return worst

    with torch.no_grad():
        fwd_k = render.render_fwd(wts, *args)
        torch.cuda.synchronize()
        fwd_p = render.render_fwd_plain(wts, *args)
    err_fwd = compare(("rgb", "depth", "acc"), fwd_k, fwd_p, lambda n, s: VALUE_ATOL[n])

    bwd_k = render.render_bwd(wts, *args, False, *cot)
    torch.cuda.synchronize()
    bwd_p = render.render_bwd_plain(wts, *args, False, *cot)
    err_bwd = compare(("dxyz", "dviewdir", "dz", "dzs", "dzt"), bwd_k, bwd_p,
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

    def bound(flops, nbytes):
        t_ops, t_mem = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
        return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")

    for name, tpu, src, t_k, t_p, err, (b_ms, b_by), flops in (
            ("render_fwd", "supnerf_tpu/ops/pallas_render.py:127", "supnerf_tpu_torch/csrc/render_fwd.cu",
             t_fwd, t_fwd_p, err_fwd, bound(fwd_flops, fwd_bytes), fwd_flops),
            ("render_bwd", "supnerf_tpu/ops/pallas_render.py:478", "supnerf_tpu_torch/csrc/render_bwd.cu",
             t_bwd, t_bwd_p, err_bwd, bound(bwd_flops, bwd_bytes), bwd_flops)):
        print(f"   {name}: {t_k:.3f} ms (plain {t_p:.3f} ms, bound {b_ms:.3f} ms by {b_by}; "
              f"{flops / t_k / 1e9:.1f} TFLOP/s)")
        records.append({"name": name, "route": "cuda", "source": src, "replaces": tpu,
                        "launches": 0, "max_abs_err": err, "ms": t_k, "plain_ms": t_p,
                        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
    if not ok:
        raise RuntimeError("a kernel disagrees with its plain version")
    return records


def main_path(records):
    """The port's CLI TTO at the published config on 2 synthetic objects,
    writing into a temporary directory that is removed afterwards."""
    out_dir = tempfile.mkdtemp(prefix="supnerf_smoke_")
    try:
        return _main_path(records, out_dir)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def _main_path(records, out_dir):
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
    counts = dict(render.LAUNCHES)
    print(f"   main path: {seconds:.2f} s for 2 objects, {2 * 60 / seconds:.1f} objects/min "
          "end to end through the CLI; phases: " + ", ".join(
        f"{k} {v:.2f} s" for k, v in summary["phase_seconds"].items()))
    print(f"   launches: {counts}")
    for r in records:
        r["launches"] = counts[r["name"]]
    if min(counts.values()) == 0:
        raise RuntimeError(f"a kernel of the main path never launched: {counts}")
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
    records = check_kernels()
    check_kernel_branches()
    done(t0, "kernels")
    t0 = phase("main path: TTO through the CLI")
    records = main_path(records)
    done(t0, "main path")
    print(f"total {time.perf_counter() - t_all:.1f} s")
    print("kernels: " + " ".join(f"{r['name']}({t})" for r, t in zip(records, ("A1", "A2"))))
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
