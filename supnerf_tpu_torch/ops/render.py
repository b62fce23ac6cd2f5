"""Fused conditioned-field + compositing render on two hand-written CUDA
kernels, their plain PyTorch versions, and the autograd.Function that joins
them; the port of supnerf_tpu/ops/pallas_render.py (A1, A2) and of the parts
of supnerf_tpu/ops/pallas_field.py it uses (pack_decoder_params,
conditioned_latents, flatten_weights).

  render_fwd  (K1, csrc/render_fwd.cu): per ray, the decoder on every sample
              and the compositing -> rgb (B,R,3), depth (B,R), acc (B,R).
  render_bwd  (K2, csrc/render_bwd.cu): recompute + manual compositing VJP +
              transposed decoder chain -> dxyz, dviewdir, dz, dz_shape, dz_tex.

Shapes: objects B along axis 0, R rays, S <= 64 samples per ray shared by all
rays of an object (xyz (B,R,S,3), per-ray viewdir (B,R,3), z (B,S)), latent
projections zs (B,n_shape,W), zt (B,n_tex,W). Everything is float32.

Each wrapper takes its plain version for tensors on the CPU, and only then.
For CUDA tensors it launches its kernel or raises; there is no fallback. The
decoder is frozen: the weights are constants of the autograd.Function and get
no gradient (test-time optimization, reference optimizer_nuscenes.py:1762).

The kernels are built at first use by one nvcc call over csrc/*.cu into
supnerf_tpu_torch/_build/ (git-ignored), under a name keyed by a hash of the
sources and flags, and bound through ctypes; importing this module builds
nothing.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch
import torch.nn.functional as F

from supnerf_tpu_torch.models.nerf_mlp import positional_encoding
from supnerf_tpu_torch.ops.volume_render import volume_render

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
MAX_SAMPLES = 64          # kRows in csrc/render_common.cuh

# Launches of each kernel since the last reset_launch_counts(); a wrapper
# adds one where it launches its kernel and nowhere else.
LAUNCHES = {"render_fwd": 0, "render_bwd": 0}


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# --------------------------------------------------------------------------
# decoder weights
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DecoderWeights:
    """The frozen decoder as kernel operands: w_* in the (in, out) layout the
    forward chain reads, wt_* in torch's (out, in) layout for the backward's
    transposed chain, and the latent projections (applied outside the
    kernels, once per object)."""

    w_xyz: torch.Tensor
    b_xyz: torch.Tensor
    w_sh: torch.Tensor
    b_sh: torch.Tensor
    w_es: torch.Tensor
    b_es: torch.Tensor
    w_sg: torch.Tensor
    b_sg: torch.Tensor
    w_vd_a: torch.Tensor
    w_vd_b: torch.Tensor
    b_vd: torch.Tensor
    w_tx: torch.Tensor
    b_tx: torch.Tensor
    w_r1: torch.Tensor
    b_r1: torch.Tensor
    w_r2: torch.Tensor
    b_r2: torch.Tensor
    wt_xyz: torch.Tensor
    wt_sh: torch.Tensor
    wt_es: torch.Tensor
    wt_vd_a: torch.Tensor
    wt_tx: torch.Tensor
    wt_r1: torch.Tensor
    w_shape_latent: torch.Tensor   # (n_shape, latent, W)
    b_shape_latent: torch.Tensor   # (n_shape, W)
    w_tex_latent: torch.Tensor     # (n_tex, latent, W)
    b_tex_latent: torch.Tensor     # (n_tex, W)
    num_xyz_freq: int
    num_dir_freq: int

    @property
    def W(self):
        return self.w_es.shape[0]

    @property
    def n_shape(self):
        return self.w_sh.shape[0]

    @property
    def n_tex(self):
        return self.w_tx.shape[0]


# pointer fields shared with csrc/render_common.cuh:DecoderWeights, in order
_PTR_FIELDS = ("w_xyz", "b_xyz", "w_sh", "b_sh", "w_es", "b_es", "w_sg", "b_sg",
               "w_vd_a", "w_vd_b", "b_vd", "w_tx", "b_tx", "w_r1", "b_r1", "w_r2",
               "b_r2", "wt_xyz", "wt_sh", "wt_es", "wt_vd_a", "wt_tx", "wt_r1")


class _DecoderPtrs(ctypes.Structure):
    _fields_ = [(name, ctypes.c_void_p) for name in _PTR_FIELDS]


def pack_decoder_params(decoder) -> DecoderWeights:
    """Frozen, contiguous float32 copies of a CodeNeRF-style decoder's weights
    (any module holding the reference layer names: CodeNeRFDecoder, SUPNeRF),
    on the decoder's device."""
    n_sh, n_tx = decoder.shape_blocks, decoder.texture_blocks
    W = decoder.encoding_shape.weight.shape[0]

    def lin(name):
        layer = decoder.get_submodule(name)
        return layer.weight.detach().float(), layer.bias.detach().float()

    def c(t):
        return t.contiguous()

    w_xyz, b_xyz = lin("encoding_xyz.0")
    sh = [lin(f"shape_layer_{j}.0") for j in range(1, n_sh + 1)]
    sl = [lin(f"shape_latent_layer_{j}.0") for j in range(1, n_sh + 1)]
    tx = [lin(f"texture_layer_{j}.0") for j in range(1, n_tx + 1)]
    tl = [lin(f"texture_latent_layer_{j}.0") for j in range(1, n_tx + 1)]
    w_es, b_es = lin("encoding_shape")
    w_sg, b_sg = lin("sigma.0")
    w_vd, b_vd = lin("encoding_viewdir.0")
    w_r1, b_r1 = lin("rgb.0")
    w_r2, b_r2 = lin("rgb.2")
    return DecoderWeights(
        w_xyz=c(w_xyz.t()), b_xyz=c(b_xyz),
        w_sh=c(torch.stack([w.t() for w, _ in sh])), b_sh=c(torch.stack([b for _, b in sh])),
        w_es=c(w_es.t()), b_es=c(b_es),
        w_sg=c(w_sg.reshape(-1)), b_sg=c(b_sg),
        w_vd_a=c(w_vd[:, :W].t()), w_vd_b=c(w_vd[:, W:].t()), b_vd=c(b_vd),
        w_tx=c(torch.stack([w.t() for w, _ in tx])), b_tx=c(torch.stack([b for _, b in tx])),
        w_r1=c(w_r1.t()), b_r1=c(b_r1), w_r2=c(w_r2.t()), b_r2=c(b_r2),
        wt_xyz=c(w_xyz), wt_sh=c(torch.stack([w for w, _ in sh])), wt_es=c(w_es),
        wt_vd_a=c(w_vd[:, :W]), wt_tx=c(torch.stack([w for w, _ in tx])), wt_r1=c(w_r1),
        w_shape_latent=c(torch.stack([w.t() for w, _ in sl])),
        b_shape_latent=c(torch.stack([b for _, b in sl])),
        w_tex_latent=c(torch.stack([w.t() for w, _ in tl])),
        b_tex_latent=c(torch.stack([b for _, b in tl])),
        num_xyz_freq=decoder.num_xyz_freq, num_dir_freq=decoder.num_dir_freq,
    )


def conditioned_latents(wts: DecoderWeights, shapecode, texturecode):
    """Per-object latent projections z_j = relu(code @ Wz_j + bz_j):
    codes (B, latent) -> (zs (B, n_shape, W), zt (B, n_tex, W))."""
    zs = F.relu(torch.einsum("bl,jlw->bjw", shapecode, wts.w_shape_latent) + wts.b_shape_latent)
    zt = F.relu(torch.einsum("bl,jlw->bjw", texturecode, wts.w_tex_latent) + wts.b_tex_latent)
    return zs, zt


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------

def decoder_plain(wts: DecoderWeights, xyz, viewdir, zs, zt):
    """The decoder as matmuls. xyz (B,R,S,3), viewdir (B,R,3) per ray ->
    (sigma (B,R,S), rgb (B,R,S,3))."""
    y = F.relu(positional_encoding(xyz, wts.num_xyz_freq) @ wts.w_xyz + wts.b_xyz)
    for j in range(wts.n_shape):
        y = F.relu((y + zs[:, None, None, j]) @ wts.w_sh[j] + wts.b_sh[j])
    e = y @ wts.w_es + wts.b_es
    sigma = F.softplus(e @ wts.w_sg + wts.b_sg)
    hdir = positional_encoding(viewdir, wts.num_dir_freq) @ wts.w_vd_b      # (B,R,W)
    h = F.relu(e @ wts.w_vd_a + hdir[:, :, None] + wts.b_vd)
    for j in range(wts.n_tex):
        h = F.relu((h + zt[:, None, None, j]) @ wts.w_tx[j] + wts.b_tx[j])
    rgb = F.relu(h @ wts.w_r1 + wts.b_r1) @ wts.w_r2 + wts.b_r2
    return sigma, rgb


def render_fwd_plain(wts: DecoderWeights, xyz, viewdir, z, zs, zt, white_bkgd=False):
    """K1's plain version: decoder_plain + ops.volume_render (differentiable)."""
    sigma, rgb = decoder_plain(wts, xyz, viewdir, zs, zt)
    return volume_render(sigma, rgb, z[:, None, :], white_bkgd=white_bkgd)


def render_bwd_plain(wts: DecoderWeights, xyz, viewdir, z, zs, zt, white_bkgd,
                     g_rgb, g_depth, g_acc):
    """K2's plain version: autograd through render_fwd_plain.
    Returns (dxyz, dviewdir, dz, dzs, dzt)."""
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_(True) for t in (xyz, viewdir, z, zs, zt)]
        outs = render_fwd_plain(wts, *inputs, white_bkgd=white_bkgd)
        return torch.autograd.grad(outs, inputs, (g_rgb, g_depth, g_acc),
                                   allow_unused=True, materialize_grads=True)


# --------------------------------------------------------------------------
# kernel build and binding
# --------------------------------------------------------------------------

def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def kernel_sources():
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in kernel_sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libsupnerf_render_{h.hexdigest()[:16]}.so"


def build_kernels() -> dict:
    """Compile csrc/*.cu with one nvcc call unless this source hash is built.
    Returns {'path', 'seconds', 'log'} ('seconds' 0.0 when already built)."""
    out = library_path()
    if out.exists():
        return {"path": out, "seconds": 0.0, "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp)] + [str(s) for s in sorted(CSRC_DIR.glob("*.cu"))]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return {"path": out, "seconds": seconds, "log": proc.stdout + proc.stderr}


@functools.cache
def _library():
    lib = ctypes.CDLL(str(build_kernels()["path"]))
    p, i = ctypes.c_void_p, ctypes.c_int
    head = [p] * 5 + [ctypes.POINTER(_DecoderPtrs)] + [i] * 9
    lib.supnerf_render_fwd.argtypes = head + [p] * 3 + [p]
    lib.supnerf_render_fwd.restype = i
    lib.supnerf_render_bwd.argtypes = head + [p] * 3 + [p] * 5 + [p]
    lib.supnerf_render_bwd.restype = i
    return lib


def _ptrs(wts: DecoderWeights) -> _DecoderPtrs:
    return _DecoderPtrs(*[getattr(wts, name).data_ptr() for name in _PTR_FIELDS])


def _check_inputs(wts: DecoderWeights, xyz, viewdir, z, zs, zt, *extra):
    B, R, S = xyz.shape[:3]
    W = wts.W
    expect = {"xyz": (xyz, (B, R, S, 3)), "viewdir": (viewdir, (B, R, 3)), "z": (z, (B, S)),
              "zs": (zs, (B, wts.n_shape, W)), "zt": (zt, (B, wts.n_tex, W))}
    for i, t in enumerate(extra):
        expect[f"grad{i}"] = (t, t.shape)
    for name, (t, shape) in expect.items():
        if t.device != xyz.device or t.dtype != torch.float32:
            raise ValueError(f"{name}: expected float32 on {xyz.device}, got {t.dtype} on {t.device}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name in _PTR_FIELDS:
        t = getattr(wts, name)
        if t.device != xyz.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"decoder weight {name}: expected contiguous float32 on {xyz.device}")
    if not 1 <= S <= MAX_SAMPLES:
        raise ValueError(f"the render kernels take 1..{MAX_SAMPLES} samples per ray, got {S}")
    if W not in (64, 128, 256):
        raise ValueError(f"the render kernels take W in {{64, 128, 256}}, got {W}")
    if wts.num_xyz_freq > 10 or wts.num_dir_freq > 10:
        raise ValueError("the render kernels take at most 10 encoding frequencies")


def _dims(wts, xyz, white_bkgd):
    B, R, S = xyz.shape[:3]
    return [B, R, S, wts.W, wts.n_shape, wts.n_tex, wts.num_xyz_freq, wts.num_dir_freq,
            int(bool(white_bkgd))]


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def render_fwd(wts: DecoderWeights, xyz, viewdir, z, zs, zt, white_bkgd=False):
    """K1 wrapper. Returns (rgb (B,R,3), depth (B,R), acc_trans (B,R))."""
    if xyz.device.type == "cpu":
        return render_fwd_plain(wts, xyz, viewdir, z, zs, zt, white_bkgd)
    _check_inputs(wts, xyz, viewdir, z, zs, zt)
    B, R = xyz.shape[:2]
    rgb = torch.empty((B, R, 3), device=xyz.device)
    depth = torch.empty((B, R), device=xyz.device)
    acc = torch.empty((B, R), device=xyz.device)
    ptrs = _ptrs(wts)
    with torch.cuda.device(xyz.device):     # the runtime launches on its current device
        err = _library().supnerf_render_fwd(
            xyz.data_ptr(), viewdir.data_ptr(), z.data_ptr(), zs.data_ptr(), zt.data_ptr(),
            ctypes.byref(ptrs), *_dims(wts, xyz, white_bkgd),
            rgb.data_ptr(), depth.data_ptr(), acc.data_ptr(),
            torch.cuda.current_stream(xyz.device).cuda_stream)
    _raise_on(err, "render_fwd")
    LAUNCHES["render_fwd"] += 1
    return rgb, depth, acc


def render_bwd(wts: DecoderWeights, xyz, viewdir, z, zs, zt, white_bkgd,
               g_rgb, g_depth, g_acc):
    """K2 wrapper. Returns (dxyz (B,R,S,3), dviewdir (B,R,3), dz (B,S),
    dzs (B,n_shape,W), dzt (B,n_tex,W)). The kernel writes per-ray partial
    sums of dz, dzs and dzt; summing them over rays here is the second,
    deterministic pass of the cross-block reduction."""
    if xyz.device.type == "cpu":
        return render_bwd_plain(wts, xyz, viewdir, z, zs, zt, white_bkgd, g_rgb, g_depth, g_acc)
    _check_inputs(wts, xyz, viewdir, z, zs, zt, g_rgb, g_depth, g_acc)
    B, R, S = xyz.shape[:3]
    dev = xyz.device
    if g_rgb.shape != (B, R, 3) or g_depth.shape != (B, R) or g_acc.shape != (B, R):
        raise ValueError("cotangent shapes do not match the render outputs")
    dxyz = torch.empty_like(xyz)
    dvd = torch.empty_like(viewdir)
    dzs_part = torch.empty((B, R, wts.n_shape, wts.W), device=dev)
    dzt_part = torch.empty((B, R, wts.n_tex, wts.W), device=dev)
    dz_part = torch.empty((B, R, S), device=dev)
    ptrs = _ptrs(wts)
    with torch.cuda.device(dev):
        err = _library().supnerf_render_bwd(
            xyz.data_ptr(), viewdir.data_ptr(), z.data_ptr(), zs.data_ptr(), zt.data_ptr(),
            ctypes.byref(ptrs), *_dims(wts, xyz, white_bkgd),
            g_rgb.data_ptr(), g_depth.data_ptr(), g_acc.data_ptr(),
            dxyz.data_ptr(), dvd.data_ptr(), dzs_part.data_ptr(), dzt_part.data_ptr(),
            dz_part.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "render_bwd")
    LAUNCHES["render_bwd"] += 1
    return dxyz, dvd, dz_part.sum(1), dzs_part.sum(1), dzt_part.sum(1)


class FieldComposite(torch.autograd.Function):
    """(xyz, viewdir, z, zs, zt) -> (rgb, depth, acc) with K1 as the forward
    and K2 as the backward; the decoder weights are constants."""

    @staticmethod
    def forward(ctx, xyz, viewdir, z, zs, zt, wts, white_bkgd):
        ctx.save_for_backward(xyz, viewdir, z, zs, zt)
        ctx.wts, ctx.white_bkgd = wts, white_bkgd
        return render_fwd(wts, xyz, viewdir, z, zs, zt, white_bkgd)

    @staticmethod
    def backward(ctx, g_rgb, g_depth, g_acc):
        xyz, viewdir, z, zs, zt = ctx.saved_tensors
        grads = render_bwd(ctx.wts, xyz, viewdir, z, zs, zt, ctx.white_bkgd,
                           g_rgb.contiguous(), g_depth.contiguous(), g_acc.contiguous())
        return (*grads, None, None)


def field_composite(wts: DecoderWeights, xyz, viewdir, z, shapecode, texturecode,
                    white_bkgd: bool = False, impl: str = "auto"):
    """Differentiable fused render of B objects: xyz (B,R,S,3), viewdir
    (B,R,3), z (B,S), codes (B, latent) -> (rgb, depth, acc_trans).
    Gradients reach the points, view directions, z and, through the latent
    projections, the codes.

    impl: "auto" runs FieldComposite (the kernels for CUDA tensors, the plain
    versions inside the same wrappers for CPU tensors); "cuda" is "auto"
    that refuses CPU tensors; "plain" differentiates render_fwd_plain with
    autograd on any device."""
    zs, zt = conditioned_latents(wts, shapecode, texturecode)
    if impl == "plain":
        return render_fwd_plain(wts, xyz, viewdir, z, zs, zt, white_bkgd)
    if impl == "cuda" and xyz.device.type != "cuda":
        raise ValueError("field_impl='cuda' needs CUDA tensors")
    if impl not in ("auto", "cuda"):
        raise ValueError(f"unknown field_impl {impl!r}")
    return FieldComposite.apply(xyz.contiguous(), viewdir.contiguous(), z.contiguous(),
                                zs.contiguous(), zt.contiguous(), wts, white_bkgd)
