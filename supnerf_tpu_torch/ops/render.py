"""Fused conditioned-field + compositing render on hand-written CUDA
kernels, their plain PyTorch versions, and the autograd.Functions that join
them; the port of supnerf_tpu/ops/pallas_render.py (A1-A6) and of the
parts of supnerf_tpu/ops/pallas_field.py it uses (pack_decoder_params,
conditioned_latents, flatten_weights).

  render_fwd        (K1, csrc/render_fwd.cu): per ray, the decoder on every
                    sample and the compositing -> rgb (B,R,3), depth (B,R),
                    acc (B,R). Serves test-time optimization (A1), the
                    training forward with per-object latents (A5) and, with
                    per-ray z and a hit mask, the AABB render (A3).
  render_bwd        (K2, csrc/render_bwd.cu): frozen-decoder backward,
                    recompute + manual compositing VJP + transposed decoder
                    chain -> dxyz, dviewdir, dz, dz_shape, dz_tex (A2; A4
                    with per-ray z and a hit mask).
  render_train_bwd  (K3, csrc/render_train_bwd.cu + K4, csrc/wgrad.cu): the
                    training backward (A6): dz_shape, dz_tex and every
                    decoder weight and bias gradient, and in the
                    data_grads mode also dxyz, dviewdir and dz. K3 runs
                    K2's per-ray work and stashes each layer's input and
                    pre-activation-gradient rows; K4 (wgrad) reduces them
                    into the weight gradients.

The per-point field kernels K5, K6 and K7 (A7, A8, A9, A10) are in
ops/field.py; they share this module's weights, build, library, stash
layout, K4 and launch counts.

Shapes: objects B along axis 0, R rays, S <= 64 samples per ray shared by all
rays of an object (xyz (B,R,S,3), per-ray viewdir (B,R,3), z (B,S)), latent
projections zs (B,n_shape,W), zt (B,n_tex,W). Everything is float32. The
AABB mode (reference render_rays_v3) takes per-ray z (B,R,S) and hit (B,R):
the density of a ray that misses its box is zero, and dz is per ray.

Each wrapper takes its plain version for tensors on the CPU, and only then.
For CUDA tensors it launches its kernel or raises; there is no fallback.
FieldComposite freezes the decoder (test-time optimization, reference
optimizer_nuscenes.py:1762); FieldCompositeTrain trains it.

The kernels are built at first use by nvcc over csrc/*.cu (one process per
source, started together, then one link) into supnerf_tpu_torch/_build/
(git-ignored), under a name keyed by a hash of the sources and flags, and
bound through ctypes; importing this module builds nothing.
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

from supnerf_tpu_torch.models.nerf_mlp import CodeNeRFDecoder, positional_encoding
from supnerf_tpu_torch.ops.volume_render import volume_render

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
MAX_SAMPLES = 64          # kRows in csrc/render_common.cuh

# Launches of each kernel since the last reset_launch_counts(); a wrapper
# adds one where it launches its kernel and nowhere else.
# K1 and K2 count their AABB-mode launches (render_*_aabb) apart, K3 its
# data-mode launches (render_train_bwd_data). K5, K6 and K7 (ops/field.py)
# count here too.
LAUNCHES = {"render_fwd": 0, "render_bwd": 0, "render_fwd_aabb": 0, "render_bwd_aabb": 0,
            "render_train_bwd": 0, "render_train_bwd_data": 0, "wgrad": 0, "field_fwd": 0,
            "field_bwd": 0, "field_train_bwd": 0}


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# --------------------------------------------------------------------------
# decoder weights
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DecoderWeights:
    """The decoder as kernel operands: w_* in the (in, out) layout the
    forward chain reads, wt_* in torch's (out, in) layout for the backward's
    transposed chain, and the latent projections (applied outside the
    kernels, once per object; None where only the kernels need the pack)."""

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
    wt_vd_b: torch.Tensor
    w_shape_latent: torch.Tensor | None   # (n_shape, latent, W)
    b_shape_latent: torch.Tensor | None   # (n_shape, W)
    w_tex_latent: torch.Tensor | None     # (n_tex, latent, W)
    b_tex_latent: torch.Tensor | None     # (n_tex, W)
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
               "b_r2", "wt_xyz", "wt_sh", "wt_es", "wt_vd_a", "wt_tx", "wt_r1", "wt_vd_b")


class _DecoderPtrs(ctypes.Structure):
    _fields_ = [(name, ctypes.c_void_p) for name in _PTR_FIELDS]


def decoder_kernel_compatible(model) -> bool:
    """Whether the kernels run this model's decoder (the port of
    supnerf_tpu/ops/pallas_field.py decoder_kernel_compatible), by its
    structure alone: a CodeNeRF-style decoder (CodeNeRFDecoder: SUPNeRF,
    AutoRFMix, CodeNeRF) with at least one shape and one texture block. The
    original AutoRF's feature-averaging decoder has no kernel here, as it
    has no Pallas kernel in the JAX package; its callers run it as the
    plain decoder (decoder_composite)."""
    return (isinstance(model, CodeNeRFDecoder) and model.shape_blocks >= 1
            and model.texture_blocks >= 1)


def check_kernel_decoder(decoder):
    """Raise ValueError unless decoder_kernel_compatible(decoder)."""
    if not decoder_kernel_compatible(decoder):
        raise ValueError(f"{type(decoder).__name__} has no render kernel: the kernels run a "
                         "CodeNeRF-style decoder with at least one shape and one texture block "
                         "(SUPNeRF, AutoRFMix, CodeNeRF); the original AutoRF decoder runs as "
                         "the plain decoder (ops.render.decoder_composite)")


def linear_names(n_shape: int, n_tex: int) -> list:
    """The decoder layers the render kernels run, in kernel order (the
    reference's module names; the latent projections are not among them)."""
    return (["encoding_xyz.0"] + [f"shape_layer_{j}.0" for j in range(1, n_shape + 1)]
            + ["encoding_shape", "sigma.0", "encoding_viewdir.0"]
            + [f"texture_layer_{j}.0" for j in range(1, n_tex + 1)] + ["rgb.0", "rgb.2"])


def decoder_linear_params(decoder) -> list:
    """The live weight and bias of every layer of linear_names, flattened
    [w0, b0, w1, b1, ...] in torch.nn.Linear's (out, in) layout."""
    out = []
    for name in linear_names(decoder.shape_blocks, decoder.texture_blocks):
        layer = decoder.get_submodule(name)
        out += [layer.weight, layer.bias]
    return out


def pack_linear_params(params, n_shape: int, n_tex: int, num_xyz_freq: int,
                       num_dir_freq: int, latents=None) -> DecoderWeights:
    """Kernel operands from the flat Linear-layout list of
    decoder_linear_params: the (in, out) copies the forward chain reads,
    w_vd split into its trunk and direction rows, w_sg flattened, the block
    layers stacked, and the (out, in) wt_* copies of the transposed chain.
    Differentiable in `params` (the plain training backward relies on it).
    latents: optional ((w, b) of each shape latent layer, (w, b) of each
    texture latent layer); without it the latent fields are None."""
    lin = [(params[2 * i], params[2 * i + 1]) for i in range(len(params) // 2)]
    (w_xyz, b_xyz), sh = lin[0], lin[1:1 + n_shape]
    (w_es, b_es), (w_sg, b_sg), (w_vd, b_vd) = lin[1 + n_shape:4 + n_shape]
    tx = lin[4 + n_shape:4 + n_shape + n_tex]
    (w_r1, b_r1), (w_r2, b_r2) = lin[4 + n_shape + n_tex:]
    W = w_es.shape[0]

    def c(t):
        return t.contiguous()

    def stack(pairs, i, transpose=False):
        return c(torch.stack([p[i].t() if transpose else p[i] for p in pairs]))

    lat = {k: None for k in ("w_shape_latent", "b_shape_latent", "w_tex_latent", "b_tex_latent")}
    if latents is not None:
        sl, tl = latents
        lat = {"w_shape_latent": stack(sl, 0, True), "b_shape_latent": stack(sl, 1),
               "w_tex_latent": stack(tl, 0, True), "b_tex_latent": stack(tl, 1)}
    return DecoderWeights(
        w_xyz=c(w_xyz.t()), b_xyz=c(b_xyz), w_sh=stack(sh, 0, True), b_sh=stack(sh, 1),
        w_es=c(w_es.t()), b_es=c(b_es), w_sg=c(w_sg.reshape(-1)), b_sg=c(b_sg),
        w_vd_a=c(w_vd[:, :W].t()), w_vd_b=c(w_vd[:, W:].t()), b_vd=c(b_vd),
        w_tx=stack(tx, 0, True), b_tx=stack(tx, 1),
        w_r1=c(w_r1.t()), b_r1=c(b_r1), w_r2=c(w_r2.t()), b_r2=c(b_r2),
        wt_xyz=c(w_xyz), wt_sh=stack(sh, 0), wt_es=c(w_es), wt_vd_a=c(w_vd[:, :W]),
        wt_tx=stack(tx, 0), wt_r1=c(w_r1), wt_vd_b=c(w_vd[:, W:]), **lat,
        num_xyz_freq=num_xyz_freq, num_dir_freq=num_dir_freq,
    )


def pack_decoder_params(decoder) -> DecoderWeights:
    """Frozen (detached), contiguous float32 kernel operands of a
    CodeNeRF-style decoder (any module holding the reference layer names:
    CodeNeRFDecoder, SUPNeRF), latent projections included, on the
    decoder's device. Raises ValueError for a decoder that is not
    kernel-compatible (decoder_kernel_compatible)."""
    check_kernel_decoder(decoder)
    n_sh, n_tx = decoder.shape_blocks, decoder.texture_blocks

    def pair(name):
        layer = decoder.get_submodule(name)
        return layer.weight.detach(), layer.bias.detach()

    latents = ([pair(f"shape_latent_layer_{j}.0") for j in range(1, n_sh + 1)],
               [pair(f"texture_latent_layer_{j}.0") for j in range(1, n_tx + 1)])
    return pack_linear_params([t.detach() for t in decoder_linear_params(decoder)], n_sh, n_tx,
                              decoder.num_xyz_freq, decoder.num_dir_freq, latents)


def conditioned_latents(wts: DecoderWeights, shapecode, texturecode):
    """Per-object latent projections z_j = relu(code @ Wz_j + bz_j):
    codes (B, latent) -> (zs (B, n_shape, W), zt (B, n_tex, W))."""
    zs = F.relu(torch.einsum("bl,jlw->bjw", shapecode, wts.w_shape_latent) + wts.b_shape_latent)
    zt = F.relu(torch.einsum("bl,jlw->bjw", texturecode, wts.w_tex_latent) + wts.b_tex_latent)
    return zs, zt


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------

def decoder_chain(wts: DecoderWeights, xyz, hdir, zs, zt):
    """The decoder as matmuls on points xyz (B,...,3), with the viewdir
    layer's direction term hdir = encoding(viewdir) @ w_vd_b broadcastable to
    (B,...,W) and the latents zs, zt (B,n,W) broadcast over the middle axes
    -> (sigma (B,...), rgb (B,...,3))."""
    mid = (slice(None),) + (None,) * (xyz.dim() - 2)
    y = F.relu(positional_encoding(xyz, wts.num_xyz_freq) @ wts.w_xyz + wts.b_xyz)
    for j in range(wts.n_shape):
        y = F.relu((y + zs[mid + (j,)]) @ wts.w_sh[j] + wts.b_sh[j])
    e = y @ wts.w_es + wts.b_es
    sigma = F.softplus(e @ wts.w_sg + wts.b_sg)
    h = F.relu(e @ wts.w_vd_a + hdir + wts.b_vd)
    for j in range(wts.n_tex):
        h = F.relu((h + zt[mid + (j,)]) @ wts.w_tx[j] + wts.b_tx[j])
    rgb = F.relu(h @ wts.w_r1 + wts.b_r1) @ wts.w_r2 + wts.b_r2
    return sigma, rgb


def decoder_plain(wts: DecoderWeights, xyz, viewdir, zs, zt):
    """The decoder as matmuls. xyz (B,R,S,3), viewdir (B,R,3) per ray ->
    (sigma (B,R,S), rgb (B,R,S,3))."""
    hdir = positional_encoding(viewdir, wts.num_dir_freq) @ wts.w_vd_b      # (B,R,W)
    return decoder_chain(wts, xyz, hdir[:, :, None], zs, zt)


def render_fwd_plain(wts: DecoderWeights, xyz, viewdir, z, zs, zt, white_bkgd=False,
                     hit=None):
    """K1's plain version: decoder_plain + ops.volume_render (differentiable).
    With hit (B,R) (the AABB mode) z is per ray (B,R,S) and the density of
    missed rays is zero, the unfused where(hit, sigma, 0) of render_rays_aabb."""
    sigma, rgb = decoder_plain(wts, xyz, viewdir, zs, zt)
    if hit is None:
        z = z[:, None, :]
    else:
        sigma = torch.where(hit[..., None] != 0, sigma, torch.zeros_like(sigma))
    return volume_render(sigma, rgb, z, white_bkgd=white_bkgd)


def render_bwd_plain(wts: DecoderWeights, xyz, viewdir, z, zs, zt, white_bkgd,
                     g_rgb, g_depth, g_acc, hit=None):
    """K2's plain version: autograd through render_fwd_plain.
    Returns (dxyz, dviewdir, dz, dzs, dzt); dz is per ray with hit."""
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_(True) for t in (xyz, viewdir, z, zs, zt)]
        outs = render_fwd_plain(wts, *inputs, white_bkgd=white_bkgd, hit=hit)
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
    """Compile csrc/*.cu unless this source hash is built: one nvcc process
    per source, all started together, then one link into a shared library.
    Returns {'path', 'seconds', 'log'} ('seconds' 0.0 when already built)."""
    out = library_path()
    if out.exists():
        return {"path": out, "seconds": 0.0, "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    t0 = time.perf_counter()
    jobs = []
    for src in sorted(CSRC_DIR.glob("*.cu")):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        jobs.append((obj, subprocess.Popen([_nvcc(), *compile_flags, "-c", "-o", str(obj), str(src)],
                                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                           text=True)))
    logs, failed = [], []
    for obj, proc in jobs:
        logs.append(proc.communicate()[0])
        if proc.returncode != 0:
            failed.append(obj.name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if not failed:
        link = subprocess.run([_nvcc(), "-shared", "-Xcompiler", "-fPIC", "-o", str(tmp)]
                              + [str(o) for o, _ in jobs], capture_output=True, text=True)
        logs.append(link.stdout + link.stderr)
        if link.returncode != 0:
            failed.append("link")
    for obj, _ in jobs:
        obj.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    log = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n{log}")
    os.replace(tmp, out)
    return {"path": out, "seconds": seconds, "log": log}


@functools.cache
def _library():
    lib = ctypes.CDLL(str(build_kernels()["path"]))
    p, i = ctypes.c_void_p, ctypes.c_int
    head = [p] * 5 + [ctypes.POINTER(_DecoderPtrs)] + [i] * 9
    lib.supnerf_render_fwd.argtypes = head + [i, p] + [p] * 3 + [p]
    lib.supnerf_render_fwd.restype = i
    lib.supnerf_render_bwd.argtypes = head + [i, p] + [p] * 3 + [p] * 5 + [p]
    lib.supnerf_render_bwd.restype = i
    lib.supnerf_render_train_bwd.argtypes = (head + [p] * 3 + [ctypes.POINTER(_StashLayout)]
                                             + [p] * 6)
    lib.supnerf_render_train_bwd.restype = i
    lib.supnerf_wgrad.argtypes = [ctypes.POINTER(_WgradProblem), i, i, p]
    lib.supnerf_wgrad.restype = i
    field = [p] * 4 + [ctypes.POINTER(_DecoderPtrs)] + [i] * 7
    lib.supnerf_field_fwd.argtypes = field + [p] * 3
    lib.supnerf_field_fwd.restype = i
    lib.supnerf_field_bwd.argtypes = field + [p] * 7
    lib.supnerf_field_bwd.restype = i
    lib.supnerf_field_train_bwd.argtypes = field + [p] * 2 + [ctypes.POINTER(_StashLayout)] + [p] * 5
    lib.supnerf_field_train_bwd.restype = i
    # the same kernels with their ReLU gates written out (csrc/field_gates.cu)
    lib.supnerf_field_fwd_gates.argtypes = field + [p] * 4
    lib.supnerf_field_bwd_gates.argtypes = field + [p] * 8
    lib.supnerf_field_train_bwd_gates.argtypes = (field + [p] * 2 + [ctypes.POINTER(_StashLayout)]
                                                  + [p] * 6)
    for fn in ("fwd", "bwd", "train_bwd"):
        getattr(lib, f"supnerf_field_{fn}_gates").restype = i
    return lib


def _ptrs(wts: DecoderWeights) -> _DecoderPtrs:
    return _DecoderPtrs(*[getattr(wts, name).data_ptr() for name in _PTR_FIELDS])


def check_operands(wts: DecoderWeights, expect: dict, device):
    """What every decoder kernel takes: each tensor of expect (name ->
    (tensor, shape)) float32, contiguous, of its shape, on `device`; the
    decoder weights the same; W in {64, 128, 256}; at most 10 encoding
    frequencies. Raises ValueError otherwise."""
    for name, (t, shape) in expect.items():
        if t.device != device or t.dtype != torch.float32:
            raise ValueError(f"{name}: expected float32 on {device}, got {t.dtype} on {t.device}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name in _PTR_FIELDS:
        t = getattr(wts, name)
        if t.device != device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"decoder weight {name}: expected contiguous float32 on {device}")
    if wts.W not in (64, 128, 256):
        raise ValueError(f"the decoder kernels take W in {{64, 128, 256}}, got {wts.W}")
    if wts.num_xyz_freq > 10 or wts.num_dir_freq > 10:
        raise ValueError("the decoder kernels take at most 10 encoding frequencies")


def _check_inputs(wts: DecoderWeights, xyz, viewdir, z, zs, zt, *extra, hit=None):
    B, R, S = xyz.shape[:3]
    W = wts.W
    expect = {"xyz": (xyz, (B, R, S, 3)), "viewdir": (viewdir, (B, R, 3)),
              "z": (z, (B, S) if hit is None else (B, R, S)),
              "zs": (zs, (B, wts.n_shape, W)), "zt": (zt, (B, wts.n_tex, W))}
    if hit is not None:
        expect["hit"] = (hit, (B, R))
    for i, t in enumerate(extra):
        expect[f"grad{i}"] = (t, t.shape)
    check_operands(wts, expect, xyz.device)
    if not 1 <= S <= MAX_SAMPLES:
        raise ValueError(f"the render kernels take 1..{MAX_SAMPLES} samples per ray, got {S}")


def _dims(wts, xyz, white_bkgd):
    B, R, S = xyz.shape[:3]
    return [B, R, S, wts.W, wts.n_shape, wts.n_tex, wts.num_xyz_freq, wts.num_dir_freq,
            int(bool(white_bkgd))]


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _hit_operand(hit):
    """The hit mask as the kernels read it: float32 (B,R), 0 for a miss."""
    return None if hit is None else hit.to(torch.float32).contiguous()


def _mode_args(hit):
    return [int(hit is not None), hit.data_ptr() if hit is not None else None]


def render_fwd(wts: DecoderWeights, xyz, viewdir, z, zs, zt, white_bkgd=False, hit=None):
    """K1 wrapper. Returns (rgb (B,R,3), depth (B,R), acc_trans (B,R)).
    With hit (B,R) (bool or float, nonzero for a hit) it runs the AABB mode:
    z is per ray (B,R,S) and missed rays have zero density."""
    if xyz.device.type == "cpu":
        return render_fwd_plain(wts, xyz, viewdir, z, zs, zt, white_bkgd, hit)
    hit = _hit_operand(hit)
    _check_inputs(wts, xyz, viewdir, z, zs, zt, hit=hit)
    B, R = xyz.shape[:2]
    rgb = torch.empty((B, R, 3), device=xyz.device)
    depth = torch.empty((B, R), device=xyz.device)
    acc = torch.empty((B, R), device=xyz.device)
    ptrs = _ptrs(wts)
    with torch.cuda.device(xyz.device):     # the runtime launches on its current device
        err = _library().supnerf_render_fwd(
            xyz.data_ptr(), viewdir.data_ptr(), z.data_ptr(), zs.data_ptr(), zt.data_ptr(),
            ctypes.byref(ptrs), *_dims(wts, xyz, white_bkgd), *_mode_args(hit),
            rgb.data_ptr(), depth.data_ptr(), acc.data_ptr(),
            torch.cuda.current_stream(xyz.device).cuda_stream)
    _raise_on(err, "render_fwd")
    LAUNCHES["render_fwd" if hit is None else "render_fwd_aabb"] += 1
    return rgb, depth, acc


def render_bwd(wts: DecoderWeights, xyz, viewdir, z, zs, zt, white_bkgd,
               g_rgb, g_depth, g_acc, hit=None):
    """K2 wrapper. Returns (dxyz (B,R,S,3), dviewdir (B,R,3), dz (B,S),
    dzs (B,n_shape,W), dzt (B,n_tex,W)). The kernel writes per-ray partial
    sums of dz, dzs and dzt; summing them over rays here is the second,
    deterministic pass of the cross-block reduction. With hit (the AABB
    mode) z and dz are per ray, (B,R,S), and dz is returned unsummed."""
    if xyz.device.type == "cpu":
        return render_bwd_plain(wts, xyz, viewdir, z, zs, zt, white_bkgd, g_rgb, g_depth, g_acc,
                                hit)
    hit = _hit_operand(hit)
    _check_inputs(wts, xyz, viewdir, z, zs, zt, g_rgb, g_depth, g_acc, hit=hit)
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
            ctypes.byref(ptrs), *_dims(wts, xyz, white_bkgd), *_mode_args(hit),
            g_rgb.data_ptr(), g_depth.data_ptr(), g_acc.data_ptr(),
            dxyz.data_ptr(), dvd.data_ptr(), dzs_part.data_ptr(), dzt_part.data_ptr(),
            dz_part.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "render_bwd")
    LAUNCHES["render_bwd" if hit is None else "render_bwd_aabb"] += 1
    dz = dz_part.sum(1) if hit is None else dz_part
    return dxyz, dvd, dz, dzs_part.sum(1), dzt_part.sum(1)


class FieldComposite(torch.autograd.Function):
    """(xyz, viewdir, z, zs, zt[, hit]) -> (rgb, depth, acc) with K1 as the
    forward and K2 as the backward; the decoder weights are constants, and
    hit (the AABB mode: z per ray) gets no gradient."""

    @staticmethod
    def forward(ctx, xyz, viewdir, z, zs, zt, wts, white_bkgd, hit=None):
        ctx.save_for_backward(xyz, viewdir, z, zs, zt, hit)
        ctx.wts, ctx.white_bkgd = wts, white_bkgd
        return render_fwd(wts, xyz, viewdir, z, zs, zt, white_bkgd, hit)

    @staticmethod
    def backward(ctx, g_rgb, g_depth, g_acc):
        xyz, viewdir, z, zs, zt, hit = ctx.saved_tensors
        grads = render_bwd(ctx.wts, xyz, viewdir, z, zs, zt, ctx.white_bkgd,
                           g_rgb.contiguous(), g_depth.contiguous(), g_acc.contiguous(), hit)
        return (*grads, None, None, None)


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


def field_composite_aabb(wts: DecoderWeights, xyz, viewdir, z, hit, shapecode, texturecode,
                         white_bkgd: bool = False):
    """Differentiable fused AABB render of B objects (counterpart of
    pallas_render.field_composite_aabb_apply): xyz (B,R,S,3), viewdir
    (B,R,3), per-ray z (B,R,S), hit (B,R) bool, codes (B, latent) ->
    (rgb, depth, acc_trans), through FieldComposite in its AABB mode (the
    kernels for CUDA tensors, the plain versions inside the same wrappers
    for CPU tensors). Gradients reach the points, view directions, per-ray z
    and, through the latent projections, the codes; hit and the decoder get
    none."""
    zs, zt = conditioned_latents(wts, shapecode, texturecode)
    return FieldComposite.apply(xyz.contiguous(), viewdir.contiguous(), z.contiguous(),
                                zs.contiguous(), zt.contiguous(), wts, white_bkgd, hit)


def decoder_field(model, xyz, viewdir, shapecode, texturecode):
    """The model's own decoder on the points of B objects, under autograd:
    xyz, viewdir (B,...,3), codes (B, latent) broadcast over the middle
    axes -> (sigma (B,...,1), rgb (B,...,3)). The route of a decoder that
    is not kernel-compatible (the original AutoRF), as the JAX package runs
    it on flax autodiff."""
    mid = (slice(None),) + (None,) * (xyz.dim() - 2)
    return model(xyz, viewdir, shapecode[mid], texturecode[mid])


def decoder_composite(model, xyz, viewdir, z, shapecode, texturecode, white_bkgd: bool = False,
                      hit=None):
    """field_composite's (and with hit field_composite_aabb's) counterpart
    for a decoder that is not kernel-compatible: decoder_field composited
    by ops.volume_render, differentiable in the data, the codes and the
    decoder's weights. xyz (B,R,S,3), viewdir (B,R,3) per ray or
    (B,R,S,3), z (B,S), or per ray (B,R,S) with hit (B,R), whose missed
    rays get zero density (render_fwd_plain's rule) -> (rgb, depth,
    acc_trans)."""
    if viewdir.dim() == 3:
        viewdir = viewdir[:, :, None, :].expand_as(xyz)
    sigma, rgb = decoder_field(model, xyz, viewdir, shapecode, texturecode)
    sigma = sigma[..., 0]
    if hit is None:
        z = z[:, None, :]
    else:
        sigma = torch.where(hit[..., None] != 0, sigma, torch.zeros_like(sigma))
    return volume_render(sigma, rgb, z, white_bkgd=white_bkgd)


# --------------------------------------------------------------------------
# training render: A5 forward on K1, A6 backward on K3 + K4
# --------------------------------------------------------------------------

# Budget of K3's and K7's stash per launch (about 1 GB per object at the
# published 1024 x 64 points and W 256); the batch is cut into chunks of
# objects to fit.
STASH_BYTES = 4 << 30
# the stash columns of csrc/render_common.cuh:StashLayout, in its order
_STASH_POINT_COLS = ("a_xyz", "a_sh", "a_es", "a_e", "a_tx", "a_r1", "a_hh",
                     "g_xyz", "g_sh", "g_e", "g_sig", "g_v", "g_tx", "g_hh", "g_rgb")


class _StashLayout(ctypes.Structure):
    """csrc/render_common.cuh:StashLayout."""
    _fields_ = ([("pt", ctypes.c_void_p), ("ray", ctypes.c_void_p),
                 ("ld_pt", ctypes.c_int), ("ld_ray", ctypes.c_int)]
                + [(name, ctypes.c_int) for name in _STASH_POINT_COLS]
                + [("r_dpe", ctypes.c_int), ("r_gv", ctypes.c_int), ("a_dpe", ctypes.c_int)])


def stash_struct(L: dict, pt, ray=None) -> _StashLayout:
    """The kernels' StashLayout over the buffers pt (and ray) in layout L."""
    return _StashLayout(pt.data_ptr(), ray.data_ptr() if ray is not None else None, L["ld_pt"],
                        L["ld_ray"], *[L[name] for name in _STASH_POINT_COLS], L["r_dpe"],
                        L["r_gv"], L["a_dpe"])


class _WgradProblem(ctypes.Structure):
    """csrc/wgrad.cu:WgradProblem."""
    _fields_ = ([(name, ctypes.c_void_p) for name in ("A", "G", "partial", "w_out", "b_out")]
                + [(name, ctypes.c_int) for name in ("lda", "ldg", "M", "K", "N", "ldw", "col0",
                                                     "n_split", "rows_per_split", "block0",
                                                     "rblock0")])


def stash_layout(wts: DecoderWeights, per_point: bool = False) -> dict:
    """Float column offsets of the training stash: per point, every layer's
    input rows (a_*) and pre-activation gradient rows (g_*), ld_pt floats a
    row, of which the first `width` are used. The viewdir layer's direction
    input is per ray in K3: per ray, the direction encoding (r_dpe) and the
    viewdir layer's gradient summed over the ray's samples (r_gv), ld_ray
    floats a row. With per_point (K7: every point has its own direction)
    the direction encoding is a column block of the point row (a_dpe) and
    there are no ray rows (ld_ray 0). Every column block, and every row,
    starts on 16 bytes (a multiple of 4 floats), as K4's 16-byte copies
    need; the pad columns between blocks are written by nobody and read
    into no output."""
    W, ns, nt = wts.W, wts.n_shape, wts.n_tex
    d_dir = 3 * (2 * wts.num_dir_freq + 1)
    widths = {"a_xyz": 3 * (2 * wts.num_xyz_freq + 1), "a_sh": ns * W, "a_es": W, "a_e": W,
              "a_tx": nt * W, "a_r1": W, "a_hh": W // 2, "g_xyz": W, "g_sh": ns * W,
              "g_e": W, "g_sig": 1, "g_v": W, "g_tx": nt * W, "g_hh": W // 2, "g_rgb": 3,
              "a_dpe": d_dir if per_point else 0}
    out, end = {}, 0
    for name in _STASH_POINT_COLS + ("a_dpe",):
        out[name] = _round_up(end)
        end = out[name] + widths[name] if widths[name] else end
    r_gv = _round_up(d_dir)
    out.update(width=end, ld_pt=_round_up(end), r_dpe=0, r_gv=r_gv,
               ld_ray=0 if per_point else _round_up(r_gv + W))
    return out


def _round_up(n: int, k: int = 4) -> int:
    return -(-n // k) * k


def linear_params_of(wts: DecoderWeights) -> list:
    """decoder_linear_params recovered from kernel operands (Linear layout)."""
    out = [wts.wt_xyz, wts.b_xyz]
    for j in range(wts.n_shape):
        out += [wts.wt_sh[j], wts.b_sh[j]]
    out += [wts.wt_es, wts.b_es, wts.w_sg[None], wts.b_sg,
            torch.cat([wts.wt_vd_a, wts.w_vd_b.t()], 1), wts.b_vd]
    for j in range(wts.n_tex):
        out += [wts.wt_tx[j], wts.b_tx[j]]
    return out + [wts.wt_r1, wts.b_r1, wts.w_r2.t(), wts.b_r2]


@dataclasses.dataclass
class WgradProblem:
    """One layer's weight gradient for K4:
    w_out[n, col0 + k] (+)= sum_r A[r, k] G[r, n] and b_out[n] (+)= sum_r G[r, n]."""

    A: torch.Tensor                 # (M, K), unit column stride
    G: torch.Tensor                 # (M, N), unit column stride
    w_out: torch.Tensor             # (N, >= col0 + K), contiguous
    col0: int
    b_out: torch.Tensor | None      # (N,) or None


def wgrad_problems(wts: DecoderWeights, pt, ray, grads) -> list:
    """The decoder's weight-gradient problems over a stash (pt rows per
    point, ray rows per ray; stash_layout; ray None for K7's per-point
    layout) into `grads`, the flat Linear-layout list of linear_params_of."""
    per_point = ray is None
    L, W, ns, nt = stash_layout(wts, per_point), wts.W, wts.n_shape, wts.n_tex
    d_xyz, d_dir = 3 * (2 * wts.num_xyz_freq + 1), 3 * (2 * wts.num_dir_freq + 1)

    def col(name, j=0, width=W):
        return pt[:, L[name] + j * W:L[name] + j * W + width]

    def prob(a, g, layer, col0=0, bias=True):       # layer: index in linear_names
        return WgradProblem(a, g, grads[2 * layer], col0, grads[2 * layer + 1] if bias else None)

    probs = [prob(col("a_xyz", width=d_xyz), col("g_xyz"), 0)]
    probs += [prob(col("a_sh", j), col("g_sh", j), 1 + j) for j in range(ns)]
    i = 1 + ns                   # encoding_shape, sigma, encoding_viewdir
    # the viewdir layer's direction rows: its input per point, or per ray
    # with the ray's sum of g_v
    dir_rows = ((col("a_dpe", width=d_dir), col("g_v")) if per_point else
                (ray[:, L["r_dpe"]:L["r_dpe"] + d_dir], ray[:, L["r_gv"]:L["r_gv"] + W]))
    probs += [prob(col("a_es"), col("g_e"), i), prob(col("a_e"), col("g_sig", width=1), i + 1),
              prob(col("a_e"), col("g_v"), i + 2), prob(*dir_rows, i + 2, col0=W, bias=False)]
    probs += [prob(col("a_tx", j), col("g_tx", j), i + 3 + j) for j in range(nt)]
    i += 3 + nt                  # rgb.0, rgb.2
    probs += [prob(col("a_r1"), col("g_hh", width=W // 2), i),
              prob(col("a_hh", width=W // 2), col("g_rgb", width=3), i + 1)]
    return probs


def wgrad_plain(problems, accumulate: bool = False):
    """K4's plain version: G^T A and the column sums of G, in place."""
    for p in problems:
        K = p.A.shape[1]
        pairs = [(p.w_out[:, p.col0:p.col0 + K], p.G.t() @ p.A)]
        if p.b_out is not None:
            pairs.append((p.b_out, p.G.sum(0)))
        for out, val in pairs:
            if accumulate:
                out.add_(val)
            else:
                out.copy_(val)


# csrc/wgrad.cu: rows per shared-memory stage of K4's first pass, and the
# number of row slices ("splits") a large problem is cut into
WGRAD_STAGE_ROWS = 64
WGRAD_SPLITS = 32


def wgrad_splits(M: int) -> tuple:
    """(rows per split, number of splits) of K4's first pass over M rows:
    about WGRAD_SPLITS splits of a large problem, at least 256 rows each, a
    multiple of the 64-row stage; split s takes rows s * rows .. min(M,
    (s + 1) * rows) - 1, so every row lies in exactly one split, in order."""
    rows = _round_up(max(256, -(-M // WGRAD_SPLITS)), WGRAD_STAGE_ROWS)
    return rows, -(-M // rows)


def check_wgrad_problems(problems):
    """What K4 takes (raises ValueError otherwise): at most 24 problems,
    float32 operands with unit column stride on one device, consistent
    shapes, and A's and G's rows starting on 16 bytes (a 16-byte-aligned
    first element and a row stride that is a multiple of 4 floats, as
    stash_layout's column blocks are), since the kernel copies them 16 bytes
    at a time."""
    dev = problems[0].A.device
    if len(problems) > 24:
        raise ValueError(f"wgrad takes at most 24 problems, got {len(problems)}")
    for p in problems:
        (M, K), N = p.A.shape, p.G.shape[1]
        for name, t in (("A", p.A), ("G", p.G), ("w_out", p.w_out), ("b_out", p.b_out)):
            if t is not None and (t.device != dev or t.dtype != torch.float32 or t.stride(-1) != 1):
                raise ValueError(f"wgrad {name}: expected float32 rows with unit stride on {dev}")
        if (p.G.shape[0] != M or not p.w_out.is_contiguous() or p.w_out.shape[0] != N
                or p.w_out.shape[1] < p.col0 + K or (p.b_out is not None and p.b_out.shape != (N,))):
            raise ValueError("wgrad: inconsistent problem shapes")
        for name, t in (("A", p.A), ("G", p.G)):
            if t.data_ptr() % 16 or (t.shape[0] > 1 and t.stride(0) % 4):
                raise ValueError(f"wgrad {name}: rows must start on 16 bytes (stash_layout's "
                                 "column blocks do)")


def wgrad(problems, accumulate: bool = False):
    """K4 wrapper: every problem's weight and bias gradient in one grouped
    launch (plus its fixed-order reduction pass), written into (or, with
    accumulate, added to) w_out and b_out."""
    dev = problems[0].A.device
    if dev.type == "cpu":
        return wgrad_plain(problems, accumulate)
    check_wgrad_problems(problems)
    table = (_WgradProblem * len(problems))()
    partials = []
    for s, p in zip(table, problems):
        (M, K), N = p.A.shape, p.G.shape[1]
        rows, n_split = wgrad_splits(M)
        part = torch.empty((n_split, N, K + 1), device=dev)
        partials.append(part)
        s.A, s.G, s.partial, s.w_out = (p.A.data_ptr(), p.G.data_ptr(), part.data_ptr(),
                                        p.w_out.data_ptr())
        s.b_out = p.b_out.data_ptr() if p.b_out is not None else None
        s.lda, s.ldg, s.M, s.K, s.N = p.A.stride(0), p.G.stride(0), M, K, N
        s.ldw, s.col0, s.n_split, s.rows_per_split = p.w_out.shape[1], p.col0, n_split, rows
    with torch.cuda.device(dev):
        err = _library().supnerf_wgrad(table, len(problems), int(bool(accumulate)),
                                       torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "wgrad")
    LAUNCHES["wgrad"] += 1


def _linear_grad_buffers(wts: DecoderWeights, device) -> list:
    return [torch.empty(t.shape, device=device) for t in linear_params_of(wts)]


def stashed_chain(wts: DecoderWeights, xyz, hdir, zs, zt):
    """decoder_chain written out for the stash's plain versions, on points
    xyz (B,...,3) with the viewdir layer's direction term hdir broadcastable
    to (B,...,W). Returns (rows, pre, logit, rgb): rows the layer inputs a_*
    named as stash_layout names them; pre the pre-activations, keyed xyz,
    sh{j}, e, v, tx{j}, hh, each requiring a gradient (their gradients are
    the g_* rows); logit the sigma head's pre-activation (B,...,1)."""
    mid = (slice(None),) + (None,) * (xyz.dim() - 2)
    rows, pre = {}, {}

    def layer(key, x, w, b):
        rows["a_" + key] = x
        pre[key] = x @ w + b
        if not pre[key].requires_grad:      # the first layer: inputs and weights are data
            pre[key].requires_grad_(True)
        return pre[key]

    y = F.relu(layer("xyz", positional_encoding(xyz, wts.num_xyz_freq), wts.w_xyz, wts.b_xyz))
    for j in range(wts.n_shape):
        y = F.relu(layer(f"sh{j}", y + zs[mid + (j,)], wts.w_sh[j], wts.b_sh[j]))
    e = layer("e", y, wts.w_es, wts.b_es)
    rows["a_es"], rows["a_e"] = rows.pop("a_e"), e
    logit = e @ wts.w_sg[:, None] + wts.b_sg
    h = F.relu(layer("v", e, wts.w_vd_a, hdir + wts.b_vd))
    del rows["a_v"]                                  # = a_e
    for j in range(wts.n_tex):
        h = F.relu(layer(f"tx{j}", h + zt[mid + (j,)], wts.w_tx[j], wts.b_tx[j]))
    hh = F.relu(layer("hh", h, wts.w_r1, wts.b_r1))
    rows["a_r1"], rows["a_hh"] = rows.pop("a_hh"), hh
    return rows, pre, logit, hh @ wts.w_r2 + wts.b_r2


def stash_grads(outs, cotangents, pre, logit, rgb, inputs):
    """Autograd of a stashed_chain's outputs: (g, input gradients), g the
    gradients of every pre-activation (keyed as pre), of the sigma head's
    logit ("sig") and of rgb ("rgb")."""
    keys = list(pre)
    g = torch.autograd.grad(outs, [pre[k] for k in keys] + [logit, rgb] + inputs, cotangents,
                            allow_unused=True, materialize_grads=True)
    return dict(zip(keys + ["sig", "rgb"], g)), list(g[len(keys) + 2:])


def write_stash(wts: DecoderWeights, rows: dict, g: dict, pt, per_point: bool = False):
    """The point rows of a stash plain version: stashed_chain's layer inputs
    and stash_grads' gradients, written into pt (one row per point) at
    stash_layout's columns."""
    L = stash_layout(wts, per_point)
    rows = dict(rows, g_xyz=g["xyz"], g_e=g["e"], g_sig=g["sig"], g_v=g["v"], g_hh=g["hh"],
                g_rgb=g["rgb"])
    for kind, n in (("sh", wts.n_shape), ("tx", wts.n_tex)):
        rows["a_" + kind] = torch.cat([rows.pop(f"a_{kind}{j}") for j in range(n)], -1)
        rows["g_" + kind] = torch.cat([g[f"{kind}{j}"] for j in range(n)], -1)
    with torch.no_grad():
        for name, t in rows.items():
            pt[:, L[name]:L[name] + t.shape[-1]] = t.reshape(-1, t.shape[-1])


def _leaves(tensors, grad: bool = True):
    return [t.detach().requires_grad_(grad) for t in tensors]


def render_train_bwd_stash_plain(wts: DecoderWeights, xyz, viewdir, z, zs, zt, white_bkgd,
                                 g_rgb, g_depth, g_acc, pt, ray, data_grads: bool = False):
    """K3's plain version: the decoder chain written out with every layer
    input kept (stashed_chain), autograd for the pre-activation gradients,
    the rows written into pt and ray as stash_layout places them. Returns
    (dzs, dzt), and with data_grads (dxyz, dviewdir, dz) after them."""
    L, nd = stash_layout(wts), wts.num_dir_freq
    with torch.enable_grad():
        lat = _leaves((zs, zt))
        xyz, viewdir, z = _leaves((xyz, viewdir, z), data_grads)
        dpe = positional_encoding(viewdir, nd)
        rows, pre, logit, rgb = stashed_chain(wts, xyz, (dpe @ wts.w_vd_b)[:, :, None], *lat)
        outs = volume_render(F.softplus(logit), rgb, z[:, None, :],
                             white_bkgd=white_bkgd)
        g, dlat = stash_grads(outs, (g_rgb, g_depth, g_acc), pre, logit, rgb,
                              lat + ([xyz, viewdir, z] if data_grads else []))
    write_stash(wts, rows, g, pt)
    with torch.no_grad():
        ray[:, L["r_dpe"]:L["r_dpe"] + dpe.shape[-1]] = dpe.reshape(-1, dpe.shape[-1])
        ray[:, L["r_gv"]:L["r_gv"] + wts.W] = g["v"].sum(2).reshape(-1, wts.W)
    return tuple(dlat)


def render_train_bwd_stash(wts: DecoderWeights, xyz, viewdir, z, zs, zt, white_bkgd,
                           g_rgb, g_depth, g_acc, pt, ray, data_grads: bool = False):
    """K3 wrapper: writes the stash rows of these B objects into pt
    (B*R*S, ld_pt) and ray (B*R, ld_ray) and returns (dzs (B,n_shape,W),
    dzt (B,n_tex,W)), summed over rays here (the second, deterministic pass
    of that reduction). With data_grads it runs K3's data mode
    (LAUNCHES["render_train_bwd_data"]) and also returns (dxyz (B,R,S,3),
    dviewdir (B,R,3), dz (B,S)), dz summed over rays here too; the stash,
    dzs and dzt are the same bits in both modes."""
    if xyz.device.type == "cpu":
        return render_train_bwd_stash_plain(wts, xyz, viewdir, z, zs, zt, white_bkgd,
                                            g_rgb, g_depth, g_acc, pt, ray, data_grads)
    _check_inputs(wts, xyz, viewdir, z, zs, zt, g_rgb, g_depth, g_acc)
    B, R, S = xyz.shape[:3]
    dev = xyz.device
    if g_rgb.shape != (B, R, 3) or g_depth.shape != (B, R) or g_acc.shape != (B, R):
        raise ValueError("cotangent shapes do not match the render outputs")
    L = stash_layout(wts)
    if (pt.shape != (B * R * S, L["ld_pt"]) or ray.shape != (B * R, L["ld_ray"])
            or not (pt.is_contiguous() and ray.is_contiguous()) or pt.device != dev):
        raise ValueError("stash buffers do not match stash_layout")
    if pt.data_ptr() % 16 or ray.data_ptr() % 16:
        raise ValueError("stash buffers must start on 16 bytes (K3 stores 16 bytes at a time)")
    dzs_part = torch.empty((B, R, wts.n_shape, wts.W), device=dev)
    dzt_part = torch.empty((B, R, wts.n_tex, wts.W), device=dev)
    data = ((torch.empty_like(xyz), torch.empty_like(viewdir), torch.empty((B, R, S), device=dev))
            if data_grads else (None, None, None))
    layout = stash_struct(L, pt, ray)
    ptrs = _ptrs(wts)
    with torch.cuda.device(dev):
        err = _library().supnerf_render_train_bwd(
            xyz.data_ptr(), viewdir.data_ptr(), z.data_ptr(), zs.data_ptr(), zt.data_ptr(),
            ctypes.byref(ptrs), *_dims(wts, xyz, white_bkgd),
            g_rgb.data_ptr(), g_depth.data_ptr(), g_acc.data_ptr(), ctypes.byref(layout),
            dzs_part.data_ptr(), dzt_part.data_ptr(),
            *[t.data_ptr() if t is not None else None for t in data],
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "render_train_bwd")
    LAUNCHES["render_train_bwd_data" if data_grads else "render_train_bwd"] += 1
    out = (dzs_part.sum(1), dzt_part.sum(1))
    return out + (data[0], data[1], data[2].sum(1)) if data_grads else out


def render_train_bwd_plain(wts: DecoderWeights, xyz, viewdir, z, zs, zt, white_bkgd,
                           g_rgb, g_depth, g_acc, data_grads: bool = False):
    """K3 + K4's plain version: autograd through render_fwd_plain with the
    layer weights as inputs. Returns (dzs, dzt, grads), grads in the order
    and Linear layout of linear_params_of, and with data_grads (dxyz,
    dviewdir, dz) after them."""
    with torch.enable_grad():
        params = _leaves(linear_params_of(wts))
        lat = _leaves((zs, zt))
        data = _leaves((xyz, viewdir, z), data_grads)
        live = pack_linear_params(params, wts.n_shape, wts.n_tex, wts.num_xyz_freq,
                                  wts.num_dir_freq)
        outs = render_fwd_plain(live, *data, *lat, white_bkgd=white_bkgd)
        g = torch.autograd.grad(outs, lat + params + (data if data_grads else []),
                                (g_rgb, g_depth, g_acc), allow_unused=True,
                                materialize_grads=True)
    n = 2 + len(params)
    return (g[0], g[1], list(g[2:n])) + tuple(g[n:])


def render_train_bwd(wts: DecoderWeights, xyz, viewdir, z, zs, zt, white_bkgd,
                     g_rgb, g_depth, g_acc, data_grads: bool = False):
    """The training backward (A6): K3 then K4 on each chunk of objects that
    fits STASH_BYTES, the weight gradients accumulated over chunks in order.
    Returns (dzs (B,n_shape,W), dzt (B,n_tex,W), grads) with grads in the
    order and Linear layout of linear_params_of, and with data_grads (K3's
    data mode) (dxyz (B,R,S,3), dviewdir (B,R,3), dz (B,S)) after them."""
    if xyz.device.type == "cpu":
        return render_train_bwd_plain(wts, xyz, viewdir, z, zs, zt, white_bkgd,
                                      g_rgb, g_depth, g_acc, data_grads)
    B, R, S = xyz.shape[:3]
    dev = xyz.device
    L = stash_layout(wts)
    chunk = max(1, min(B, STASH_BYTES // (R * S * L["ld_pt"] * 4)))
    pt = torch.empty((chunk * R * S, L["ld_pt"]), device=dev)
    ray = torch.empty((chunk * R, L["ld_ray"]), device=dev)
    grads = _linear_grad_buffers(wts, dev)
    outs = []
    for o0 in range(0, B, chunk):
        sl = slice(o0, min(B, o0 + chunk))
        nb = sl.stop - o0
        pt_c, ray_c = pt[:nb * R * S], ray[:nb * R]
        outs.append(render_train_bwd_stash(wts, xyz[sl], viewdir[sl], z[sl], zs[sl], zt[sl],
                                           white_bkgd, g_rgb[sl], g_depth[sl], g_acc[sl],
                                           pt_c, ray_c, data_grads))
        wgrad(wgrad_problems(wts, pt_c, ray_c, grads), accumulate=o0 > 0)
    cat = [torch.cat(parts) for parts in zip(*outs)]
    return (cat[0], cat[1], grads) + tuple(cat[2:])


class FieldCompositeTrain(torch.autograd.Function):
    """(xyz, viewdir, z, zs, zt, decoder layer weights) -> (rgb, depth, acc)
    with K1 as the forward and K3 + K4 as the backward. The weights enter in
    torch.nn.Linear's layout (decoder_linear_params) and get their gradients
    in it. xyz, viewdir and z get theirs from K3's data mode where autograd
    asks for them; with data_grads False they are data and must not ask."""

    @staticmethod
    def forward(ctx, xyz, viewdir, z, zs, zt, meta, white_bkgd, data_grads, *params):
        if not data_grads and any(ctx.needs_input_grad[:3]):
            raise ValueError("the training render with data_grads=False gives no gradient "
                             "for xyz, viewdir or z")
        wts = pack_linear_params(params, *meta)
        ctx.save_for_backward(xyz, viewdir, z, zs, zt)
        ctx.wts, ctx.white_bkgd = wts, white_bkgd
        return render_fwd(wts, xyz, viewdir, z, zs, zt, white_bkgd)

    @staticmethod
    def backward(ctx, g_rgb, g_depth, g_acc):
        xyz, viewdir, z, zs, zt = ctx.saved_tensors
        data = any(ctx.needs_input_grad[:3])
        dzs, dzt, grads, *dx = render_train_bwd(ctx.wts, xyz, viewdir, z, zs, zt, ctx.white_bkgd,
                                                g_rgb.contiguous(), g_depth.contiguous(),
                                                g_acc.contiguous(), data)
        return (*(dx or (None,) * 3), dzs, dzt, None, None, None, *grads)


def conditioned_latents_of(decoder, shapecode, texturecode):
    """conditioned_latents through the decoder's live latent layers, so the
    layers and the codes get gradients: (zs (B,n_shape,W), zt (B,n_tex,W))."""
    zs = torch.stack([decoder.get_submodule(f"shape_latent_layer_{j}")(shapecode)
                      for j in range(1, decoder.shape_blocks + 1)], 1)
    zt = torch.stack([decoder.get_submodule(f"texture_latent_layer_{j}")(texturecode)
                      for j in range(1, decoder.texture_blocks + 1)], 1)
    return zs, zt


def field_composite_train(decoder, xyz, viewdir, z, shapecode, texturecode,
                          white_bkgd: bool = False, data_grads: bool = True):
    """The training render of B objects (counterpart of
    pallas_render.field_composite_train_pallas): xyz (B,R,S,3), viewdir
    (B,R,3), or (B,R,S,3) constant along the samples, of which sample 0 is
    read, z (B,S), codes (B, latent) -> (rgb, depth, acc_trans). Gradients
    reach every weight and bias of the decoder and, through the latent
    projections, the codes; with data_grads (the default, as in JAX) also
    xyz, viewdir and z where they require one. With data_grads False they
    are data (the NeRF branch of a training step) and must not require a
    gradient: this raises where JAX returns zeros. Runs
    FieldCompositeTrain: K1 and K3 + K4 for CUDA tensors, their plain
    versions inside the same wrappers for CPU tensors. Raises ValueError for
    a decoder that is not kernel-compatible (decoder_kernel_compatible)."""
    check_kernel_decoder(decoder)
    if viewdir.dim() == 4:
        viewdir = viewdir[:, :, 0]
    zs, zt = conditioned_latents_of(decoder, shapecode, texturecode)
    meta = (decoder.shape_blocks, decoder.texture_blocks, decoder.num_xyz_freq,
            decoder.num_dir_freq)
    return FieldCompositeTrain.apply(xyz.contiguous(), viewdir.contiguous(), z.contiguous(),
                                     zs.contiguous(), zt.contiguous(), meta, white_bkgd,
                                     data_grads, *decoder_linear_params(decoder))
