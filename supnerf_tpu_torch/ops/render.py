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

The bfloat16 mode (DecoderWeights.field_dtype "bfloat16", packed from a
model built with net_hyperparams' field_dtype "bfloat16") is the Pallas
kernels' at dtype=bfloat16, the precision the JAX package runs them at on
its accelerator: every dense layer's operands rounded to bfloat16 (the
weights at pack time, as pallas_field.py:_precast_weights), float32 sums
and biases, the encodings rounded (PE_MODES: by the doubling recurrence
for TTO, pallas_field.py:_pe_for_dtype; exact for the kernels that encode
in place and for training), the per-ray direction term rounded except in
A11a; the backward kernels recompute with their ReLU outputs rounded (the
stash) and round each transposed layer's operand, the rgb cotangent per
ray and the encodings' chain-rule terms (decoder_chain_bf16,
recompute_bf16, transposed_bf16, composite_vjp_bf16, encode_bwd_bf16);
the training backward's weight products take both operands rounded and
its bias sums the unrounded float32 cotangents (wgrad_plain). Inputs,
outputs, latents and compositing stay float32. K1 (both modes and the
training encodings), K2 (both modes), K3 (both modes), K4, K5 (its
encodings by the doubling recurrence, or exact for A11b and the training
field), K6 and K7 (ops/field.py) have bfloat16 builds, counted apart
(LAUNCHES' *_bf16 keys); every kernel has one, and no entry point refuses
the mode.

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

from supnerf_tpu_torch.models.nerf_mlp import (
    FIELD_DTYPES,
    CodeNeRFDecoder,
    bf16_round,
    positional_encoding,
    positional_encoding_doubling,
)
from supnerf_tpu_torch.ops.volume_render import EPS_TRANS, LAST_DELTA, volume_render

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
MAX_SAMPLES = 64          # kRows in csrc/render_common.cuh

# Launches of each kernel since the last reset_launch_counts(); a wrapper
# adds one where it launches its kernel and nowhere else.
# K1 and K2 count their AABB-mode launches (render_*_aabb) apart, K3 its
# data-mode launches (render_train_bwd_data), K1-K7 their bfloat16 builds'
# (*_bf16), K1's and K5's bfloat16 builds on the training encodings
# (render_fwd_train_bf16, field_fwd_train_bf16) apart from their other
# encodings. K5, K6 and K7 (ops/field.py) count here too.
LAUNCHES = {"render_fwd": 0, "render_bwd": 0, "render_fwd_aabb": 0, "render_bwd_aabb": 0,
            "render_train_bwd": 0, "render_train_bwd_data": 0, "wgrad": 0, "field_fwd": 0,
            "field_bwd": 0, "field_train_bwd": 0, "render_fwd_bf16": 0, "render_bwd_bf16": 0,
            "render_fwd_aabb_bf16": 0, "render_bwd_aabb_bf16": 0, "field_fwd_bf16": 0,
            "field_bwd_bf16": 0, "render_fwd_train_bf16": 0, "render_train_bwd_bf16": 0,
            "render_train_bwd_data_bf16": 0, "wgrad_bf16": 0, "field_fwd_train_bf16": 0,
            "field_train_bwd_bf16": 0}

# The bfloat16 render kernels' encodings (K1's pe argument): "doubling",
# the sines and cosines by the doubling recurrence and the direction term
# rounded (A1-A4, pallas_field.py:_pe_for_dtype); "exact", exact sines and
# cosines and an unrounded direction term (A11a, the kernel that encodes in
# place and sums the term with its split matmuls); "train", exact sines and
# cosines and the direction term rounded (A5 and A6,
# pallas_render.py:_make_render_train_core's encode). Every value of an
# encoding is rounded to bfloat16; the index is csrc/render_common.cuh's
# PeMode. The float32 mode's encodings are exact in all three.
PE_MODES = ("doubling", "exact", "train")


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
    kernels, once per object; None where only the kernels need the pack).
    field_dtype "bfloat16": the kernels' bfloat16 mode, every w_* and wt_*
    matrix holding its bfloat16-rounded values (the biases and latent
    projections stay float32), and `tiles`, the same matrices as the
    bfloat16 builds of K1 and K2 read them (bf16_tile_pack); None in the
    float32 mode."""

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
    field_dtype: str = "float32"
    tiles: torch.Tensor | None = None     # bf16_tile_pack's, in the bfloat16 mode

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


# the dense layers' matrices, which the bfloat16 mode rounds at pack time
_MATRIX_FIELDS = tuple(name for name in _PTR_FIELDS if not name.startswith("b_"))


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
                       num_dir_freq: int, latents=None,
                       field_dtype: str = "float32") -> DecoderWeights:
    """Kernel operands from the flat Linear-layout list of
    decoder_linear_params: the (in, out) copies the forward chain reads,
    w_vd split into its trunk and direction rows, w_sg flattened, the block
    layers stacked, and the (out, in) wt_* copies of the transposed chain.
    Differentiable in `params` (the plain training backward relies on it).
    latents: optional ((w, b) of each shape latent layer, (w, b) of each
    texture latent layer); without it the latent fields are None.
    field_dtype "bfloat16": the matrices rounded to bfloat16 once, here (the
    kernels' bfloat16 mode, DecoderWeights; with_field_dtype)."""
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
    wts = DecoderWeights(
        w_xyz=c(w_xyz.t()), b_xyz=c(b_xyz), w_sh=stack(sh, 0, True), b_sh=stack(sh, 1),
        w_es=c(w_es.t()), b_es=c(b_es), w_sg=c(w_sg.reshape(-1)), b_sg=c(b_sg),
        w_vd_a=c(w_vd[:, :W].t()), w_vd_b=c(w_vd[:, W:].t()), b_vd=c(b_vd),
        w_tx=stack(tx, 0, True), b_tx=stack(tx, 1),
        w_r1=c(w_r1.t()), b_r1=c(b_r1), w_r2=c(w_r2.t()), b_r2=c(b_r2),
        wt_xyz=c(w_xyz), wt_sh=stack(sh, 0), wt_es=c(w_es), wt_vd_a=c(w_vd[:, :W]),
        wt_tx=stack(tx, 0), wt_r1=c(w_r1), wt_vd_b=c(w_vd[:, W:]), **lat,
        num_xyz_freq=num_xyz_freq, num_dir_freq=num_dir_freq,
    )
    return with_field_dtype(wts, field_dtype)


def with_field_dtype(wts: DecoderWeights, field_dtype: str) -> DecoderWeights:
    """wts in field_dtype's mode: a float32 pack as it is, or in the
    bfloat16 mode with its matrices rounded to bfloat16 and their tiles
    packed (DecoderWeights)."""
    if field_dtype not in FIELD_DTYPES:
        raise ValueError(f"field_dtype {field_dtype!r}: one of {FIELD_DTYPES}")
    if field_dtype == wts.field_dtype:
        return wts
    if wts.field_dtype != "float32":
        raise ValueError(f"a {wts.field_dtype} pack does not convert to {field_dtype}")
    out = dataclasses.replace(wts, field_dtype=field_dtype,
                              **{n: bf16_round(getattr(wts, n)) for n in _MATRIX_FIELDS})
    return dataclasses.replace(out, tiles=bf16_tile_pack(out))


# K rows of a weight tile of the bfloat16 builds of K1 and K2 (128 bytes of
# bfloat16: csrc/render_bf16.cuh kTileK) and its rows at most (kTileRows)
TILE_K = 64
TILE_ROWS = 128


def direction_tile_rows(num_dir_freq: int) -> int:
    """The padded width of the direction encoding as K2's transposed chain
    reads it (the wgmma N of its direction rows: 32 or 64)."""
    return 32 if 3 * (2 * num_dir_freq + 1) <= 32 else 64


def bf16_tile_plan(wts: DecoderWeights) -> list:
    """The matrices of bf16_tile_pack, in its order: (layer name of
    linear_names, "forward" or "transposed", M (N, K), N padded), M the
    layer's product as the kernels' wgmma B operand reads it, K-major: row
    n holds the K values output column n takes. The forward chain in
    kernel order (linear_names without the heads; the viewdir layer's
    trunk rows), then K2's transposed chain (rgb.0 from the last, the
    viewdir layer's direction rows before its trunk rows) in the order K2
    runs it."""
    W, ns, nt = wts.W, wts.n_shape, wts.n_tex
    names = linear_names(ns, nt)
    sh, tx = names[1:1 + ns], names[4 + ns:4 + ns + nt]
    fwd = ([(names[0], wts.wt_xyz, W)] + [(sh[j], wts.wt_sh[j], W) for j in range(ns)]
           + [("encoding_shape", wts.wt_es, W), ("encoding_viewdir.0", wts.wt_vd_a, W)]
           + [(tx[j], wts.wt_tx[j], W) for j in range(nt)] + [("rgb.0", wts.wt_r1, W // 2)])
    bwd = ([("rgb.0", wts.w_r1, W)] + [(tx[j], wts.w_tx[j], W) for j in reversed(range(nt))]
           + [("encoding_viewdir.0", wts.w_vd_b, direction_tile_rows(wts.num_dir_freq)),
              ("encoding_viewdir.0", wts.w_vd_a, W), ("encoding_shape", wts.w_es, W)]
           + [(sh[j], wts.w_sh[j], W) for j in reversed(range(ns))]
           + [(names[0], wts.w_xyz, 64)])
    return ([(n, "forward", m, rows) for n, m, rows in fwd]
            + [(n, "transposed", m, rows) for n, m, rows in bwd])


def _tiles_of(m, rows: int):
    """M (N, K) as its tiles, flat bfloat16: K zero-padded to whole K-tiles
    of TILE_K, N to `rows`; per K-tile, blocks of up to TILE_ROWS rows,
    each a tile of TILE_K values (128 bytes) a row, 16-byte chunk c of row
    n stored at chunk c ^ (n % 8) (the 128-byte swizzle of a wgmma
    shared-memory descriptor)."""
    N, K = m.shape
    kt, rb = -(-K // TILE_K), min(rows, TILE_ROWS)
    t = torch.zeros((rows, kt * TILE_K), dtype=torch.bfloat16, device=m.device)
    t[:N, :K] = m.detach()
    # (K-tile, row block, row, 16-byte chunk, value)
    t = t.view(rows // rb, rb, kt, 8, 8).permute(2, 0, 1, 3, 4)
    n = torch.arange(rb, device=m.device)[:, None]
    chunk = torch.arange(8, device=m.device)[None, :] ^ (n % 8)
    return t[:, :, n, chunk].reshape(-1)


def bf16_tile_pack(wts: DecoderWeights):
    """The weight tiles of the bfloat16 builds of K1 and K2
    (csrc/render_bf16.cuh tile_sequence): bf16_tile_plan's matrices in
    bfloat16 (their values are, in the mode), each cut into K-tiles
    (_tiles_of), all in one flat tensor. K1 reads the forward part, K2 all
    of it; each tile is one bulk copy into a ring slot. Built once with the
    pack."""
    return torch.cat([_tiles_of(m, rows) for _, _, m, rows in bf16_tile_plan(wts)])


def bf16_tile_count(wts: DecoderWeights) -> int:
    """The bfloat16 values bf16_tile_pack holds."""
    return sum(rows * -(-m.shape[1] // TILE_K) * TILE_K for _, _, m, rows in bf16_tile_plan(wts))


def pack_decoder_params(decoder) -> DecoderWeights:
    """Frozen (detached), contiguous float32 kernel operands of a
    CodeNeRF-style decoder (any module holding the reference layer names:
    CodeNeRFDecoder, SUPNeRF), latent projections included, on the
    decoder's device, in the decoder's field_dtype. Raises ValueError for a
    decoder that is not kernel-compatible (decoder_kernel_compatible)."""
    check_kernel_decoder(decoder)
    n_sh, n_tx = decoder.shape_blocks, decoder.texture_blocks

    def pair(name):
        layer = decoder.get_submodule(name)
        return layer.weight.detach(), layer.bias.detach()

    latents = ([pair(f"shape_latent_layer_{j}.0") for j in range(1, n_sh + 1)],
               [pair(f"texture_latent_layer_{j}.0") for j in range(1, n_tx + 1)])
    return pack_linear_params([t.detach() for t in decoder_linear_params(decoder)], n_sh, n_tx,
                              decoder.num_xyz_freq, decoder.num_dir_freq, latents,
                              decoder.field_dtype)


def conditioned_latents(wts: DecoderWeights, shapecode, texturecode):
    """Per-object latent projections z_j = relu(code @ Wz_j + bz_j):
    codes (B, latent) -> (zs (B, n_shape, W), zt (B, n_tex, W)), as one
    batched product of a (1, latent) row by Wz_j per object and layer: a
    matmul over the B rows rounds each row with B (the CPU library picks
    its routine by the row count), and an object's latents, so its whole
    TTO run, must be the same bits in any batch (ROADMAP C.27)."""

    def each(code, w, b):
        return F.relu(torch.matmul(code[:, None, None], w).squeeze(2) + b)

    return (each(shapecode, wts.w_shape_latent, wts.b_shape_latent),
            each(texturecode, wts.w_tex_latent, wts.b_tex_latent))


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
                     hit=None, pe="doubling"):
    """K1's plain version: decoder_plain (decoder_plain_bf16 in the bfloat16
    mode) + ops.volume_render (differentiable). With hit (B,R) (the AABB
    mode) z is per ray (B,R,S) and the density of missed rays is zero, the
    unfused where(hit, sigma, 0) of render_rays_aabb. pe: the bfloat16
    mode's encodings (PE_MODES; the float32 mode's are exact in all)."""
    if wts.field_dtype == "bfloat16":
        sigma, rgb = decoder_plain_bf16(wts, xyz, viewdir, zs, zt, pe)
    else:
        sigma, rgb = decoder_plain(wts, xyz, viewdir, zs, zt)
    if hit is None:
        z = z[:, None, :]
    else:
        sigma = torch.where(hit[..., None] != 0, sigma, torch.zeros_like(sigma))
    return volume_render(sigma, rgb, z, white_bkgd=white_bkgd)


def render_bwd_plain(wts: DecoderWeights, xyz, viewdir, z, zs, zt, white_bkgd,
                     g_rgb, g_depth, g_acc, hit=None):
    """K2's plain version: autograd through render_fwd_plain (in the
    bfloat16 mode render_bwd_plain_bf16, the backward kernel's own
    rounding). Returns (dxyz, dviewdir, dz, dzs, dzt); dz is per ray with
    hit."""
    if wts.field_dtype == "bfloat16":
        return render_bwd_plain_bf16(wts, xyz, viewdir, z, zs, zt, white_bkgd, g_rgb, g_depth,
                                     g_acc, hit)
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_(True) for t in (xyz, viewdir, z, zs, zt)]
        outs = render_fwd_plain(wts, *inputs, white_bkgd=white_bkgd, hit=hit)
        return torch.autograd.grad(outs, inputs, (g_rgb, g_depth, g_acc),
                                   allow_unused=True, materialize_grads=True)


# --------------------------------------------------------------------------
# plain versions of the bfloat16 mode (the Pallas kernels at dtype=bfloat16)
# --------------------------------------------------------------------------

def encode_bf16(x, degree: int, exact_pe: bool = False):
    """The encoding the bfloat16 kernels read: by the doubling recurrence
    (pallas_field.py:_pe_for_dtype; exact_pe: the exact sines and cosines,
    as the kernels that encode in place, A11a and A11b, and the training
    kernels, A5 and A6), rounded to bfloat16."""
    pe = positional_encoding if exact_pe else positional_encoding_doubling
    return bf16_round(pe(x, degree))


def decoder_chain_bf16(wts: DecoderWeights, xpe, hdir, zs, zt):
    """decoder_chain in the bfloat16 mode (pallas_field.py:
    _field_chain_to_heads and the heads at dtype=bfloat16): each dense
    layer's input rounded to bfloat16 (the weights are, from the pack),
    float32 sums, float32 biases added after; each latent added in float32
    before its layer's rounding. xpe: the rounded encodings (encode_bf16)
    (B,...,d_xyz); hdir: the viewdir layer's direction term (float32),
    broadcastable to (B,...,W) -> (sigma (B,...), rgb (B,...,3))."""
    r = bf16_round
    mid = (slice(None),) + (None,) * (xpe.dim() - 2)
    y = F.relu(xpe @ wts.w_xyz + wts.b_xyz)
    for j in range(wts.n_shape):
        y = F.relu(r(y + zs[mid + (j,)]) @ wts.w_sh[j] + wts.b_sh[j])
    e = r(y) @ wts.w_es + wts.b_es
    sigma = F.softplus(r(e) @ wts.w_sg + wts.b_sg)
    h = F.relu(r(e) @ wts.w_vd_a + hdir + wts.b_vd)
    for j in range(wts.n_tex):
        h = F.relu(r(h + zt[mid + (j,)]) @ wts.w_tx[j] + wts.b_tx[j])
    rgb = r(F.relu(r(h) @ wts.w_r1 + wts.b_r1)) @ wts.w_r2 + wts.b_r2
    return sigma, rgb


def check_pe(pe: str):
    if pe not in PE_MODES:
        raise ValueError(f"pe {pe!r}: one of {PE_MODES}")


def render_direction_bf16(wts: DecoderWeights, viewdir, pe: str = "doubling"):
    """The render kernels' per-ray direction input in the bfloat16 mode with
    the encodings `pe` (PE_MODES): (dpe, hdir), the rounded encoding
    (B,R,d_dir) and the viewdir layer's direction term dpe @ w_vd_b (B,R,W),
    rounded before the per-ray term is expanded to the samples
    (pallas_render.py:_render_kernel's dir_term and the training backward's
    seg_expand); not rounded with "exact" (A11a, whose split matmuls sum it
    in float32)."""
    check_pe(pe)
    dpe = encode_bf16(viewdir, wts.num_dir_freq, pe != "doubling")
    hdir = dpe @ wts.w_vd_b
    return dpe, hdir if pe == "exact" else bf16_round(hdir)


def decoder_plain_bf16(wts: DecoderWeights, xyz, viewdir, zs, zt, pe: str = "doubling"):
    """decoder_plain in the bfloat16 mode with the encodings `pe`
    (PE_MODES: "doubling" for A1 and A3, "exact" for A11a,
    field_composite_pallas(pe_in_kernel=True), "train" for A5): xyz
    (B,R,S,3), viewdir (B,R,3) per ray -> (sigma (B,R,S), rgb (B,R,S,3))."""
    _, hdir = render_direction_bf16(wts, viewdir, pe)
    return decoder_chain_bf16(wts, encode_bf16(xyz, wts.num_xyz_freq, pe != "doubling"),
                              hdir[:, :, None], zs, zt)


def recompute_bf16(wts: DecoderWeights, xpe, hdir, zs, zt) -> dict:
    """The backward kernels' forward recompute in the bfloat16 mode
    (pallas_render.py:_render_bwd_kernel, pallas_field.py:_field_bwd_kernel):
    decoder_chain_bf16 with each ReLU layer's output rounded to bfloat16
    (the stash), so the next layer adds its latent to the rounded value and
    rounds again; not the forward's bits. Returns the stashed outputs y0,
    ys (shape blocks), e (encoding_shape's, rounded), v (viewdir layer), hs
    (texture blocks), hh (rgb_hidden), the sigma head's pre-activation logit
    and rgb."""
    r = bf16_round
    mid = (slice(None),) + (None,) * (xpe.dim() - 2)
    y0 = r(F.relu(xpe @ wts.w_xyz + wts.b_xyz))
    ys, y = [], y0
    for j in range(wts.n_shape):
        y = r(F.relu(r(y + zs[mid + (j,)]) @ wts.w_sh[j] + wts.b_sh[j]))
        ys.append(y)
    e = r(y @ wts.w_es + wts.b_es)
    v = r(F.relu(e @ wts.w_vd_a + hdir + wts.b_vd))
    hs, h = [], v
    for j in range(wts.n_tex):
        h = r(F.relu(r(h + zt[mid + (j,)]) @ wts.w_tx[j] + wts.b_tx[j]))
        hs.append(h)
    hh = r(F.relu(h @ wts.w_r1 + wts.b_r1))
    return {"y0": y0, "ys": ys, "e": e, "v": v, "hs": hs, "hh": hh,
            "logit": e @ wts.w_sg + wts.b_sg, "rgb": hh @ wts.w_r2 + wts.b_r2}


def transposed_bf16(wts: DecoderWeights, rec: dict, g_sig, drgb, dims, pre=None):
    """The backward kernels' transposed chain in the bfloat16 mode: each
    layer's cotangent rounded to bfloat16 before its product (mm_t), the
    ReLU masks from the stashed outputs of recompute_bf16. g_sig: the sigma
    head's pre-activation cotangent, drgb the rgb cotangent (B,...,3);
    dims: the point axes the latents' cotangents sum over. Returns (gpe,
    gdir, dzs (B,n_shape,W), dzt (B,n_tex,W)): gpe the point encodings'
    cotangent (B,...,d_xyz), gdir the direction encodings' per point
    (B,...,d_dir), both float32. pre: a dict that receives each layer's
    pre-activation gradient, unrounded float32 (the training stash's g_*
    rows, keyed as stashed_chain's pre: xyz, sh{j}, e, v, tx{j}, hh)."""
    r = bf16_round
    pre = {} if pre is None else pre
    pre["hh"] = torch.where(rec["hh"] > 0, r(drgb) @ wts.w_r2.t(), 0.0)
    g = r(pre["hh"]) @ wts.wt_r1
    dzt = [None] * wts.n_tex
    for j in reversed(range(wts.n_tex)):
        pre[f"tx{j}"] = torch.where(rec["hs"][j] > 0, g, 0.0)
        g = r(pre[f"tx{j}"]) @ wts.wt_tx[j]
        dzt[j] = g.sum(dims)
    pre["v"] = torch.where(rec["v"] > 0, g, 0.0)
    g_v = r(pre["v"])
    pre["e"] = g_v @ wts.wt_vd_a + r(g_sig)[..., None] * wts.w_sg
    g = r(pre["e"]) @ wts.wt_es
    dzs = [None] * wts.n_shape
    for j in reversed(range(wts.n_shape)):
        pre[f"sh{j}"] = torch.where(rec["ys"][j] > 0, g, 0.0)
        g = r(pre[f"sh{j}"]) @ wts.wt_sh[j]
        dzs[j] = g.sum(dims)
    pre["xyz"] = torch.where(rec["y0"] > 0, g, 0.0)
    gpe = r(pre["xyz"]) @ wts.wt_xyz
    return gpe, g_v @ wts.wt_vd_b, torch.stack(dzs, 1), torch.stack(dzt, 1)


def encode_bwd_bf16(pe, g, degree: int):
    """The encoding's chain rule in the bfloat16 mode
    (pallas_field.py:_pe_bwd_from_streamed): the sines and cosines are the
    rounded encoding pe the forward read, each term cos g_sin - sin g_cos
    is rounded to bfloat16 before its 2^i weight (the ladder matmul):
    (..., d) cotangents g -> (..., 3)."""
    L3 = 3 * degree
    s, c = pe[..., 3:3 + L3], pe[..., 3 + L3:]
    dxx = bf16_round(c * g[..., 3:3 + L3] - s * g[..., 3 + L3:])
    freq = (2.0 ** torch.arange(degree, dtype=g.dtype, device=g.device)).repeat_interleave(3)
    return g[..., :3] + (dxx * freq).reshape(*dxx.shape[:-1], degree, 3).sum(-2)


def composite_vjp_bf16(sigma, rgb, z, white_bkgd, g_rgb, g_depth, g_acc):
    """The compositing replay and its manual VJP of
    pallas_render.py:_render_bwd_kernel (stable product form) with the rgb
    cotangent rounded to bfloat16 per ray (its seg_expand), except in the
    white background's term. sigma (B,R,S) the density (zero for a missed
    ray), rgb (B,R,S,3), z (B,R,S); cotangents (B,R,3), (B,R), (B,R).
    Returns (dsig, drgb, dz): the density's cotangent where it is positive,
    the colours' (B,R,S,3) and the per-ray z cotangent (B,R,S)."""
    delta = torch.cat([z[..., 1:] - z[..., :-1], torch.full_like(z[..., :1], LAST_DELTA)], -1)
    alpha = 1.0 - torch.exp(-F.relu(sigma) * delta)
    tt = F.relu(1.0 - alpha) + EPS_TRANS
    t_excl = F.pad(torch.cumprod(tt, -1)[..., :-1], (1, 0), value=1.0)
    w = alpha * t_excl
    g_pts = bf16_round(g_rgb)[..., None, :]
    gw = (g_pts * rgb).sum(-1) + g_depth[..., None] * z
    if white_bkgd:
        gw = gw - g_rgb.sum(-1, keepdim=True)
    suffix = F.pad(torch.flip(torch.cumsum(torch.flip((gw * w)[..., 1:], [-1]), -1), [-1]),
                   (0, 1))                                   # sum over i > s of gw_i w_i
    not_last = torch.ones_like(z)
    not_last[..., -1] = 0.0
    de = (suffix + g_acc[..., None] * t_excl[..., -1:] * not_last) / tt - gw * t_excl
    e_val = 1.0 - alpha
    dsig = torch.where(sigma > 0, de * (-delta) * e_val, 0.0)
    dd = de * (-F.relu(sigma)) * e_val * not_last
    return dsig, w[..., None] * g_pts, g_depth[..., None] * w + F.pad(dd[..., :-1], (1, 0)) - dd


def render_bwd_plain_bf16(wts: DecoderWeights, xyz, viewdir, z, zs, zt, white_bkgd,
                          g_rgb, g_depth, g_acc, hit=None, pe="doubling", stash=None):
    """K2's plain version in the bfloat16 mode: the backward kernel's own
    arithmetic (pallas_render.py:_render_bwd_kernel at dtype=bfloat16), not
    autograd through the forward: recompute_bf16 (the stash), the
    compositing VJP with the per-ray rgb cotangent rounded, transposed_bf16,
    and the encodings' chain rules, the per-point direction cotangents
    rounded before their sum over the ray (its seg_reduce). Returns (dxyz,
    dviewdir, dz, dzs, dzt) as render_bwd_plain. pe: the encodings
    (PE_MODES; "train" for K3, pallas_render.py:_render_train_bwd_kernel,
    which runs this arithmetic on the training encodings); stash: a dict
    that receives the encodings (xpe, dpe), recompute_bf16's dict (rec),
    the sigma head's and the colours' cotangents (g_sig, drgb) and
    transposed_bf16's pre-activation gradients (pre)."""
    xpe = encode_bf16(xyz, wts.num_xyz_freq, pe != "doubling")
    dpe, hdir = render_direction_bf16(wts, viewdir, pe)
    rec = recompute_bf16(wts, xpe, hdir[:, :, None], zs, zt)
    sigma = F.softplus(rec["logit"])
    if hit is None:
        z = z[:, None, :].expand_as(sigma)
    else:
        sigma = torch.where(hit[..., None] != 0, sigma, torch.zeros_like(sigma))
    dsig, drgb, dz = composite_vjp_bf16(sigma, rec["rgb"], z, white_bkgd, g_rgb, g_depth, g_acc)
    g_sig = dsig * torch.sigmoid(rec["logit"])
    pre = {}
    gpe, gdir, dzs, dzt = transposed_bf16(wts, rec, g_sig, drgb, (1, 2), pre)
    if stash is not None:
        stash.update(xpe=xpe, dpe=dpe, rec=rec, g_sig=g_sig, drgb=drgb, pre=pre)
    return (encode_bwd_bf16(xpe, gpe, wts.num_xyz_freq),
            encode_bwd_bf16(dpe, bf16_round(gdir).sum(2), wts.num_dir_freq),
            dz.sum(1) if hit is None else dz, dzs, dzt)


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
    # the bfloat16 builds: the weight tiles after the weights (K1 also takes
    # its PE_MODES index after hit)
    head16 = head[:6] + [p] + head[6:]
    lib.supnerf_render_fwd_bf16.argtypes = head16 + [i, p, i] + [p] * 3 + [p]
    lib.supnerf_render_fwd_bf16.restype = i
    lib.supnerf_render_bwd_bf16.argtypes = head16 + [i, p] + [p] * 3 + [p] * 5 + [p]
    lib.supnerf_render_bwd_bf16.restype = i
    lib.supnerf_render_train_bwd.argtypes = (head + [p] * 3 + [ctypes.POINTER(_StashLayout)]
                                             + [p] * 6)
    lib.supnerf_render_train_bwd.restype = i
    lib.supnerf_render_train_bwd_bf16.argtypes = lib.supnerf_render_train_bwd.argtypes
    lib.supnerf_render_train_bwd_bf16.restype = i
    for fn in ("supnerf_wgrad", "supnerf_wgrad_bf16"):
        getattr(lib, fn).argtypes = [ctypes.POINTER(_WgradProblem), i, i, p]
        getattr(lib, fn).restype = i
    field = [p] * 4 + [ctypes.POINTER(_DecoderPtrs)] + [i] * 7
    lib.supnerf_field_fwd.argtypes = field + [p] * 3
    lib.supnerf_field_fwd.restype = i
    lib.supnerf_field_bwd.argtypes = field + [p] * 7
    lib.supnerf_field_bwd.restype = i
    lib.supnerf_field_fwd_bf16.argtypes = field + [p] * 2 + [i, p]
    lib.supnerf_field_fwd_bf16.restype = i
    lib.supnerf_field_bwd_bf16.argtypes = field + [p] * 7
    lib.supnerf_field_bwd_bf16.restype = i
    lib.supnerf_field_train_bwd.argtypes = field + [p] * 2 + [ctypes.POINTER(_StashLayout)] + [p] * 5
    lib.supnerf_field_train_bwd.restype = i
    lib.supnerf_field_train_bwd_bf16.argtypes = lib.supnerf_field_train_bwd.argtypes
    lib.supnerf_field_train_bwd_bf16.restype = i
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


def _tiles_operand(wts: DecoderWeights, device) -> list:
    """The weight tiles argument of the bfloat16 builds of K1 and K2 ([]
    in the float32 mode); raises ValueError unless the pack's tiles are
    bf16_tile_pack's, on `device`."""
    if wts.field_dtype != "bfloat16":
        return []
    t = wts.tiles
    if (t is None or t.dtype != torch.bfloat16 or t.device != device or not t.is_contiguous()
            or t.numel() != bf16_tile_count(wts)):
        raise ValueError("a bfloat16 pack needs its weight tiles (bf16_tile_pack) on "
                         f"{device}: build it with pack_decoder_params or with_field_dtype")
    return [t.data_ptr()]


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


def launch_key(name: str, wts: DecoderWeights, hit=None, pe="doubling") -> str:
    """The LAUNCHES key of kernel `name` (render_fwd, render_bwd, field_fwd,
    field_bwd, field_train_bwd) in wts' mode: _aabb with hit, _bf16 in the
    bfloat16 mode, render_fwd_train_bf16 and field_fwd_train_bf16 for K1's
    and K5's bfloat16 builds on the training encodings (pe "train")."""
    bf16 = wts.field_dtype == "bfloat16"
    if bf16 and pe == "train":
        return name + "_train_bf16"
    return name + ("_aabb" if hit is not None else "") + ("_bf16" if bf16 else "")


def render_fwd(wts: DecoderWeights, xyz, viewdir, z, zs, zt, white_bkgd=False, hit=None,
               pe="doubling"):
    """K1 wrapper. Returns (rgb (B,R,3), depth (B,R), acc_trans (B,R)).
    With hit (B,R) (bool or float, nonzero for a hit) it runs the AABB mode:
    z is per ray (B,R,S) and missed rays have zero density. In wts'
    bfloat16 mode it launches K1's bfloat16 build with the encodings `pe`
    (PE_MODES; "train" counted as render_fwd_train_bf16)."""
    check_pe(pe)
    if xyz.device.type == "cpu":
        return render_fwd_plain(wts, xyz, viewdir, z, zs, zt, white_bkgd, hit, pe)
    hit = _hit_operand(hit)
    _check_inputs(wts, xyz, viewdir, z, zs, zt, hit=hit)
    B, R = xyz.shape[:2]
    rgb = torch.empty((B, R, 3), device=xyz.device)
    depth = torch.empty((B, R), device=xyz.device)
    acc = torch.empty((B, R), device=xyz.device)
    ptrs = _ptrs(wts)
    bf16 = wts.field_dtype == "bfloat16"
    with torch.cuda.device(xyz.device):     # the runtime launches on its current device
        err = getattr(_library(), "supnerf_render_fwd" + ("_bf16" if bf16 else ""))(
            xyz.data_ptr(), viewdir.data_ptr(), z.data_ptr(), zs.data_ptr(), zt.data_ptr(),
            ctypes.byref(ptrs), *_tiles_operand(wts, xyz.device), *_dims(wts, xyz, white_bkgd),
            *_mode_args(hit), *([PE_MODES.index(pe)] if bf16 else []),
            rgb.data_ptr(), depth.data_ptr(), acc.data_ptr(),
            torch.cuda.current_stream(xyz.device).cuda_stream)
    _raise_on(err, "render_fwd")
    LAUNCHES[launch_key("render_fwd", wts, hit, pe)] += 1
    return rgb, depth, acc


def render_bwd(wts: DecoderWeights, xyz, viewdir, z, zs, zt, white_bkgd,
               g_rgb, g_depth, g_acc, hit=None):
    """K2 wrapper. Returns (dxyz (B,R,S,3), dviewdir (B,R,3), dz (B,S),
    dzs (B,n_shape,W), dzt (B,n_tex,W)). The kernel writes per-ray partial
    sums of dz, dzs and dzt; summing them over rays here is the second,
    deterministic pass of the cross-block reduction. With hit (the AABB
    mode) z and dz are per ray, (B,R,S), and dz is returned unsummed. In
    wts' bfloat16 mode it launches K2's bfloat16 build."""
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
        err = getattr(_library(), "supnerf_render_bwd"
                      + ("_bf16" if wts.field_dtype == "bfloat16" else ""))(
            xyz.data_ptr(), viewdir.data_ptr(), z.data_ptr(), zs.data_ptr(), zt.data_ptr(),
            ctypes.byref(ptrs), *_tiles_operand(wts, dev), *_dims(wts, xyz, white_bkgd),
            *_mode_args(hit), g_rgb.data_ptr(), g_depth.data_ptr(), g_acc.data_ptr(),
            dxyz.data_ptr(), dvd.data_ptr(), dzs_part.data_ptr(), dzt_part.data_ptr(),
            dz_part.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "render_bwd")
    LAUNCHES[launch_key("render_bwd", wts, hit)] += 1
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
    into no output. The bfloat16 mode keeps the layout: every a_* column
    and r_dpe holds bfloat16-exact values (the operands
    pallas_render.py:_render_train_bwd_kernel's mm_xg casts: the rounded
    encodings, the ReLU outputs rounded, each latent-added layer input
    rounded once more after the float32 add), the g_* columns and r_gv
    (the ray's sum of the rounded g_v) stay float32, since the biases sum
    the unrounded cotangents; K4 rounds G where it enters a product."""
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


def wgrad_plain(problems, accumulate: bool = False, field_dtype: str = "float32"):
    """K4's plain version: G^T A and the column sums of G, in place. In the
    bfloat16 mode the product takes both operands rounded to bfloat16
    (float32 sums, pallas_render.py:_render_train_bwd_kernel's mm_xg) and
    the bias sums the unrounded G (its jnp.sum(g, 0))."""
    bf16 = field_dtype == "bfloat16"
    for p in problems:
        K = p.A.shape[1]
        a, g = (bf16_round(p.A), bf16_round(p.G)) if bf16 else (p.A, p.G)
        pairs = [(p.w_out[:, p.col0:p.col0 + K], g.t() @ a)]
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


def wgrad(problems, accumulate: bool = False, field_dtype: str = "float32"):
    """K4 wrapper: every problem's weight and bias gradient in one grouped
    launch (plus its fixed-order reduction pass), written into (or, with
    accumulate, added to) w_out and b_out; in the bfloat16 mode on
    bfloat16 mma.sync (wgrad_plain's rounding; LAUNCHES["wgrad_bf16"])."""
    dev = problems[0].A.device
    if dev.type == "cpu":
        return wgrad_plain(problems, accumulate, field_dtype)
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
    key = "wgrad_bf16" if field_dtype == "bfloat16" else "wgrad"
    with torch.cuda.device(dev):
        err = getattr(_library(), "supnerf_" + key)(table, len(problems), int(bool(accumulate)),
                                                   torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, key)
    LAUNCHES[key] += 1


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
    the rows written into pt and ray as stash_layout places them (in the
    bfloat16 mode the kernel's own arithmetic, train_bwd_stash_plain_bf16).
    Returns (dzs, dzt), and with data_grads (dxyz, dviewdir, dz) after
    them."""
    if wts.field_dtype == "bfloat16":
        return train_bwd_stash_plain_bf16(wts, xyz, viewdir, z, zs, zt, white_bkgd, g_rgb,
                                          g_depth, g_acc, pt, ray, data_grads)
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


def train_bwd_stash_plain_bf16(wts: DecoderWeights, xyz, viewdir, z, zs, zt, white_bkgd,
                               g_rgb, g_depth, g_acc, pt, ray, data_grads: bool = False):
    """K3's plain version in the bfloat16 mode
    (pallas_render.py:_render_train_bwd_kernel at dtype=bfloat16): K2's
    bfloat16 arithmetic (render_bwd_plain_bf16) on the training encodings
    (pe "train"), its values written into pt and ray as stash_layout places
    them: the A side bfloat16-exact (the encodings, the stashed ReLU outputs
    and e, each latent-added input rounded after its float32 add), the G
    side the unrounded float32 pre-activation gradients, the colours'
    cotangent w * bf16(g_rgb) and the sigma head's; per ray the rounded
    direction encoding and the sum over its samples of the rounded g_v
    (seg_reduce). Returns (dzs, dzt), and with data_grads (dxyz, dviewdir,
    dz) after them."""
    r, W = bf16_round, wts.W
    st = {}
    with torch.no_grad():
        dxyz, dvd, dz, dzs, dzt = render_bwd_plain_bf16(wts, xyz, viewdir, z, zs, zt, white_bkgd,
                                                        g_rgb, g_depth, g_acc, pe="train",
                                                        stash=st)
        write_stash_bf16(wts, st, zs, zt, pt)
        pre, L = st["pre"], stash_layout(wts)
        dpe = st["dpe"]
        ray[:, L["r_dpe"]:L["r_dpe"] + dpe.shape[-1]] = dpe.reshape(-1, dpe.shape[-1])
        ray[:, L["r_gv"]:L["r_gv"] + W] = r(pre["v"]).sum(2).reshape(-1, W)
    return (dzs, dzt, dxyz, dvd, dz) if data_grads else (dzs, dzt)


def write_stash_bf16(wts: DecoderWeights, st: dict, zs, zt, pt, per_point: bool = False):
    """The point rows of a stash plain version in the bfloat16 mode, written
    into pt at stash_layout(per_point)'s columns from st, the backward's
    values (render_bwd_plain_bf16's stash dict: the rounded encodings xpe
    (and with per_point dpe), recompute_bf16's rec, transposed_bf16's pre,
    g_sig, drgb): the A side bfloat16-exact (the encodings, the stashed
    ReLU outputs and e, each latent-added input rounded after its float32
    add: the operands the Pallas kernels' mm_xg casts), the G side the
    unrounded float32 pre-activation gradients and the sigma head's and the
    colours' cotangents."""
    r, ns, nt = bf16_round, wts.n_shape, wts.n_tex
    rec, pre = st["rec"], st["pre"]
    mid = (slice(None),) + (None,) * (st["xpe"].dim() - 2)
    inputs_sh = [rec["y0"]] + rec["ys"][:-1]
    inputs_tx = [rec["v"]] + rec["hs"][:-1]
    rows = {"a_xyz": st["xpe"], "a_es": rec["ys"][-1], "a_e": rec["e"],
            "a_r1": rec["hs"][-1], "a_hh": rec["hh"],
            "a_sh": torch.cat([r(inputs_sh[j] + zs[mid + (j,)]) for j in range(ns)], -1),
            "a_tx": torch.cat([r(inputs_tx[j] + zt[mid + (j,)]) for j in range(nt)], -1),
            "g_xyz": pre["xyz"], "g_e": pre["e"], "g_sig": st["g_sig"][..., None],
            "g_v": pre["v"], "g_hh": pre["hh"], "g_rgb": st["drgb"],
            "g_sh": torch.cat([pre[f"sh{j}"] for j in range(ns)], -1),
            "g_tx": torch.cat([pre[f"tx{j}"] for j in range(nt)], -1)}
    if per_point:
        rows["a_dpe"] = st["dpe"]
    L = stash_layout(wts, per_point)
    with torch.no_grad():
        for name, t in rows.items():
            pt[:, L[name]:L[name] + t.shape[-1]] = t.reshape(-1, t.shape[-1])


def render_train_bwd_stash(wts: DecoderWeights, xyz, viewdir, z, zs, zt, white_bkgd,
                           g_rgb, g_depth, g_acc, pt, ray, data_grads: bool = False):
    """K3 wrapper: writes the stash rows of these B objects into pt
    (B*R*S, ld_pt) and ray (B*R, ld_ray) and returns (dzs (B,n_shape,W),
    dzt (B,n_tex,W)), summed over rays here (the second, deterministic pass
    of that reduction). With data_grads it runs K3's data mode
    (LAUNCHES["render_train_bwd_data"]) and also returns (dxyz (B,R,S,3),
    dviewdir (B,R,3), dz (B,S)), dz summed over rays here too; the stash,
    dzs and dzt are the same bits in both modes. In wts' bfloat16 mode it
    launches K3's bfloat16 build (counted as render_train_bwd_bf16 and
    render_train_bwd_data_bf16)."""
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
    bf16 = "_bf16" if wts.field_dtype == "bfloat16" else ""
    with torch.cuda.device(dev):
        err = getattr(_library(), "supnerf_render_train_bwd" + bf16)(
            xyz.data_ptr(), viewdir.data_ptr(), z.data_ptr(), zs.data_ptr(), zt.data_ptr(),
            ctypes.byref(ptrs), *_dims(wts, xyz, white_bkgd),
            g_rgb.data_ptr(), g_depth.data_ptr(), g_acc.data_ptr(), ctypes.byref(layout),
            dzs_part.data_ptr(), dzt_part.data_ptr(),
            *[t.data_ptr() if t is not None else None for t in data],
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "render_train_bwd" + bf16)
    LAUNCHES["render_train_bwd" + ("_data" if data_grads else "") + bf16] += 1
    out = (dzs_part.sum(1), dzt_part.sum(1))
    return out + (data[0], data[1], data[2].sum(1)) if data_grads else out


def render_train_bwd_plain(wts: DecoderWeights, xyz, viewdir, z, zs, zt, white_bkgd,
                           g_rgb, g_depth, g_acc, data_grads: bool = False):
    """K3 + K4's plain version: autograd through render_fwd_plain with the
    layer weights as inputs; in the bfloat16 mode, whose backward rounds
    its cotangents, K3's plain version then K4's (render_train_bwd's
    chunks). Returns (dzs, dzt, grads), grads in the order and Linear layout
    of linear_params_of, and with data_grads (dxyz, dviewdir, dz) after
    them."""
    if wts.field_dtype == "bfloat16":
        return _train_bwd_chunks(render_train_bwd_stash_plain, wgrad_plain, wts, xyz, viewdir,
                                 z, zs, zt, white_bkgd, g_rgb, g_depth, g_acc, data_grads)
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
    return _train_bwd_chunks(render_train_bwd_stash, wgrad, wts, xyz, viewdir, z, zs, zt,
                             white_bkgd, g_rgb, g_depth, g_acc, data_grads)


def _train_bwd_chunks(stash_fn, wgrad_fn, wts: DecoderWeights, xyz, viewdir, z, zs, zt,
                      white_bkgd, g_rgb, g_depth, g_acc, data_grads):
    """stash_fn (K3 or its plain version) then wgrad_fn (K4 or its plain
    version) on each chunk of objects that fits STASH_BYTES, into one stash
    buffer; the weight gradients accumulated over chunks in order."""
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
        outs.append(stash_fn(wts, xyz[sl], viewdir[sl], z[sl], zs[sl], zt[sl], white_bkgd,
                             g_rgb[sl], g_depth[sl], g_acc[sl], pt_c, ray_c, data_grads))
        wgrad_fn(wgrad_problems(wts, pt_c, ray_c, grads), accumulate=o0 > 0,
                 field_dtype=wts.field_dtype)
    cat = [torch.cat(parts) for parts in zip(*outs)]
    return (cat[0], cat[1], grads) + tuple(cat[2:])


class FieldCompositeTrain(torch.autograd.Function):
    """(xyz, viewdir, z, zs, zt, decoder layer weights) -> (rgb, depth, acc)
    with K1 as the forward and K3 + K4 as the backward. The weights enter in
    torch.nn.Linear's layout (decoder_linear_params) and get their gradients
    in it, float32 and unrounded in either mode (in the bfloat16 mode the
    pack rounds the live weights each call, as pallas_render.py's
    _precast_weights, and their gradient is the rounded matrices'). meta:
    pack_linear_params' arguments after params. K1 runs the training
    encodings (pe "train"). xyz, viewdir and z get theirs from K3's data
    mode where autograd asks for them; with data_grads False they are data
    and must not ask."""

    @staticmethod
    def forward(ctx, xyz, viewdir, z, zs, zt, meta, white_bkgd, data_grads, *params):
        if not data_grads and any(ctx.needs_input_grad[:3]):
            raise ValueError("the training render with data_grads=False gives no gradient "
                             "for xyz, viewdir or z")
        wts = pack_linear_params(params, *meta)
        ctx.save_for_backward(xyz, viewdir, z, zs, zt)
        ctx.wts, ctx.white_bkgd = wts, white_bkgd
        return render_fwd(wts, xyz, viewdir, z, zs, zt, white_bkgd, pe="train")

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
    versions inside the same wrappers for CPU tensors, in the decoder's
    field_dtype (the latent projections float32 in both, as
    pallas_field.py:conditioned_latents_batched). Raises ValueError for a
    decoder that is not kernel-compatible (decoder_kernel_compatible)."""
    check_kernel_decoder(decoder)
    if viewdir.dim() == 4:
        viewdir = viewdir[:, :, 0]
    zs, zt = conditioned_latents_of(decoder, shapecode, texturecode)
    meta = (decoder.shape_blocks, decoder.texture_blocks, decoder.num_xyz_freq,
            decoder.num_dir_freq, None, decoder.field_dtype)
    return FieldCompositeTrain.apply(xyz.contiguous(), viewdir.contiguous(), z.contiguous(),
                                     zs.contiguous(), zt.contiguous(), meta, white_bkgd,
                                     data_grads, *decoder_linear_params(decoder))
