"""The per-point conditioned field on hand-written CUDA kernels, their plain
PyTorch versions, and the autograd.Function that joins them; the port of the
parts of supnerf_tpu/ops/pallas_field.py the TTO regularisers use
(field_forward_pallas, field_apply_pallas).

  field_fwd  (K5, csrc/field_fwd.cu): the decoder on every point, no
             compositing -> sigma (B,M,1), rgb (B,M,3). Ports A7
             (_field_kernel, encodings streamed) and A11b
             (_field_kernel_raw, encodings in the kernel): K5 always encodes
             in the kernel from the raw points and directions.
  field_bwd  (K6, csrc/field_bwd.cu): the frozen-decoder backward of K5,
             (dsigma, drgb) -> dxyz, dviewdir (B,M,3), dzs (B,n_shape,W),
             dzt (B,n_tex,W) (A8, _field_bwd_kernel).

Shapes: objects B along axis 0, M points per object, each with its own view
direction (xyz, viewdir (B,M,3)), latent projections zs (B,n_shape,W), zt
(B,n_tex,W). Everything is float32. The kernels share ops/render.py's
decoder operands, build, library and launch counts (LAUNCHES["field_fwd"],
LAUNCHES["field_bwd"]).

Each wrapper takes its plain version for tensors on the CPU, and only then.
For CUDA tensors it launches its kernel or raises; there is no fallback.
FieldApply freezes the decoder (test-time optimization): the weights get no
gradient.
"""
from __future__ import annotations

import ctypes

import torch

from supnerf_tpu_torch.models.nerf_mlp import positional_encoding
from supnerf_tpu_torch.ops.render import (
    LAUNCHES,
    DecoderWeights,
    _library,
    _ptrs,
    _raise_on,
    check_operands,
    conditioned_latents,
    decoder_chain,
)

ROWS = 64          # points per block of K5 and K6 (kRows in csrc/render_common.cuh)


def field_fwd_plain(wts: DecoderWeights, xyz, viewdir, zs, zt):
    """K5's plain version: the decoder as matmuls with a per-point view
    direction. xyz, viewdir (B,M,3) -> (sigma (B,M,1), rgb (B,M,3))."""
    hdir = positional_encoding(viewdir, wts.num_dir_freq) @ wts.w_vd_b
    sigma, rgb = decoder_chain(wts, xyz, hdir, zs, zt)
    return sigma[..., None], rgb


def field_bwd_plain(wts: DecoderWeights, xyz, viewdir, zs, zt, g_sigma, g_rgb):
    """K6's plain version: autograd through field_fwd_plain.
    Returns (dxyz, dviewdir, dzs, dzt)."""
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_(True) for t in (xyz, viewdir, zs, zt)]
        outs = field_fwd_plain(wts, *inputs)
        return torch.autograd.grad(outs, inputs, (g_sigma, g_rgb), allow_unused=True,
                                   materialize_grads=True)


def _check_field_inputs(wts: DecoderWeights, xyz, viewdir, zs, zt, *grads):
    B, M = xyz.shape[:2]
    expect = {"xyz": (xyz, (B, M, 3)), "viewdir": (viewdir, (B, M, 3)),
              "zs": (zs, (B, wts.n_shape, wts.W)), "zt": (zt, (B, wts.n_tex, wts.W))}
    for name, t, width in zip(("g_sigma", "g_rgb"), grads, (1, 3)):
        expect[name] = (t, (B, M, width))
    check_operands(wts, expect, xyz.device)
    if M < 1:
        raise ValueError("the field kernels take at least one point per object")


def _dims(wts: DecoderWeights, xyz):
    B, M = xyz.shape[:2]
    return [B, M, wts.W, wts.n_shape, wts.n_tex, wts.num_xyz_freq, wts.num_dir_freq]


def field_fwd(wts: DecoderWeights, xyz, viewdir, zs, zt):
    """K5 wrapper. Returns (sigma (B,M,1), rgb (B,M,3))."""
    if xyz.device.type == "cpu":
        return field_fwd_plain(wts, xyz, viewdir, zs, zt)
    _check_field_inputs(wts, xyz, viewdir, zs, zt)
    B, M = xyz.shape[:2]
    sigma = torch.empty((B, M, 1), device=xyz.device)
    rgb = torch.empty((B, M, 3), device=xyz.device)
    ptrs = _ptrs(wts)
    with torch.cuda.device(xyz.device):     # the runtime launches on its current device
        err = _library().supnerf_field_fwd(
            xyz.data_ptr(), viewdir.data_ptr(), zs.data_ptr(), zt.data_ptr(),
            ctypes.byref(ptrs), *_dims(wts, xyz), sigma.data_ptr(), rgb.data_ptr(),
            torch.cuda.current_stream(xyz.device).cuda_stream)
    _raise_on(err, "field_fwd")
    LAUNCHES["field_fwd"] += 1
    return sigma, rgb


def field_bwd(wts: DecoderWeights, xyz, viewdir, zs, zt, g_sigma, g_rgb):
    """K6 wrapper. Returns (dxyz (B,M,3), dviewdir (B,M,3), dzs
    (B,n_shape,W), dzt (B,n_tex,W)). The kernel writes per-block partial
    sums of dzs and dzt; summing them over blocks here is the second,
    deterministic pass of the cross-block reduction."""
    if xyz.device.type == "cpu":
        return field_bwd_plain(wts, xyz, viewdir, zs, zt, g_sigma, g_rgb)
    _check_field_inputs(wts, xyz, viewdir, zs, zt, g_sigma, g_rgb)
    B, M = xyz.shape[:2]
    dev = xyz.device
    nblk = -(-M // ROWS)
    dxyz = torch.empty_like(xyz)
    dvd = torch.empty_like(viewdir)
    dzs_part = torch.empty((B, nblk, wts.n_shape, wts.W), device=dev)
    dzt_part = torch.empty((B, nblk, wts.n_tex, wts.W), device=dev)
    ptrs = _ptrs(wts)
    with torch.cuda.device(dev):
        err = _library().supnerf_field_bwd(
            xyz.data_ptr(), viewdir.data_ptr(), zs.data_ptr(), zt.data_ptr(),
            ctypes.byref(ptrs), *_dims(wts, xyz), g_sigma.data_ptr(), g_rgb.data_ptr(),
            dxyz.data_ptr(), dvd.data_ptr(), dzs_part.data_ptr(), dzt_part.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "field_bwd")
    LAUNCHES["field_bwd"] += 1
    return dxyz, dvd, dzs_part.sum(1), dzt_part.sum(1)


class FieldApply(torch.autograd.Function):
    """(xyz, viewdir, zs, zt) -> (sigma, rgb) with K5 as the forward and K6
    as the backward; the decoder weights are constants (the counterpart of
    field_apply_pallas's custom_vjp, whose weight cotangent is zero)."""

    @staticmethod
    def forward(ctx, xyz, viewdir, zs, zt, wts):
        ctx.save_for_backward(xyz, viewdir, zs, zt)
        ctx.wts = wts
        return field_fwd(wts, xyz, viewdir, zs, zt)

    @staticmethod
    def backward(ctx, g_sigma, g_rgb):
        xyz, viewdir, zs, zt = ctx.saved_tensors
        grads = field_bwd(ctx.wts, xyz, viewdir, zs, zt, g_sigma.contiguous(),
                          g_rgb.contiguous())
        return (*grads, None)


def _flat(t):
    return t.reshape(t.shape[0], -1, 3).contiguous()


def field_apply(wts: DecoderWeights, xyz, viewdir, shapecode, texturecode):
    """The differentiable field of B objects (counterpart of
    field_apply_pallas, batched over objects where the JAX package vmaps
    one): xyz, viewdir (B,...,3), codes (B, latent) -> (sigma (B,...,1),
    rgb (B,...,3)), through FieldApply (the kernels for CUDA tensors, the
    plain versions inside the same wrappers for CPU tensors). Gradients
    reach the points, the view directions and, through the latent
    projections, the codes; the decoder gets none."""
    lead = xyz.shape[:-1]
    zs, zt = conditioned_latents(wts, shapecode, texturecode)
    sigma, rgb = FieldApply.apply(_flat(xyz), _flat(viewdir), zs.contiguous(), zt.contiguous(),
                                  wts)
    return sigma.reshape(*lead, 1), rgb.reshape(*lead, 3)


@torch.no_grad()
def field_forward(wts: DecoderWeights, xyz, viewdir, shapecode, texturecode):
    """Forward only (counterpart of field_forward_pallas): K5 on CUDA
    tensors, its plain version on CPU tensors; shapes as field_apply."""
    lead = xyz.shape[:-1]
    zs, zt = conditioned_latents(wts, shapecode, texturecode)
    sigma, rgb = field_fwd(wts, _flat(xyz), _flat(viewdir), zs.contiguous(), zt.contiguous())
    return sigma.reshape(*lead, 1), rgb.reshape(*lead, 3)
