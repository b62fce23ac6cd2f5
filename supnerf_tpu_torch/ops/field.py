"""The per-point conditioned field on hand-written CUDA kernels, their plain
PyTorch versions, and the autograd.Functions that join them; the port of
supnerf_tpu/ops/pallas_field.py's per-point entry points: field_forward_pallas
and field_apply_pallas (the TTO regularisers) and field_train_pallas (the
per-point training field).

  field_fwd        (K5, csrc/field_fwd.cu): the decoder on every point, no
                   compositing -> sigma (B,M,1), rgb (B,M,3). Ports A7
                   (_field_kernel, encodings streamed), A11b
                   (_field_kernel_raw, encodings in the kernel) and A9
                   (_field_train_fwd_kernel, A7 with per-object latents):
                   K5 always encodes in the kernel from the raw points and
                   directions, and always takes per-object latents.
  field_bwd        (K6, csrc/field_bwd.cu): the frozen-decoder backward of
                   K5, (dsigma, drgb) -> dxyz, dviewdir (B,M,3), dzs
                   (B,n_shape,W), dzt (B,n_tex,W) (A8, _field_bwd_kernel).
  field_train_bwd  (K7, csrc/field_train_bwd.cu + K4, csrc/wgrad.cu): the
                   training backward of K5 (A10, _field_train_bwd_kernel):
                   K6's outputs and every decoder weight and bias gradient.
                   K7 is K6's kernel body (render_common.cuh
                   field_backward) with a stash: each layer's input and
                   pre-activation-gradient rows (ops/render.py's
                   stash_layout, per-point mode), which K4 reduces.

K5, K6 and K7 run one forward chain (render_common.cuh field_chain), so
they take the same ReLU gates; asked with `gates` (gate_buffer), each
wrapper launches its kernel's build that also writes the gates it took
(csrc/field_gates.cu), for a check.

Shapes: objects B along axis 0, M points per object, each with its own view
direction (xyz, viewdir (B,M,3)), latent projections zs (B,n_shape,W), zt
(B,n_tex,W). Everything is float32. The kernels share ops/render.py's
decoder operands, build, library, stash layout, K4 and launch counts
(LAUNCHES["field_fwd"], ["field_bwd"], ["field_train_bwd"], ["wgrad"]).

Each wrapper takes its plain version for tensors on the CPU, and only then.
For CUDA tensors it launches its kernel or raises; there is no fallback.
FieldApply freezes the decoder (test-time optimization): the weights get no
gradient. FieldTrain trains it.
"""
from __future__ import annotations

import ctypes

import torch

from supnerf_tpu_torch.models.nerf_mlp import positional_encoding
from supnerf_tpu_torch.ops import render
from supnerf_tpu_torch.ops.render import (
    LAUNCHES,
    DecoderWeights,
    _leaves,
    _library,
    _linear_grad_buffers,
    _ptrs,
    _raise_on,
    check_operands,
    conditioned_latents,
    conditioned_latents_of,
    decoder_chain,
    decoder_linear_params,
    linear_params_of,
    pack_linear_params,
    stash_grads,
    stash_layout,
    stash_struct,
    stashed_chain,
    wgrad,
    wgrad_problems,
    write_stash,
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


def gate_buffer(wts: DecoderWeights, xyz):
    """A zeroed buffer for a field kernel's ReLU gates (the `gates` argument
    of field_fwd, field_bwd and field_train_bwd_stash): per point, the bit
    masks of its n_shape + n_tex + 3 ReLU layers (encoding_xyz, the shape
    blocks, viewdir, the texture blocks, rgb_hidden) as W/32 int32 words
    each, bit l of word j for unit 32 j + l (rgb_hidden's W/2 units in the
    first W/64 words). (B, M, n_shape + n_tex + 3, W/32) on xyz's device."""
    B, M = xyz.shape[:2]
    return torch.zeros((B, M, wts.n_shape + wts.n_tex + 3, wts.W // 32), dtype=torch.int32,
                       device=xyz.device)


def _gates_args(wts: DecoderWeights, xyz, gates):
    """The C entry's name suffix and extra arguments for gates: ("", []) for
    none, else ("_gates", [its pointer]) (csrc/field_gates.cu) once gates is
    checked against gate_buffer's shape on xyz's device. The plain versions
    keep no gates, so CPU tensors with gates raise."""
    if gates is None:
        return "", []
    if xyz.device.type == "cpu":
        raise ValueError("only the kernels report their gates")
    shape = (*xyz.shape[:2], wts.n_shape + wts.n_tex + 3, wts.W // 32)
    if (gates.shape != shape or gates.dtype != torch.int32 or not gates.is_contiguous()
            or gates.device != xyz.device):
        raise ValueError("the gates buffer does not match gate_buffer")
    return "_gates", [gates.data_ptr()]


def field_fwd(wts: DecoderWeights, xyz, viewdir, zs, zt, gates=None):
    """K5 wrapper. Returns (sigma (B,M,1), rgb (B,M,3)); with gates
    (gate_buffer), the kernel's ReLU gates are written into it too."""
    entry, extra = _gates_args(wts, xyz, gates)
    if xyz.device.type == "cpu":
        return field_fwd_plain(wts, xyz, viewdir, zs, zt)
    _check_field_inputs(wts, xyz, viewdir, zs, zt)
    B, M = xyz.shape[:2]
    sigma = torch.empty((B, M, 1), device=xyz.device)
    rgb = torch.empty((B, M, 3), device=xyz.device)
    ptrs = _ptrs(wts)
    with torch.cuda.device(xyz.device):     # the runtime launches on its current device
        err = getattr(_library(), "supnerf_field_fwd" + entry)(
            xyz.data_ptr(), viewdir.data_ptr(), zs.data_ptr(), zt.data_ptr(),
            ctypes.byref(ptrs), *_dims(wts, xyz), sigma.data_ptr(), rgb.data_ptr(), *extra,
            torch.cuda.current_stream(xyz.device).cuda_stream)
    _raise_on(err, "field_fwd")
    LAUNCHES["field_fwd"] += 1
    return sigma, rgb


def field_bwd(wts: DecoderWeights, xyz, viewdir, zs, zt, g_sigma, g_rgb, gates=None):
    """K6 wrapper. Returns (dxyz (B,M,3), dviewdir (B,M,3), dzs
    (B,n_shape,W), dzt (B,n_tex,W)). The kernel writes per-block partial
    sums of dzs and dzt; summing them over blocks here is the second,
    deterministic pass of the cross-block reduction. gates: as field_fwd's,
    the gates this backward differentiates."""
    entry, extra = _gates_args(wts, xyz, gates)
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
        err = getattr(_library(), "supnerf_field_bwd" + entry)(
            xyz.data_ptr(), viewdir.data_ptr(), zs.data_ptr(), zt.data_ptr(),
            ctypes.byref(ptrs), *_dims(wts, xyz), g_sigma.data_ptr(), g_rgb.data_ptr(),
            dxyz.data_ptr(), dvd.data_ptr(), dzs_part.data_ptr(), dzt_part.data_ptr(), *extra,
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


# --------------------------------------------------------------------------
# training field: A9 forward on K5, A10 backward on K7 + K4
# --------------------------------------------------------------------------

def field_train_bwd_stash_plain(wts: DecoderWeights, xyz, viewdir, zs, zt, g_sigma, g_rgb, pt):
    """K7's plain version: the decoder chain written out with every layer
    input kept (render.stashed_chain), autograd for the pre-activation
    gradients and the data, the rows written into pt as
    stash_layout(per_point=True) places them. Returns (dxyz, dviewdir, dzs,
    dzt)."""
    with torch.enable_grad():
        inputs = _leaves((xyz, viewdir, zs, zt))
        dpe = positional_encoding(inputs[1], wts.num_dir_freq)
        rows, pre, logit, rgb = stashed_chain(wts, inputs[0], dpe @ wts.w_vd_b, *inputs[2:])
        g, grads = stash_grads((torch.nn.functional.softplus(logit), rgb), (g_sigma, g_rgb),
                               pre, logit, rgb, inputs)
    write_stash(wts, dict(rows, a_dpe=dpe), g, pt, per_point=True)
    return tuple(grads)


def field_train_bwd_stash(wts: DecoderWeights, xyz, viewdir, zs, zt, g_sigma, g_rgb, pt,
                          gates=None):
    """K7 wrapper: writes the stash rows of these B objects' points into pt
    (B*M, ld_pt of stash_layout(per_point=True)) and returns (dxyz (B,M,3),
    dviewdir (B,M,3), dzs (B,n_shape,W), dzt (B,n_tex,W)); the kernel
    writes per-block partial sums of dzs and dzt, summed over blocks here
    (the second, deterministic pass of that reduction). gates: as
    field_bwd's."""
    entry, extra = _gates_args(wts, xyz, gates)
    if xyz.device.type == "cpu":
        return field_train_bwd_stash_plain(wts, xyz, viewdir, zs, zt, g_sigma, g_rgb, pt)
    _check_field_inputs(wts, xyz, viewdir, zs, zt, g_sigma, g_rgb)
    B, M = xyz.shape[:2]
    dev = xyz.device
    L = stash_layout(wts, per_point=True)
    if pt.shape != (B * M, L["ld_pt"]) or not pt.is_contiguous() or pt.device != dev:
        raise ValueError("the stash buffer does not match stash_layout(per_point=True)")
    nblk = -(-M // ROWS)
    dxyz = torch.empty_like(xyz)
    dvd = torch.empty_like(viewdir)
    dzs_part = torch.empty((B, nblk, wts.n_shape, wts.W), device=dev)
    dzt_part = torch.empty((B, nblk, wts.n_tex, wts.W), device=dev)
    layout = stash_struct(L, pt)
    ptrs = _ptrs(wts)
    with torch.cuda.device(dev):
        err = getattr(_library(), "supnerf_field_train_bwd" + entry)(
            xyz.data_ptr(), viewdir.data_ptr(), zs.data_ptr(), zt.data_ptr(),
            ctypes.byref(ptrs), *_dims(wts, xyz), g_sigma.data_ptr(), g_rgb.data_ptr(),
            ctypes.byref(layout), dxyz.data_ptr(), dvd.data_ptr(), dzs_part.data_ptr(),
            dzt_part.data_ptr(), *extra, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "field_train_bwd")
    LAUNCHES["field_train_bwd"] += 1
    return dxyz, dvd, dzs_part.sum(1), dzt_part.sum(1)


def field_train_bwd_plain(wts: DecoderWeights, xyz, viewdir, zs, zt, g_sigma, g_rgb):
    """K7 + K4's plain version: autograd through field_fwd_plain with the
    layer weights as inputs. Returns (dxyz, dviewdir, dzs, dzt, grads),
    grads in the order and Linear layout of render.linear_params_of."""
    with torch.enable_grad():
        params = _leaves(linear_params_of(wts))
        inputs = _leaves((xyz, viewdir, zs, zt))
        live = pack_linear_params(params, wts.n_shape, wts.n_tex, wts.num_xyz_freq,
                                  wts.num_dir_freq)
        g = torch.autograd.grad(field_fwd_plain(live, *inputs), inputs + params,
                                (g_sigma, g_rgb), allow_unused=True, materialize_grads=True)
    return (*g[:4], list(g[4:]))


def field_train_bwd(wts: DecoderWeights, xyz, viewdir, zs, zt, g_sigma, g_rgb):
    """The per-point training backward (A10): K7 then K4 on each chunk of
    objects whose stash fits render.STASH_BYTES, the weight gradients
    accumulated over chunks in order. Returns (dxyz (B,M,3), dviewdir
    (B,M,3), dzs (B,n_shape,W), dzt (B,n_tex,W), grads) with grads in the
    order and Linear layout of render.linear_params_of."""
    if xyz.device.type == "cpu":
        return field_train_bwd_plain(wts, xyz, viewdir, zs, zt, g_sigma, g_rgb)
    B, M = xyz.shape[:2]
    dev = xyz.device
    L = stash_layout(wts, per_point=True)
    chunk = max(1, min(B, render.STASH_BYTES // (M * L["ld_pt"] * 4)))
    pt = torch.empty((chunk * M, L["ld_pt"]), device=dev)
    grads = _linear_grad_buffers(wts, dev)
    outs = []
    for o0 in range(0, B, chunk):
        sl = slice(o0, min(B, o0 + chunk))
        pt_c = pt[:(sl.stop - o0) * M]
        outs.append(field_train_bwd_stash(wts, xyz[sl], viewdir[sl], zs[sl], zt[sl],
                                          g_sigma[sl], g_rgb[sl], pt_c))
        wgrad(wgrad_problems(wts, pt_c, None, grads), accumulate=o0 > 0)
    return (*[torch.cat(parts) for parts in zip(*outs)], grads)


class FieldTrain(torch.autograd.Function):
    """(xyz, viewdir, zs, zt, decoder layer weights) -> (sigma, rgb) with K5
    as the forward and K7 + K4 as the backward (the counterpart of
    field_train_pallas's custom_vjp). The weights enter in torch.nn.Linear's
    layout (render.decoder_linear_params) and get their gradients in it."""

    @staticmethod
    def forward(ctx, xyz, viewdir, zs, zt, meta, *params):
        wts = pack_linear_params(params, *meta)
        ctx.save_for_backward(xyz, viewdir, zs, zt)
        ctx.wts = wts
        return field_fwd(wts, xyz, viewdir, zs, zt)

    @staticmethod
    def backward(ctx, g_sigma, g_rgb):
        xyz, viewdir, zs, zt = ctx.saved_tensors
        *grads, wgrads = field_train_bwd(ctx.wts, xyz, viewdir, zs, zt, g_sigma.contiguous(),
                                         g_rgb.contiguous())
        return (*grads, None, *wgrads)


def field_train(decoder, xyz, viewdir, shapecode, texturecode):
    """The differentiable per-point field of B objects for training
    (counterpart of field_train_pallas): xyz, viewdir (B,...,3), codes
    (B, latent) -> (sigma (B,...,1), rgb (B,...,3)), through FieldTrain (the
    kernels for CUDA tensors, the plain versions inside the same wrappers
    for CPU tensors). Gradients reach every weight and bias of the decoder,
    the points, the view directions and, through the live latent layers,
    the codes. Raises ValueError for a decoder that is not kernel-compatible
    (render.decoder_kernel_compatible)."""
    render.check_kernel_decoder(decoder)
    lead = xyz.shape[:-1]
    zs, zt = conditioned_latents_of(decoder, shapecode, texturecode)
    meta = (decoder.shape_blocks, decoder.texture_blocks, decoder.num_xyz_freq,
            decoder.num_dir_freq)
    sigma, rgb = FieldTrain.apply(_flat(xyz), _flat(viewdir), zs.contiguous(), zt.contiguous(),
                                  meta, *decoder_linear_params(decoder))
    return sigma.reshape(*lead, 1), rgb.reshape(*lead, 3)
