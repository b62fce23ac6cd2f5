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

The bfloat16 mode (render.DecoderWeights.field_dtype "bfloat16", ops/render.py's
module docstring): K5, K6 and K7 launch their bfloat16 builds (LAUNCHES'
field_fwd_bf16, field_bwd_bf16, field_train_bwd_bf16; K5 on the training
field's exact encodings as field_fwd_train_bf16) and K4 its bfloat16
entry (wgrad_bf16), the Pallas kernels at dtype=bfloat16, and their plain
versions follow those kernels' rounding (field_fwd_plain,
field_bwd_plain_bf16, field_train_bwd_stash_plain_bf16,
render.wgrad_plain in the mode). field_train takes the mode from the
decoder's field_dtype, as the training render does.

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
    decoder_chain_bf16,
    decoder_linear_params,
    encode_bf16,
    encode_bwd_bf16,
    launch_key,
    linear_params_of,
    pack_linear_params,
    recompute_bf16,
    stash_grads,
    stash_layout,
    stash_struct,
    stashed_chain,
    transposed_bf16,
    wgrad,
    wgrad_problems,
    write_stash,
    write_stash_bf16,
)

ROWS = 64          # points per block of K5 and K6 (kRows in csrc/render_common.cuh)


def field_fwd_plain(wts: DecoderWeights, xyz, viewdir, zs, zt, exact_pe=False):
    """K5's plain version: the decoder as matmuls with a per-point view
    direction. xyz, viewdir (B,M,3) -> (sigma (B,M,1), rgb (B,M,3)). In the
    bfloat16 mode render.decoder_chain_bf16 on the rounded encodings
    (render.encode_bf16: by the doubling recurrence as A7, exact_pe the
    exact ones as A11b), the direction term per point and unrounded
    (pallas_field.py:_field_chain_to_heads)."""
    if wts.field_dtype == "bfloat16":
        dpe = encode_bf16(viewdir, wts.num_dir_freq, exact_pe)
        sigma, rgb = decoder_chain_bf16(wts, encode_bf16(xyz, wts.num_xyz_freq, exact_pe),
                                        dpe @ wts.w_vd_b, zs, zt)
        return sigma[..., None], rgb
    hdir = positional_encoding(viewdir, wts.num_dir_freq) @ wts.w_vd_b
    sigma, rgb = decoder_chain(wts, xyz, hdir, zs, zt)
    return sigma[..., None], rgb


def field_bwd_plain(wts: DecoderWeights, xyz, viewdir, zs, zt, g_sigma, g_rgb):
    """K6's plain version: autograd through field_fwd_plain (in the bfloat16
    mode field_bwd_plain_bf16). Returns (dxyz, dviewdir, dzs, dzt)."""
    if wts.field_dtype == "bfloat16":
        return field_bwd_plain_bf16(wts, xyz, viewdir, zs, zt, g_sigma, g_rgb)
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_(True) for t in (xyz, viewdir, zs, zt)]
        outs = field_fwd_plain(wts, *inputs)
        return torch.autograd.grad(outs, inputs, (g_sigma, g_rgb), allow_unused=True,
                                   materialize_grads=True)


def field_bwd_plain_bf16(wts: DecoderWeights, xyz, viewdir, zs, zt, g_sigma, g_rgb):
    """K6's plain version in the bfloat16 mode: the backward kernel's own
    arithmetic (pallas_field.py:_field_bwd_kernel at dtype=bfloat16):
    render.recompute_bf16 (the stash) with the per-point direction term,
    render.transposed_bf16, and the encodings' chain rules
    (render.encode_bwd_bf16). Returns (dxyz, dviewdir, dzs, dzt)."""
    xpe = encode_bf16(xyz, wts.num_xyz_freq)
    dpe = encode_bf16(viewdir, wts.num_dir_freq)
    rec = recompute_bf16(wts, xpe, dpe @ wts.w_vd_b, zs, zt)
    gpe, gdir, dzs, dzt = transposed_bf16(wts, rec, g_sigma[..., 0] * torch.sigmoid(rec["logit"]),
                                          g_rgb, 1)
    return (encode_bwd_bf16(xpe, gpe, wts.num_xyz_freq),
            encode_bwd_bf16(dpe, gdir, wts.num_dir_freq), dzs, dzt)


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
    keep no gates, so CPU tensors with gates raise, and neither do the
    bfloat16 builds."""
    if gates is None:
        return "", []
    if xyz.device.type == "cpu":
        raise ValueError("only the kernels report their gates")
    if wts.field_dtype != "float32":
        raise ValueError("only the float32 builds report their gates")
    shape = (*xyz.shape[:2], wts.n_shape + wts.n_tex + 3, wts.W // 32)
    if (gates.shape != shape or gates.dtype != torch.int32 or not gates.is_contiguous()
            or gates.device != xyz.device):
        raise ValueError("the gates buffer does not match gate_buffer")
    return "_gates", [gates.data_ptr()]


def field_fwd(wts: DecoderWeights, xyz, viewdir, zs, zt, gates=None, pe="doubling"):
    """K5 wrapper. Returns (sigma (B,M,1), rgb (B,M,3)); with gates
    (gate_buffer), the kernel's ReLU gates are written into it too. In wts'
    bfloat16 mode it launches K5's bfloat16 build with the encodings `pe`
    (render.PE_MODES): "doubling" for A7, "exact" for A11b, "train" for the
    training field's forward (A9: the exact encodings, counted as
    field_fwd_train_bf16). The float32 build's encodings are exact in all."""
    render.check_pe(pe)
    exact_pe = pe != "doubling"
    entry, extra = _gates_args(wts, xyz, gates)
    if xyz.device.type == "cpu":
        return field_fwd_plain(wts, xyz, viewdir, zs, zt, exact_pe)
    if wts.field_dtype == "bfloat16":
        entry, extra = "_bf16", [int(exact_pe)]
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
    LAUNCHES[launch_key("field_fwd", wts, pe=pe)] += 1
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
    if wts.field_dtype == "bfloat16":
        entry = "_bf16"
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
    LAUNCHES[launch_key("field_bwd", wts)] += 1
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
    stash_layout(per_point=True) places them (in the bfloat16 mode the
    kernel's own arithmetic, field_train_bwd_stash_plain_bf16). Returns
    (dxyz, dviewdir, dzs, dzt)."""
    if wts.field_dtype == "bfloat16":
        return field_train_bwd_stash_plain_bf16(wts, xyz, viewdir, zs, zt, g_sigma, g_rgb, pt)
    with torch.enable_grad():
        inputs = _leaves((xyz, viewdir, zs, zt))
        dpe = positional_encoding(inputs[1], wts.num_dir_freq)
        rows, pre, logit, rgb = stashed_chain(wts, inputs[0], dpe @ wts.w_vd_b, *inputs[2:])
        g, grads = stash_grads((torch.nn.functional.softplus(logit), rgb), (g_sigma, g_rgb),
                               pre, logit, rgb, inputs)
    write_stash(wts, dict(rows, a_dpe=dpe), g, pt, per_point=True)
    return tuple(grads)


def encode_bwd_exact(x, g, degree: int):
    """The chain rule of the float32 encoding (positional_encoding, exact
    sines and cosines) by autograd: (..., d) cotangents g -> (..., 3), as
    XLA differentiates the encoding that field_train_pallas computes
    outside its kernels."""
    with torch.enable_grad():
        x = x.detach().requires_grad_(True)
        return torch.autograd.grad(positional_encoding(x, degree), x, g)[0]


def field_train_bwd_stash_plain_bf16(wts: DecoderWeights, xyz, viewdir, zs, zt, g_sigma, g_rgb,
                                     pt):
    """K7's plain version in the bfloat16 mode
    (pallas_field.py:_field_train_bwd_kernel at dtype=bfloat16): K6's
    bfloat16 arithmetic on the exact encodings (render.encode_bf16 with
    exact_pe), render.recompute_bf16 (the stash) with the per-point
    direction term, render.transposed_bf16, the unrounded float32
    cotangents of the encodings through the float32 encoding's chain rule
    (encode_bwd_exact, XLA's autodiff outside the kernel), and the stash
    rows written into pt as stash_layout(per_point=True) places them, the A
    side bfloat16-exact and the G side float32 (render.write_stash_bf16).
    Returns (dxyz, dviewdir, dzs, dzt)."""
    with torch.no_grad():
        xpe = encode_bf16(xyz, wts.num_xyz_freq, True)
        dpe = encode_bf16(viewdir, wts.num_dir_freq, True)
        rec = recompute_bf16(wts, xpe, dpe @ wts.w_vd_b, zs, zt)
        g_sig = g_sigma[..., 0] * torch.sigmoid(rec["logit"])
        pre = {}
        gpe, gdir, dzs, dzt = transposed_bf16(wts, rec, g_sig, g_rgb, 1, pre)
        write_stash_bf16(wts, {"xpe": xpe, "dpe": dpe, "rec": rec, "pre": pre, "g_sig": g_sig,
                               "drgb": g_rgb}, zs, zt, pt, per_point=True)
    return (encode_bwd_exact(xyz, gpe, wts.num_xyz_freq),
            encode_bwd_exact(viewdir, gdir, wts.num_dir_freq), dzs, dzt)


def field_train_bwd_stash(wts: DecoderWeights, xyz, viewdir, zs, zt, g_sigma, g_rgb, pt,
                          gates=None):
    """K7 wrapper: writes the stash rows of these B objects' points into pt
    (B*M, ld_pt of stash_layout(per_point=True)) and returns (dxyz (B,M,3),
    dviewdir (B,M,3), dzs (B,n_shape,W), dzt (B,n_tex,W)); the kernel
    writes per-block partial sums of dzs and dzt, summed over blocks here
    (the second, deterministic pass of that reduction). gates: as
    field_bwd's. In wts' bfloat16 mode it launches K7's bfloat16 build
    (LAUNCHES["field_train_bwd_bf16"])."""
    entry, extra = _gates_args(wts, xyz, gates)
    if xyz.device.type == "cpu":
        return field_train_bwd_stash_plain(wts, xyz, viewdir, zs, zt, g_sigma, g_rgb, pt)
    if wts.field_dtype == "bfloat16":
        entry = "_bf16"
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
    LAUNCHES[launch_key("field_train_bwd", wts)] += 1
    return dxyz, dvd, dzs_part.sum(1), dzt_part.sum(1)


def field_train_bwd_plain(wts: DecoderWeights, xyz, viewdir, zs, zt, g_sigma, g_rgb):
    """K7 + K4's plain version: autograd through field_fwd_plain with the
    layer weights as inputs; in the bfloat16 mode, whose backward rounds
    its cotangents, K7's plain version then K4's (field_train_bwd's
    chunks). Returns (dxyz, dviewdir, dzs, dzt, grads), grads in the order
    and Linear layout of render.linear_params_of."""
    if wts.field_dtype == "bfloat16":
        return _field_train_bwd_chunks(field_train_bwd_stash_plain, render.wgrad_plain, wts,
                                       xyz, viewdir, zs, zt, g_sigma, g_rgb)
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
    accumulated over chunks in order, in wts' mode. Returns (dxyz (B,M,3),
    dviewdir (B,M,3), dzs (B,n_shape,W), dzt (B,n_tex,W), grads) with grads
    in the order and Linear layout of render.linear_params_of."""
    if xyz.device.type == "cpu":
        return field_train_bwd_plain(wts, xyz, viewdir, zs, zt, g_sigma, g_rgb)
    return _field_train_bwd_chunks(field_train_bwd_stash, wgrad, wts, xyz, viewdir, zs, zt,
                                   g_sigma, g_rgb)


def field_train_chunks(wts: DecoderWeights, B: int, M: int):
    """How field_train_bwd splits B objects of M points: (chunk, slices),
    chunk the most objects whose per-point stash fits render.STASH_BYTES and
    slices the objects of each launch of K7 and K4, in order."""
    chunk = max(1, min(B, render.STASH_BYTES // (M * stash_layout(wts, per_point=True)["ld_pt"]
                                                 * 4)))
    return chunk, [slice(o0, min(B, o0 + chunk)) for o0 in range(0, B, chunk)]


def _field_train_bwd_chunks(stash_fn, wgrad_fn, wts: DecoderWeights, xyz, viewdir, zs, zt,
                            g_sigma, g_rgb):
    """stash_fn (K7 or its plain version) then wgrad_fn (K4 or its plain
    version) in wts' mode on each chunk of objects whose stash fits
    render.STASH_BYTES, into one stash buffer; the weight gradients
    accumulated over chunks in order."""
    B, M = xyz.shape[:2]
    dev = xyz.device
    chunk, chunks = field_train_chunks(wts, B, M)
    pt = torch.empty((chunk * M, stash_layout(wts, per_point=True)["ld_pt"]), device=dev)
    grads = _linear_grad_buffers(wts, dev)
    outs = []
    for sl in chunks:
        pt_c = pt[:(sl.stop - sl.start) * M]
        outs.append(stash_fn(wts, xyz[sl], viewdir[sl], zs[sl], zt[sl], g_sigma[sl], g_rgb[sl],
                             pt_c))
        wgrad_fn(wgrad_problems(wts, pt_c, None, grads), accumulate=sl.start > 0,
                 field_dtype=wts.field_dtype)
    return (*[torch.cat(parts) for parts in zip(*outs)], grads)


class FieldTrain(torch.autograd.Function):
    """(xyz, viewdir, zs, zt, decoder layer weights) -> (sigma, rgb) with K5
    as the forward and K7 + K4 as the backward (the counterpart of
    field_train_pallas's custom_vjp). The weights enter in torch.nn.Linear's
    layout (render.decoder_linear_params) and get their gradients in it,
    float32 and unrounded in either mode (in the bfloat16 mode the pack
    rounds the live weights each call, as pallas_field.py's
    _precast_weights, and their gradient is the rounded matrices'). meta:
    pack_linear_params' arguments after params. K5 runs the training
    field's encodings (field_fwd's pe "train")."""

    @staticmethod
    def forward(ctx, xyz, viewdir, zs, zt, meta, *params):
        wts = pack_linear_params(params, *meta)
        ctx.save_for_backward(xyz, viewdir, zs, zt)
        ctx.wts = wts
        return field_fwd(wts, xyz, viewdir, zs, zt, pe="train")

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
    for CPU tensors), in the decoder's field_dtype (the latent projections
    float32 in both, as pallas_field.py:conditioned_latents_batched).
    Gradients reach every weight and bias of the decoder, the points, the
    view directions and, through the live latent layers, the codes. Raises
    ValueError for a decoder that is not kernel-compatible
    (render.decoder_kernel_compatible)."""
    render.check_kernel_decoder(decoder)
    lead = xyz.shape[:-1]
    zs, zt = conditioned_latents_of(decoder, shapecode, texturecode)
    meta = (decoder.shape_blocks, decoder.texture_blocks, decoder.num_xyz_freq,
            decoder.num_dir_freq, None, decoder.field_dtype)
    sigma, rgb = FieldTrain.apply(_flat(xyz), _flat(viewdir), zs.contiguous(), zt.contiguous(),
                                  meta, *decoder_linear_params(decoder))
    return sigma.reshape(*lead, 1), rgb.reshape(*lead, 3)
