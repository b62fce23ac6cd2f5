"""The weight tiles of the bfloat16 builds of K1 and K2
(ops/render.py bf16_tile_pack; csrc/render_bf16.cuh): each tile read back
with numpy by the addressing of the kernels' wgmma shared-memory
descriptor (128-byte swizzle, K-major, 1024 bytes between 8-row groups, a
k-step of 16 starting 32 bytes on), independently of the pack's own
permutation, against the decoder's Linear weights rounded to bfloat16 in
the kernels' order, which the test derives from linear_names. The padding
must be zero, the tile count and sizes those of the kernels'
tile_sequence, and a float32 pack carries no tiles."""
import dataclasses

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401
from supnerf_tpu_torch.models.nerf_mlp import CodeNeRFDecoder
from supnerf_tpu_torch.ops import render

# (W, shape blocks, texture blocks, direction frequencies): the published
# layer counts at narrow widths, two row blocks a K-tile (W 256), and a
# direction encoding wider than 32
CASES = [(64, 3, 1, 4), (128, 2, 2, 4), (256, 1, 1, 4), (64, 1, 1, 6)]


def _decoder(W, ns, nt, dir_freq, field_dtype="bfloat16"):
    torch.manual_seed(W + 10 * ns + 100 * nt + dir_freq)
    return CodeNeRFDecoder(ns, nt, W, W, num_dir_freq=dir_freq, field_dtype=field_dtype)


def _rounded(t):
    return t.detach().to(torch.bfloat16).float().numpy()


def _expected(dec):
    """(forward, transposed) lists of (name, B^T (N, K), rows): the kernels'
    order from linear_names, each matrix from the decoder's own layers."""
    ns, nt = dec.shape_blocks, dec.texture_blocks
    names = render.linear_names(ns, nt)
    W = dec.get_submodule("encoding_shape").weight.shape[0]
    d_dir = 3 * (2 * dec.num_dir_freq + 1)

    def weight(name):
        return dec.get_submodule(name).weight

    body = [n for n in names if n not in ("sigma.0", "rgb.2")]
    fwd = []
    for n in body:
        w = weight(n)
        if n == "encoding_viewdir.0":
            w = w[:, :W]
        fwd.append((n, _rounded(w), w.shape[0]))
    tex = [n for n in names if n.startswith("texture_layer_")]
    shp = [n for n in names if n.startswith("shape_layer_")]
    vd = weight("encoding_viewdir.0")
    bwd = ([("rgb.0", _rounded(weight("rgb.0").t()), W)]
           + [(n, _rounded(weight(n).t()), W) for n in reversed(tex)]
           + [("encoding_viewdir.0", _rounded(vd[:, W:].t()), 32 if d_dir <= 32 else 64),
              ("encoding_viewdir.0", _rounded(vd[:, :W].t()), W),
              ("encoding_shape", _rounded(weight("encoding_shape").t()), W)]
           + [(n, _rounded(weight(n).t()), W) for n in reversed(shp)]
           + [("encoding_xyz.0", _rounded(weight("encoding_xyz.0").t()), 64)])
    return fwd, bwd


def _descriptor_offset(n, k):
    """Byte offset in a tile (its slot 1024-byte aligned) of row n, column
    k, as the wgmma descriptor addresses it: start + 32 per k-step, 1024
    bytes per 8 rows, 128 per row, then bits 4-6 XOR bits 7-9."""
    off = (n // 8) * 1024 + (n % 8) * 128 + 32 * (k // 16) + (k % 16) * 2
    return off ^ (((off >> 7) & 7) << 4)


def _read_tiles(raw, at, rows, kt):
    """(rows, 64 kt) float32 values of a layer's tiles at byte `at`: per
    K-tile, blocks of up to 128 rows, each a tile."""
    rb = min(rows, 128)
    n = np.arange(rb)[:, None]
    k = np.arange(64)[None, :]
    off = _descriptor_offset(n, k)
    out = np.empty((rows, 64 * kt), np.float32)
    for t in range(kt):
        for b in range(rows // rb):
            half = raw[(at + (t * rows + b * rb) * 128 + off) // 2]
            out[b * rb:(b + 1) * rb, 64 * t:64 * (t + 1)] = (
                half.astype(np.uint32) << 16).view(np.float32)
    return out


def _tile_sequence(W, ns, nt, dir_rows):
    """Rows of each tile of csrc/render_bf16.cuh:tile_sequence (forward,
    then transposed): a layer of R rows takes ceil(R / 128) tiles of up to
    128 rows per K-tile."""
    kt, kt_half = W // 64, -(-(W // 2) // 64)

    def layer(k_tiles, rows):
        return [min(rows, 128)] * (k_tiles * -(-rows // 128))

    fwd = layer(1, W) + layer(kt * (ns + 2 + nt), W) + layer(kt, W // 2)
    bwd = (layer(kt_half, W) + layer(kt * nt, W) + layer(kt, dir_rows) + layer(kt * (2 + ns), W)
           + layer(kt, 64))
    return fwd, bwd


@pytest.mark.parametrize("W,ns,nt,dir_freq", CASES)
def test_tiles_hold_the_rounded_matrices(W, ns, nt, dir_freq):
    dec = _decoder(W, ns, nt, dir_freq)
    wts = render.pack_decoder_params(dec)
    assert wts.tiles is not None and wts.tiles.dtype == torch.bfloat16
    raw = wts.tiles.view(torch.int16).numpy().view(np.uint16)
    fwd, bwd = _expected(dec)
    at = 0
    for name, m, rows in fwd + bwd:
        N, K = m.shape
        kt = -(-K // 64)
        got = _read_tiles(raw, at, rows, kt)
        np.testing.assert_array_equal(got[:N, :K], m, err_msg=name)
        assert not got[N:].any() and not got[:, K:].any(), f"{name}: padding not zero"
        at += rows * 64 * kt * 2
    assert at == raw.size * 2, "the pack holds more than the kernels' sequence"


@pytest.mark.parametrize("W,ns,nt,dir_freq", CASES)
def test_tile_sizes_follow_the_kernel_sequence(W, ns, nt, dir_freq):
    wts = render.pack_decoder_params(_decoder(W, ns, nt, dir_freq))
    plan = render.bf16_tile_plan(wts)
    rows = [min(r, 128) for _, _, m, r in plan
            for _ in range(-(-m.shape[1] // 64) * -(-r // 128))]
    fwd, bwd = _tile_sequence(W, ns, nt, render.direction_tile_rows(dir_freq))
    assert rows == fwd + bwd
    assert [p for _, p, _, _ in plan].index("transposed") == ns + nt + 4
    assert render.bf16_tile_count(wts) == wts.tiles.numel() == 64 * sum(fwd + bwd)
    # the forward names run in linear_names' order, without the heads
    names = [n for n, p, _, _ in plan if p == "forward"]
    assert names == [n for n in render.linear_names(ns, nt) if n not in ("sigma.0", "rgb.2")]


def test_float32_pack_has_no_tiles_and_conversion_packs_once():
    W, ns, nt, dir_freq = CASES[0]
    w32 = render.pack_decoder_params(_decoder(W, ns, nt, dir_freq, "float32"))
    assert w32.tiles is None
    assert render._tiles_operand(w32, torch.device("cpu")) == []
    w16 = render.with_field_dtype(w32, "bfloat16")
    direct = render.pack_decoder_params(_decoder(W, ns, nt, dir_freq))
    assert torch.equal(w16.tiles.view(torch.int16), direct.tiles.view(torch.int16))
    with pytest.raises(ValueError, match="weight tiles"):
        render._tiles_operand(dataclasses.replace(w16, tiles=None), torch.device("cpu"))
