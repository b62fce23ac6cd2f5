"""The arithmetic of the port's tensor-core kernels, emulated on the CPU:
supnerf_tpu_torch/csrc/tf32.cuh's 3xTF32 product (each float32 operand x
split into big = x rounded to TF32 as cvt.rna does it and small = x - big
truncated to TF32;
a * b = small_a big_b + big_a small_b + big_a big_b, float32 sums), as K4
(csrc/wgrad.cu: per 64-row stage a stage sum in row order, stage sums added
into the block's sum) and K2's dense layer (csrc/render_common.cuh:
dense_mma: the same per k-step of 8) form it, at small versions of their
problems, against float64. The TF32 rounding is done on the float32 bits
with integer operations, as the conversion instruction does it; products of
TF32 values are exact in float32, and float32 tensor adds round to nearest.
The tensor core's own adder is modelled as a float32 add.

The error must stay at least 10x inside the chip's tolerances
(chip_smoke.py: WGRAD_RTOL 1e-4 for K4 against its plain version,
GRAD_RTOL 1e-3 for K2's gradients, both relative to the output's largest
magnitude) and below a single TF32 pass's. This guards the choice of route;
the chip comparison of each kernel with its plain version stays the test of
the kernels themselves.

The last cases carry the same arithmetic through whole kernels at the
published width (W 256, 3 shape blocks, 1 texture block) on a few rays of
chip_smoke.py:kernel_inputs-like data: K1's decoder chain and compositing
(csrc/render_fwd.cu: every dense layer on dense_mma, the heads, direction
term and compositing in float32) against the float64 plain version within
a tenth of VALUE_ATOL, and K3's stash rows (csrc/render_train_bwd.cu: each
layer's input rows A_l and pre-activation gradient rows G_l, the transposed
chain on dense_mma) and the weight gradients K4 forms from them against
float64 within a tenth of GRAD_RTOL and WGRAD_RTOL, on rays with no ReLU
unit within KINK_RTOL of zero (there the gate, and so a whole gradient row,
is decided by the summation order, which chip_smoke.py arbitrates). The
kernels' kRefine step (render_common.cuh: a ReLU pre-activation within
2^-20 of its row's scale from zero recomputed in float64) is left out: it
only moves such values onto float64's.

The per-point field's kernels get the same cases: K5's chain
(csrc/render_common.cuh:field_chain, the viewdir layer's trunk and
per-point direction-encoding operand pairs summed into one accumulator)
against the float64 plain version within a tenth of VALUE_ATOL, K6's
outputs from that chain's gates and its transposed chain within a tenth of
GRAD_RTOL, and K7's per-point stash rows (the same chains,
render_common.cuh:field_backward) and the weight gradients K4 forms from
them within a tenth of GRAD_RTOL and WGRAD_RTOL, on points clear of kinks.
One case builds kinks instead: the
viewdir layer's bias set so that a unit per column sits within float32
rounding of zero, where kRefine, emulated over both operand pairs, must
give float64's gate at every unit (a refine of the trunk's product alone,
the direction term added in float32, does not). Another holds the same
built units against the exact function (float64 all the way): there the
refined gate, exact only for the layer's float32 inputs, is sometimes the
other side, and every such unit lies in a row the refine step flags, whose
layer output field_chain's exact step (K5, K6 and K7) takes from the
float64 chain, so that the layer's gates become the exact function's."""
import dataclasses
import functools
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import torch_threads  # noqa: F401
from supnerf_tpu_torch.models.nerf_mlp import CodeNeRFDecoder, positional_encoding
from supnerf_tpu_torch.ops import render
from supnerf_tpu_torch.ops.volume_render import volume_render

WGRAD_RTOL = 1e-4
GRAD_RTOL = 1e-3
VALUE_ATOL = {"rgb": 3e-4, "depth": 3e-3, "acc": 3e-4}
KINK_RTOL = 1e-6
STAGE_ROWS = 64


def tf32_rna(x):
    """cvt.rna.tf32.f32: keep 10 mantissa bits, round to nearest with ties
    away from zero (add half of the dropped 13 bits' unit to the magnitude
    bits, then clear them)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_truncate(x):
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def split(x):
    """(x rounded to TF32, x - that truncated to TF32): csrc/tf32.cuh's
    tf32_split."""
    big = tf32_rna(x)
    return big, tf32_truncate(x - big)


def products(a, b, passes):
    """a * b (broadcast) as the tensor cores form it from TF32 operands:
    three float32-accumulated passes, small terms first, or one pass."""
    (ab, as_), (bb, bs) = split(a), split(b)
    return [as_ * bb, ab * bs, ab * bb] if passes == 3 else [ab * bb]


def wgrad_emulated(A, G, passes=3):
    """dW (N, K) = G^T A as csrc/wgrad.cu sums it over the rows of one split."""
    acc = torch.zeros((G.shape[1], A.shape[1]), dtype=torch.float32)
    for r0 in range(0, A.shape[0], STAGE_ROWS):
        seg = torch.zeros_like(acc)
        for r in range(r0, min(A.shape[0], r0 + STAGE_ROWS)):
            for p in products(G[r][:, None], A[r][None, :], passes):
                seg = seg + p
        acc = acc + seg
    return acc


def dense_emulated(x, M, passes=3):
    """x (rows, K) @ M (K, N) as dense_mma sums it: per k-step of 8 a sum
    in reduction order, k-step sums added into the output's sum."""
    acc = torch.zeros((x.shape[0], M.shape[1]), dtype=torch.float32)
    for k0 in range(0, x.shape[1], 8):
        step = torch.zeros_like(acc)
        for k in range(k0, min(x.shape[1], k0 + 8)):
            for p in products(x[:, k:k + 1], M[k][None, :], passes):
                step = step + p
        acc = acc + step
    return acc


def k_steps(x, M):
    """The k-step sums of x @ M as dense_mma forms them, (rows, steps, N):
    per k-step of 8 the three-pass products summed in reduction order (a K
    that is not a multiple of 8 is padded with zero products, which leave
    each sum as it is)."""
    pad = -x.shape[1] % 8
    (ab, as_), (bb, bs) = split(F.pad(x, (0, pad))), split(F.pad(M, (0, 0, 0, pad)))
    steps = torch.zeros((x.shape[0], ab.shape[1] // 8, M.shape[1]), dtype=torch.float32)
    for j in range(8):
        a_b, a_s = ab[:, j::8, None], as_[:, j::8, None]
        b_b, b_s = bb[None, j::8], bs[None, j::8]
        for p in (a_s * b_b, a_b * b_s, a_b * b_b):
            steps = steps + p
    return steps


def dense_steps(x, M, x2=None, M2=None):
    """dense_emulated's three-pass arithmetic vectorised over the k-steps:
    the same float32 adds in the same order for every output. With a second
    operand pair (dense_mma's kDir: the per-point viewdir layer) its k-steps
    are added after the first pair's into the same sums."""
    steps = k_steps(x, M)
    if x2 is not None:
        steps = torch.cat([steps, k_steps(x2, M2)], 1)
    acc = torch.zeros((x.shape[0], M.shape[1]), dtype=torch.float32)
    for step in steps.unbind(1):
        acc = acc + step
    return acc


def wgrad_steps(A, G):
    """wgrad_emulated's three-pass arithmetic vectorised over the stages, as
    dense_steps is dense_emulated's."""
    pad = -A.shape[0] % STAGE_ROWS
    (Ab, As), (Gb, Gs) = split(F.pad(A, (0, 0, 0, pad))), split(F.pad(G, (0, 0, 0, pad)))
    seg = torch.zeros((Ab.shape[0] // STAGE_ROWS, G.shape[1], A.shape[1]), dtype=torch.float32)
    for r in range(STAGE_ROWS):
        g_b, g_s = Gb[r::STAGE_ROWS, :, None], Gs[r::STAGE_ROWS, :, None]
        a_b, a_s = Ab[r::STAGE_ROWS, None], As[r::STAGE_ROWS, None]
        for p in (g_s * a_b, g_b * a_s, g_b * a_b):
            seg = seg + p
    acc = torch.zeros((G.shape[1], A.shape[1]), dtype=torch.float32)
    for stage in seg.unbind(0):
        acc = acc + stage
    return acc


def rel_err(got, want64):
    return float((got.double() - want64).abs().max() / want64.abs().max())


def test_tf32_rounding_is_round_to_nearest_ties_away():
    one = 1.0
    cases = {one: one, one + 2.0 ** -11: one + 2.0 ** -10,            # a tie, away from zero
             one + 2.0 ** -11 - 2.0 ** -23: one,                       # just below the tie
             -(one + 2.0 ** -11): -(one + 2.0 ** -10),
             2.0 - 2.0 ** -23: 2.0,                                    # carry into the exponent
             2.0 ** -15 * (one + 2.0 ** -10): 2.0 ** -15 * (one + 2.0 ** -10)}
    x = torch.tensor(list(cases), dtype=torch.float32)
    want = torch.tensor(list(cases.values()), dtype=torch.float32)
    assert torch.equal(tf32_rna(x), want)
    assert not (tf32_rna(torch.randn(1000)).view(torch.int32) & 0x1FFF).any()


def test_split_recovers_float32_operands():
    """big + small is x to within 2^-21 of |x| (small is itself truncated
    to TF32), where big alone is 2^-11 away."""
    x = torch.randn(100_000, generator=torch.Generator().manual_seed(0)) * 10.0
    big, small = split(x)
    xd = x.double()
    assert float(((big.double() + small.double() - xd).abs() / xd.abs()).max()) <= 2.0 ** -21
    assert float(((big.double() - xd).abs() / xd.abs()).max()) <= 2.0 ** -11


@pytest.mark.parametrize("K,N", [(63, 64), (64, 1), (32, 3), (27, 64)],
                         ids=["a_xyz", "g_sig", "g_rgb", "direction_rows"])
def test_wgrad_split_product_is_float32_accurate(K, N):
    """K4's problems with their odd widths (the 63-wide point encoding, the
    sigma and rgb heads' 1 and 3 gradient columns, the 27-wide direction
    encoding) over 1,500 stash rows: ReLU-output inputs A, mixed-sign
    gradients G."""
    rng = np.random.default_rng(K * 7 + N)
    A = torch.from_numpy(np.maximum(rng.normal(size=(1500, K)), 0).astype(np.float32))
    G = torch.from_numpy((rng.normal(size=(1500, N)) * 1e-3).astype(np.float32))
    want = G.double().t() @ A.double()
    err3, err1 = rel_err(wgrad_emulated(A, G), want), rel_err(wgrad_emulated(A, G, 1), want)
    assert err3 <= WGRAD_RTOL / 10, err3
    assert err3 < err1


@pytest.mark.parametrize("K,N", [(256, 256), (128, 128), (63, 256), (256, 128)],
                         ids=["W256", "W128", "encoding_xyz", "rgb_hidden"])
def test_dense_split_product_is_float32_accurate(K, N):
    """K2's dense layers on a ray's 64 rows: the W x W trunk and texture
    layers at W 256 and 128, the first layer on the 63-wide point encoding,
    and rgb.0's W -> W/2."""
    rng = np.random.default_rng(K + N)
    x = torch.from_numpy(np.maximum(rng.normal(size=(64, K)), 0).astype(np.float32))
    M = torch.from_numpy((rng.uniform(-1, 1, size=(K, N)) / np.sqrt(K)).astype(np.float32))
    want = x.double() @ M.double()
    err3, err1 = rel_err(dense_emulated(x, M), want), rel_err(dense_emulated(x, M, 1), want)
    assert err3 <= GRAD_RTOL / 10, err3
    assert err3 < err1


# ---- whole kernels at the published width -----------------------------------

@pytest.fixture
def one_thread():
    """The emulations below are a few thousand tensor operations of ~1M
    elements: on one thread each, since intra-op threads of several test
    workers sharing the cores stall each other at every operation."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("K,N,rows", [(63, 256, 64), (256, 128, 100)],
                         ids=["encoding_xyz", "rgb_hidden"])
def test_vectorised_emulations_give_the_same_bits(K, N, rows, one_thread):
    """dense_steps and wgrad_steps, which the whole-kernel cases below use
    to run in seconds, are dense_emulated and wgrad_emulated bit for bit,
    ragged K and row counts included."""
    rng = np.random.default_rng(K + rows)
    x = torch.from_numpy(np.maximum(rng.normal(size=(rows, K)), 0).astype(np.float32))
    M = torch.from_numpy(rng.uniform(-0.1, 0.1, size=(K, N)).astype(np.float32))
    assert torch.equal(dense_steps(x, M), dense_emulated(x, M))
    G = torch.from_numpy(rng.normal(size=(rows, N)).astype(np.float32))
    assert torch.equal(wgrad_steps(x, G), wgrad_emulated(x, G))


def _f64(wts):
    return render.DecoderWeights(**{
        k: (v.double() if isinstance(v, torch.Tensor) else v)
        for k, v in vars(wts).items()})


def _published_decoder(seed):
    """A CodeNeRF decoder at the published width, Linear weights and biases
    U(+-1/sqrt(fan_in)) from a numpy seed, as kernel operands."""
    rng = np.random.default_rng(seed)
    dec = CodeNeRFDecoder(3, 1, 256, 256)
    with torch.no_grad():
        for m in dec.modules():
            if isinstance(m, torch.nn.Linear):
                b = 1.0 / math.sqrt(m.in_features)
                for t in (m.weight, m.bias):
                    t.copy_(torch.from_numpy(rng.uniform(-b, b, t.shape).astype(np.float32)))
    return render.pack_decoder_params(dec)


def _rays(wts, seed, R, S=64):
    """kernel_inputs' rays for one object: points on R rays from an origin
    20 m away through a car-sized box, S stratified depths, in units of the
    box diagonal; codes N(0, 0.3^2); cotangents N(0, 1)."""
    rng = np.random.default_rng(seed)
    diag = 5.3
    origin = np.array([0.0, -20.0, 1.0])
    target = (rng.uniform(size=(1, R, 3)) - 0.5) * np.array([4.6, 1.9, 1.7])
    vd = target - origin
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    near, far = 20.0 - diag / 2, 20.0 + diag / 2
    z = near + (far - near) * np.linspace(0, 1, S) + rng.uniform(size=(1, S)) * (far - near) / S
    xyz = (origin + vd[:, :, None, :] * z[:, None, :, None]) / diag
    codes = rng.normal(size=(2, 1, 256)) * 0.3
    cot = [rng.normal(size=s) for s in ((1, R, 3), (1, R), (1, R))]
    f32 = [torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
           for a in (xyz, vd, z, codes, *cot)]
    zs, zt = render.conditioned_latents(wts, f32[3][0], f32[3][1])
    return (f32[0], f32[1], f32[2], zs.contiguous(), zt.contiguous()), tuple(f32[4:])


def _mma_layer(x, M, bias, relu):
    """dense_mma: x @ M on the tensor cores (dense_emulated), then the bias
    (a (N,) vector or (rows, N) rows) and the ReLU in float32."""
    y = dense_steps(x, M) + bias
    return torch.relu(y) if relu else y


def _k1_chain(wts, xyz, vd, zs, zt):
    """K1's decoder on the rows of all samples (rows (R*S, .)): the layers on
    dense_mma, the heads and the direction term in float32. Returns (logit,
    rgb, rows, pre): the stash's layer-input rows a_* and every ReLU layer's
    pre-activation, keyed as render.stashed_chain keys them."""
    R, S = xyz.shape[1:3]
    pe = positional_encoding(xyz[0].reshape(-1, 3), wts.num_xyz_freq)
    hdir = (positional_encoding(vd[0], wts.num_dir_freq) @ wts.w_vd_b + wts.b_vd)
    hdir = hdir[:, None, :].expand(R, S, -1).reshape(R * S, -1)
    rows, pre = {"a_xyz": pe}, {}
    pre["xyz"] = dense_steps(pe, wts.w_xyz) + wts.b_xyz
    y = torch.relu(pre["xyz"])
    for j in range(wts.n_shape):
        rows[f"a_sh{j}"] = y = y + zs[0, j]
        pre[f"sh{j}"] = dense_steps(y, wts.w_sh[j]) + wts.b_sh[j]
        y = torch.relu(pre[f"sh{j}"])
    rows["a_es"] = y
    rows["a_e"] = e = _mma_layer(y, wts.w_es, wts.b_es, False)
    logit = e @ wts.w_sg[:, None] + wts.b_sg
    pre["v"] = dense_steps(e, wts.w_vd_a) + hdir
    h = torch.relu(pre["v"])
    for j in range(wts.n_tex):
        rows[f"a_tx{j}"] = h = h + zt[0, j]
        pre[f"tx{j}"] = dense_steps(h, wts.w_tx[j]) + wts.b_tx[j]
        h = torch.relu(pre[f"tx{j}"])
    rows["a_r1"] = h
    pre["hh"] = dense_steps(h, wts.w_r1) + wts.b_r1
    rows["a_hh"] = hh = torch.relu(pre["hh"])
    return logit, hh @ wts.w_r2 + wts.b_r2, rows, pre


@functools.cache
def _published_case(seed, R=6, keep=3):
    """The decoder and `keep` of R rays of one object at which no ReLU unit
    of any sample lies within KINK_RTOL of zero in float64 (margins relative
    to the layer's largest |pre-activation| at that sample)."""
    wts = _published_decoder(seed)
    args, cot = _rays(wts, seed, R)
    w64 = _f64(wts)
    xyz, vd, _, zs, zt = (t.double() for t in args)
    hdir = positional_encoding(vd, wts.num_dir_freq) @ w64.w_vd_b
    with torch.no_grad():
        _, pre, _, _ = render.stashed_chain(w64, xyz, hdir[:, :, None], zs, zt)
    clear = torch.ones(R, dtype=torch.bool)
    for k, p in pre.items():
        if k != "e":
            margin = p.abs() / p.abs().amax(-1, keepdim=True)          # (1, R, S, N)
            clear &= (margin > KINK_RTOL).flatten(2).all(-1)[0]
    idx = clear.nonzero().flatten()[:keep]
    assert len(idx) == keep, "too few rays clear of kinks"
    xyz, vd, z, zs, zt = args
    return (wts, (xyz[:, idx].contiguous(), vd[:, idx].contiguous(), z, zs, zt),
            tuple(c[:, idx].contiguous() for c in cot))


@pytest.mark.parametrize("white", [False, True], ids=["black_bkgd", "white_bkgd"])
def test_k1_chain_split_product_is_float32_accurate(white, one_thread):
    """K1's forward at the published width, its nine dense layers as
    dense_mma sums them: rgb, depth and acc within a tenth of VALUE_ATOL of
    the float64 plain version."""
    wts, (xyz, vd, z, zs, zt), _ = _published_case(0)
    R, S = xyz.shape[1:3]
    logit, rgb, _, _ = _k1_chain(wts, xyz, vd, zs, zt)
    got = volume_render(torch.nn.functional.softplus(logit.reshape(1, R, S)),
                        rgb.reshape(1, R, S, 3), z[:, None, :], white_bkgd=white)
    want = render.render_fwd_plain(_f64(wts), *(t.double() for t in (xyz, vd, z, zs, zt)), white)
    for name, a, b in zip(("rgb", "depth", "acc"), got, want):
        err = float((a.double() - b).abs().max())
        assert err <= VALUE_ATOL[name] / 10, (name, err)


@pytest.mark.parametrize("seed", [0, 1])
def test_k3_stash_split_product_is_float32_accurate(seed, one_thread):
    """K3's stash at the published width: the layer-input rows A_l of K1's
    chain and the pre-activation gradient rows G_l of the transposed chain,
    every dense layer as dense_mma sums it (the compositing's VJP by float32
    autograd, the ReLU gates from the recomputed pre-activations), each
    column block within a tenth of GRAD_RTOL of its float64 plain version's
    largest magnitude; the weight gradients K4 forms from them (as
    wgrad_emulated sums them) within a tenth of WGRAD_RTOL of float64's."""
    wts, args, cot = _published_case(seed)
    xyz, vd, z, zs, zt = args
    R, S = xyz.shape[1:3]
    W = wts.W
    L = render.stash_layout(wts)
    logit, rgb, rows, pre = _k1_chain(wts, xyz, vd, zs, zt)
    lg, col = (t.detach().requires_grad_(True) for t in (logit, rgb))
    with torch.enable_grad():
        outs = volume_render(torch.nn.functional.softplus(lg.reshape(1, R, S)),
                             col.reshape(1, R, S, 3), z[:, None, :])
        g_sig, g_rgb = torch.autograd.grad(outs, (lg, col), cot)
    gate = {k: (p > 0).float() for k, p in pre.items()}
    g = {"sig": g_sig, "rgb": g_rgb}
    g["hh"] = gate["hh"] * (g_rgb @ wts.w_r2.t())
    cur = dense_steps(g["hh"], wts.wt_r1)
    for j in reversed(range(wts.n_tex)):
        g[f"tx{j}"] = gate[f"tx{j}"] * cur
        cur = dense_steps(g[f"tx{j}"], wts.wt_tx[j])
    g["v"] = gate["v"] * cur
    g["e"] = dense_steps(g["v"], wts.wt_vd_a) + g_sig * wts.w_sg
    cur = dense_steps(g["e"], wts.wt_es)
    for j in reversed(range(wts.n_shape)):
        g[f"sh{j}"] = gate[f"sh{j}"] * cur
        cur = dense_steps(g[f"sh{j}"], wts.wt_sh[j])
    g["xyz"] = gate["xyz"] * cur
    pt = torch.zeros((R * S, L["ld_pt"]))
    render.write_stash(wts, dict(rows), g, pt)
    ray = torch.zeros((R, L["ld_ray"]))
    d_dir = 3 * (2 * wts.num_dir_freq + 1)
    ray[:, :d_dir] = positional_encoding(vd[0], wts.num_dir_freq)
    ray[:, L["r_gv"]:L["r_gv"] + W] = g["v"].reshape(R, S, W).sum(1)

    pt64 = torch.zeros((R * S, L["ld_pt"]), dtype=torch.float64)
    ray64 = torch.zeros((R, L["ld_ray"]), dtype=torch.float64)
    render.render_train_bwd_stash_plain(_f64(wts), *(t.double() for t in args), False,
                                        *(c.double() for c in cot), pt64, ray64)
    widths = {"a_xyz": 63, "a_sh": wts.n_shape * W, "a_es": W, "a_e": W, "a_tx": wts.n_tex * W,
              "a_r1": W, "a_hh": W // 2, "g_xyz": W, "g_sh": wts.n_shape * W, "g_e": W,
              "g_sig": 1, "g_v": W, "g_tx": wts.n_tex * W, "g_hh": W // 2, "g_rgb": 3}
    for name, n in widths.items():
        a, b = pt[:, L[name]:L[name] + n].double(), pt64[:, L[name]:L[name] + n]
        assert rel_err(a, b) <= GRAD_RTOL / 10, (name, rel_err(a, b))

    grads = render._linear_grad_buffers(wts, "cpu")
    for p, p64 in zip(render.wgrad_problems(wts, pt, ray, grads),
                      render.wgrad_problems(_f64(wts), pt64, ray64, grads)):
        err = rel_err(wgrad_steps(p.A, p.G), p64.G.t() @ p64.A)
        assert err <= WGRAD_RTOL / 10, (p.A.shape, p.G.shape, err)


# ---- the per-point field (K5, K6) at the published width ---------------------

def _k5_chain(wts, xyz, vd, zs, zt):
    """K5's decoder on points with a direction each (xyz, vd (1, M, 3)), as
    csrc/render_common.cuh:field_chain sums it: every dense layer on
    dense_mma, the viewdir layer's trunk and direction-encoding operand
    pairs in one accumulator, the heads in float32. Returns (logit, rgb,
    rows, pre): the stash's layer-input rows a_* (K7's, a_dpe included) and
    every ReLU layer's pre-activation, keyed as render.stashed_chain keys
    them."""
    pe = positional_encoding(xyz[0], wts.num_xyz_freq)
    dpe = positional_encoding(vd[0], wts.num_dir_freq)
    rows, pre = {"a_xyz": pe, "a_dpe": dpe}, {}
    pre["xyz"] = dense_steps(pe, wts.w_xyz) + wts.b_xyz
    y = torch.relu(pre["xyz"])
    for j in range(wts.n_shape):
        rows[f"a_sh{j}"] = y = y + zs[0, j]
        pre[f"sh{j}"] = dense_steps(y, wts.w_sh[j]) + wts.b_sh[j]
        y = torch.relu(pre[f"sh{j}"])
    rows["a_es"] = y
    rows["a_e"] = e = _mma_layer(y, wts.w_es, wts.b_es, False)
    logit = e @ wts.w_sg[:, None] + wts.b_sg
    pre["v"] = dense_steps(e, wts.w_vd_a, dpe, wts.w_vd_b) + wts.b_vd
    h = torch.relu(pre["v"])
    for j in range(wts.n_tex):
        rows[f"a_tx{j}"] = h = h + zt[0, j]
        pre[f"tx{j}"] = dense_steps(h, wts.w_tx[j]) + wts.b_tx[j]
        h = torch.relu(pre[f"tx{j}"])
    rows["a_r1"] = h
    pre["hh"] = dense_steps(h, wts.w_r1) + wts.b_r1
    rows["a_hh"] = hh = torch.relu(pre["hh"])
    return logit, hh @ wts.w_r2 + wts.b_r2, rows, pre


@functools.cache
def _published_field_case(seed, R=4, keep=128):
    """The published decoder and `keep` of _rays' R x 64 points of one object,
    each with its own direction (its ray's turned by a small random offset,
    as chip_smoke.py:field_train_inputs makes them), chosen where no ReLU
    unit lies within KINK_RTOL of zero in float64 (margins relative to the
    layer's largest |pre-activation| at that point); cotangents of sigma and
    rgb N(0, 1)."""
    wts = _published_decoder(seed)
    (xyz, vd, _, zs, zt), _ = _rays(wts, seed, R)
    rng = np.random.default_rng(seed + 100)
    pts = xyz.reshape(1, -1, 3)
    turn = torch.from_numpy(rng.normal(size=pts.shape).astype(np.float32))
    dirs = F.normalize(vd[:, :, None, :].expand_as(xyz).reshape(1, -1, 3) + 0.1 * turn, dim=-1)
    w64 = _f64(wts)
    hdir = positional_encoding(dirs.double(), wts.num_dir_freq) @ w64.w_vd_b
    with torch.no_grad():
        _, pre, _, _ = render.stashed_chain(w64, pts.double(), hdir, zs.double(), zt.double())
    clear = torch.ones(pts.shape[1], dtype=torch.bool)
    for k, p in pre.items():
        if k != "e":
            clear &= (p.abs() / p.abs().amax(-1, keepdim=True) > KINK_RTOL).all(-1)[0]
    idx = clear.nonzero().flatten()[:keep]
    assert len(idx) == keep, "too few points clear of kinks"
    cot = [torch.from_numpy(rng.normal(size=(1, keep, n)).astype(np.float32)) for n in (1, 3)]
    return wts, (pts[:, idx].contiguous(), dirs[:, idx].contiguous(), zs, zt), tuple(cot)


def test_k5_chain_split_product_is_float32_accurate(one_thread):
    """K5 at the published width, its nine dense layers as dense_mma sums
    them and the viewdir layer's two operand pairs in one accumulator:
    sigma and rgb within a tenth of VALUE_ATOL of the float64 plain
    version (ops/field.py:field_fwd_plain)."""
    from supnerf_tpu_torch.ops import field

    wts, args, _ = _published_field_case(0)
    logit, rgb, _, _ = _k5_chain(wts, *args)
    got = (F.softplus(logit)[None], rgb[None])
    want = field.field_fwd_plain(_f64(wts), *(t.double() for t in args))
    for name, a, b in zip(("sigma", "rgb"), got, want):
        err = float((a.double() - b).abs().max())
        assert err <= VALUE_ATOL["rgb"] / 10, (name, err)


def _encoding_vjp(x, degree, g):
    """The encoding's chain rule (the kernels' encode_backward_points) on
    float32 values: the cotangent of x given that of its encoding."""
    with torch.enable_grad():
        x = x.detach().requires_grad_(True)
        return torch.autograd.grad(positional_encoding(x, degree), x, g)[0]


@pytest.mark.parametrize("seed", [0, 1])
def test_k6_split_product_is_float32_accurate(seed, one_thread):
    """K6 at the published width: the gates of K5's chain as dense_mma sums
    it (_k5_chain), the transposed chain on dense_mma as
    csrc/field_bwd.cu orders it (rgb_hidden, the texture blocks, the
    viewdir layer's trunk rows, encoding_shape with the sigma head's
    gradient added in float32, the shape blocks, the first layer's encoding
    columns), the direction encodings' cotangent g_v @ Wvd_b^T in float32:
    dxyz, dviewdir, dzs and dzt within a tenth of GRAD_RTOL of the float64
    plain version (ops/field.py:field_bwd_plain), on points clear of ReLU
    kinks."""
    from supnerf_tpu_torch.ops import field

    wts, args, (g_sigma, g_rgb) = _published_field_case(seed)
    xyz, vd, zs, zt = args
    logit, _, _, pre = _k5_chain(wts, *args)
    gate = {k: (p > 0).float() for k, p in pre.items()}
    cur = dense_steps(gate["hh"] * (g_rgb[0] @ wts.w_r2.t()), wts.wt_r1)
    dzt = [None] * wts.n_tex
    for j in reversed(range(wts.n_tex)):
        cur = dense_steps(gate[f"tx{j}"] * cur, wts.wt_tx[j])
        dzt[j] = cur.sum(0)
    g_v = gate["v"] * cur
    dvd = _encoding_vjp(vd[0], wts.num_dir_freq, g_v @ wts.w_vd_b.t())
    g_e = dense_steps(g_v, wts.wt_vd_a) + (g_sigma[0] * torch.sigmoid(logit)) * wts.w_sg
    cur = dense_steps(g_e, wts.wt_es)
    dzs = [None] * wts.n_shape
    for j in reversed(range(wts.n_shape)):
        cur = dense_steps(gate[f"sh{j}"] * cur, wts.wt_sh[j])
        dzs[j] = cur.sum(0)
    dxyz = _encoding_vjp(xyz[0], wts.num_xyz_freq, dense_steps(gate["xyz"] * cur, wts.wt_xyz))
    got = (dxyz[None], dvd[None], torch.stack(dzs)[None], torch.stack(dzt)[None])
    want = field.field_bwd_plain(_f64(wts), *(t.double() for t in args), g_sigma.double(),
                                 g_rgb.double())
    for name, a, b in zip(("dxyz", "dviewdir", "dzs", "dzt"), got, want):
        assert rel_err(a, b) <= GRAD_RTOL / 10, (name, rel_err(a, b))


@pytest.mark.parametrize("seed", [0, 1])
def test_k7_stash_split_product_is_float32_accurate(seed, one_thread):
    """K7's per-point stash at the published width: the layer-input rows A_l
    of K5's chain (_k5_chain, a_dpe included) and the pre-activation
    gradient rows G_l of K6's transposed chain on dense_mma, in
    csrc/render_common.cuh:field_backward's order (rgb_out's gradient and
    the sigma head's softplus gate in float32, the gates from the
    recomputed pre-activations), written by render.write_stash in its
    per-point layout: each column block within a tenth of GRAD_RTOL of
    ops/field.py:field_train_bwd_stash_plain's in float64; the weight
    gradients K4 forms from them (as wgrad_emulated sums them) within a
    tenth of WGRAD_RTOL of float64's, on points clear of ReLU kinks."""
    from supnerf_tpu_torch.ops import field

    wts, args, (g_sigma, g_rgb) = _published_field_case(seed)
    M, W, ns, nt = args[0].shape[1], wts.W, wts.n_shape, wts.n_tex
    L = render.stash_layout(wts, per_point=True)
    logit, _, rows, pre = _k5_chain(wts, *args)
    gate = {k: (p > 0).float() for k, p in pre.items()}
    g = {"sig": g_sigma[0] * torch.sigmoid(logit), "rgb": g_rgb[0]}
    g["hh"] = gate["hh"] * (g_rgb[0] @ wts.w_r2.t())
    cur = dense_steps(g["hh"], wts.wt_r1)
    for j in reversed(range(nt)):
        g[f"tx{j}"] = gate[f"tx{j}"] * cur
        cur = dense_steps(g[f"tx{j}"], wts.wt_tx[j])
    g["v"] = gate["v"] * cur
    g["e"] = dense_steps(g["v"], wts.wt_vd_a) + g["sig"] * wts.w_sg
    cur = dense_steps(g["e"], wts.wt_es)
    for j in reversed(range(ns)):
        g[f"sh{j}"] = gate[f"sh{j}"] * cur
        cur = dense_steps(g[f"sh{j}"], wts.wt_sh[j])
    g["xyz"] = gate["xyz"] * cur
    pt = torch.zeros((M, L["ld_pt"]))
    render.write_stash(wts, dict(rows), g, pt, per_point=True)

    pt64 = torch.zeros((M, L["ld_pt"]), dtype=torch.float64)
    field.field_train_bwd_stash_plain(_f64(wts), *(t.double() for t in args), g_sigma.double(),
                                      g_rgb.double(), pt64)
    widths = {"a_xyz": 63, "a_sh": ns * W, "a_es": W, "a_e": W, "a_tx": nt * W, "a_r1": W,
              "a_hh": W // 2, "g_xyz": W, "g_sh": ns * W, "g_e": W, "g_sig": 1, "g_v": W,
              "g_tx": nt * W, "g_hh": W // 2, "g_rgb": 3, "a_dpe": 27}
    for name, n in widths.items():
        a, b = pt[:, L[name]:L[name] + n].double(), pt64[:, L[name]:L[name] + n]
        assert rel_err(a, b) <= GRAD_RTOL / 10, (name, rel_err(a, b))

    grads = render._linear_grad_buffers(wts, "cpu")
    for p, p64 in zip(render.wgrad_problems(wts, pt, None, grads),
                      render.wgrad_problems(_f64(wts), pt64, None, grads)):
        err = rel_err(wgrad_steps(p.A, p.G), p64.G.t() @ p64.A)
        assert err <= WGRAD_RTOL / 10, (p.A.shape, p.G.shape, err)


def thread_flags(acc, rtol):
    """dense_mma_t's flag test on a W 256 ReLU layer's pre-activations acc
    (rows, 256; float32 sums, bias added): a value within rtol of the
    largest |value| among its thread's 8 values of the row (warp c // 32,
    thread (c % 8) // 2 of it: columns 32 w + 8 t + 2 tig + h)."""
    rows, N = acc.shape
    group = (torch.arange(N) // 32) * 4 + (torch.arange(N) % 8) // 2
    scale = torch.zeros_like(acc)
    for gi in group.unique():
        cols = group == gi
        scale[:, cols] = acc[:, cols].abs().amax(1, keepdim=True)
    return acc.abs() <= scale * rtol


def refine(acc, exact64):
    """dense_mma's kRefine step on a W 256 ReLU layer's pre-activations acc:
    a value flagged at 2^-20 (thread_flags) is replaced by exact64 (the
    float64 sum of the same float32 operands) rounded to float32. Returns
    (the refined values, the flags)."""
    flagged = thread_flags(acc, 2.0 ** -20)
    return torch.where(flagged, exact64.float(), acc), flagged


@pytest.mark.parametrize("seed", [0, 1])
def test_refine_settles_the_viewdir_layer_with_its_direction_term(seed, one_thread):
    """The viewdir layer of K5/K6 at units built to sit at a kink: for every
    column the bias is minus the float64 pre-activation (trunk and
    direction term) of one point, rounded to float32, so that point's exact
    pre-activation is that rounding's residue, below float32's resolution
    of the sum. Its gate from the float32 sum (dense_mma without kRefine)
    is then decided by the summation order, and so is a refine that
    recomputes only the trunk's product in float64 and adds the direction
    term as a separate float32 layer (as an accumulated direction layer
    would leave it): both take the other gate than float64 at some of those
    units. The kRefine step over both operand pairs flags every unit whose
    float32 gate is wrong and gives float64's gate at every unit of the
    layer."""
    wts, args, _ = _published_field_case(seed)
    _, _, rows, _ = _k5_chain(wts, *args)
    e, dpe = rows["a_e"], rows["a_dpe"]
    trunk64 = e.double() @ wts.w_vd_a.double()
    dir64 = dpe.double() @ wts.w_vd_b.double()
    rows = torch.arange(wts.W) % e.shape[0]           # one built unit per column
    cols = torch.arange(wts.W)
    bias = -(trunk64 + dir64)[rows, cols].float()
    exact = trunk64 + dir64 + bias.double()
    acc = dense_steps(e, wts.w_vd_a, dpe, wts.w_vd_b) + bias
    trunk_only = (trunk64 + ((dpe @ wts.w_vd_b) + bias).double()).float()
    refined, flagged = refine(acc, exact)
    gate64 = exact > 0
    wrong = (acc > 0) != gate64
    assert bool(wrong[rows, cols].any())
    assert bool(((trunk_only > 0) != gate64)[rows, cols].any())
    assert bool(flagged[wrong].all())
    assert torch.equal(refined > 0, gate64)


@pytest.mark.parametrize("seed", [0, 1])
def test_gate_step_reaches_every_gate_refine_leaves_wrong(seed, one_thread):
    """The viewdir layer's kinks built as in the case above, now against the
    exact function: the float64 plain version's pre-activation
    (render.stashed_chain on float64 operands, float64 inputs all the way).
    kRefine's gate is exact for the kernel's float32 inputs, and at some of
    the built units that is the other side from the exact function's: the
    float32 rounding of the layers before (~1e-8 of the row's scale)
    outweighs the built residue. Every such unit lies in a row the refine
    step flags, so field_chain's exact step (render_common.cuh:
    field_exact64: the row's chain in float64, the layer's output row
    replaced by its rounding) reaches it: with the flagged rows so
    replaced, every gate of the layer is the exact function's."""
    wts, args, _ = _published_field_case(seed)
    _, _, rows, _ = _k5_chain(wts, *args)
    e, dpe = rows["a_e"], rows["a_dpe"]
    trunk64 = e.double() @ wts.w_vd_a.double()
    dir64 = dpe.double() @ wts.w_vd_b.double()
    built = torch.arange(wts.W) % e.shape[0], torch.arange(wts.W)   # one unit per column
    bias = -(trunk64 + dir64)[built].float()
    acc = dense_steps(e, wts.w_vd_a, dpe, wts.w_vd_b) + bias
    refined, flagged = refine(acc, trunk64 + dir64 + bias.double())
    w64 = dataclasses.replace(_f64(wts), b_vd=bias.double())
    xyz, vd, zs, zt = (t.double() for t in args)
    with torch.no_grad():
        _, pre, _, _ = render.stashed_chain(
            w64, xyz, positional_encoding(vd, wts.num_dir_freq) @ w64.w_vd_b, zs, zt)
    wrong = (refined > 0) != (pre["v"][0] > 0)
    assert bool(wrong[built].any())
    assert bool(flagged.any(1)[wrong.any(1)].all())
    settled = torch.where(flagged.any(1, keepdim=True), torch.relu(pre["v"][0]).float(),
                          torch.relu(refined))
    assert torch.equal(settled > 0, pre["v"][0] > 0)


@pytest.mark.parametrize("seed", [0, 1])
def test_exact_window_is_wider_than_the_inputs_rounding(seed, one_thread):
    """field_chain's exact step takes a row whose refined value lies within
    2^-24 (render_common.cuh:kExactRtol) of its terms' magnitude |b| +
    sum_k |a_k w_k|. At the published width that magnitude is, at the
    median unit of every ReLU layer, over 1.5 times the row's largest
    |pre-activation|, so the window reaches ~9e-8 of that largest value: more
    than three times the widest margin at which a refined gate differed
    from the exact function's on the card (2.3e-8, chip_smoke.py at 8 x
    65,536 points)."""
    wts, args, _ = _published_field_case(seed)
    _, _, rows, pre = _k5_chain(wts, *args)
    layers = {"xyz": ([rows["a_xyz"]], [wts.w_xyz], wts.b_xyz),
              "v": ([rows["a_e"], rows["a_dpe"]], [wts.w_vd_a, wts.w_vd_b], wts.b_vd),
              "hh": ([rows["a_r1"]], [wts.w_r1], wts.b_r1)}
    layers.update({f"sh{j}": ([rows[f"a_sh{j}"]], [wts.w_sh[j]], wts.b_sh[j])
                   for j in range(wts.n_shape)})
    layers.update({f"tx{j}": ([rows[f"a_tx{j}"]], [wts.w_tx[j]], wts.b_tx[j])
                   for j in range(wts.n_tex)})
    assert set(layers) == set(pre)
    for key, (ins, ws, b) in layers.items():
        mag = sum(a.double().abs() @ w.double().abs() for a, w in zip(ins, ws)) + b.double().abs()
        largest = pre[key].double().abs().amax(1, keepdim=True)
        ratio = float((mag / largest).median())
        assert ratio > 1.5, (key, ratio)
        assert 2.0 ** -24 * ratio > 3 * 2.3e-8, (key, ratio)
