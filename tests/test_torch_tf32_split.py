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
the kernels themselves."""
import numpy as np
import pytest
import torch

WGRAD_RTOL = 1e-4
GRAD_RTOL = 1e-3
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
