"""chip_smoke.py's float64 arbitration of the render backward kernels on the
CPU, where each wrapper runs its plain version: take_out_kink_rays (through
train_bwd_at_kinks for K3 + K4 and render_bwd_at_kinks for K2) must pass
outputs that agree with the plain versions, take a ray out only where the
kernel's gate at a unit within KINK_RTOL differs from float64's, and fail a
ray that lies outside both references with no such unit. stash_gate must
read each ReLU's gate from K3's stash as the float32 pre-activation's sign.
take_out_kink_points, the per-point field's carve-out (K6, whose gates are
not shown), must take out a point outside both references only where it
has a unit within KINK_RTOL. k7_against_k6 must pass K7's outputs only
where K6's are the same bits, and gates_against_k5 K6's and K7's gates
only where they are K5's, word for word. A small decoder (W 64); the card
runs the same code at full width."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import torch_threads  # noqa: F401
import chip_smoke as cs
from supnerf_tpu_torch.models.nerf_mlp import CodeNeRFDecoder, positional_encoding
from supnerf_tpu_torch.ops import field, render

W, S, R = 64, 8, 5


@pytest.fixture
def case(monkeypatch):
    """_inputs() with the card's synchronisation a no-op, and torch on one
    thread (many small operations: intra-op threads of several test
    workers sharing the cores stall each other at every one)."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield _inputs()
    torch.set_num_threads(n)


def _inputs():
    """Decoder, inputs and cotangents of 2 objects from a numpy seed."""
    rng = np.random.default_rng(3)
    dec = CodeNeRFDecoder(3, 1, W, W)
    with torch.no_grad():
        for m in dec.modules():
            if isinstance(m, torch.nn.Linear):
                b = 1.0 / np.sqrt(m.in_features)
                for t in (m.weight, m.bias):
                    t.copy_(torch.from_numpy(rng.uniform(-b, b, t.shape).astype(np.float32)))
    wts = render.pack_decoder_params(dec)
    f32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
    vd = F.normalize(f32(rng.normal(size=(2, R, 3))), dim=-1)
    z = torch.sort(f32(rng.uniform(size=(2, S)) * 4 + 2), dim=-1).values
    xyz = (vd[:, :, None, :] * z[:, None, :, None] * 0.3).contiguous()
    codes = f32(rng.normal(size=(2, 2, W)) * 0.3)
    zs, zt = (t.contiguous() for t in render.conditioned_latents(wts, codes[0], codes[1]))
    cot = tuple(f32(rng.normal(size=s)) for s in ((2, R, 3), (2, R), (2, R)))
    return wts, (xyz, vd.contiguous(), z.contiguous(), zs, zt), cot


def test_train_bwd_at_kinks_passes_the_plain_version(case):
    wts, args, cot = case
    arb = cs.train_bwd_at_kinks(wts, args, False, cot, verbose=False)
    assert arb["ok"] and arb["off_ok"] and arb["same"] and arb["kinks"] == []
    assert arb["err"] == 0.0 and arb["off_err"] == 0.0


def test_render_bwd_at_kinks_passes_the_plain_version(case):
    wts, args, cot = case
    _, err, _, ok, kinks = cs.render_bwd_at_kinks(wts, args, False, cot, verbose=False)
    assert ok and kinks == [] and err == 0.0


@pytest.mark.parametrize("unit_gate", [None, False, True],
                         ids=["no_unit", "unit_gate_as_float64", "unit_gate_flipped"])
def test_a_ray_outside_both_references(case, monkeypatch, unit_gate):
    """One ray's dxyz moved outside both references. The ray is taken out,
    its cotangents zeroed and the rest compared again; the check passes only
    if the sample has a unit within KINK_RTOL at which the kernel's gate (a
    stand-in stash reader) differs from float64's (here float32 plain's
    agrees with float64's): not without such a unit, nor where the kernel's
    gate agrees."""
    wts, args, cot = case
    plain = render.render_train_bwd

    def shifted(*a, **kw):
        out = plain(*a, **kw)
        if kw.get("data_grads") and float(a[7][0, 1].abs().sum()) > 0:
            out[3][0, 1, 2, 0] += 1.0
        return out

    monkeypatch.setattr(render, "render_train_bwd", shifted)
    if unit_gate is not None:
        monkeypatch.setattr(cs, "ray_kink_units", lambda wts, args, o, r, gate=None:
                            [(2, "sh0", 7, 3e-9, gate(2, "sh0", 7), False, False)])
        monkeypatch.setattr(cs, "stash_gate", lambda *a: lambda smp, k, u: unit_gate)
    arb = cs.train_bwd_at_kinks(wts, args, False, cot, verbose=False)
    assert [k[:3] for k in arb["kinks"]] == [(0, 1, [2])]
    assert arb["kinks"][0][-1] is bool(unit_gate)
    assert arb["ok"] is bool(unit_gate) and arb["off_ok"] and arb["same"]


def test_stash_gate_reads_the_relu_gates(case):
    wts, args, cot = case
    xyz, vd, _, zs, zt = args
    gate = cs.stash_gate(wts, args, False, cot, 1, 3)
    hdir = positional_encoding(vd[1:2, 3:4], wts.num_dir_freq) @ wts.w_vd_b
    with torch.no_grad():
        _, pre, _, _ = render.stashed_chain(wts, xyz[1:2, 3], hdir, zs[1:2], zt[1:2])
    for k, p in pre.items():
        if k == "e":
            continue
        p = p.reshape(S, -1)
        got = torch.tensor([[gate(s, k, u) for u in range(p.shape[1])] for s in range(S)])
        assert torch.equal(got, p > 0), k


@pytest.mark.parametrize("units", [[], [("sh0", 7, 3e-9, None, False, False)]],
                         ids=["no_unit", "unit_gate_unknown"])
def test_a_point_outside_both_references(case, monkeypatch, units):
    """K6's per-point carve-out: one point's dxyz moved outside both
    references is taken out (its cotangents zeroed, every output evaluated
    again) and the check passes only if the point has a unit within
    KINK_RTOL (a stand-in kink_units); every other point then agrees."""
    wts, (xyz, vd, _, zs, zt), _ = case
    rng = np.random.default_rng(5)
    M = 7
    f32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
    args = (f32(rng.normal(size=(2, M, 3)) * 0.4),
            F.normalize(f32(rng.normal(size=(2, M, 3))), dim=-1).contiguous(), zs, zt)
    cot = (f32(rng.normal(size=(2, M, 1))), f32(rng.normal(size=(2, M, 3))))

    def evaluate(c):
        got = list(field.field_bwd(wts, *args, *c))
        if float(c[1][0, 2].abs().sum()) > 0:
            got[0] = got[0].clone()
            got[0][0, 2, 0] += 1.0
        ref64 = field.field_bwd_plain(cs.as_float64(wts), *(t.double() for t in args),
                                      *(t.double() for t in c))
        return got, field.field_bwd_plain(wts, *args, *c), ref64

    monkeypatch.setattr(cs, "kink_units", lambda *a, **kw: list(units))
    got, ref, ref64, c, kinks, _, at_kinks = cs.take_out_kink_points(
        "K6", wts, args, evaluate, cot, stash_gates=False)
    assert kinks == [(0, 2)] and at_kinks is bool(units)
    assert float(c[0][0, 2].abs().sum()) == 0 and float(c[1][0, 2].abs().sum()) == 0
    _, _, ok = cs.compare_at_kinks(("dxyz", "dviewdir", "dzs", "dzt"), got, ref, ref64,
                                   cs.GRAD_RTOL, verbose=False)
    assert ok


@pytest.mark.parametrize("ulp", [0, 1], ids=["same_bits", "one_ulp_apart"])
def test_k7_against_k6_asks_for_the_same_bits(case, monkeypatch, ulp):
    """k7_against_k6 with a stand-in K6 that returns K7's outputs (here
    field_train_bwd_stash's plain version's) passes with every output the
    same bits and no difference; with one point's dxyz moved by one ulp it
    fails, however small the difference."""
    wts, (_, _, _, zs, zt), _ = case
    rng = np.random.default_rng(7)
    M = 7
    f32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
    args = (f32(rng.normal(size=(2, M, 3)) * 0.4),
            F.normalize(f32(rng.normal(size=(2, M, 3))), dim=-1).contiguous(), zs, zt)
    cot = (f32(rng.normal(size=(2, M, 1))), f32(rng.normal(size=(2, M, 3))))
    ld = render.stash_layout(wts, per_point=True)["ld_pt"]

    def k6(w, *a):
        out = list(field.field_train_bwd_stash_plain(w, *a, torch.empty((2 * M, ld))))
        if ulp:
            out[0] = out[0].clone()
            out[0][1, 3, 2] = torch.nextafter(out[0][1, 3, 2], torch.tensor(float("inf")))
        return out

    monkeypatch.setattr(field, "field_bwd", k6)
    err, same, ok = cs.k7_against_k6(wts, args, cot)
    assert ok is (ulp == 0) and same == 4 - ulp
    assert err == 0.0 if ulp == 0 else 0.0 < err < 1e-5


@pytest.mark.parametrize("apart", [None, "K6", "K7", "K5 outputs"],
                         ids=["same_gates", "k6_one_bit_apart", "k7_one_bit_apart",
                              "k5_gate_build_apart"])
def test_gates_against_k5_asks_for_every_word(case, monkeypatch, apart):
    """gates_against_k5 with stand-ins for K5, K6 and K7 that write gate
    words made from the points (and give the same outputs with and without
    gates): it passes when all three write the same words, and counts a
    word apart wherever K6, or K7 in each of its chunks of one object (a
    stash budget of one object), flips one bit; it fails, with no word
    apart, where K5's gate build gives outputs one ulp from K5's."""
    wts, (_, _, _, zs, zt), _ = case
    rng = np.random.default_rng(11)
    M = 7
    f32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
    args = (f32(rng.normal(size=(2, M, 3))), f32(rng.normal(size=(2, M, 3))), zs, zt)
    cot = (f32(rng.normal(size=(2, M, 1))), f32(rng.normal(size=(2, M, 3))))

    def stand_in(name):
        def run(w, xyz, *rest, gates=None):
            out = xyz * 2.0
            if gates is not None:
                gates.copy_((xyz[..., 0, None, None] * 1e4).int().expand_as(gates))
                if name == apart:
                    gates[-1, 3, 2, 1] ^= 1
                if f"{name} outputs" == apart:
                    out = torch.nextafter(out, torch.tensor(float("inf")))
            return (out,)
        return run

    for name, fn in (("K5", "field_fwd"), ("K6", "field_bwd"), ("K7", "field_train_bwd_stash")):
        monkeypatch.setattr(field, fn, stand_in(name))
    monkeypatch.setattr(render, "STASH_BYTES",
                        M * render.stash_layout(wts, per_point=True)["ld_pt"] * 4)
    n, ok = cs.gates_against_k5(wts, args, cot)
    assert n == {"K6": 1, "K7": 2}.get(apart, 0) and ok is (apart is None)
