"""The port's training render in the kernels' bfloat16 mode on the CPU: the
plain versions of K1 with the training encodings (A5) and of K3 + K4 in
both data_grads modes (A6) against the JAX package's training kernels
(pallas_render.py:_make_render_train_core, the core of
field_composite_train_pallas, at dtype=bfloat16 in interpret mode), one
unified train step with field_dtype "bfloat16" against JAX's step on its
Pallas path at bfloat16, the training stash's layout in the mode, and K4's
plain version in the mode (both product operands rounded, the bias sums
the unrounded cotangents).

Each comparison asserts, as tests/test_torch_bf16.py's do, that the port
lies within a stated tolerance of JAX's bfloat16 result and that this
tolerance is at most a tenth of JAX's own bfloat16-against-float32
distance on the same inputs. The two sides sum float32 products in other
orders (XLA's dot, torch's matmul), and where such a sum differs by a unit
a value can round to the neighbouring bfloat16 value at the next layer's
operand; the largest such difference measured here is 3.3e-6 of the
sigma head's bias gradient (its float32 sum over the points equals the
float64 one to 1.5e-8, so it is a per-point rounding, not the sum's
order). The training encodings are exact sines and cosines: torch's and
XLA's differ by a float32 unit at ~5 % of the arguments, which flips a
bfloat16 value only near a tie, and at these inputs none does.

Shapes: W 32, 3 shape blocks and 1 texture block, 2 objects x 16 rays x 8
samples; the train step at tests/test_torch_train_step.py's tiny config
(1 shape block, latent 32, 4 objects of 32 rays), its batch with the
points given (the expanded prep, compact=False): from compact rays each
package forms origin + t * direction with its own float32 rounding, and
a unit of a coordinate becomes ~512 units of sin(2^9 x), which rounds to
another bfloat16 value at ~1 % of the top frequency's encodings (measured
1.3e-3 of the first layer's weight gradient from it alone).

Serial cost on an 8-core CPU: ~80 s, most of it JAX: the training kernels
in interpret mode (three runs, ~20 s) and two train steps on the Pallas
path with the ResNet34 encoder (initialisation and compilation)."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_threads  # noqa: F401
from supnerf_tpu.models import build_model as jax_build_model
from supnerf_tpu.models.nerf_mlp import CodeNeRFDecoder as JaxDecoder
from supnerf_tpu.ops import pallas_field
from supnerf_tpu.ops import pallas_render
from supnerf_tpu.ops.pallas_field import (
    _precast_weights,
    conditioned_latents_batched,
    flatten_weights,
)
from supnerf_tpu.ops.pallas_field import pack_decoder_params as jax_pack
from supnerf_tpu.training import TrainBatch as JaxBatch
from supnerf_tpu.training import TrainConfig as JaxConfig
from supnerf_tpu.training import init_train_state as jax_init_state
from supnerf_tpu.training import make_train_step
from supnerf_tpu_torch.models.convert import convert_decoder, convert_train_state
from supnerf_tpu_torch.models.nerf_mlp import CodeNeRFDecoder
from supnerf_tpu_torch.ops import render
from supnerf_tpu_torch.training import train_step as port
from torch_memory import release_memory_after_module  # noqa: F401

W, NS, NT = 32, 3, 1
B, R, S = 2, 16, 8
TILE_R = 8                     # rays per JAX kernel tile: two tiles an object
N_XYZ, N_DIR = 10, 4

# tolerances of the port against JAX at bfloat16: the forward as
# tests/test_torch_bf16.py's (measured at most 3e-8 on rgb and acc, 9.5e-7
# on depth); every gradient relative to its largest |JAX bfloat16 value|
# (measured at most 3.3e-6, the sigma head's bias, whose JAX
# bfloat16-vs-float32 distance is 6.5e-5 of it)
FWD_TOL = {"rgb": 1e-6, "depth": 5e-6, "acc": 1e-6}
GRAD_RTOL = 6e-6
# the train step: loss_total, loss_rgb and psnr (measured equal), and each
# decoder tensor's and code table's gradient, as the optimizer's first
# moment, relative to its largest value (measured at most 2.4e-7, where
# JAX's bfloat16-vs-float32 distance is at least 1.7e-4)
STEP_LOSS_TOL = 1e-6
STEP_GRAD_RTOL = 2e-6


def _close(name, port, j16, j32, tol):
    """port within tol of JAX's bfloat16 result, tol <= a tenth of JAX's
    bfloat16-vs-float32 distance."""
    port, j16, j32 = (np.asarray(a, np.float64) for a in (port, j16, j32))
    err, spread = float(np.abs(port - j16).max()), float(np.abs(j16 - j32).max())
    assert err <= tol, f"{name}: port vs JAX bfloat16 {err:.3e} > tol {tol:.1e}"
    assert tol <= spread / 10, f"{name}: tol {tol:.1e} > JAX's bf16-vs-f32 {spread:.3e} / 10"
    return err, spread


def _rel_close(name, port, j16, j32, rtol):
    return _close(name, port, j16, j32, rtol * float(np.abs(np.asarray(j16)).max()))


def _inputs():
    rng = np.random.default_rng(0)
    vd = rng.normal(size=(B, R, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    z = (np.linspace(2.0, 6.0, S)[None] + 0.05 * rng.uniform(size=(B, S))).astype(np.float32)
    xyz = (vd[:, :, None, :] * z[:, None, :, None] * 0.3).astype(np.float32)
    codes = (rng.normal(size=(2, B, W)) * 0.3).astype(np.float32)
    heads = [rng.normal(size=s).astype(np.float32) for s in ((B, R, 3), (B, R), (B, R))]
    return xyz, vd, z, codes, heads


@pytest.fixture(scope="module")
def kernels():
    """The JAX decoder's pack, the port's bfloat16 pack of the same weights,
    the inputs, the latents, and JAX's training core (forward outputs and
    every cotangent: dxyz, dviewdir, dz, dzs, dzt and the 17 weight and bias
    gradients) at bfloat16 in both data_grads modes and at float32."""
    xyz, vd, z, codes, heads = _inputs()
    rng = np.random.default_rng(1)
    x4 = jnp.asarray(rng.normal(size=(4, 3)).astype(np.float32))
    jdec = JaxDecoder(shape_blocks=NS, texture_blocks=NT, W=W, latent_dim=W)
    params = jax.tree.map(np.asarray, jdec.init(jax.random.PRNGKey(0), x4, x4, jnp.zeros(W),
                                                jnp.zeros(W))["params"])
    packed = jax_pack(params, NS, NT)
    zs, zt = conditioned_latents_batched(packed, jnp.asarray(codes[0]), jnp.asarray(codes[1]))

    def run(dtype, data_grads):
        core = pallas_render._make_render_train_core(
            S, NS, NT, N_XYZ, N_DIR, TILE_R * S, TILE_R * S, R // TILE_R, R // TILE_R, dtype,
            False, jnp.float32, True, data_grads)
        wt = _precast_weights(flatten_weights(packed), dtype)
        outs, vjp = jax.vjp(core, *(jnp.asarray(a) for a in (xyz, vd, z)), zs, zt, wt)
        return jax.tree.map(np.asarray, (outs, vjp(tuple(jnp.asarray(h) for h in heads))))

    ref = {(jnp.bfloat16, True): run(jnp.bfloat16, True),
           (jnp.bfloat16, False): run(jnp.bfloat16, False),
           (jnp.float32, True): run(jnp.float32, True)}
    tdec = CodeNeRFDecoder(NS, NT, W, W, field_dtype="bfloat16")
    tdec.load_state_dict(convert_decoder(params, NS, NT), strict=True)
    lat = tuple(torch.from_numpy(np.array(a)) for a in (zs, zt))
    return render.pack_decoder_params(tdec), (xyz, vd, z, codes, heads), lat, ref


def _in_linear_layout(dwt):
    """JAX's 17 weight and bias gradients in the order and torch.nn.Linear
    layout of render.linear_params_of."""
    (dwxyz, dbxyz, dwsh, dbsh, dwes, dbes, dwsg, dbsg, dwvd_a, dwvd_b, dbvd, dwtx, dbtx,
     dwr1, dbr1, dwr2, dbr2) = (np.asarray(a, np.float32) for a in dwt)
    out = [dwxyz.T, dbxyz.reshape(-1)]
    for j in range(NS):
        out += [dwsh[j].T, dbsh[j]]
    out += [dwes.T, dbes.reshape(-1), dwsg.T, dbsg.reshape(-1),
            np.concatenate([dwvd_a, dwvd_b], 0).T, dbvd.reshape(-1)]
    for j in range(NT):
        out += [dwtx[j].T, dbtx[j]]
    return out + [dwr1.T, dbr1.reshape(-1), dwr2.T, dbr2.reshape(-1)]


def test_train_fwd_bf16_matches_pallas(kernels):
    """K1's plain version with the training encodings (pe "train": exact
    sines and cosines rounded, the direction term rounded) against the
    training core's forward (A5: _render_kernel on per-object latents at
    dtype=bfloat16)."""
    wts, (xyz, vd, z, _, _), (zs, zt), ref = kernels
    t = torch.from_numpy
    render.reset_launch_counts()
    out = render.render_fwd(wts, t(xyz), t(vd), t(z), zs, zt, pe="train")
    assert not any(render.LAUNCHES.values())        # CPU tensors: the plain version
    for name, a, j16, j32 in zip(("rgb", "depth", "acc"), out, ref[jnp.bfloat16, True][0],
                                 ref[jnp.float32, True][0]):
        _close(name, a.numpy(), j16, j32, FWD_TOL[name])


@pytest.mark.parametrize("data_grads", [False, True], ids=["data_grads_off", "data_grads"])
def test_train_bwd_bf16_matches_pallas(kernels, data_grads):
    """K3 + K4's plain version in the bfloat16 mode (render_train_bwd on CPU
    tensors: train_bwd_stash_plain_bf16, then wgrad_plain in the mode)
    against the training core's VJP (A6: _render_train_bwd_kernel at
    dtype=bfloat16) in the same data_grads mode: dzs, dzt, the 17 weight and
    bias gradients, float32 and unrounded (no leaf of JAX's is
    bfloat16-exact either), and in the data mode dxyz, dviewdir and dz; the
    float32 distance from JAX's data mode, whose shared outputs the other
    mode repeats."""
    wts, (xyz, vd, z, _, heads), (zs, zt), ref = kernels
    t = torch.from_numpy
    render.reset_launch_counts()
    dzs, dzt, grads, *data = render.render_train_bwd(wts, t(xyz), t(vd), t(z), zs, zt, False,
                                                     *(t(h) for h in heads),
                                                     data_grads=data_grads)
    assert not any(render.LAUNCHES.values())
    j16, j32 = ref[jnp.bfloat16, data_grads][1], ref[jnp.float32, True][1]
    if data_grads:
        for name, a, b, c in zip(("dxyz", "dviewdir", "dz"), data, j16, j32):
            _rel_close(name, a.numpy(), b, c, GRAD_RTOL)
    else:
        assert data == [] and all(np.abs(np.asarray(a)).max() == 0 for a in j16[:3])
    for name, a, b, c in zip(("dzs", "dzt"), (dzs, dzt), j16[3:5], j32[3:5]):
        _rel_close(name, a.numpy(), b, c, GRAD_RTOL)
    names = [f"{n}.{k}" for n in render.linear_names(NS, NT) for k in ("weight", "bias")]
    for name, a, b, c in zip(names, grads, _in_linear_layout(j16[5]),
                             _in_linear_layout(j32[5])):
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape, name
        assert not torch.equal(a, render.bf16_round(a)), f"{name} is bfloat16-exact"
        assert not np.array_equal(b, np.asarray(jnp.asarray(b).astype(jnp.bfloat16),
                                                np.float32)), f"JAX's {name}"
        _rel_close(name, a.numpy(), b, c, GRAD_RTOL)


def test_train_stash_bf16_layout(kernels):
    """The training stash in the bfloat16 mode: stash_layout's, every column
    block and row starting on 16 bytes (K4's copies), the same as the
    float32 mode's; K3's plain version writes every A-side column (a_*,
    r_dpe) as bfloat16-exact values and the G side (g_*, r_gv) in float32,
    r_gv the sum over the ray's samples of the rounded g_v; and K4's
    problems on it pass check_wgrad_problems."""
    wts, (xyz, vd, z, _, heads), (zs, zt), _ = kernels
    t = torch.from_numpy
    L = render.stash_layout(wts)
    assert L == render.stash_layout(dataclasses.replace(wts, field_dtype="float32"))
    blocks = [n for n in L if n.startswith(("a_", "g_", "r_"))]
    assert all(L[n] % 4 == 0 for n in blocks) and L["ld_pt"] % 4 == L["ld_ray"] % 4 == 0
    pt = torch.full((B * R * S, L["ld_pt"]), float("nan"))
    ray = torch.full((B * R, L["ld_ray"]), float("nan"))
    render.render_train_bwd_stash(wts, t(xyz), t(vd), t(z), zs, zt, False,
                                  *(t(h) for h in heads), pt, ray)
    grads = render._linear_grad_buffers(wts, "cpu")
    probs = render.wgrad_problems(wts, pt, ray, grads)
    render.check_wgrad_problems(probs)
    a_side = [p.A for p in probs]
    g_side = [p.G for p in probs]
    assert all(torch.equal(a, render.bf16_round(a)) for a in a_side)
    assert all(bool(torch.isfinite(x).all()) for x in a_side + g_side)
    assert not any(torch.equal(g, render.bf16_round(g)) for g in g_side)
    d_dir = 3 * (2 * N_DIR + 1)
    g_v = pt[:, L["g_v"]:L["g_v"] + W].reshape(B * R, S, W)
    assert torch.equal(ray[:, L["r_gv"]:L["r_gv"] + W], render.bf16_round(g_v).sum(1))
    assert torch.equal(ray[:, :d_dir], render.bf16_round(ray[:, :d_dir]))


def test_wgrad_plain_bf16_rounds_products_not_biases():
    """K4's plain version in the bfloat16 mode: each weight gradient is
    bf16(G)^T bf16(A) summed in float32, each bias the column sums of the
    unrounded G (pallas_render.py's jnp.sum(g, 0)); the float32 mode's
    product takes the operands as they are."""
    g = torch.Generator().manual_seed(0)
    A = torch.randn((300, 20), generator=g)
    G = torch.randn((300, 12), generator=g)
    w = {m: torch.zeros((12, 24)) for m in ("float32", "bfloat16")}
    b = {m: torch.zeros(12) for m in w}
    for mode in w:
        render.wgrad([render.WgradProblem(A, G, w[mode], 4, b[mode])], field_dtype=mode)
    r = render.bf16_round
    assert torch.equal(w["bfloat16"][:, 4:], r(G).t() @ r(A))
    assert torch.equal(w["float32"][:, 4:], G.t() @ A)
    assert torch.equal(b["bfloat16"], G.sum(0)) and torch.equal(b["float32"], G.sum(0))
    assert not torch.equal(b["bfloat16"], r(G).sum(0))
    assert not torch.equal(w["bfloat16"], w["float32"])
    assert not w["bfloat16"][:, :4].any()


@pytest.fixture(scope="module")
def step_runs():
    """One unified train step at tests/test_torch_train_step.py's tiny
    config from one initial state: JAX's make_train_step on its Pallas path
    (field_impl "pallas") with resolve_decoder_kernel_config's kwargs at
    dtype=float32 and at bfloat16 (what it returns on an accelerator), and
    the port's train_step with net_hyperparams' field_dtype "bfloat16". The
    step is one with the encoder inactive (im_enc_rate 0): the NeRF branch
    renders the table rows, the same numbers on both sides. An active
    encoder's codes are averaged into them and carry the two packages'
    float32 convolution noise (test_torch_train_step.py holds their float32
    gradients to 1e-2 for it), which moves bfloat16 roundings; the encoder,
    its BatchNorm statistics and its losses run all the same. Returns
    {"float32": (state, metrics), "bfloat16": ..., "port": ...}."""
    from test_torch_train_step import PORT_CFG, TINY_HP, _rows

    jmodel = jax_build_model("supnerf", TINY_HP)
    jcfg = JaxConfig(latent_dim=32, im_enc_rate=0.0, lr_interval_model=1, lr_interval_codes=1,
                     field_impl="pallas")
    state = jax.tree.map(np.asarray, jax_init_state(jmodel, jax.random.PRNGKey(0),
                                                    n_instances=3, cfg=jcfg, img_size=32))
    arrays = _rows(compact=False)
    jbatch = JaxBatch(**{k: jnp.asarray(v) for k, v in arrays.items()})
    hpams = {"arch": "supnerf", "net_hyperparams": dict(TINY_HP, field_dtype="bfloat16")}
    kernel_config = pallas_field.resolve_decoder_kernel_config
    out = {}
    for name, dtype in (("float32", jnp.float32), ("bfloat16", jnp.bfloat16)):
        def config(model, variables, dtype=dtype):
            packed, kw = kernel_config(model, variables)
            return packed, dict(kw, dtype=dtype)

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(pallas_field, "resolve_decoder_kernel_config", config)
            st, m = make_train_step(jmodel, jcfg, donate=False)(state, jbatch,
                                                                jax.random.PRNGKey(0))
        out[name] = (convert_train_state(jax.tree.map(np.asarray, st), hpams, cfg=PORT_CFG),
                     jax.device_get(m))
    pstate = convert_train_state(state, hpams, cfg=PORT_CFG)
    assert pstate.model.field_dtype == "bfloat16"
    render.reset_launch_counts()
    metrics = port.train_step(pstate, port.TrainBatch.from_numpy(arrays, "cpu"),
                              dataclasses.replace(PORT_CFG, im_enc_rate=0.0), enc_active=False)
    assert not any(render.LAUNCHES.values())
    out["port"] = (pstate, metrics)
    return out


def test_train_step_bf16_matches_jax_pallas(step_runs):
    """The port's unified train step with field_dtype "bfloat16" (the NeRF
    branch through field_composite_train's bfloat16 plain versions) against
    JAX's on its Pallas path at bfloat16: the NeRF losses, and the gradient
    of every decoder tensor and both code tables (the optimizers' first
    moments, 0.1 x the gradient after one step), each within its stated
    tolerance, at most a tenth of JAX's own bfloat16-against-float32
    distance."""
    from test_torch_train_step import REFINER

    (p, pm), (j16, m16), (j32, m32) = (step_runs[k] for k in ("port", "bfloat16", "float32"))
    # not loss_occ: it reads acc, whose compositing is float32 in both modes,
    # and JAX's two precisions part there by 9 float32 units (5.4e-7)
    for k in ("loss_total", "loss_rgb", "psnr"):
        _close(k, pm[k], m16[k], m32[k], STEP_LOSS_TOL)
    names = [n for n, _ in p.model.named_parameters()] + ["shape_codes", "texture_codes"]
    checked = 0
    for name, a, b, c in zip(names, p.opt_model.m + p.opt_codes.m, j16.opt_model.m
                             + j16.opt_codes.m, j32.opt_model.m + j32.opt_codes.m):
        if name.startswith(("img_encoder.",) + REFINER):
            continue       # the NeRF branch's gradient reaches the decoder and the codes
        _rel_close(f"first moment of {name}", a.numpy(), b.numpy(), c.numpy(), STEP_GRAD_RTOL)
        checked += 1
    assert checked == 2 * (len(render.linear_names(1, 1)) + 2) + 2
    assert pm["enc_active"] == float(m16["enc_active"]) == 0.0
