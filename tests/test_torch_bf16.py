"""The port's bfloat16 mode on the CPU: the plain versions of K1 (shared z,
AABB, the encodings in the kernel), K2 (both modes), K5 and K6 in the
kernels' bfloat16 mode against the JAX package's Pallas entry points at
dtype=bfloat16 in interpret mode, the plain decoder's bfloat16 mode
(nerf_mlp.decode_bf16) against flax's CodeNeRFDecoder(dtype=bfloat16),
run_tto_batch with field_dtype "bfloat16" against the JAX TTO on its
Pallas kernels at bfloat16, and the entry points that take the mode.

Each comparison asserts two things: the port lies within a stated
tolerance of JAX's bfloat16 result (float32 sums in another order on both
sides: XLA's dot against torch's matmul; a sum that differs by a float32
unit can round to another bfloat16 value at the next layer's operand), and
that tolerance is at most a tenth of JAX's own bfloat16-against-float32
distance on the same inputs, which shows that the port rounds where the
kernels round. The float32 mode is what the other tests of the port hold.

The port's doubling encodings (nerf_mlp.positional_encoding_doubling) are
XLA's in these tests (use_xla_encodings), computed as the JAX entry point
computes them: under jit for the forward entry points, op by op for the
custom_vjp ones under jax.grad. XLA's sin and cos differ from torch's by a
float32 unit at ~5 % of these arguments, and jit fuses the recurrence
otherwise than op-by-op dispatch (the two differ at 10,823 of the field
tests' 18,900 float32 values); the recurrence doubles a difference at each
of its nine steps, and at the field tests' points 3 to 23 of the 18,900
values then round to neighbouring bfloat16 values, up to 1e-4 in sigma.
That is a difference of the libraries' sin and of XLA's fusion, not of the
kernels' contract, so the tests feed both packages the same encodings, as
they feed both the same sampling draws elsewhere.

Serial cost on an 8-core CPU: ~2.5 min, most of it JAX's interpret
mode, the ResNet34's JAX init (~27 s) and the two JAX TTO runs."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_threads  # noqa: F401
from supnerf_tpu.models.nerf_mlp import CodeNeRFDecoder as JaxDecoder
from supnerf_tpu.models.nerf_mlp import positional_encoding_doubling as jax_doubling
from supnerf_tpu.ops import pallas_field
from supnerf_tpu.ops.pallas_field import field_apply_pallas, field_forward_pallas
from supnerf_tpu.ops.pallas_field import pack_decoder_params as jax_pack
from supnerf_tpu.geometry.boxes import invert_pose as jax_invert_pose
from supnerf_tpu.ops.pallas_render import (
    field_composite_aabb_apply,
    field_composite_aabb_pallas,
    field_composite_apply,
    field_composite_pallas,
    make_composite_grad_fn,
)
from supnerf_tpu.ops.volume_render import occupancy_loss as jax_occ_loss
from supnerf_tpu.ops.volume_render import rgb_loss_masked as jax_rgb_loss
from supnerf_tpu.render.renderer import render_rays_frustum as jax_render_frustum
from supnerf_tpu.tto import ObjectBatch as JaxBatch
from supnerf_tpu.tto import run_tto_batch as jax_run_tto_batch
from supnerf_tpu.tto.core import pose_param_fns as jax_pose_param_fns
from supnerf_tpu_torch.models.convert import convert_decoder
from supnerf_tpu_torch.models.nerf_mlp import CodeNeRFDecoder
from supnerf_tpu_torch.ops import field, render
from supnerf_tpu_torch.tto import core
from torch_memory import release_memory_after_module  # noqa: F401

W, NS, NT = 32, 3, 1
R, S = 19, 8              # rays (not a multiple of the JAX kernel's 4-ray tile), samples
B, M = 2, 150             # field: objects, points per object
JAX_TILES = {"tile_fwd": 32, "tile_bwd": 32}


def _decoders(seed=0):
    """The JAX decoder's variables and the port's float32 and bfloat16
    packs of the same weights."""
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.normal(size=(4, 3)).astype(np.float32))
    c = jnp.zeros((W,), jnp.float32)
    jmodel = JaxDecoder(shape_blocks=NS, texture_blocks=NT, W=W, latent_dim=W)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(seed), x, x, c, c)["params"])
    packs = {}
    for dtype in ("float32", "bfloat16"):
        tmodel = CodeNeRFDecoder(NS, NT, W, W, field_dtype=dtype)
        tmodel.load_state_dict(convert_decoder(params, NS, NT), strict=True)
        packs[dtype] = render.pack_decoder_params(tmodel)
    return jmodel, params, jax_pack(params, NS, NT), packs


@pytest.fixture(scope="module")
def decoders():
    return _decoders()


def use_xla_encodings(monkeypatch, jit: bool):
    """The port's doubling encodings from XLA (module docstring): jitted as
    the forward entry points compute them, or op by op as jax.grad runs the
    custom_vjp entry points."""
    pe = jax.jit(jax_doubling, static_argnums=1) if jit else jax_doubling

    def doubling(x, degree):
        return torch.from_numpy(np.asarray(pe(jnp.asarray(x.detach().numpy()), degree)))

    monkeypatch.setattr(render, "positional_encoding_doubling", doubling)


def _render_inputs(aabb):
    """One object's rays (R, S) through an object at ~4 units, codes, and
    for the AABB mode per-ray z and a hit mask with misses."""
    rng = np.random.default_rng(1)
    vd = rng.normal(size=(R, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    if aabb:
        z = np.sort(rng.uniform(2.0, 6.0, size=(R, S)), -1).astype(np.float32)
        hit = rng.uniform(size=R) > 0.3
        hit[0] = False
        xyz = (vd[:, None, :] * z[..., None] * 0.3).astype(np.float32)
    else:
        z = (np.linspace(2.0, 6.0, S) + 0.01 * rng.uniform(size=S)).astype(np.float32)
        hit = None
        xyz = (vd[:, None, :] * z[None, :, None] * 0.3).astype(np.float32)
    codes = (rng.normal(size=(2, W)) * 0.3).astype(np.float32)
    cots = [rng.normal(size=(R,) + s).astype(np.float32) for s in ((3,), (), ())]
    return xyz, vd, z, hit, codes, cots


def _close(name, port, j16, j32, tol):
    """port within tol of JAX's bfloat16 result, tol <= a tenth of JAX's
    bfloat16-vs-float32 distance; returns the three numbers."""
    port, j16, j32 = (np.asarray(a, np.float64) for a in (port, j16, j32))
    err, spread = float(np.abs(port - j16).max()), float(np.abs(j16 - j32).max())
    assert err <= tol, f"{name}: port vs JAX bfloat16 {err:.3e} > tol {tol:.1e}"
    assert tol <= spread / 10, f"{name}: tol {tol:.1e} > JAX's bf16-vs-f32 {spread:.3e} / 10"
    return err, spread


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))[None]


# tolerances of the port against JAX at bfloat16 (float32 sums in another
# order; measured at most 6e-8 on rgb, acc and sigma, 4.8e-7 on depth, and
# 1.1e-6 of the largest gradient)
FWD_TOL = {"rgb": 1e-6, "depth": 5e-6, "acc": 1e-6, "sigma": 1e-6}
GRAD_TOL = 1e-5           # relative to the largest |JAX bf16 gradient|


@pytest.mark.parametrize("mode", ["shared_z", "aabb", "pe_in_kernel"])
def test_render_fwd_bf16_matches_pallas(decoders, mode, monkeypatch):
    """K1's plain version in the bfloat16 mode against field_composite_pallas
    (A1; pe_in_kernel=True: A11a, exact encodings and an unrounded
    direction term) and field_composite_aabb_pallas (A3) at dtype=bfloat16."""
    _, _, packed, packs = decoders
    use_xla_encodings(monkeypatch, jit=True)
    xyz, vd, z, hit, codes, _ = _render_inputs(mode == "aabb")
    jargs = [jnp.asarray(a) for a in (xyz, vd, z)]
    jc = (jnp.asarray(codes[0]), jnp.asarray(codes[1]))

    def jax_fwd(dtype):
        kw = dict(dtype=dtype, tile_m=32, interpret=True)
        if mode == "aabb":
            return field_composite_aabb_pallas(packed, *jargs, jnp.asarray(hit), *jc, **kw)
        return field_composite_pallas(packed, *jargs, *jc, pe_in_kernel=mode == "pe_in_kernel",
                                      **kw)

    wts = packs["bfloat16"]
    zs, zt = render.conditioned_latents(wts, _t(codes[0]), _t(codes[1]))
    out = render.render_fwd_plain(wts, _t(xyz), _t(vd), _t(z), zs, zt,
                                  hit=None if hit is None else _t(hit),
                                  pe="exact" if mode == "pe_in_kernel" else "doubling")
    for name, a, j16, j32 in zip(("rgb", "depth", "acc"), out, jax_fwd(jnp.bfloat16),
                                 jax_fwd(jnp.float32)):
        _close(f"{mode} {name}", a[0].numpy(), j16, j32, FWD_TOL[name])


@pytest.mark.parametrize("mode", ["shared_z", "aabb"])
def test_render_grads_bf16_match_pallas(decoders, mode, monkeypatch):
    """K2's plain version in the bfloat16 mode (render_bwd_plain_bf16,
    through field_composite's autograd.Function on CPU tensors, the codes'
    gradients through the latent projections) against jax.grad through
    field_composite_apply (A2) and field_composite_aabb_apply (A4) at
    dtype=bfloat16. z's gradient too: per ray in the AABB mode."""
    _, _, packed, packs = decoders
    use_xla_encodings(monkeypatch, jit=False)
    xyz, vd, z, hit, codes, cots = _render_inputs(mode == "aabb")

    def jloss(dtype):
        def f(x, v, zz, sc, tc):
            kw = dict(dtype=dtype, interpret=True, **JAX_TILES)
            o = (field_composite_aabb_apply(packed, x, v, zz, jnp.asarray(hit), sc, tc, **kw)
                 if mode == "aabb" else field_composite_apply(packed, x, v, zz, sc, tc, **kw))
            return sum(jnp.sum(oo * c) for oo, c in zip(o, cots))

        return jax.grad(f, argnums=(0, 1, 2, 3, 4))(
            *(jnp.asarray(a) for a in (xyz, vd, z, codes[0], codes[1])))

    args = [_t(a).requires_grad_(True) for a in (xyz, vd, z, codes[0], codes[1])]
    wts = packs["bfloat16"]
    render.reset_launch_counts()
    if mode == "aabb":
        out = render.field_composite_aabb(wts, *args[:3], _t(hit), *args[3:])
    else:
        out = render.field_composite(wts, *args)
    grads = torch.autograd.grad(sum((o[0] * torch.from_numpy(c)).sum()
                                    for o, c in zip(out, cots)), args)
    assert not any(render.LAUNCHES.values())       # CPU tensors: the plain versions
    for name, g, j16, j32 in zip(("xyz", "viewdir", "z", "shapecode", "texturecode"), grads,
                                 jloss(jnp.bfloat16), jloss(jnp.float32)):
        _close(f"{mode} d{name}", g[0].numpy(), j16, j32,
               GRAD_TOL * float(np.abs(np.asarray(j16)).max()))


def _field_inputs():
    rng = np.random.default_rng(2)
    xyz = (rng.normal(size=(B, M, 3)) * 0.4).astype(np.float32)
    vd = rng.normal(size=(B, M, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    codes = (rng.normal(size=(2, B, W)) * 0.3).astype(np.float32)
    cots = [rng.normal(size=(B, M, k)).astype(np.float32) for k in (1, 3)]
    return xyz, vd, codes, cots


@pytest.mark.parametrize("pe_in_kernel", [False, True], ids=["A7", "A11b"])
def test_field_fwd_bf16_matches_pallas(decoders, pe_in_kernel, monkeypatch):
    """K5's plain version in the bfloat16 mode against field_forward_pallas
    at dtype=bfloat16, object by object: the encodings by the doubling
    recurrence (A7) or exact (A11b, exact_pe)."""
    _, _, packed, packs = decoders
    use_xla_encodings(monkeypatch, jit=True)
    xyz, vd, codes, _ = _field_inputs()
    wts = packs["bfloat16"]
    t = torch.from_numpy
    zs, zt = render.conditioned_latents(wts, t(codes[0]), t(codes[1]))
    sig, rgb = field.field_fwd_plain(wts, t(xyz), t(vd), zs, zt, exact_pe=pe_in_kernel)
    for b in range(B):
        def jfwd(dtype):
            return field_forward_pallas(packed, jnp.asarray(xyz[b]), jnp.asarray(vd[b]),
                                        jnp.asarray(codes[0, b]), jnp.asarray(codes[1, b]),
                                        dtype=dtype, tile_m=64, interpret=True,
                                        pe_in_kernel=pe_in_kernel)

        for name, a, j16, j32 in zip(("sigma", "rgb"), (sig[b], rgb[b]), jfwd(jnp.bfloat16),
                                     jfwd(jnp.float32)):
            _close(f"object {b} {name}", a.numpy(), j16, j32, FWD_TOL[name])


def test_field_grads_bf16_match_pallas(decoders, monkeypatch):
    """K6's plain version in the bfloat16 mode (through field_apply's
    autograd.Function on CPU tensors) against jax.grad through
    field_apply_pallas (A8) at dtype=bfloat16, object by object."""
    _, _, packed, packs = decoders
    use_xla_encodings(monkeypatch, jit=False)
    xyz, vd, codes, cots = _field_inputs()
    args = [torch.from_numpy(a).requires_grad_(True) for a in (xyz, vd, codes[0], codes[1])]
    out = field.field_apply(packs["bfloat16"], *args)
    grads = torch.autograd.grad(sum((o * torch.from_numpy(c)).sum()
                                    for o, c in zip(out, cots)), args)
    for b in range(B):
        def jgrad(dtype):
            def f(x, v, sc, tc):
                o = field_apply_pallas(packed, x, v, sc, tc, dtype=dtype, tile_fwd=64,
                                       tile_bwd=64, interpret=True)
                return sum(jnp.sum(oo * c[b]) for oo, c in zip(o, cots))

            return jax.grad(f, argnums=(0, 1, 2, 3))(
                *(jnp.asarray(a) for a in (xyz[b], vd[b], codes[0, b], codes[1, b])))

        for name, g, j16, j32 in zip(("xyz", "viewdir", "shapecode", "texturecode"), grads,
                                     jgrad(jnp.bfloat16), jgrad(jnp.float32)):
            _close(f"object {b} d{name}", g[b].numpy(), j16, j32,
                   GRAD_TOL * float(np.abs(np.asarray(j16)).max()))


def test_decoder_bf16_matches_flax(decoders):
    """The plain decoder's bfloat16 mode (CodeNeRFDecoder(field_dtype=
    "bfloat16"), flax TorchDense's contract: every layer and latent
    projection on bfloat16 operands, the exact encodings) against flax's
    CodeNeRFDecoder(dtype=bfloat16), values and the codes' and points'
    gradients."""
    jmodel, params, _, _ = decoders
    rng = np.random.default_rng(3)
    xyz = (rng.normal(size=(6, 5, 3)) * 0.4).astype(np.float32)
    vd = rng.normal(size=(6, 5, 3)).astype(np.float32)
    sc, tc = (rng.normal(size=(2, W)) * 0.3).astype(np.float32)
    cots = [rng.normal(size=(6, 5, k)).astype(np.float32) for k in (1, 3)]

    def jout(dtype):
        m = dataclasses.replace(jmodel, dtype=dtype)

        def f(x, v, s, t):
            o = m.apply({"params": params}, x, v, s, t)
            return sum(jnp.sum(oo * c) for oo, c in zip(o, cots)), o

        (_, o), g = jax.value_and_grad(f, argnums=(0, 1, 2, 3), has_aux=True)(
            *(jnp.asarray(a) for a in (xyz, vd, sc, tc)))
        return list(o) + list(g)

    tmodel = CodeNeRFDecoder(NS, NT, W, W, field_dtype="bfloat16")
    tmodel.load_state_dict(convert_decoder(params, NS, NT), strict=True)
    args = [torch.from_numpy(a).requires_grad_(True) for a in (xyz, vd, sc, tc)]
    out = tmodel(*args)
    grads = torch.autograd.grad(sum((o * torch.from_numpy(c)).sum() for o, c in zip(out, cots)),
                                args)
    names = ("sigma", "rgb", "dxyz", "dviewdir", "dshapecode", "dtexturecode")
    for name, a, j16, j32 in zip(names, list(out) + list(grads), jout(jnp.bfloat16),
                                 jout(None)):
        tol = (FWD_TOL[name] if name in ("sigma", "rgb")
               else GRAD_TOL * float(np.abs(np.asarray(j16)).max()))
        _close(name, a.detach().numpy(), j16, j32, tol)


# run_tto_batch against JAX at bfloat16: the first updating iteration's
# gradients (measured at most 1.2e-7, 3.4e-7, 4.5e-5 and 1.2e-5)
TTO_GRAD_TOL = {"shapecode": 5e-7, "texturecode": 2e-6, "rot_vec": 8e-5, "trans_vec": 2e-5}
# ... and the replay iterations' curves (measured 8.2e-6 and 4.5e-5)
TTO_REPLAY_TOL = {"loss": 2e-5, "psnr": 1e-4}
# the whole run, as tests/test_torch_tto.py holds the float32 one once AdamW
# steps (C.14; measured at most 9.3e-4 in the codes, where JAX's own
# bfloat16 and float32 runs part by 2.5e-3)
TTO_RUN_TOL = 1e-3


def _tto_runs(models, jax_cfg, port_cfg, port: bool):
    """tests/test_torch_tto._run_both's two runs (the port's only with
    port): (JAX result, port result or None, the loss renders' draws)."""
    from test_torch_tto import B, T

    jmodel, variables, raw, tmodel = models
    key = jax.random.PRNGKey(0)
    jres = jax.tree.map(np.asarray, jax_run_tto_batch(
        jmodel, variables, JaxBatch(**{k: jnp.asarray(v) for k, v in raw.items()}),
        jnp.zeros(W), jnp.zeros(W), jax_cfg, key))
    obj_keys = jax.random.split(key, B)
    it_keys = [[jax.random.fold_in(obj_keys[b], t) for b in range(B)] for t in range(T)]
    draws = [np.asarray([[jax.random.uniform(jax.random.fold_in(k, 1) if depth else k, (S,))
                          for k in row] for row in it_keys]) for depth in (False, True)]
    if not port:
        return jres, None, draws[0]
    batch = core.ObjectBatch.from_numpy(raw, "cpu")
    pres = core.run_tto_batch(tmodel, render.pack_decoder_params(tmodel), batch,
                              torch.zeros(W), torch.zeros(W), port_cfg,
                              jitter=tuple(torch.from_numpy(d) for d in draws))
    return jres, {k: v.detach().numpy() for k, v in pres.items()}, draws[0]


def _first_update_grads(models, jres, jax_cfg, port_cfg, draws, port: bool):
    """The code and pose gradients of the first updating iteration (t =
    reg_iters + 1) at JAX's parameters there: JAX's loss through its
    kernels (make_composite_grad_fn with resolve_decoder_kernel_config's
    kwargs), and with port the port's tto_loss. Lists of (B, ...) arrays in
    the order shapecode, texturecode, rot_vec, trans_vec."""
    from test_torch_tto import B, REG

    jmodel, variables, raw, tmodel = models
    t = REG + 1
    to_params, from_params = jax_pose_param_fns(jax_cfg)
    sc0, tc0 = jres["shapecodes_saved"][:, 0], jres["texturecodes_saved"][:, 0]
    rot0, trans0 = jax.vmap(to_params)(jnp.asarray(jres["pose_traj"][:, -1]))
    obj_keys = jax.random.split(jax.random.PRNGKey(0), B)
    packed, kw = pallas_field.resolve_decoder_kernel_config(jmodel, variables)

    def jloss(sc, tc, rot, trans, b):
        out = jax_render_frustum(
            None, jax.random.fold_in(obj_keys[b], t), jax_invert_pose(from_params(rot, trans)),
            raw["K"][b], raw["roi_nerf"][b].astype(np.float32), np.linalg.norm(raw["wlh"][b]),
            n_samples=S, im_sz=8, shapenet_obj_cood=True,
            composite_fn=make_composite_grad_fn(packed, kw, sc, tc))
        return (jax_rgb_loss(out["rgb"], raw["rgb_tgt"][b], raw["occ_tgt"][b])
                + 0.1 * jax_occ_loss(out["acc_trans"], raw["occ_tgt"][b]))

    ref = [jax.grad(jloss, argnums=(0, 1, 2, 3))(sc0[b], tc0[b], rot0[b], trans0[b], b)
           for b in range(B)]
    ref = [np.stack([np.asarray(r[i]) for r in ref]) for i in range(4)]
    if not port:
        return ref
    params = [torch.tensor(np.asarray(a)).requires_grad_(True) for a in (sc0, tc0, rot0, trans0)]
    batch = core.ObjectBatch.from_numpy(raw, "cpu")
    pose = core.pose_param_fns(port_cfg)[1](params[2], params[3])
    loss, _, _ = core.tto_loss(render.pack_decoder_params(tmodel), params[0], params[1], pose,
                               batch, torch.linalg.norm(batch.wlh, dim=-1), port_cfg,
                               jitter=torch.from_numpy(draws[t]))
    return [g.numpy() for g in torch.autograd.grad(loss.sum(), params)], ref


def test_tto_bf16_matches_jax_pallas(monkeypatch):
    """run_tto_batch with field_dtype "bfloat16" (K1/K2's bfloat16 plain
    versions; the latent projections in float32, as in JAX) against the JAX
    run_tto_batch on its Pallas kernels at bfloat16 (field_impl "pallas";
    resolve_decoder_kernel_config's kwargs carry dtype=bfloat16, what it
    returns on an accelerator), at tests/test_torch_tto.py's tiny config
    (reg_iters 2, 5 iterations, 2 objects), as C.14 holds the float32 runs:
    the first updating iteration's code and pose gradients at the same
    parameters and the replay iterations' curves each within a stated
    tolerance that is at most a tenth of JAX's own bfloat16-against-float32
    distance; then, since AdamW divides each gradient component by its own
    magnitude and so carries a rounding of a near-zero component on as a
    step of up to the learning rate, the curves, the saved codes and the
    final pose to the last iteration within test_torch_tto's float32 bound,
    the codes within at most JAX's own bfloat16-against-float32 distance."""
    from test_torch_tto import JAX_CFG, PORT_CFG, REG, TINY_HP, _models

    kernel_config = pallas_field.resolve_decoder_kernel_config

    def bf16_config(model, variables):
        packed, kw = kernel_config(model, variables)
        return packed, dict(kw, dtype=jnp.bfloat16)

    models = _models(dict(TINY_HP, field_dtype="bfloat16"), 32)
    cfg = dataclasses.replace(JAX_CFG, field_impl="pallas")
    j32, _, draws = _tto_runs(models, cfg, PORT_CFG, port=False)
    g32 = _first_update_grads(models, j32, cfg, PORT_CFG, draws, port=False)
    monkeypatch.setattr(pallas_field, "resolve_decoder_kernel_config", bf16_config)
    j16, p16, draws = _tto_runs(models, cfg, PORT_CFG, port=True)
    g16p, g16 = _first_update_grads(models, j16, cfg, PORT_CFG, draws, port=True)
    for (name, tol), port, ref, f32 in zip(TTO_GRAD_TOL.items(), g16p, g16, g32):
        _close(f"first update d{name}", port, ref, f32, tol)
    for name, tol in TTO_REPLAY_TOL.items():
        _close(f"replay {name}", *(a[name][:, :REG + 1] for a in (p16, j16, j32)), tol)
    for name in ("loss", "psnr", "rot_err", "trans_err", "depth_err", "final_pose"):
        np.testing.assert_allclose(p16[name], j16[name], atol=TTO_RUN_TOL, rtol=TTO_RUN_TOL,
                                   err_msg=name)
    codes = [np.concatenate([a["shapecodes_saved"], a["texturecodes_saved"]], -1)
             for a in (p16, j16, j32)]
    err, spread = (float(np.abs(a - b).max()) for a, b in ((codes[0], codes[1]),
                                                            (codes[1], codes[2])))
    assert err <= TTO_RUN_TOL <= spread, (err, spread)


def test_pack_rounds_the_matrices_once(decoders):
    """The bfloat16 pack holds each dense layer's matrix rounded to
    bfloat16 (to nearest, ties to even, as _precast_weights casts them),
    in float32, and the float32 pack's values unchanged; biases and the
    latent projections stay float32 in both."""
    _, params, packed, packs = decoders
    f32, b16 = packs["float32"], packs["bfloat16"]
    assert (f32.field_dtype, b16.field_dtype) == ("float32", "bfloat16")
    jw = np.asarray(packed["w_xyz"][0])
    np.testing.assert_array_equal(f32.w_xyz.numpy(), jw)
    np.testing.assert_array_equal(b16.w_xyz.numpy(),
                                  np.asarray(jnp.asarray(jw).astype(jnp.bfloat16), np.float32))
    for name in render._PTR_FIELDS:
        a, b = getattr(f32, name), getattr(b16, name)
        assert b.dtype == torch.float32
        if name.startswith("b_"):
            assert torch.equal(a, b), name
        else:
            assert torch.equal(b, a.to(torch.bfloat16).float()), name
    for name in ("w_shape_latent", "b_shape_latent", "w_tex_latent", "b_tex_latent"):
        assert torch.equal(getattr(f32, name), getattr(b16, name)), name


def test_bf16_entry_points_accept_the_mode(tmp_path):
    """No entry point refuses the bfloat16 mode the JAX package runs: the
    trainer, the training render (K1 with the training encodings, K3, K4),
    the training field (K5 on the exact encodings, K7, K4) and multiview
    opt_model (its decoder copy on decode_bf16, as JAX's opt_model trains
    its flax decoder) take a SUPNeRF in the mode and give finite results,
    with no launch on CPU tensors; an unknown field_dtype raises."""
    from supnerf_tpu_torch.models.factory import build_model
    from supnerf_tpu_torch.training.trainer import UnifiedTrainer
    from supnerf_tpu_torch.tto.multiview import MultiviewBatch, decoder_copy, run_multiview_tto

    model = build_model("supnerf", {"shape_blocks": 1, "texture_blocks": 1, "latent_dim": 32,
                                    "field_dtype": "bfloat16"})
    UnifiedTrainer(model, {}, [{"instoken": "a"}], str(tmp_path), device="cpu", log_writer=False)
    render.reset_launch_counts()
    x = torch.zeros((1, 2, 4, 3))
    codes = torch.zeros((1, 32))
    rgb, depth, acc = render.field_composite_train(model, x, x[:, :, 0], torch.zeros((1, 4)),
                                                   codes, codes, data_grads=False)
    assert rgb.shape == (1, 2, 3) and depth.shape == acc.shape == (1, 2)
    sigma, rgb = field.field_train(model, x, x, codes, codes)
    assert sigma.shape == (1, 2, 4, 1) and rgb.shape == (1, 2, 4, 3)
    assert bool(torch.isfinite(sigma).all() and torch.isfinite(rgb).all())
    assert decoder_copy(model).field_dtype == "bfloat16"
    V, g = 2, torch.Generator().manual_seed(0)
    K = torch.tensor([[40.0, 0.0, 16.0], [0.0, 40.0, 16.0], [0.0, 0.0, 1.0]]).expand(V, 3, 3)
    pose = torch.cat([torch.eye(3), torch.tensor([[0.0], [0.0], [8.0]])], 1).expand(V, 3, 4)
    batch = MultiviewBatch(img_in=torch.rand((V, 32, 32, 3), generator=g),
                           rgb_tgt=torch.rand((V, 16, 3), generator=g),
                           occ_tgt=torch.ones((V, 16, 1)), K=K,
                           roi_nerf=torch.tensor([[8.0, 8.0, 24.0, 24.0]]).expand(V, 4),
                           pose_init=pose, wlh=torch.tensor([[1.8, 4.5, 1.6]]).expand(V, 3),
                           obj_pose_gt=pose)
    res = run_multiview_tto(model, render.pack_decoder_params(model), batch, codes[0], codes[0],
                            core.TTOConfig(num_opts=2, n_samples=4, render_im_sz=4,
                                           in_img_sz=32), opt_model=True)
    assert res["loss"].shape == (2,) and bool(torch.isfinite(res["loss"]).all())
    assert not any(render.LAUNCHES.values())
    for bad in ("float16", "bf16"):
        with pytest.raises(ValueError, match="field_dtype"):
            build_model("supnerf", {"field_dtype": bad})
        with pytest.raises(ValueError, match="field_dtype"):
            CodeNeRFDecoder(1, 1, 32, 32, field_dtype=bad)


def test_chip_smoke_bf16_rule():
    """chip_smoke.py's phase 18 rule (closer_than_float32): a bfloat16
    kernel passes within a BF16_CLOSER-th of the bfloat16-vs-float32
    distance in root mean square, with at most BF16_POINT_SHARE of its
    elements beyond a BF16_CLOSER-th of that distance's largest value and
    none beyond it; it fails farther away, with an element past the
    distance, or non-finite. bound_bf16: the products at 989 TFLOP/s or the
    bytes at 3.35 TB/s, whichever is longer."""
    import chip_smoke as cs

    rng = np.random.default_rng(0)
    p32 = torch.from_numpy(rng.normal(size=4000))
    p16 = p32 + 1e-2 * torch.from_numpy(rng.normal(size=4000))
    noise = torch.from_numpy(rng.normal(size=4000))

    def ok(got):
        return cs.closer_than_float32(("x",), (got,), (p16,), (p32,))[1]

    assert ok(p16 + 1e-4 * noise)
    assert not ok(p16 + 3e-3 * noise)                   # a rounding point left out
    one = p16.clone()
    one[7] += 0.5 * float((p16 - p32).abs().max())      # one flipped point
    assert ok(one)
    one[7] = p16[7] + 2 * float((p16 - p32).abs().max())
    assert not ok(one)                                   # past the whole distance
    many = p16.clone()
    many[:100] += 0.5 * float((p16 - p32).abs().max())  # 2.5 % of the points
    assert not ok(many)
    bad = p16.clone()
    bad[0] = float("nan")
    assert not ok(bad)
    assert cs.bound_bf16(989e9, 1.0) == (1.0, "operations")
    assert cs.bound_bf16(1.0, 3.35e9) == (1.0, "bytes")
