"""The port's fused render (supnerf_tpu_torch/ops/render.py) on the CPU: the
plain versions of K1 (forward) and K2 (backward), and the autograd.Function
that runs them through the kernels' wrappers, against the JAX package's
Pallas render kernels in interpret mode (field_composite_pallas and
field_composite_apply) on the same decoder weights and inputs, at tiny tiles
as tests/test_pallas_render.py runs them. Tolerances are that file's: atol
3e-4 on rgb and acc, 3e-3 on depth, 2e-4 on gradients (float32 on both
sides; the JAX kernel composites with a log-space cumprod)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_threads  # noqa: F401
from supnerf_tpu.models.nerf_mlp import CodeNeRFDecoder as JaxDecoder
from supnerf_tpu.ops.pallas_field import pack_decoder_params as jax_pack
from supnerf_tpu.ops.pallas_render import field_composite_apply, field_composite_pallas
from supnerf_tpu_torch.models.convert import convert_decoder
from supnerf_tpu_torch.models.nerf_mlp import CodeNeRFDecoder
from supnerf_tpu_torch.ops import render

W, S = 64, 8


def _setup(R, n_obj=1):
    rng = np.random.default_rng(0)
    vd = rng.normal(size=(R, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    z = (np.linspace(2.0, 6.0, S) + 0.01 * rng.uniform(size=S)).astype(np.float32)
    xyz = (vd[:, None, :] * z[None, :, None]).astype(np.float32)
    codes = (rng.normal(size=(2, n_obj, W)) * 0.3).astype(np.float32)
    jmodel = JaxDecoder(shape_blocks=3, texture_blocks=1, W=W, latent_dim=W)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(xyz),
                            jnp.asarray(np.broadcast_to(vd[:, None], xyz.shape)),
                            jnp.asarray(codes[0, 0]), jnp.asarray(codes[1, 0]))
    tmodel = CodeNeRFDecoder(3, 1, W, W)
    tmodel.load_state_dict(convert_decoder(jax.tree.map(np.asarray, variables["params"]), 3, 1),
                           strict=True)
    return jax_pack(variables["params"], 3, 1), render.pack_decoder_params(tmodel), xyz, vd, z, codes


def _port_inputs(xyz, vd, z, codes):
    n = codes.shape[1]
    t = torch.from_numpy
    return (t(np.broadcast_to(xyz, (n,) + xyz.shape).copy()),
            t(np.broadcast_to(vd, (n,) + vd.shape).copy()),
            t(np.broadcast_to(z, (n, S)).copy()), t(codes[0]), t(codes[1]))


def _cotangents(R, n):
    rng = np.random.default_rng(7)
    return [rng.normal(size=(n, R) + s).astype(np.float32) for s in ((3,), (), ())]


@pytest.mark.parametrize("white,R", [(False, 24), (True, 19)])
def test_render_fwd_plain_matches_pallas(white, R):
    """R = 19 is not a multiple of the JAX kernel's 4-ray tile."""
    _compare_fwd_plain_with_pallas(white, R, pe_in_kernel=False)


@pytest.mark.parametrize("white,R", [(False, 24), (True, 19)])
def test_render_fwd_plain_matches_pallas_pe_in_kernel(white, R):
    """A11a: the JAX render kernel with the positional encodings computed in
    the kernel (pe_in_kernel=True) computes the function K1 computes, which
    always encodes in the kernel; its plain version matches it too."""
    _compare_fwd_plain_with_pallas(white, R, pe_in_kernel=True)


def _compare_fwd_plain_with_pallas(white, R, pe_in_kernel):
    packed, wts, xyz, vd, z, codes = _setup(R)
    ref = field_composite_pallas(packed, jnp.asarray(xyz), jnp.asarray(vd), jnp.asarray(z),
                                 jnp.asarray(codes[0, 0]), jnp.asarray(codes[1, 0]),
                                 dtype=jnp.float32, tile_m=32, interpret=True, white_bkgd=white,
                                 pe_in_kernel=pe_in_kernel)
    x, v, zz, sc, tc = _port_inputs(xyz, vd, z, codes)
    zs, zt = render.conditioned_latents(wts, sc, tc)
    out = render.render_fwd_plain(wts, x, v, zz, zs, zt, white_bkgd=white)
    for name, a, b, atol in zip(("rgb", "depth", "acc"), out, ref, (3e-4, 3e-3, 3e-4)):
        np.testing.assert_allclose(a[0].numpy(), np.asarray(b), atol=atol, rtol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("impl", ["auto", "plain"])
@pytest.mark.parametrize("white", [False, True])
def test_render_gradients_match_pallas(impl, white):
    """Two objects with their own codes: the object axis of the port against
    per-object calls of the JAX kernel pair. impl "auto" on CPU tensors is the
    autograd.Function with both wrappers taking their plain versions (K2's
    plain version: autograd through K1's); "plain" differentiates K1's plain
    version directly."""
    R, n = 19, 2
    packed, wts, xyz, vd, z, codes = _setup(R, n)
    cots = _cotangents(R, n)
    args = [a.requires_grad_(True) for a in _port_inputs(xyz, vd, z, codes)]
    render.reset_launch_counts()
    out = render.field_composite(wts, *args, white_bkgd=white, impl=impl)
    loss = sum((o * torch.from_numpy(c)).sum() for o, c in zip(out, cots))
    grads = torch.autograd.grad(loss, args)
    assert not any(render.LAUNCHES.values())   # CPU: no kernel
    for b in range(n):
        def jloss(x, v, zz, sc, tc):
            o = field_composite_apply(packed, x, v, zz, sc, tc, dtype=jnp.float32, tile_fwd=32,
                                      tile_bwd=32, interpret=True, white_bkgd=white)
            return sum(jnp.sum(oo * c[b]) for oo, c in zip(o, cots))

        ref = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(
            jnp.asarray(xyz), jnp.asarray(vd), jnp.asarray(z), jnp.asarray(codes[0, b]),
            jnp.asarray(codes[1, b]))
        for name, g, r in zip(("xyz", "viewdir", "z", "shapecode", "texturecode"), grads, ref):
            np.testing.assert_allclose(g[b].numpy(), np.asarray(r), atol=2e-4, rtol=2e-4,
                                       err_msg=f"{name} object {b}")


def test_render_bwd_plain_matches_function_backward():
    """K2's plain version (what chip_smoke.py holds the kernel to) returns
    the cotangents of the latents zs/zt the kernel returns, and they are the
    Function's."""
    R, n = 12, 2
    _, wts, xyz, vd, z, codes = _setup(R, n)
    x, v, zz, sc, tc = _port_inputs(xyz, vd, z, codes)
    zs, zt = render.conditioned_latents(wts, sc, tc)
    cots = [torch.from_numpy(c) for c in _cotangents(R, n)]
    plain = render.render_bwd_plain(wts, x, v, zz, zs, zt, False, *cots)
    args = [t.clone().requires_grad_(True) for t in (x, v, zz, zs, zt)]
    out = render.FieldComposite.apply(*args, wts, False)
    fn = torch.autograd.grad(out, args, cots)
    assert [tuple(p.shape) for p in plain] == [(n, R, S, 3), (n, R, 3), (n, S), (n, 3, W),
                                               (n, 1, W)]
    for a, b in zip(plain, fn):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


def test_cuda_impl_refuses_cpu_tensors():
    _, wts, xyz, vd, z, codes = _setup(4)
    with pytest.raises(ValueError, match="CUDA"):
        render.field_composite(wts, *_port_inputs(xyz, vd, z, codes), impl="cuda")


def test_kernel_sources_name_what_they_replace():
    """Each CUDA source names the TPU kernel it replaces and what bounds it."""
    for src, tpu in (("render_fwd.cu", "pallas_render.py:_render_kernel"),
                     ("render_bwd.cu", "pallas_render.py:_render_bwd_kernel"),
                     ("field_fwd.cu", "pallas_field.py:_field_kernel"),
                     ("field_fwd.cu", "pallas_field.py:_field_kernel_raw"),
                     ("field_bwd.cu", "pallas_field.py:_field_bwd_kernel")):
        text = (render.CSRC_DIR / src).read_text()
        assert tpu in text and "What bounds it on the H100" in text
    assert render.library_path().parent == render.BUILD_DIR


@pytest.mark.parametrize("case", ["dtype", "shape", "contiguity", "samples", "width"])
def test_kernel_wrappers_validate_inputs(case):
    """The checks a CUDA launch runs first (they need no card): wrong dtype,
    mismatched shape, non-contiguous input, more than 64 samples per ray, an
    unsupported width."""
    _, wts, xyz, vd, z, codes = _setup(4)
    x, v, zz, sc, tc = _port_inputs(xyz, vd, z, codes)
    zs, zt = render.conditioned_latents(wts, sc, tc)
    render._check_inputs(wts, x, v, zz, zs, zt)          # the unchanged inputs pass
    if case == "dtype":
        x = x.double()
    elif case == "shape":
        zz = zz[:, :-1].contiguous()
    elif case == "contiguity":
        v = v.transpose(0, 1)
    elif case == "samples":
        x, zz = x.repeat(1, 1, 9, 1), zz.repeat(1, 9)
    else:
        wts = render.pack_decoder_params(CodeNeRFDecoder(3, 1, 32, 32))
        zs, zt = render.conditioned_latents(wts, sc[:, :32], tc[:, :32])
    with pytest.raises(ValueError):
        render._check_inputs(wts, x, v, zz, zs, zt)
