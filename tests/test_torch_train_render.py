"""The port's training render (supnerf_tpu_torch/ops/render.py:
field_composite_train, the NeRF branch of a training step) on the CPU
against the JAX package's field_composite_train_pallas in interpret mode
(float32, data_grads=False) on the same decoder and inputs, at the shapes of
tests/test_pallas_render.py:test_fused_train_render_full_grads_match_flax
(2 shape blocks, 1 texture block, W 128; 2 objects x 16 rays x 8 samples).
Tolerances are that test's: the scalar loss rtol 1e-5; every decoder weight
and bias gradient and both code gradients rtol 2e-4, atol 2e-5. The stash
and weight-gradient layout of K3/K4 is checked through their plain versions."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from supnerf_tpu.models.nerf_mlp import CodeNeRFDecoder as JaxDecoder
from supnerf_tpu.ops.pallas_field import pack_decoder_params as jax_pack
from supnerf_tpu.ops.pallas_render import field_composite_train_pallas
from supnerf_tpu_torch.models.convert import convert_decoder
from supnerf_tpu_torch.models.nerf_mlp import CodeNeRFDecoder
from supnerf_tpu_torch.ops import render

B, R, S, W = 2, 16, 8, 128


def _inputs():
    rng = np.random.default_rng(0)
    vd = rng.normal(size=(B, R, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    z = (np.linspace(2.0, 6.0, S)[None] + 0.05 * rng.uniform(size=(B, S))).astype(np.float32)
    xyz = (vd[:, :, None, :] * z[:, None, :, None] * 0.3).astype(np.float32)
    codes = (rng.normal(size=(2, B, W)) * 0.3).astype(np.float32)
    heads = [rng.normal(size=s).astype(np.float32) for s in ((B, R, 3), (B, R), (B, R))]
    return xyz, vd, z, codes, heads


@pytest.fixture(scope="module", params=[False, True], ids=["black", "white"])
def reference(request):
    """(white, inputs, JAX params, loss and gradients of the JAX kernel pair)."""
    white = request.param
    xyz, vd, z, codes, heads = _inputs()
    jdec = JaxDecoder(shape_blocks=2, texture_blocks=1, W=W, latent_dim=W)
    params = jdec.init(jax.random.PRNGKey(0), jnp.asarray(xyz),
                       jnp.asarray(np.broadcast_to(vd[:, :, None], xyz.shape)),
                       jnp.asarray(codes[0][:, None, None]),
                       jnp.asarray(codes[1][:, None, None]))["params"]

    def loss(p, sc, tc):
        out = field_composite_train_pallas(
            jax_pack(p, 2, 1), jnp.asarray(xyz), jnp.asarray(vd), jnp.asarray(z), sc, tc,
            shape_blocks=2, texture_blocks=1, dtype=jnp.float32, tile_fwd=64, tile_bwd=64,
            interpret=True, white_bkgd=white, data_grads=False)
        return sum(jnp.sum(o * h) for o, h in zip(out, heads)), out

    (value, outs), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        params, jnp.asarray(codes[0]), jnp.asarray(codes[1]))
    return white, (xyz, vd, z, codes, heads), jax.tree.map(np.asarray, (params, value, outs,
                                                                        grads))


def _port_model(params):
    dec = CodeNeRFDecoder(2, 1, W, W)
    dec.load_state_dict(convert_decoder(params, 2, 1), strict=True)
    return dec


def _port_render(dec, xyz, vd, z, sc, tc, white, impl):
    """impl "auto": field_composite_train, i.e. FieldCompositeTrain with both
    wrappers on their plain versions (CPU tensors; no kernel launches);
    "plain": autograd straight through K1's plain version with the live
    weights as inputs (what render_train_bwd_plain differentiates)."""
    if impl == "auto":
        return render.field_composite_train(dec, xyz, vd, z, sc, tc, white_bkgd=white)
    zs, zt = render.conditioned_latents_of(dec, sc, tc)
    live = render.pack_linear_params(render.decoder_linear_params(dec), dec.shape_blocks,
                                     dec.texture_blocks, dec.num_xyz_freq, dec.num_dir_freq)
    return render.render_fwd_plain(live, xyz, vd, z, zs, zt, white)


@pytest.mark.parametrize("impl", ["auto", "plain"])
def test_train_render_matches_pallas(reference, impl):
    white, (xyz, vd, z, codes, heads), (params, value, outs, grads) = reference
    dec = _port_model(params)
    sc, tc = (torch.tensor(c, requires_grad=True) for c in codes)
    render.reset_launch_counts()
    out = _port_render(dec, torch.from_numpy(xyz), torch.from_numpy(vd), torch.from_numpy(z),
                       sc, tc, white, impl)
    loss = sum((o * torch.from_numpy(h)).sum() for o, h in zip(out, heads))
    names = [n for n, _ in dec.named_parameters()]
    g = torch.autograd.grad(loss, list(dec.parameters()) + [sc, tc])
    assert all(v == 0 for v in render.LAUNCHES.values())
    np.testing.assert_allclose(float(loss.detach()), float(value), rtol=1e-5)
    for name, a, b, atol in zip(("rgb", "depth", "acc"), out, outs, (3e-4, 3e-3, 3e-4)):
        np.testing.assert_allclose(a.detach().numpy(), b, atol=atol, rtol=1e-4, err_msg=name)
    ref = convert_decoder(grads[0], 2, 1)
    assert set(ref) == set(names)
    for name, got in zip(names, g):
        np.testing.assert_allclose(got.numpy(), ref[name].numpy(), rtol=2e-4, atol=2e-5,
                                   err_msg=name)
    for name, got, want in zip(("shapecode", "texturecode"), g[-2:], grads[1:]):
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-5, err_msg=name)


@pytest.mark.parametrize("which", ["xyz", "viewdir", "z"])
def test_train_render_refuses_data_gradients(which):
    """Training batches are data (data_grads=False): asking for a gradient
    of the points, directions or depths raises instead of returning zeros."""
    xyz, vd, z, codes, _ = _inputs()
    dec = CodeNeRFDecoder(2, 1, W, W)
    args = {"xyz": torch.from_numpy(xyz), "viewdir": torch.from_numpy(vd),
            "z": torch.from_numpy(z)}
    args[which].requires_grad_(True)
    with pytest.raises(ValueError, match="no gradient for xyz, viewdir or z"):
        render.field_composite_train(dec, args["xyz"], args["viewdir"], args["z"],
                                     torch.from_numpy(codes[0]), torch.from_numpy(codes[1]))


@pytest.mark.parametrize("white", [False, True])
@pytest.mark.parametrize("shape", [(64, 3, 1), (32, 2, 2)])
def test_stash_and_wgrad_plain_give_the_backward(white, shape):
    """K3's plain version writes the stash at stash_layout's columns, and K4's
    plain version over wgrad_problems of that stash gives the weight
    gradients of render_train_bwd_plain in Linear layout, overwriting and
    then accumulating: the layout the CUDA pair shares, checked on the CPU."""
    W_, ns, nt = shape
    gen = torch.Generator().manual_seed(1)
    dec = CodeNeRFDecoder(ns, nt, W_, W_)
    wts = render.pack_decoder_params(dec)
    vd = torch.nn.functional.normalize(torch.randn((3, 5, 3), generator=gen), dim=-1)
    z = torch.sort(torch.rand((3, S), generator=gen) * 4 + 2, -1).values
    xyz = (vd[:, :, None] * z[:, None, :, None] * 0.3).contiguous()
    codes = torch.randn((2, 3, W_), generator=gen) * 0.3
    zs, zt = render.conditioned_latents(wts, codes[0], codes[1])
    cot = [torch.randn(s, generator=gen) for s in ((3, 5, 3), (3, 5), (3, 5))]
    dzs, dzt, grads = render.render_train_bwd_plain(wts, xyz, vd, z, zs, zt, white, *cot)
    assert [tuple(t.shape) for t in grads] == [tuple(p.shape)
                                               for p in render.decoder_linear_params(dec)]
    L = render.stash_layout(wts)
    pt = torch.full((3 * 5 * S, L["ld_pt"]), float("nan"))
    ray = torch.full((3 * 5, L["ld_ray"]), float("nan"))
    a, b = render.render_train_bwd_stash(wts, xyz, vd, z, zs, zt, white, *cot, pt, ray)
    torch.testing.assert_close(a, dzs, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(b, dzt, rtol=1e-5, atol=1e-6)
    out = [torch.full_like(t, float("nan")) for t in grads]
    problems = render.wgrad_problems(wts, pt, ray, out)
    assert len(problems) == 7 + ns + nt
    render.wgrad(problems)
    for got, want in zip(out, grads):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6)
    render.wgrad(problems, accumulate=True)
    for got, want in zip(out, grads):
        torch.testing.assert_close(got, 2 * want, rtol=1e-4, atol=2e-6)


def test_kernel_sources_name_what_they_replace():
    """K3 and K4 name the TPU kernel they replace and what bounds them."""
    for src in ("render_train_bwd.cu", "wgrad.cu"):
        text = (render.CSRC_DIR / src).read_text()
        assert "pallas_render.py:_render_train_bwd_kernel" in text
        assert "What bounds it on the H100" in text
