"""The port's per-point training field (supnerf_tpu_torch/ops/field.py:
field_train, FieldTrain: K5 forward, K7 + K4 backward, their plain versions
inside the wrappers on CPU tensors) against the JAX package's
field_train_pallas in interpret mode (float32, tiles of 64) on the same
decoder and inputs, at the shapes of tests/test_pallas_field.py:
test_pallas_train_field_full_grads_match_flax (2 shape blocks, 1 texture
block, W 128; 2 objects x 16 x 8 points, each with its own direction), and
at a point count that is not a multiple of K5/K7's 64-row blocks. Tolerances
are that test's: the scalar loss rtol 1e-5; every decoder weight and bias
gradient, both code gradients and the xyz and viewdir gradients rtol 2e-4,
atol 1e-5; K5's plain version against field_train_pallas's forward atol
2e-5 (tests/test_pallas_field.py's value tolerance). The stash layout that
K7 and K4 share is checked through their plain versions."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from supnerf_tpu.models.nerf_mlp import CodeNeRFDecoder as JaxDecoder
from supnerf_tpu.ops.pallas_field import field_train_pallas
from supnerf_tpu.ops.pallas_field import pack_decoder_params as jax_pack
from supnerf_tpu_torch.models.convert import convert_decoder
from supnerf_tpu_torch.models.nerf_mlp import CodeNeRFDecoder
from supnerf_tpu_torch.ops import field, render
from torch_memory import release_memory_after_module  # noqa: F401

B = 2
# (lead shape of one object's points, W, shape blocks, texture blocks): the
# JAX test's 16 x 8 points at W 128, and 96 points (one full block of 64 and
# one of 32) at W 64
CASES = {"jax_test_shape": ((16, 8), 128, 2, 1), "ragged_M": ((96,), 64, 3, 1)}


def _inputs(lead, W, seed=0):
    rng = np.random.default_rng(seed)
    xyz = (rng.normal(size=(B, *lead, 3)) * 0.4).astype(np.float32)
    vd = rng.normal(size=(B, *lead, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    codes = (rng.normal(size=(2, B, W)) * 0.3).astype(np.float32)
    return xyz, vd, codes


def _loss(sig, rgb):
    """test_pallas_train_field_full_grads_match_flax's loss head."""
    return (sig * 0.7).mean() + ((rgb - 0.2) ** 2).mean()


@pytest.fixture(scope="module", params=list(CASES))
def reference(request):
    """(case, inputs, JAX params, outputs, loss and gradients of
    field_train_pallas for the params, xyz, viewdir and both codes)."""
    lead, W, ns, nt = CASES[request.param]
    xyz, vd, codes = _inputs(lead, W)
    jdec = JaxDecoder(shape_blocks=ns, texture_blocks=nt, W=W, latent_dim=W)
    params = jdec.init(jax.random.PRNGKey(0), jnp.asarray(xyz[0]), jnp.asarray(vd[0]),
                       jnp.asarray(codes[0, 0]), jnp.asarray(codes[1, 0]))["params"]

    def loss(p, x, v, sc, tc):
        out = field_train_pallas(jax_pack(p, ns, nt), x, v, sc, tc, shape_blocks=ns,
                                 texture_blocks=nt, dtype=jnp.float32, tile_fwd=64, tile_bwd=64,
                                 interpret=True)
        return _loss(*out), out

    (value, outs), grads = jax.value_and_grad(loss, argnums=(0, 1, 2, 3, 4), has_aux=True)(
        params, *(jnp.asarray(a) for a in (xyz, vd, codes[0], codes[1])))
    return (request.param, (xyz, vd, codes),
            jax.tree.map(np.asarray, (params, value, outs, grads)))


def _port_model(params, case):
    _, W, ns, nt = CASES[case]
    dec = CodeNeRFDecoder(ns, nt, W, W)
    dec.load_state_dict(convert_decoder(params, ns, nt), strict=True)
    return dec


def test_field_train_matches_pallas(reference):
    """field_train on CPU tensors: its outputs, the loss and the gradients
    of every weight and bias, both codes, xyz and viewdir against
    field_train_pallas's; no kernel launches."""
    case, (xyz, vd, codes), (params, value, outs, grads) = reference
    _, _, ns, nt = CASES[case]
    dec = _port_model(params, case)
    data = [torch.tensor(a, requires_grad=True) for a in (xyz, vd)]
    sc, tc = (torch.tensor(c, requires_grad=True) for c in codes)
    render.reset_launch_counts()
    sig, rgb = field.field_train(dec, *data, sc, tc)
    assert sig.shape == xyz.shape[:-1] + (1,) and rgb.shape == xyz.shape
    loss = _loss(sig, rgb)
    names = [n for n, _ in dec.named_parameters()]
    g = torch.autograd.grad(loss, list(dec.parameters()) + data + [sc, tc])
    assert all(v == 0 for v in render.LAUNCHES.values())
    np.testing.assert_allclose(float(loss.detach()), float(value), rtol=1e-5)
    for name, a, b in zip(("sigma", "rgb"), (sig, rgb), outs):
        np.testing.assert_allclose(a.detach().numpy(), b, atol=2e-5, err_msg=name)
    ref = convert_decoder(grads[0], ns, nt)
    assert set(ref) == set(names)
    for name, got in zip(names, g):
        np.testing.assert_allclose(got.numpy(), ref[name].numpy(), rtol=2e-4, atol=1e-5,
                                   err_msg=name)
    for name, got, want in zip(("xyz", "viewdir", "shapecode", "texturecode"), g[len(names):],
                               grads[1:]):
        assert float(np.abs(want).max()) > 0, name
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=1e-5, err_msg=name)


def test_field_fwd_plain_matches_field_train_pallas_forward(reference):
    """A9 is K5 on the training contract: K5's plain version on the
    per-object latents of conditioned_latents gives field_train_pallas's
    forward."""
    case, (xyz, vd, codes), (params, _, outs, _) = reference
    wts = render.pack_decoder_params(_port_model(params, case))
    t = torch.from_numpy
    zs, zt = render.conditioned_latents(wts, t(codes[0]), t(codes[1]))
    sig, rgb = field.field_fwd_plain(wts, t(xyz).reshape(B, -1, 3), t(vd).reshape(B, -1, 3),
                                     zs, zt)
    for name, a, b in zip(("sigma", "rgb"), (sig, rgb), outs):
        np.testing.assert_allclose(a.reshape(b.shape).numpy(), b, atol=2e-5, err_msg=name)


@pytest.mark.parametrize("W,ns,nt,M", [(64, 3, 1, 150), (32, 2, 2, 64)])
def test_stash_and_wgrad_plain_give_the_backward(W, ns, nt, M):
    """K7's plain version writes the per-point stash at
    stash_layout(per_point=True)'s columns and returns the data and latent
    cotangents of field_train_bwd_plain; K4's plain version over
    wgrad_problems of that stash (ray rows None) gives its weight gradients
    in Linear layout, overwriting and then accumulating: the layout the
    CUDA pair shares, checked on the CPU."""
    gen = torch.Generator().manual_seed(2)
    dec = CodeNeRFDecoder(ns, nt, W, W)
    wts = render.pack_decoder_params(dec)
    xyz = torch.randn((3, M, 3), generator=gen) * 0.4
    vd = torch.nn.functional.normalize(torch.randn((3, M, 3), generator=gen), dim=-1)
    codes = torch.randn((2, 3, W), generator=gen) * 0.3
    zs, zt = render.conditioned_latents(wts, codes[0], codes[1])
    cot = [torch.randn((3, M, k), generator=gen) for k in (1, 3)]
    *data, grads = field.field_train_bwd_plain(wts, xyz, vd, zs, zt, *cot)
    assert [tuple(t.shape) for t in grads] == [tuple(p.shape)
                                               for p in render.decoder_linear_params(dec)]
    fwd_bwd = field.field_bwd_plain(wts, xyz, vd, zs, zt, *cot)
    L = render.stash_layout(wts, per_point=True)
    # the direction encoding follows K3's columns on the next 16 bytes
    a_dpe = -(-render.stash_layout(wts)["width"] // 4) * 4
    assert L["ld_ray"] == 0 and L["a_dpe"] == a_dpe and L["width"] == a_dpe + 27
    pt = torch.full((3 * M, L["ld_pt"]), float("nan"))
    got = field.field_train_bwd_stash(wts, xyz, vd, zs, zt, *cot, pt)
    for a, b, c in zip(got, data, fwd_bwd):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(a, c, rtol=1e-5, atol=1e-6)
    # every column block is written (the pad columns between blocks are not)
    d_xyz = 3 * (2 * wts.num_xyz_freq + 1)
    widths = {"a_xyz": d_xyz, "a_sh": ns * W, "a_hh": W // 2, "g_sh": ns * W, "a_tx": nt * W,
              "g_tx": nt * W, "g_sig": 1, "g_hh": W // 2, "g_rgb": 3, "a_dpe": 27}
    for name in render._STASH_POINT_COLS + ("a_dpe",):
        assert not pt[:, L[name]:L[name] + widths.get(name, W)].isnan().any(), name
    out = [torch.full_like(t, float("nan")) for t in grads]
    problems = render.wgrad_problems(wts, pt, None, out)
    assert len(problems) == 7 + ns + nt
    render.wgrad(problems)
    for a, b in zip(out, grads):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)
    render.wgrad(problems, accumulate=True)
    for a, b in zip(out, grads):
        torch.testing.assert_close(a, 2 * b, rtol=1e-4, atol=2e-6)


def test_field_train_bwd_source_names_what_it_replaces():
    """K7 names the TPU kernel it replaces and what bounds it."""
    text = (render.CSRC_DIR / "field_train_bwd.cu").read_text()
    assert "pallas_field.py:_field_train_bwd_kernel" in text
    assert "What bounds it on the H100" in text
