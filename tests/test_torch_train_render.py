"""The port's training render (supnerf_tpu_torch/ops/render.py:
field_composite_train, the NeRF branch of a training step) on the CPU
against the JAX package's field_composite_train_pallas in interpret mode
(float32) on the same decoder and inputs, with data_grads=False (the train
step's mode) and data_grads=True (the default, K3's data mode), at the
shapes of tests/test_pallas_render.py:
test_fused_train_render_full_grads_match_flax (2 shape blocks, 1 texture
block, W 128; 2 objects x 16 rays x 8 samples). Tolerances are that test's:
the scalar loss rtol 1e-5; every decoder weight and bias gradient, both code
gradients and the xyz, viewdir and z gradients rtol 2e-4, atol 2e-5. The
stash and weight-gradient layout of K3/K4 is checked through their plain
versions."""
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
from torch_memory import release_memory_after_module  # noqa: F401

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


def _jax_params(xyz, vd, codes):
    jdec = JaxDecoder(shape_blocks=2, texture_blocks=1, W=W, latent_dim=W)
    return jdec.init(jax.random.PRNGKey(0), jnp.asarray(xyz),
                     jnp.asarray(np.broadcast_to(vd[:, :, None], xyz.shape)),
                     jnp.asarray(codes[0][:, None, None]),
                     jnp.asarray(codes[1][:, None, None]))["params"]


@pytest.fixture(scope="module", params=[False, True], ids=["black", "white"])
def reference(request):
    """(white, inputs, JAX params, loss and gradients of the JAX kernel pair)."""
    white = request.param
    xyz, vd, z, codes, heads = _inputs()
    params = _jax_params(xyz, vd, codes)

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


@pytest.fixture(scope="module", params=[False, True], ids=["black", "white"])
def reference_data(request):
    """As `reference`, with data_grads=True: (white, inputs, JAX params, loss
    and gradients for the params, xyz, viewdir, z and both codes)."""
    white = request.param
    xyz, vd, z, codes, heads = _inputs()
    params = _jax_params(xyz, vd, codes)

    def loss(p, x, v, zv, sc, tc):
        out = field_composite_train_pallas(
            jax_pack(p, 2, 1), x, v, zv, sc, tc, shape_blocks=2, texture_blocks=1,
            dtype=jnp.float32, tile_fwd=64, tile_bwd=64, interpret=True, white_bkgd=white,
            data_grads=True)
        return sum(jnp.sum(o * h) for o, h in zip(out, heads))

    value, grads = jax.value_and_grad(loss, argnums=(0, 1, 2, 3, 4, 5))(
        params, *(jnp.asarray(a) for a in (xyz, vd, z, codes[0], codes[1])))
    return white, (xyz, vd, z, codes, heads), jax.tree.map(np.asarray, (params, value, grads))


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


def test_train_render_data_grads_match_pallas(reference_data):
    """data_grads=True (K3's data mode; its plain version inside the wrappers
    on CPU tensors): the loss and the gradients of every weight and bias,
    both codes, xyz, viewdir and z against the JAX kernel pair's."""
    white, (xyz, vd, z, codes, heads), (params, value, grads) = reference_data
    dec = _port_model(params)
    data = [torch.tensor(a, requires_grad=True) for a in (xyz, vd, z)]
    sc, tc = (torch.tensor(c, requires_grad=True) for c in codes)
    render.reset_launch_counts()
    out = render.field_composite_train(dec, *data, sc, tc, white_bkgd=white)
    loss = sum((o * torch.from_numpy(h)).sum() for o, h in zip(out, heads))
    names = [n for n, _ in dec.named_parameters()]
    g = torch.autograd.grad(loss, list(dec.parameters()) + data + [sc, tc])
    assert all(v == 0 for v in render.LAUNCHES.values())
    np.testing.assert_allclose(float(loss.detach()), float(value), rtol=1e-5)
    ref = convert_decoder(grads[0], 2, 1)
    for name, got in zip(names, g):
        np.testing.assert_allclose(got.numpy(), ref[name].numpy(), rtol=2e-4, atol=2e-5,
                                   err_msg=name)
    for name, got, want in zip(("xyz", "viewdir", "z", "shapecode", "texturecode"),
                               g[len(names):], grads[1:]):
        assert float(np.abs(want).max()) > 0, name
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-5, err_msg=name)


def _grads_in_mode(dec, xyz, vd, z, codes, heads, data_grads, white):
    """Weight and code gradients (and, with data_grads, xyz, viewdir and z
    gradients) of field_composite_train on CPU tensors."""
    data = [torch.tensor(a, requires_grad=data_grads) for a in (xyz, vd, z)]
    sc, tc = (torch.tensor(c, requires_grad=True) for c in codes)
    out = render.field_composite_train(dec, *data, sc, tc, white_bkgd=white,
                                       data_grads=data_grads)
    loss = sum((o * torch.from_numpy(h)).sum() for o, h in zip(out, heads))
    return torch.autograd.grad(loss, list(dec.parameters()) + [sc, tc]
                               + (data if data_grads else []))


@pytest.mark.parametrize("white", [False, True])
def test_data_mode_leaves_weight_and_code_gradients_bit_identical(white):
    """The data mode only adds outputs: the weight and code gradients of
    field_composite_train, K3's stash rows and dzs/dzt are the same bits with
    data_grads True and False (JAX's test_fused_train_render_data_grads_off
    asserts the same of its kernel); the data outputs of K3's plain version
    are render_train_bwd_plain's; and a viewdir given per sample, constant
    along the samples, gives the per-ray viewdir's values."""
    xyz, vd, z, codes, heads = _inputs()
    dec = CodeNeRFDecoder(2, 1, W, W)
    on = _grads_in_mode(dec, xyz, vd, z, codes, heads, True, white)
    off = _grads_in_mode(dec, xyz, vd, z, codes, heads, False, white)
    n = len(off)
    for a, b in zip(on[:n], off):
        assert torch.equal(a, b)
    assert all(float(t.abs().max()) > 0 for t in on[n:])

    wts = render.pack_decoder_params(dec)
    t = torch.from_numpy
    zs, zt = render.conditioned_latents(wts, t(codes[0]), t(codes[1]))
    cot = [t(h) for h in heads]
    L = render.stash_layout(wts)
    stashes = []
    for data_grads in (False, True):
        pt = torch.full((B * R * S, L["ld_pt"]), float("nan"))
        ray = torch.full((B * R, L["ld_ray"]), float("nan"))
        outs = render.render_train_bwd_stash(wts, t(xyz), t(vd), t(z), zs, zt, white, *cot,
                                             pt, ray, data_grads=data_grads)
        stashes.append((pt, ray, outs))
    (pt0, ray0, o0), (pt1, ray1, o1) = stashes
    assert len(o0) == 2 and len(o1) == 5
    for a, b in zip((pt0, ray0) + o0, (pt1, ray1) + o1[:2]):
        assert torch.equal(a.nan_to_num(), b.nan_to_num())
    ref = render.render_train_bwd_plain(wts, t(xyz), t(vd), t(z), zs, zt, white, *cot,
                                        data_grads=True)
    assert len(ref) == 6
    for got, want in zip(o1[2:], ref[3:]):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)

    with torch.no_grad():
        per_ray = render.field_composite_train(dec, t(xyz), t(vd), t(z), t(codes[0]),
                                               t(codes[1]), white_bkgd=white)
        per_sample = render.field_composite_train(
            dec, t(xyz), t(vd)[:, :, None].expand(xyz.shape), t(z), t(codes[0]), t(codes[1]),
            white_bkgd=white)
    for a, b in zip(per_ray, per_sample):
        assert torch.equal(a, b)


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
                                     torch.from_numpy(codes[0]), torch.from_numpy(codes[1]),
                                     data_grads=False)


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


@pytest.mark.parametrize("M", [1, 63, 64, 65, 524_288])
def test_wgrad_splits_cover_every_row_once_in_order(M):
    """K4's first pass cuts M rows into splits of `rows` rows (split s takes
    rows s * rows .. min(M, (s + 1) * rows) - 1, as csrc/wgrad.cu reads
    them): every row in exactly one split, in order, no split empty, each a
    whole number of the kernel's 64-row stages."""
    rows, n_split = render.wgrad_splits(M)
    assert rows % render.WGRAD_STAGE_ROWS == 0 and n_split >= 1
    slices = [range(s * rows, min(M, (s + 1) * rows)) for s in range(n_split)]
    assert all(len(r) > 0 for r in slices)
    assert [i for r in slices for i in r] == list(range(M))
    assert n_split <= render.WGRAD_SPLITS


@pytest.mark.parametrize("per_point", [False, True], ids=["per_ray", "per_point"])
@pytest.mark.parametrize("shape", [(256, 3, 1), (128, 2, 1), (64, 3, 1), (32, 2, 2)])
def test_stash_column_blocks_start_on_16_bytes(per_point, shape):
    """Every column block of the stash rows, and the rows themselves, start
    on a multiple of 4 floats (K4 copies them 16 bytes at a time), the
    blocks keep their order and widths without overlapping, and the row
    holds them all."""
    W_, ns, nt = shape
    wts = render.pack_decoder_params(CodeNeRFDecoder(ns, nt, W_, W_))
    L = render.stash_layout(wts, per_point)
    names = render._STASH_POINT_COLS + (("a_dpe",) if per_point else ())
    assert all(L[n] % 4 == 0 for n in names + ("ld_pt", "r_dpe", "r_gv", "ld_ray"))
    d_xyz, d_dir = 3 * (2 * wts.num_xyz_freq + 1), 3 * (2 * wts.num_dir_freq + 1)
    widths = {"a_xyz": d_xyz, "a_sh": ns * W_, "a_hh": W_ // 2, "g_sh": ns * W_,
              "a_tx": nt * W_, "g_tx": nt * W_, "g_sig": 1, "g_hh": W_ // 2, "g_rgb": 3,
              "a_dpe": d_dir}
    ends = [L[n] + widths.get(n, W_) for n in names]
    assert all(e <= L[n] and L[n] - e < 4 for e, n in zip(ends, names[1:]))
    assert L["width"] == ends[-1] <= L["ld_pt"]
    if not per_point:
        assert L["r_gv"] >= d_dir and L["ld_ray"] >= L["r_gv"] + W_


@pytest.mark.parametrize("case", ["ok", "column", "stride", "dtype", "shape", "count"])
def test_wgrad_wrapper_validates_inputs(case):
    """What K4's wrapper checks before a launch (they need no card): the
    problems of a stash pass; a column block that does not start on 16
    bytes, a row stride that is not a multiple of 4 floats, a wrong dtype,
    inconsistent shapes or too many problems raise."""
    wts = render.pack_decoder_params(CodeNeRFDecoder(2, 1, 32, 32))
    L = render.stash_layout(wts)
    pt, ray = torch.zeros((70, L["ld_pt"])), torch.zeros((10, L["ld_ray"]))
    grads = render._linear_grad_buffers(wts, "cpu")
    problems = render.wgrad_problems(wts, pt, ray, grads)
    p = problems[1]
    if case == "column":
        p.A = pt[:, L["a_sh"] + 1:L["a_sh"] + 33]
    elif case == "stride":
        p.G = torch.zeros((70, 35))[:, :32]
    elif case == "dtype":
        p.A = p.A.double()
    elif case == "shape":
        p.G = p.G[:-1]
    elif case == "count":
        problems = problems * 3
    if case == "ok":
        render.check_wgrad_problems(problems)
    else:
        with pytest.raises(ValueError):
            render.check_wgrad_problems(problems)
