"""The port's per-point field (supnerf_tpu_torch/ops/field.py) on the CPU:
the plain version of K5 against field_forward_pallas in interpret mode with
the encodings streamed (A7) and computed in the kernel (A11b), and the
autograd.Function (K5 forward, K6 backward, their plain versions inside the
wrappers on CPU tensors) against jax.grad through field_apply_pallas (A8),
on the same decoder weights and inputs. Tolerances are
tests/test_pallas_field.py's: atol 2e-5 on values, rtol 1e-4 and atol 2e-4
on gradients (float32 on both sides)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_threads  # noqa: F401
from supnerf_tpu.models.nerf_mlp import CodeNeRFDecoder as JaxDecoder
from supnerf_tpu.ops.pallas_field import field_apply_pallas, field_forward_pallas
from supnerf_tpu.ops.pallas_field import pack_decoder_params as jax_pack
from supnerf_tpu_torch.models.convert import convert_decoder
from supnerf_tpu_torch.models.nerf_mlp import CodeNeRFDecoder
from supnerf_tpu_torch.ops import field, render
from torch_memory import release_memory_after_module  # noqa: F401

B, M = 2, 150          # objects; points per object, not a multiple of the kernels' 64
CONFIGS = [(64, 3, 1), (32, 1, 1)]     # (W, shape blocks, texture blocks)


def _setup(W, ns, nt, seed=0):
    """A decoder in both packages with the same weights, per-point inputs
    for B objects (each point its own direction) and per-object codes."""
    rng = np.random.default_rng(seed)
    xyz = (rng.normal(size=(B, M, 3)) * 0.4).astype(np.float32)
    vd = rng.normal(size=(B, M, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    codes = (rng.normal(size=(2, B, W)) * 0.3).astype(np.float32)
    jmodel = JaxDecoder(shape_blocks=ns, texture_blocks=nt, W=W, latent_dim=W)
    variables = jmodel.init(jax.random.PRNGKey(seed), jnp.asarray(xyz[0]), jnp.asarray(vd[0]),
                            jnp.asarray(codes[0, 0]), jnp.asarray(codes[1, 0]))
    params = jax.tree.map(np.asarray, variables["params"])
    tmodel = CodeNeRFDecoder(ns, nt, W, W)
    tmodel.load_state_dict(convert_decoder(params, ns, nt), strict=True)
    return jax_pack(params, ns, nt), render.pack_decoder_params(tmodel), xyz, vd, codes


def _cotangents():
    rng = np.random.default_rng(7)
    return [rng.normal(size=(B, M, k)).astype(np.float32) for k in (1, 3)]


@pytest.mark.parametrize("pe_in_kernel", [False, True], ids=["A7", "A11b"])
@pytest.mark.parametrize("W,ns,nt", CONFIGS)
def test_field_fwd_plain_matches_field_forward_pallas(W, ns, nt, pe_in_kernel):
    """K5's plain version, the wrapper on CPU tensors and field_forward
    against both variants of the JAX forward kernel, object by object."""
    packed, wts, xyz, vd, codes = _setup(W, ns, nt)
    t = torch.from_numpy
    zs, zt = render.conditioned_latents(wts, t(codes[0]), t(codes[1]))
    plain = field.field_fwd_plain(wts, t(xyz), t(vd), zs, zt)
    wrapped = field.field_fwd(wts, t(xyz), t(vd), zs.contiguous(), zt.contiguous())
    entry = field.field_forward(wts, t(xyz).reshape(B, 10, 15, 3), t(vd).reshape(B, 10, 15, 3),
                                t(codes[0]), t(codes[1]))
    assert plain[0].shape == (B, M, 1) and plain[1].shape == (B, M, 3)
    assert entry[0].shape == (B, 10, 15, 1)
    for b in range(B):
        ref = field_forward_pallas(packed, jnp.asarray(xyz[b]), jnp.asarray(vd[b]),
                                   jnp.asarray(codes[0, b]), jnp.asarray(codes[1, b]),
                                   shape_blocks=ns, texture_blocks=nt, dtype=jnp.float32,
                                   tile_m=128, interpret=True, pe_in_kernel=pe_in_kernel)
        for name, i in (("sigma", 0), ("rgb", 1)):
            r = np.asarray(ref[i])
            np.testing.assert_allclose(plain[i][b].numpy(), r, atol=2e-5, err_msg=name)
            np.testing.assert_allclose(wrapped[i][b].numpy(), r, atol=2e-5, err_msg=name)
            np.testing.assert_allclose(entry[i][b].reshape(M, -1).numpy(), r, atol=2e-5,
                                       err_msg=name)


@pytest.mark.parametrize("W,ns,nt", CONFIGS)
def test_field_apply_gradients_match_pallas(W, ns, nt):
    """Two objects with their own codes: the gradients of field_apply
    (FieldApply on CPU tensors) for the points, the view directions and both
    codes against jax.grad through field_apply_pallas in interpret mode
    (tile_fwd 128, tile_bwd 64) per object; no launch counter moves."""
    packed, wts, xyz, vd, codes = _setup(W, ns, nt, seed=1)
    cots = _cotangents()
    args = [torch.from_numpy(a).requires_grad_(True) for a in (xyz, vd, codes[0], codes[1])]
    render.reset_launch_counts()
    sigma, rgb = field.field_apply(wts, *args)
    loss = (sigma * torch.from_numpy(cots[0])).sum() + (rgb * torch.from_numpy(cots[1])).sum()
    grads = torch.autograd.grad(loss, args)
    assert not any(render.LAUNCHES.values())   # CPU: no kernel
    for b in range(B):
        def jloss(x, v, sc, tc):
            s, c = field_apply_pallas(packed, x, v, sc, tc, shape_blocks=ns, texture_blocks=nt,
                                      dtype=jnp.float32, tile_fwd=128, tile_bwd=64,
                                      interpret=True)
            return jnp.sum(s * cots[0][b]) + jnp.sum(c * cots[1][b])

        ref = jax.grad(jloss, argnums=(0, 1, 2, 3))(
            jnp.asarray(xyz[b]), jnp.asarray(vd[b]), jnp.asarray(codes[0, b]),
            jnp.asarray(codes[1, b]))
        for name, g, r in zip(("xyz", "viewdir", "shapecode", "texturecode"), grads, ref):
            np.testing.assert_allclose(g[b].numpy(), np.asarray(r), rtol=1e-4, atol=2e-4,
                                       err_msg=f"{name} object {b}")


def test_field_bwd_plain_matches_function_backward():
    """K6's plain version (what chip_smoke.py holds the kernel to) returns
    the cotangents of the latents zs/zt the kernel returns, and they are the
    Function's; an unused output gets a zero cotangent."""
    _, wts, xyz, vd, codes = _setup(64, 3, 1)
    t = torch.from_numpy
    zs, zt = (z.contiguous() for z in render.conditioned_latents(wts, t(codes[0]), t(codes[1])))
    cots = [t(c) for c in _cotangents()]
    plain = field.field_bwd_plain(wts, t(xyz), t(vd), zs, zt, *cots)
    args = [a.clone().requires_grad_(True) for a in (t(xyz), t(vd), zs, zt)]
    fn = torch.autograd.grad(field.FieldApply.apply(*args, wts), args, cots)
    assert [tuple(p.shape) for p in plain] == [(B, M, 3), (B, M, 3), (B, 3, 64), (B, 1, 64)]
    for a, b in zip(plain, fn):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)
    sigma_only = torch.autograd.grad(field.FieldApply.apply(*args, wts)[0], args, cots[0])
    ref = field.field_bwd_plain(wts, t(xyz), t(vd), zs, zt, cots[0], torch.zeros_like(cots[1]))
    for a, b in zip(sigma_only, ref):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("case", ["dtype", "shape", "contiguity", "width", "cotangent", "empty"])
def test_field_wrappers_validate_inputs(case):
    """The checks a CUDA launch of K5/K6 runs first (they need no card):
    wrong dtype, mismatched shape, non-contiguous input, an unsupported
    width, a cotangent of the wrong shape, no points."""
    _, wts, xyz, vd, codes = _setup(64, 3, 1)
    t = torch.from_numpy
    x, v = t(xyz), t(vd)
    zs, zt = (z.contiguous() for z in render.conditioned_latents(wts, t(codes[0]), t(codes[1])))
    cots = [t(c) for c in _cotangents()]
    field._check_field_inputs(wts, x, v, zs, zt, *cots)      # the unchanged inputs pass
    if case == "dtype":
        x = x.double()
    elif case == "shape":
        v = v[:, :-1].contiguous()
    elif case == "contiguity":
        x = x.transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "width":
        _, wts, *_ = _setup(32, 1, 1)
        zs, zt = zs[:, :1, :32].contiguous(), zt[:, :, :32].contiguous()
    elif case == "cotangent":
        cots[1] = cots[1][..., :1].contiguous()
    else:
        x, v, cots = x[:, :0], v[:, :0], [c[:, :0] for c in cots]
    with pytest.raises(ValueError):
        field._check_field_inputs(wts, x, v, zs, zt, *cots)


@pytest.mark.parametrize("wrapper", ["field_fwd", "field_bwd", "field_train_bwd_stash"])
def test_only_the_kernels_report_gates(wrapper):
    """gate_buffer holds a point's n_shape + n_tex + 3 ReLU masks of W/32
    words; the plain versions keep no gates, so each wrapper raises when
    asked for them with CPU tensors, and without them runs as before."""
    _, wts, xyz, vd, codes = _setup(64, 3, 1)
    t = torch.from_numpy
    x, v = t(xyz), t(vd)
    zs, zt = (z.contiguous() for z in render.conditioned_latents(wts, t(codes[0]), t(codes[1])))
    gates = field.gate_buffer(wts, x)
    assert gates.shape == (*x.shape[:2], 3 + 1 + 3, 2) and gates.dtype == torch.int32
    assert not bool(gates.any())
    args = [wts, x, v, zs, zt]
    if wrapper != "field_fwd":
        args += [t(c) for c in _cotangents()]
    if wrapper == "field_train_bwd_stash":
        args.append(torch.empty((x.shape[0] * x.shape[1],
                                 render.stash_layout(wts, per_point=True)["ld_pt"])))
    fn = getattr(field, wrapper)
    with pytest.raises(ValueError):
        fn(*args, gates=gates)
    fn(*args)
