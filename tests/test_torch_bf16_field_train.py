"""The port's per-point training field and multiview opt_model in the
kernels' bfloat16 mode on the CPU: ops.field.field_train with a decoder of
field_dtype "bfloat16" (K5's plain version on the exact encodings for A9,
K7's and K4's plain versions in the mode for A10) against the JAX
package's field_train_pallas at dtype=bfloat16 in interpret mode, the
per-point stash's layout in the mode, and run_multiview_tto(opt_model=True)
with a SUPNeRF of field_dtype "bfloat16" (its decoder copy on flax
TorchDense's bfloat16 contract, models/nerf_mlp.decode_bf16) against the
JAX run on its flax decoder at bfloat16.

Each comparison follows tests/test_torch_bf16_train.py's rule: the port
lies within a stated tolerance of JAX's bfloat16 result, and that tolerance
is at most a tenth of JAX's own bfloat16-against-float32 distance on the
same inputs, which shows that the port rounds where JAX rounds.

Two inputs are given to the port as JAX computes them, as
tests/test_torch_bf16.py gives it XLA's doubling encodings: both sides
compute them in float32 from the same data, in another order, and where
the two differ by a unit a bfloat16 rounding downstream can flip.
- field_train's latent projections (pallas_field.py:
  conditioned_latents_batched's XLA dot, the port's Linear): an added
  latent is rounded at the next layer's product, and at a ReLU unit that
  is off the layer input is the latent itself at every point of the
  object, so a latent one unit from a bfloat16 tie moves that unit at half
  the object's points (measured: 3.2e-4 of rgb from the latents alone, at
  W 64; 7.7e-8 with JAX's). The port's own latents keep the autograd
  graph: only their values are replaced.
- multiview's sample points: each package forms them from the pose with
  its own float32 arithmetic (2,894 of the first update's 3,072
  coordinates differ by units), and a unit of a coordinate becomes ~512
  units of sin(2^9 x), which rounds to another bfloat16 value at ~1 % of
  the top frequency's encodings (measured: 3.7e-3 of the first layer's
  weight gradient, a third of JAX's own bfloat16-vs-float32 distance).
  The port's own points keep the autograd graph to the poses. The curves
  are run without opt_pose, so that JAX's points of every iteration are
  known before the run.

The decoder's weight gradients in multiview opt_model are held to the
whole decoder's gradient, each leaf relative to its largest value, by
chip_smoke.py's rule for a bfloat16 kernel (closer_than_float32): ten
times closer to JAX's bfloat16 gradient than that is to JAX's float32 one
in root mean square, no element farther than JAX's own largest distance,
at most 1 % of the elements beyond a tenth of it. JAX's transpose of a
bfloat16 layer rounds the weight's cotangent to bfloat16 after its float32
sum over the points, and a sum in another order rounds to the
neighbouring value near a tie: measured 3 elements of 9,860, in the
latent projections' weights, whose cotangent is one rounded product of
the summed latent cotangent and the code.

Shapes: field_train at tests/test_torch_field_train.py's two cases (W 128
with 2 shape and 1 texture block at 2 objects x 16 x 8 points; W 64 with
3 and 1 at a ragged 96 points); multiview at tests/test_torch_multiview.py's
tiny config (1 shape and 1 texture block, latent 32, 2 views, 6
iterations).

Serial cost on an 8-core CPU: ~60 s (54-73 s measured), most of it JAX:
the training kernels in interpret mode (~9 s a case at bfloat16 and
float32), the SUPNeRF's JAX init (~10-14 s), four multiview runs and two
first-update gradients (compilation)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_threads  # noqa: F401
from supnerf_tpu.data.synthetic import make_object_batch
from supnerf_tpu.geometry import poses as jax_poses
from supnerf_tpu.geometry.boxes import invert_pose as jax_invert_pose
from supnerf_tpu.models import build_model as jax_build_model
from supnerf_tpu.models import init_model_variables
from supnerf_tpu.models.nerf_mlp import CodeNeRFDecoder as JaxDecoder
from supnerf_tpu.ops.pallas_field import conditioned_latents_batched, field_train_pallas
from supnerf_tpu.ops.pallas_field import pack_decoder_params as jax_pack
from supnerf_tpu.ops.volume_render import occupancy_loss as jax_occ_loss
from supnerf_tpu.ops.volume_render import rgb_loss_masked as jax_rgb_loss
from supnerf_tpu.render.renderer import render_rays_frustum as jax_render_frustum
from supnerf_tpu.tto import TTOConfig as JaxTTOConfig
from supnerf_tpu.tto.core import pose_param_fns as jax_pose_param_fns
from supnerf_tpu.tto.multiview import MultiviewBatch as JaxMultiviewBatch
from supnerf_tpu.tto.multiview import run_multiview_tto as jax_run_multiview_tto
from supnerf_tpu_torch.models.convert import convert_decoder, convert_supnerf_variables
from supnerf_tpu_torch.models.factory import build_model
from supnerf_tpu_torch.models.nerf_mlp import CodeNeRFDecoder
from supnerf_tpu_torch.ops import field, render
from supnerf_tpu_torch.tto import core, multiview
from test_torch_field_train import CASES, _inputs, _loss
from test_torch_multiview import COMMON, TINY_HP, T, V
from torch_memory import release_memory_after_module  # noqa: F401

# field_train against field_train_pallas at bfloat16, each relative to the
# largest |JAX bfloat16 value| of its output: sigma and rgb (measured at most
# 1.4e-5 and 1.4e-4, where JAX's bfloat16-vs-float32 distance is at least
# 2.8e-4 and 2.0e-3); the loss (measured 1.2e-7, the distance 3.4e-5); every
# weight, bias and code gradient (measured at most 3.9e-5, where the
# distance is at least 9.7e-4) but the heads' biases, sums of the unrounded
# cotangents (measured at most 3.6e-7, the distance at least 1.2e-5); xyz
# and viewdir (measured at most 8.0e-4, the distance at least 0.14: the top
# frequency's 2^9 in the chain rule). The same bits at 1 and 8 threads.
FWD_RTOL = {"sigma": 2.5e-5, "rgb": 1.8e-4}
LOSS_RTOL = 1e-6
GRAD_RTOL = 6e-5
HEAD_BIAS_RTOL = 1e-6
HEAD_BIASES = ("sigma.0.bias", "rgb.2.bias")
DATA_RTOL = 2e-3
# multiview opt_model's first update, each relative to its largest |JAX
# bfloat16 value|: the loss and the codes' gradients (measured equal, the
# distance 1.2e-4 of the loss and at least 4.3e-3 of the codes' gradients)
# and the poses' (measured at most 1.4e-5, the distance at least 3.6e-2);
# the curves, absolute (measured 7.5e-6 of the loss and 9.4e-5 of the
# PSNR, the distance 3.4e-4 and 1.9e-3); the decoder's gradient as a whole
# (measured: root mean square 6.8e-4 of JAX's distance, largest 6.1e-3 of
# it, no element beyond a tenth of it)
MV_LOSS_RTOL = 1e-6
MV_GRAD_RTOL = {"shapecode": 1e-5, "texturecode": 1e-5, "rot": 1e-3, "trans": 1e-3}
MV_CURVE_TOL = {"loss": 2e-5, "psnr": 1.5e-4}
# chip_smoke.py's closer_than_float32 constants
BF16_CLOSER = 10
BF16_POINT_SHARE = 1e-2


def _close(name, port, j16, j32, tol):
    """port within tol of JAX's bfloat16 result, tol <= a tenth of JAX's
    bfloat16-vs-float32 distance (tests/test_torch_bf16_train.py's)."""
    port, j16, j32 = (np.asarray(a, np.float64) for a in (port, j16, j32))
    err, spread = float(np.abs(port - j16).max()), float(np.abs(j16 - j32).max())
    assert err <= tol, f"{name}: port vs JAX bfloat16 {err:.3e} > tol {tol:.1e}"
    assert tol <= spread / 10, f"{name}: tol {tol:.1e} > JAX's bf16-vs-f32 {spread:.3e} / 10"


def _rel_close(name, port, j16, j32, rtol):
    _close(name, port, j16, j32, rtol * float(np.abs(np.asarray(j16, np.float64)).max()))


def _not_bf16_exact(name, t):
    t = torch.as_tensor(np.asarray(t))
    assert not torch.equal(t, render.bf16_round(t)), f"{name} is bfloat16-exact"


# --------------------------------------------------------------------------
# field_train (A9 + A10)
# --------------------------------------------------------------------------

@pytest.fixture(scope="module", params=list(CASES))
def field_runs(request):
    """(case, JAX's (loss, outputs, gradients) at bfloat16 and at float32,
    the port's in the bfloat16 mode: loss, outputs and the gradients of
    every decoder parameter (named), xyz, viewdir and both codes)."""
    lead, W, ns, nt = CASES[request.param]
    xyz, vd, codes = _inputs(lead, W)
    jdec = JaxDecoder(shape_blocks=ns, texture_blocks=nt, W=W, latent_dim=W)
    params = jdec.init(jax.random.PRNGKey(0), jnp.asarray(xyz[0]), jnp.asarray(vd[0]),
                       jnp.asarray(codes[0, 0]), jnp.asarray(codes[1, 0]))["params"]
    ref = {}
    for dtype in (jnp.bfloat16, jnp.float32):
        def loss(p, x, v, sc, tc, dtype=dtype):
            out = field_train_pallas(jax_pack(p, ns, nt), x, v, sc, tc, shape_blocks=ns,
                                     texture_blocks=nt, dtype=dtype, tile_fwd=64, tile_bwd=64,
                                     interpret=True)
            return _loss(*out), out

        (value, outs), grads = jax.value_and_grad(loss, argnums=(0, 1, 2, 3, 4), has_aux=True)(
            params, *(jnp.asarray(a) for a in (xyz, vd, codes[0], codes[1])))
        value, outs, grads = jax.tree.map(np.asarray, (value, outs, grads))
        ref[dtype] = (value, outs, {**convert_decoder(grads[0], ns, nt),
                                    **dict(zip(("xyz", "viewdir", "shapecode", "texturecode"),
                                               grads[1:]))})
    jlat = [torch.from_numpy(np.array(a)) for a in conditioned_latents_batched(
        jax_pack(params, ns, nt), jnp.asarray(codes[0]), jnp.asarray(codes[1]))]

    dec = CodeNeRFDecoder(ns, nt, W, W, field_dtype="bfloat16")
    dec.load_state_dict(convert_decoder(jax.tree.map(np.asarray, params), ns, nt), strict=True)
    data = [torch.tensor(a, requires_grad=True) for a in (xyz, vd)]
    sc, tc = (torch.tensor(c, requires_grad=True) for c in codes)
    own = render.conditioned_latents_of

    def xla_latents(decoder, shapecode, texturecode):
        return tuple(p + (j - p).detach() for p, j in zip(own(decoder, shapecode, texturecode),
                                                          jlat))

    render.reset_launch_counts()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(field, "conditioned_latents_of", xla_latents)
        sig, rgb = field.field_train(dec, *data, sc, tc)
        loss = _loss(sig, rgb)
        names = [n for n, _ in dec.named_parameters()]
        g = torch.autograd.grad(loss, list(dec.parameters()) + data + [sc, tc])
    assert not any(render.LAUNCHES.values())       # CPU tensors: the plain versions
    port = dict(zip(names + ["xyz", "viewdir", "shapecode", "texturecode"],
                    (t.numpy() for t in g)))
    return (request.param, ref[jnp.bfloat16], ref[jnp.float32],
            (float(loss.detach()), (sig.detach().numpy(), rgb.detach().numpy()), port))


def test_field_train_bf16_matches_pallas(field_runs):
    """field_train with a bfloat16 decoder on CPU tensors (FieldTrain: K5's
    plain version on the exact encodings, then K7's plain version in the
    mode and K4's, wgrad_plain) against field_train_pallas at
    dtype=bfloat16: sigma, rgb, the loss, every weight and bias gradient
    (the latent projections' included), both code gradients, and the xyz
    and viewdir gradients, each within its stated tolerance, at most a
    tenth of JAX's own bfloat16-against-float32 distance; none of the
    outputs or gradients is bfloat16-exact, on either side."""
    case, (v16, o16, g16), (v32, o32, g32), (value, outs, grads) = field_runs
    _, _, ns, nt = CASES[case]
    _rel_close("loss", value, v16, v32, LOSS_RTOL)
    for name, a, b, c in zip(("sigma", "rgb"), outs, o16, o32):
        assert a.shape == b.reshape(a.shape).shape, name
        _rel_close(name, a, b.reshape(a.shape), c.reshape(a.shape), FWD_RTOL[name])
        _not_bf16_exact(name, a)
    assert set(grads) == set(g16) and len(grads) == 2 * (2 * ns + 2 * nt + 6) + 4
    for name, got in grads.items():
        rtol = (HEAD_BIAS_RTOL if name in HEAD_BIASES else
                DATA_RTOL if name in ("xyz", "viewdir") else GRAD_RTOL)
        want = np.asarray(g16[name]).reshape(got.shape)
        assert float(np.abs(want).max()) > 0, name
        _rel_close(f"d{name}", got, want, np.asarray(g32[name]).reshape(got.shape), rtol)
        if got.size > 1:
            _not_bf16_exact(f"d{name}", got)
            _not_bf16_exact(f"JAX's d{name}", want)


def _bf16_field_inputs(W=64, ns=3, nt=1, M=150, seed=2):
    gen = torch.Generator().manual_seed(seed)
    dec = CodeNeRFDecoder(ns, nt, W, W, field_dtype="bfloat16")
    wts = render.pack_decoder_params(dec)
    xyz = torch.randn((3, M, 3), generator=gen) * 0.4
    vd = torch.nn.functional.normalize(torch.randn((3, M, 3), generator=gen), dim=-1)
    codes = torch.randn((2, 3, W), generator=gen) * 0.3
    zs, zt = render.conditioned_latents(wts, codes[0], codes[1])
    cot = [torch.randn((3, M, k), generator=gen) for k in (1, 3)]
    return wts, (xyz, vd, zs, zt), cot


def test_field_train_stash_bf16_layout():
    """K7's per-point stash in the bfloat16 mode (its plain version,
    field_train_bwd_stash on CPU tensors): stash_layout(per_point=True)'s,
    the float32 mode's layout, every A-side column block (a_*, a_dpe: the
    rounded exact encodings, the stashed ReLU outputs, e and the
    latent-added inputs rounded) bfloat16-exact and every G-side block in
    float32; K4's problems on it pass check_wgrad_problems, and K4's plain
    version in the mode over them gives field_train_bwd_plain's weight
    gradients, whose data and latent outputs are the stash version's."""
    wts, args, cot = _bf16_field_inputs()
    B3, M = args[0].shape[:2]
    L = render.stash_layout(wts, per_point=True)
    w32 = render.pack_decoder_params(CodeNeRFDecoder(3, 1, 64, 64))
    assert L == render.stash_layout(w32, per_point=True)
    pt = torch.full((B3 * M, L["ld_pt"]), float("nan"))
    got = field.field_train_bwd_stash(wts, *args, *cot, pt)
    grads = render._linear_grad_buffers(wts, "cpu")
    probs = render.wgrad_problems(wts, pt, None, grads)
    render.check_wgrad_problems(probs)
    assert all(bool(torch.isfinite(x).all()) for p in probs for x in (p.A, p.G))
    assert all(torch.equal(p.A, render.bf16_round(p.A)) for p in probs)
    assert not any(torch.equal(p.G, render.bf16_round(p.G)) for p in probs)
    d_dir = 3 * (2 * wts.num_dir_freq + 1)
    a_dpe = pt[:, L["a_dpe"]:L["a_dpe"] + d_dir]
    assert torch.equal(a_dpe, render.encode_bf16(args[1], wts.num_dir_freq, True).reshape(-1,
                                                                                           d_dir))
    render.wgrad_plain(probs, field_dtype="bfloat16")
    *data, want = field.field_train_bwd_plain(wts, *args, *cot)
    for a, b in zip(got, data):
        assert torch.equal(a, b)
    for a, b in zip(grads, want):
        assert torch.equal(a, b)


def test_field_train_bwd_bf16_chain_rule_is_xlas():
    """K7's plain version in the mode differentiates the exact float32
    encoding (encode_bwd_exact, autograd of positional_encoding: XLA's
    autodiff of field_train_pallas's encodings outside its kernels), not
    K6's bfloat16 rule on the doubling encodings: its dxyz and dviewdir are
    encode_bwd_exact of the encodings' cotangents, which render's
    transposed_bf16 gives on recompute_bf16's stash."""
    wts, (xyz, vd, zs, zt), (g_sig, g_rgb) = _bf16_field_inputs(M=70)
    pt = torch.empty((3 * 70, render.stash_layout(wts, per_point=True)["ld_pt"]))
    dxyz, dvd, dzs, dzt = field.field_train_bwd_stash_plain(wts, xyz, vd, zs, zt, g_sig, g_rgb,
                                                           pt)
    xpe = render.encode_bf16(xyz, wts.num_xyz_freq, True)
    dpe = render.encode_bf16(vd, wts.num_dir_freq, True)
    rec = render.recompute_bf16(wts, xpe, dpe @ wts.w_vd_b, zs, zt)
    gpe, gdir, want_zs, want_zt = render.transposed_bf16(
        wts, rec, g_sig[..., 0] * torch.sigmoid(rec["logit"]), g_rgb, 1)
    assert torch.equal(dzs, want_zs) and torch.equal(dzt, want_zt)
    assert torch.equal(dxyz, field.encode_bwd_exact(xyz, gpe, wts.num_xyz_freq))
    assert torch.equal(dvd, field.encode_bwd_exact(vd, gdir, wts.num_dir_freq))
    doubling = render.encode_bwd_bf16(render.encode_bf16(xyz, wts.num_xyz_freq), gpe,
                                      wts.num_xyz_freq)
    assert not torch.allclose(dxyz, doubling, rtol=1e-3, atol=1e-3)


def test_field_train_bf16_kernel_sources_and_counters():
    """A9 is K5's bfloat16 build on the exact encodings, counted apart
    (field_fwd_train_bf16); A10 a bfloat16 build of K7
    (field_train_bwd_bf16_kernel, C entry supnerf_field_train_bwd_bf16:
    field_backward with kStash, kBf16 and the exact encodings), its stash
    copies rounded on the A side; K4's bfloat16 entry reduces it."""
    k7 = (render.CSRC_DIR / "field_train_bwd.cu").read_text()
    common = (render.CSRC_DIR / "render_common.cuh").read_text()
    assert "field_backward<true, false, true>(" in k7 and "field_backward<true, false>(" in k7
    assert 'extern "C" int supnerf_field_train_bwd_bf16(' in k7
    assert "the stash has no bfloat16 mode" not in common
    assert "stash_rows<kBf16>(buf, Ws, N, n, pt + col, st.ld_pt)" in common
    w16 = render.pack_decoder_params(CodeNeRFDecoder(1, 1, 64, 64, field_dtype="bfloat16"))
    w32 = render.pack_decoder_params(CodeNeRFDecoder(1, 1, 64, 64))
    assert render.launch_key("field_fwd", w16, pe="train") == "field_fwd_train_bf16"
    assert render.launch_key("field_train_bwd", w16) == "field_train_bwd_bf16"
    assert render.launch_key("field_fwd", w32, pe="train") == "field_fwd"
    assert render.launch_key("field_train_bwd", w32) == "field_train_bwd"
    for key in ("field_fwd_train_bf16", "field_train_bwd_bf16", "wgrad_bf16"):
        assert key in render.LAUNCHES
    pts = torch.zeros((1, 2, 3))
    with pytest.raises(ValueError, match="PE_MODES|one of"):
        field.field_fwd(w16, pts, pts, torch.zeros((1, 1, 64)), torch.zeros((1, 1, 64)),
                        pe="classic")
    # the chunks of K7 + K4 cover the objects in order, each a whole stash
    ld = render.stash_layout(w16, per_point=True)["ld_pt"]
    chunk, chunks = field.field_train_chunks(w16, 5, render.STASH_BYTES // (2 * ld * 4))
    assert chunk == 2 and [(c.start, c.stop) for c in chunks] == [(0, 2), (2, 4), (4, 5)]
    assert not hasattr(render, "check_float32_decoder")


# --------------------------------------------------------------------------
# multiview opt_model
# --------------------------------------------------------------------------

def _xla_points(samples):
    """A stand-in for tto.multiview.decoder_composite that gives it the
    points and directions of JAX's render (the next of `samples`, each
    (xyz, viewdir) (V,R,S,3)) as values on the port's own graph."""
    it = iter(samples)
    own = multiview.decoder_composite

    def composite(dec, xyz, vd, z, sc, tc):
        jx, jv = next(it)
        vd = vd[:, :, None].expand_as(xyz) if vd.dim() == 3 else vd
        return own(dec, xyz + (jx - xyz).detach(), vd + (jv - vd).detach(), z, sc, tc)

    return composite


@pytest.fixture(scope="module")
def mv():
    """tests/test_torch_multiview.py's tiny config with field_dtype
    "bfloat16": the JAX models in both precisions (one set of variables),
    the views, the port's model in the mode."""
    hp16 = dict(TINY_HP, field_dtype="bfloat16")
    jmodels = {"bfloat16": jax_build_model("supnerf", hp16),
               "float32": jax_build_model("supnerf", TINY_HP)}
    variables = jax.tree.map(np.asarray, init_model_variables(
        jmodels["float32"], jax.random.PRNGKey(0), img_size=32))
    raw, _ = make_object_batch(V, seed=5, in_img_sz=32, render_im_sz=8, n_lidar=16)
    keys = jax.random.split(jax.random.PRNGKey(9), V)
    raw["pose_init"] = np.asarray(jax.vmap(
        lambda k, K, roi: jax_poses.get_random_pose2(k, K, roi.astype(jnp.float32)))(
        keys, jnp.asarray(raw["K"]), jnp.asarray(raw["roi_nerf"])))
    tmodel = build_model("supnerf", hp16)
    tmodel.load_state_dict(convert_supnerf_variables(variables, TINY_HP), strict=True)
    return jmodels, variables, raw, tmodel


def _view_render(jm, variables, raw, t, v, sc, tc, rot, trans, decoder):
    """JAX's loss render of view v at iteration t, as run_multiview_tto's
    view_loss makes it: (loss, (xyz, viewdir))."""
    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(0), t), v)
    from_params = jax_pose_param_fns(JaxTTOConfig(**COMMON))[1]
    field_vars = dict(variables, params=dict(variables["params"], decoder=decoder))
    out = jax_render_frustum(
        lambda x, d: jm.apply(field_vars, x, d, sc, tc), key,
        jax_invert_pose(from_params(rot[v], trans[v])), jnp.asarray(raw["K"])[v],
        jnp.asarray(raw["roi_nerf"])[v].astype(jnp.float32),
        jnp.linalg.norm(jnp.asarray(raw["wlh"])[v]), n_samples=COMMON["n_samples"],
        im_sz=COMMON["render_im_sz"], shapenet_obj_cood=True, return_samples=True)
    loss = (jax_rgb_loss(out["rgb"], jnp.asarray(raw["rgb_tgt"])[v], jnp.asarray(raw["occ_tgt"])[v])
            + 0.1 * jax_occ_loss(out["acc_trans"], jnp.asarray(raw["occ_tgt"])[v]))
    return loss, (out["xyz"], out["viewdir"])


def _jax_views(jm, variables, raw, t, *params):
    """The mean over the views of _view_render, vmapped as in
    run_multiview_tto, with the views' points."""
    loss, pts = jax.vmap(lambda v: _view_render(jm, variables, raw, t, v, *params))(
        jnp.arange(V))
    return jnp.mean(loss), pts


def test_multiview_opt_model_bf16_first_update(mv):
    """opt_model's first update in the bfloat16 mode at JAX's starting
    parameters: the port's multiview_loss (the decoder copy in the mode
    through decoder_composite, decode_bf16 under autograd, the codes as one
    row the views share) against jax.grad of run_multiview_tto's loss
    (vmapped views, the flax decoder at bfloat16) with the decoder as a
    parameter: the loss, the codes' and the poses' gradients within their
    stated tolerances, at most a tenth of JAX's own bfloat16-vs-float32
    distance, and the decoder's gradient by closer_than_float32's rule
    over all its leaves; no kernel launches."""
    jmodels, variables, raw, tmodel = mv
    to_params = jax_pose_param_fns(JaxTTOConfig(**COMMON))[0]
    rot0, trans0 = jax.vmap(to_params)(jnp.asarray(raw["pose_init"]))
    rng = np.random.default_rng(7)
    sc0, tc0 = (rng.normal(size=(2, 32)) * 0.3).astype(np.float32)
    start = [jnp.asarray(a) for a in (sc0, tc0)] + [rot0, trans0]
    ref = {}
    for mode, jm in jmodels.items():
        (loss, pts), g = jax.jit(jax.value_and_grad(
            lambda *p, jm=jm: _jax_views(jm, variables, raw, 0, *p), argnums=range(5),
            has_aux=True))(*start, variables["params"]["decoder"])
        ref[mode] = (float(loss), [np.asarray(a) for a in g[:4]],
                     convert_decoder(jax.tree.map(np.asarray, g[4]), 1, 1), pts)
    dec = multiview.decoder_copy(tmodel)
    assert dec.field_dtype == "bfloat16"
    names = [n for n, _ in dec.named_parameters()]
    params = [torch.tensor(np.asarray(a)).requires_grad_(True) for a in start]
    cfg, batch = core.TTOConfig(**COMMON), multiview.MultiviewBatch.from_numpy(raw, "cpu")
    jitter = torch.from_numpy(np.asarray([jax.random.uniform(jax.random.fold_in(
        jax.random.fold_in(jax.random.PRNGKey(0), 0), v), (COMMON["n_samples"],))
        for v in range(V)]))
    pts = [tuple(torch.from_numpy(np.asarray(a)) for a in ref["bfloat16"][3])]
    render.reset_launch_counts()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(multiview, "decoder_composite", _xla_points(pts))
        loss, _ = multiview.multiview_loss(
            core.render_decoder(tmodel), params[0], params[1],
            core.pose_param_fns(cfg)[1](params[2], params[3]), batch, cfg, dec=dec,
            jitter=jitter)
        grads = torch.autograd.grad(loss, params + list(dec.parameters()))
    assert not any(render.LAUNCHES.values())
    (l16, g16, d16, _), (l32, g32, d32, _) = ref["bfloat16"], ref["float32"]
    _rel_close("loss", float(loss.detach()), l16, l32, MV_LOSS_RTOL)
    for (name, rtol), got, a, b in zip(MV_GRAD_RTOL.items(), grads[:4], g16, g32):
        _rel_close(f"d{name}", got.numpy(), a, b, rtol)
    port, j16, j32 = [], [], []
    for name, got in zip(names, grads[4:]):
        scale = float(d16[name].abs().max())
        assert scale > 0, name
        port.append(got.reshape(-1).double() / scale)
        j16.append(d16[name].reshape(-1).double() / scale)
        j32.append(d32[name].reshape(-1).double() / scale)
    port, j16, j32 = (torch.cat(x) for x in (port, j16, j32))
    d_port, d_16 = (port - j16).abs(), (j16 - j32).abs()
    rms = float(d_port.pow(2).mean().sqrt()) / float(d_16.pow(2).mean().sqrt())
    beyond = int((d_port > float(d_16.max()) / BF16_CLOSER).sum())
    assert rms * BF16_CLOSER <= 1, rms
    assert float(d_port.max()) <= float(d_16.max())
    assert beyond <= BF16_POINT_SHARE * port.numel(), beyond


def test_multiview_opt_model_bf16_curves(mv):
    """run_multiview_tto(opt_model=True) with a SUPNeRF in the bfloat16
    mode (no opt_pose: the poses, so JAX's points of each iteration, are
    known before the run) against JAX's run_multiview_tto on its flax
    decoder at bfloat16, on the same views, weights and jitter: the loss
    and PSNR curves within their stated tolerances, at most a tenth of
    JAX's own bfloat16-vs-float32 distance; the decoder copy moves the
    loss, the model given stays as it was, and no kernel launches."""
    jmodels, variables, raw, tmodel = mv
    key = jax.random.PRNGKey(0)
    fields = [f for f in JaxMultiviewBatch.__dataclass_fields__ if f != "view_valid"]
    jbatch = JaxMultiviewBatch(view_valid=jnp.ones(V), **{k: jnp.asarray(raw[k]) for k in fields})
    jres = {mode: jax.tree.map(np.asarray, jax_run_multiview_tto(
        jm, variables, jbatch, jnp.zeros(32), jnp.zeros(32),
        JaxTTOConfig(field_impl="flax", **COMMON), key, opt_model=True))
        for mode, jm in jmodels.items()}
    jitter = np.asarray([[jax.random.uniform(jax.random.fold_in(jax.random.fold_in(key, t), v),
                                             (COMMON["n_samples"],)) for v in range(V)]
                         for t in range(T)])
    # JAX's points of every iteration: the poses stay at pose_init's
    # parameters, and the points do not depend on the codes or the decoder
    to_params = jax_pose_param_fns(JaxTTOConfig(**COMMON))[0]
    rot0, trans0 = jax.vmap(to_params)(jnp.asarray(raw["pose_init"]))
    zeros = jnp.zeros(32)
    points = jax.jit(lambda t: _jax_views(jmodels["bfloat16"], variables, raw, t, zeros, zeros,
                                          rot0, trans0, variables["params"]["decoder"])[1])
    pts = [tuple(torch.from_numpy(np.asarray(a)) for a in points(t)) for t in range(T)]
    before = {k: v.clone() for k, v in tmodel.state_dict().items()}
    render.reset_launch_counts()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(multiview, "decoder_composite", _xla_points(pts))
        pres = multiview.run_multiview_tto(
            tmodel, core.render_decoder(tmodel), multiview.MultiviewBatch.from_numpy(raw, "cpu"),
            torch.zeros(32), torch.zeros(32), core.TTOConfig(**COMMON),
            jitter=torch.from_numpy(jitter), opt_model=True)
    assert not any(render.LAUNCHES.values())
    assert all(torch.equal(v, before[k]) for k, v in tmodel.state_dict().items())
    for name, tol in MV_CURVE_TOL.items():
        _close(name, pres[name].numpy(), jres["bfloat16"][name], jres["float32"][name], tol)
    assert float(pres["loss"][-1]) < float(pres["loss"][0])
