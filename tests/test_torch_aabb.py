"""The port's AABB render path (the demo's loss render and scene compositor)
on the CPU against the JAX package: the ray-box geometry
(supnerf_tpu_torch/geometry/rays.py), K1/K2's AABB mode (A3, A4) through
their plain versions and the autograd.Function against the Pallas kernels
in interpret mode (field_composite_aabb_pallas, field_composite_aabb_apply),
render_rays_aabb with the JAX package's draws injected, and the scene
compositor (render/compositor.py). Tolerances are stated in each test;
the kernel ones are tests/test_pallas_render.py's."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from supnerf_tpu.geometry import rays as jrays
from supnerf_tpu.geometry.boxes import invert_pose as jax_invert_pose
from supnerf_tpu.geometry.rotations import axis_angle_to_matrix as jax_aa_to_matrix
from supnerf_tpu.models.nerf_mlp import CodeNeRFDecoder as JaxDecoder
from supnerf_tpu.ops.pallas_field import pack_decoder_params as jax_pack
from supnerf_tpu.ops.pallas_render import field_composite_aabb_apply, field_composite_aabb_pallas
from supnerf_tpu.render import compositor as jcomp
from supnerf_tpu.render.renderer import render_rays_aabb as jax_render_aabb
from supnerf_tpu_torch.geometry import rays
from supnerf_tpu_torch.geometry.boxes import invert_pose
from supnerf_tpu_torch.geometry.rotations import axis_angle_to_matrix
from supnerf_tpu_torch.models.convert import convert_decoder
from supnerf_tpu_torch.models.nerf_mlp import CodeNeRFDecoder
from supnerf_tpu_torch.ops import render
from supnerf_tpu_torch.render import compositor
from supnerf_tpu_torch.render.renderer import AABB_FIELD_SCALE, render_rays_aabb
from torch_memory import release_memory_after_module  # noqa: F401

W, S = 64, 8
K = np.asarray([[100.0, 0, 64], [0, 100, 40], [0, 0, 1]], np.float32)
WLH = np.asarray([1.9, 4.6, 1.7], np.float32)


def _decoders(seed=0):
    """A W-wide decoder (3 shape blocks, 1 texture block) in both packages,
    the same weights."""
    jmodel = JaxDecoder(shape_blocks=3, texture_blocks=1, W=W, latent_dim=W)
    x = jnp.zeros((2, S, 3))
    variables = jmodel.init(jax.random.PRNGKey(seed), x, x, jnp.zeros(W), jnp.zeros(W))
    tmodel = CodeNeRFDecoder(3, 1, W, W)
    tmodel.load_state_dict(convert_decoder(jax.tree.map(np.asarray, variables["params"]), 3, 1),
                           strict=True)
    return jmodel, variables, render.pack_decoder_params(tmodel)


# --------------------------------------------------------------------------
# geometry
# --------------------------------------------------------------------------

def test_ray_box_geometry_matches_jax():
    """sample_z_stratified with the JAX draws, ray_box_intersection and
    aabb_ray_bounds on rays that hit, miss, start inside the box, point
    away from it and run parallel to an axis (1/0 = inf in the slab test):
    bounds, hits and normalised origins at 1e-5, the slab test's inf and
    NaN entries where JAX has them."""
    rng = np.random.default_rng(3)
    o = rng.normal(size=(2, 12, 3)).astype(np.float32) * 4
    d = rng.normal(size=(2, 12, 3)).astype(np.float32)
    o[0, 0], d[0, 0] = [0.0, 0.0, 0.0], [1.0, 0.0, 0.0]      # inside, axis-parallel
    o[0, 1], d[0, 1] = [0.0, -9.0, 0.2], [0.0, 1.0, 0.0]     # axis-parallel hit
    o[0, 2], d[0, 2] = [0.0, -9.0, 5.0], [0.0, 1.0, 0.0]     # axis-parallel miss
    o[0, 3], d[0, 3] = [0.0, -9.0, 0.0], [0.0, -1.0, 0.0]    # box behind the origin
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    wlh = np.stack([WLH, WLH * 0.7])
    hits = 0
    for b in range(2):
        jb, jh, jo = jrays.aabb_ray_bounds(o[b], d[b], wlh[b])
        pb, ph, po = rays.aabb_ray_bounds(*map(torch.from_numpy, (o[b:b + 1], d[b:b + 1],
                                                                   wlh[b:b + 1])))
        np.testing.assert_array_equal(ph[0].numpy(), np.asarray(jh))
        np.testing.assert_allclose(pb[0].numpy(), np.asarray(jb), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(po[0].numpy(), np.asarray(jo), atol=1e-5, rtol=1e-5)
        hits += int(np.asarray(jh).sum())
        half = WLH / 2
        jn, jf, jhit = jrays.ray_box_intersection(o[b], d[b], -half, half)
        pn, pf, phit = rays.ray_box_intersection(torch.from_numpy(o[b]), torch.from_numpy(d[b]),
                                                 torch.from_numpy(-half), torch.from_numpy(half))
        np.testing.assert_array_equal(phit.numpy(), np.asarray(jhit))
        for a, r in ((pn, jn), (pf, jf)):
            np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=1e-5, rtol=1e-5)
    assert 0 < hits < 24
    key = jax.random.PRNGKey(5)
    near, far = rng.uniform(1, 2, 12).astype(np.float32), rng.uniform(3, 4, 12).astype(np.float32)
    ref = jrays.sample_z_stratified(key, near, far, S)
    draws = np.asarray(jax.random.uniform(key, (12, S)))
    ours = rays.sample_z_stratified(torch.from_numpy(near), torch.from_numpy(far), S,
                                    torch.from_numpy(draws))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-6, rtol=1e-6)


# --------------------------------------------------------------------------
# A3 / A4: K1 and K2 in their AABB mode
# --------------------------------------------------------------------------

def _aabb_inputs(R=21, n_miss=5, n_obj=1):
    """tests/test_pallas_render.py's AABB fixture: per-ray z rows with their
    own bounds, the first n_miss rays missing the box (constant z -1,
    hit False), per object."""
    rng = np.random.default_rng(17)
    vd = rng.normal(size=(n_obj, R, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    near = 2.0 + rng.uniform(0, 1.0, (n_obj, R, 1))
    far = 5.0 + rng.uniform(0, 2.0, (n_obj, R, 1))
    z = (near + (far - near) * np.sort(rng.uniform(0, 1, (n_obj, R, S)), axis=-1))
    hit = np.ones((n_obj, R), bool)
    hit[:, :n_miss] = False
    z[:, :n_miss] = -1.0
    z = z.astype(np.float32)
    xyz = (vd[:, :, None, :] * z[..., None] * 0.3).astype(np.float32)
    codes = (rng.normal(size=(2, n_obj, W)) * 0.3).astype(np.float32)
    return xyz, vd, z, hit, codes


@pytest.mark.parametrize("white", [False, True])
def test_aabb_forward_matches_pallas(white):
    """A3: the plain version and the wrapper on CPU tensors against
    field_composite_aabb_pallas in interpret mode (tile 32; R 21 with 5
    misses): atol 3e-4 rgb and acc, 3e-3 depth. Missed rays are exactly
    background, depth 0 and acc 1."""
    _, variables, wts = _decoders()
    packed = jax_pack(variables["params"], 3, 1)
    xyz, vd, z, hit, codes = _aabb_inputs()
    ref = field_composite_aabb_pallas(packed, jnp.asarray(xyz[0]), jnp.asarray(vd[0]),
                                      jnp.asarray(z[0]), jnp.asarray(hit[0]),
                                      jnp.asarray(codes[0, 0]), jnp.asarray(codes[1, 0]),
                                      dtype=jnp.float32, tile_m=32, interpret=True,
                                      white_bkgd=white)
    t = torch.from_numpy
    zs, zt = render.conditioned_latents(wts, t(codes[0]), t(codes[1]))
    render.reset_launch_counts()
    for out in (render.render_fwd_plain(wts, t(xyz), t(vd), t(z), zs, zt, white, t(hit)),
                render.render_fwd(wts, t(xyz), t(vd), t(z), zs, zt, white, t(hit))):
        for name, a, b, atol in zip(("rgb", "depth", "acc"), out, ref, (3e-4, 3e-3, 3e-4)):
            np.testing.assert_allclose(a[0].numpy(), np.asarray(b), atol=atol, rtol=1e-4,
                                       err_msg=name)
        miss = ~hit[0]
        assert np.all(out[0][0].numpy()[miss] == (1.0 if white else 0.0))
        assert np.all(out[1][0].numpy()[miss] == 0) and np.all(out[2][0].numpy()[miss] == 1)
    assert not any(render.LAUNCHES.values())     # CPU tensors: the plain versions


@pytest.mark.parametrize("white", [False, True])
def test_aabb_gradients_match_pallas(white):
    """A4: field_composite_aabb's gradients (the autograd.Function, whose
    wrappers take the plain versions on CPU tensors) for xyz, the per-ray
    viewdir, the per-ray z and both codes against field_composite_aabb_apply
    in interpret mode, two objects with their own codes: atol 2e-4. Missed
    rays get exactly zero xyz, viewdir and z gradients."""
    _, variables, wts = _decoders()
    packed = jax_pack(variables["params"], 3, 1)
    xyz, vd, z, hit, codes = _aabb_inputs(n_obj=2)
    rng = np.random.default_rng(7)
    cots = [rng.normal(size=(2, 21) + s).astype(np.float32) for s in ((3,), (), ())]
    args = [torch.from_numpy(a).requires_grad_(True) for a in (xyz, vd, z, codes[0], codes[1])]
    out = render.field_composite_aabb(wts, *args[:3], torch.from_numpy(hit), *args[3:],
                                      white_bkgd=white)
    loss = sum((o * torch.from_numpy(c)).sum() for o, c in zip(out, cots))
    grads = torch.autograd.grad(loss, args)
    assert grads[2].shape == (2, 21, S)
    for b in range(2):
        def jloss(x, v, zz, sc, tc):
            o = field_composite_aabb_apply(packed, x, v, zz, hit[b], sc, tc, dtype=jnp.float32,
                                           tile_fwd=32, tile_bwd=32, interpret=True,
                                           white_bkgd=white)
            return sum(jnp.sum(oo * c[b]) for oo, c in zip(o, cots))

        ref = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(
            *(jnp.asarray(a) for a in (xyz[b], vd[b], z[b], codes[0, b], codes[1, b])))
        for name, g, r in zip(("xyz", "viewdir", "z", "shapecode", "texturecode"), grads, ref):
            np.testing.assert_allclose(g[b].numpy(), np.asarray(r), atol=2e-4, rtol=2e-4,
                                       err_msg=f"{name} object {b}")
    miss = torch.from_numpy(~hit)
    for g in grads[:3]:
        assert torch.all(g[miss] == 0)


def test_aabb_bwd_plain_is_the_function_backward():
    """K2's plain version in its AABB mode (what chip_smoke.py holds the
    kernel to) returns the Function's cotangents, with dz per ray."""
    _, _, wts = _decoders()
    xyz, vd, z, hit, codes = _aabb_inputs(R=12, n_miss=3, n_obj=2)
    t = torch.from_numpy
    zs, zt = render.conditioned_latents(wts, t(codes[0]), t(codes[1]))
    rng = np.random.default_rng(2)
    cots = [t(rng.normal(size=(2, 12) + s).astype(np.float32)) for s in ((3,), (), ())]
    plain = render.render_bwd_plain(wts, t(xyz), t(vd), t(z), zs, zt, False, *cots, t(hit))
    args = [a.clone().requires_grad_(True) for a in (t(xyz), t(vd), t(z), zs, zt)]
    fn = torch.autograd.grad(render.FieldComposite.apply(*args, wts, False, t(hit)), args, cots)
    assert [tuple(p.shape) for p in plain] == [(2, 12, S, 3), (2, 12, 3), (2, 12, S),
                                               (2, 3, W), (2, 1, W)]
    for a, b in zip(plain, fn):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


def test_aabb_wrappers_validate_inputs():
    """The AABB mode's input checks (they need no card): z must be per ray
    and hit per ray."""
    _, _, wts = _decoders()
    xyz, vd, z, hit, codes = _aabb_inputs(R=4, n_miss=1)
    t = torch.from_numpy
    zs, zt = render.conditioned_latents(wts, t(codes[0]), t(codes[1]))
    hit_f = t(hit).float()
    render._check_inputs(wts, t(xyz), t(vd), t(z), zs, zt, hit=hit_f)
    with pytest.raises(ValueError, match="z"):
        render._check_inputs(wts, t(xyz), t(vd), t(z[:, 0]).contiguous(), zs, zt, hit=hit_f)
    with pytest.raises(ValueError, match="hit"):
        render._check_inputs(wts, t(xyz), t(vd), t(z), zs, zt, hit=hit_f[:, :3].contiguous())


# --------------------------------------------------------------------------
# render_rays_aabb
# --------------------------------------------------------------------------

def _pose_batch():
    """Two object poses ~12 m in front of the camera (object-to-camera,
    axis-angle + translation) and their square ROIs."""
    rot = np.asarray([[0.3, -1.2, 0.2], [-0.4, 2.0, 0.1]], np.float32)
    trans = np.asarray([[0.5, 0.8, 12.0], [-1.0, 0.6, 14.0]], np.float32)
    roi = np.asarray([[30, 10, 98, 78], [20, 5, 90, 75]], np.float32)
    return rot, trans, roi


@pytest.mark.parametrize("shapenet", [False, True])
def test_render_rays_aabb_matches_jax(shapenet):
    """render_rays_aabb (the plain versions inside FieldComposite) against
    the JAX renderer on its flax field, with the JAX draws injected,
    adjust_scale AABB_FIELD_SCALE (the demo's): rgb, depth, acc at 1e-4 (depth at 1e-3,
    it is metric, ~12 m), hit exactly; the gradients of a weighted sum of
    the outputs with respect to the object pose (rotation vector and
    translation) at 2e-4 of their largest component."""
    jmodel, variables, wts = _decoders(seed=1)
    rot, trans, roi = _pose_batch()
    rng = np.random.default_rng(4)
    codes = (rng.normal(size=(2, 2, W)) * 0.3).astype(np.float32)
    im = 6
    cots = [rng.normal(size=(2, im * im) + s).astype(np.float32) for s in ((3,), (), ())]
    keys = jax.random.split(jax.random.PRNGKey(9), 2)
    draws = np.stack([np.asarray(jax.random.uniform(k, (im * im, S))) for k in keys])
    wlh = np.stack([WLH, WLH * 1.1])
    kw = dict(n_samples=S, im_sz=im, shapenet_obj_cood=shapenet)

    def jrun(r, tr, b):
        pose = jnp.concatenate([jax_aa_to_matrix(r), tr[:, None]], 1)
        return jax_render_aabb(lambda x, v: jmodel.apply(variables, x, v, codes[0, b],
                                                         codes[1, b]),
                               keys[b], jax_invert_pose(pose), K, roi[b], wlh[b],
                               adjust_scale=AABB_FIELD_SCALE, **kw)

    def jloss(r, tr, b):
        out = jrun(r, tr, b)
        return sum(jnp.sum(out[k] * c[b]) for k, c in zip(("rgb", "depth", "acc_trans"), cots))

    params = [torch.from_numpy(a).requires_grad_(True) for a in (rot, trans)]
    pose = torch.cat([axis_angle_to_matrix(params[0]), params[1][..., None]], -1)
    out = render_rays_aabb(
        lambda x, v, z, h: render.field_composite_aabb(wts, x, v, z, h, torch.from_numpy(codes[0]),
                                                       torch.from_numpy(codes[1])),
        invert_pose(pose), torch.from_numpy(np.stack([K, K])), torch.from_numpy(roi),
        torch.from_numpy(wlh), jitter=torch.from_numpy(draws), **kw)
    loss = sum((out[k] * torch.from_numpy(c)).sum() for k, c in zip(("rgb", "depth", "acc_trans"),
                                                                      cots))
    grads = torch.autograd.grad(loss, params)
    n_hit = 0
    for b in range(2):
        ref = jrun(jnp.asarray(rot[b]), jnp.asarray(trans[b]), b)
        np.testing.assert_array_equal(out["hit"][b].numpy(), np.asarray(ref["hit"]))
        n_hit += int(np.asarray(ref["hit"]).sum())
        for k, atol in (("rgb", 1e-4), ("depth", 1e-3), ("acc_trans", 1e-4)):
            np.testing.assert_allclose(out[k][b].detach().numpy(), np.asarray(ref[k]), atol=atol,
                                       rtol=1e-4, err_msg=k)
        gref = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(rot[b]), jnp.asarray(trans[b]), b)
        for name, g, r in zip(("rot_vec", "trans_vec"), grads, gref):
            r = np.asarray(r)
            assert np.isfinite(g[b].numpy()).all()
            np.testing.assert_allclose(g[b].numpy(), r, atol=2e-4 * np.abs(r).max(), rtol=0,
                                       err_msg=f"{name} object {b}")
    assert 0 < n_hit < 2 * im * im          # both hits and misses are exercised


def test_render_rays_aabb_refuses_unported_frames():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        render_rays_aabb(None, None, None, None, None, n_samples=S, im_sz=2,
                         shapenet_obj_cood=False, kitti2nusc=True)


# --------------------------------------------------------------------------
# the scene compositor
# --------------------------------------------------------------------------

def test_scene_compositor_matches_jax():
    """scene_window_from_objects exactly and render_scene_window at 1e-4
    (rgb) and 1e-3 (metric depth) against the JAX compositor on its flax
    field: three cars, two overlapping on the image so that the z merge
    interleaves their samples, one chunk smaller than the last, the JAX
    per-chunk draws injected."""
    jmodel, variables, wts = _decoders(seed=2)
    rng = np.random.default_rng(5)
    R_yaw = [jax_aa_to_matrix(jnp.asarray([0.0, a, 0.0])) for a in (0.3, 1.4, -0.8)]
    unit = np.asarray([[0.0, -1.0, 0.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]], np.float32)
    t = np.asarray([[0.0, 0.5, 12.0], [0.8, 0.6, 15.0], [-3.5, 0.4, 13.0]], np.float32)
    poses = np.stack([np.concatenate([np.asarray(r) @ unit, t[i][:, None]], 1)
                      for i, r in enumerate(R_yaw)]).astype(np.float32)
    wlh = np.stack([WLH, WLH * 0.9, WLH * 1.1]).astype(np.float32)
    codes = (rng.normal(size=(2, 3, W)) * 0.3).astype(np.float32)
    window = compositor.scene_window_from_objects(poses, wlh, K, 80, 128, margin=2)
    np.testing.assert_array_equal(window, jcomp.scene_window_from_objects(
        poses, wlh, K, 80, 128, margin=2))
    win_hw = (int(window[2] - window[0]) // 4, int(window[3] - window[1]) // 4)
    chunk = 40
    n_rays = win_hw[0] * win_hw[1]
    assert n_rays % chunk and n_rays > 2 * chunk
    key = jax.random.PRNGKey(3)
    ref_rgb, ref_depth = jcomp.render_scene_window(
        lambda x, v, sc, tc: jmodel.apply(variables, x, v, sc, tc), key, jnp.asarray(poses),
        jnp.asarray(wlh), jnp.asarray(codes[0]), jnp.asarray(codes[1]), jnp.asarray(K) / 4 *
        jnp.asarray([[1.0], [1.0], [4.0]]), jnp.asarray(window) / 4, win_hw, n_samples=S,
        shapenet_obj_cood=False, adjust_scale=AABB_FIELD_SCALE, chunk=chunk)
    n_chunks = -(-n_rays // chunk)
    draws = np.stack([np.asarray(jax.random.uniform(k, (chunk * 3, S))).reshape(chunk, 3, S)
                      for k in jax.random.split(key, n_chunks)])

    def field_fn(x, v, sc, tc):
        return render.decoder_plain(wts, x, v, *render.conditioned_latents(wts, sc, tc))

    K4 = torch.from_numpy(K) / 4 * torch.tensor([[1.0], [1.0], [4.0]])
    rgb, depth = compositor.render_scene_window(
        field_fn, torch.from_numpy(poses), torch.from_numpy(wlh), torch.from_numpy(codes[0]),
        torch.from_numpy(codes[1]), K4, torch.from_numpy(window) / 4, win_hw, n_samples=S,
        shapenet_obj_cood=False, chunk=chunk, jitter=torch.from_numpy(draws))
    np.testing.assert_allclose(rgb.numpy(), np.asarray(ref_rgb), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(depth.numpy(), np.asarray(ref_depth), atol=1e-3, rtol=1e-4)
    # the scene is not trivially background, and some rays see two cars
    rays_t = compositor.scene_rays(torch.from_numpy(poses), torch.from_numpy(wlh), K4,
                                   torch.from_numpy(window) / 4, win_hw)
    n_objects_hit = (rays_t[..., 6] != -1).sum(1)
    assert (n_objects_hit >= 2).any() and (n_objects_hit == 0).any()
    assert (rgb < 0.99).any()
