"""The port's visualisation pieces against the JAX package and cv2 on the CPU,
at a narrow width: render_full_image (shared z; with kitti2nusc; through
the JAX package's field path and, on one object, its Pallas render kernel
in interpret mode), render_virtual_views and prepare_render_target with
the JAX package's jitter fed in (atol 3e-4 on rgb and acc, 3e-3 on depth,
as tests/test_torch_render.py); ssim and roi_coord_trans at 1e-6,
resize_linear (jax.image.resize, linear) at 1e-6 (2e-6 at an upsampling
ratio that is not a whole number); utils/draw's line and text and
utils/vis's panels against cv2 5.0 (through the JAX package's utils/vis),
bit for bit: clipped and off-image segments, every glyph at the scales
0.35 and 0.175 (thickness 1) and 0.7 (thickness 2), text at the image's
edges, on random backgrounds."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import cv2
import torch_threads  # noqa: F401
from supnerf_tpu.data.synthetic import make_synthetic_object
from supnerf_tpu.eval.metrics import ssim as jax_ssim
from supnerf_tpu.geometry.roi import roi_coord_trans as jax_roi_coord_trans
from supnerf_tpu.models.nerf_mlp import CodeNeRFDecoder as JaxDecoder
from supnerf_tpu.ops.pallas_field import pack_decoder_params as jax_pack
from supnerf_tpu.ops.pallas_render import field_composite_pallas
from supnerf_tpu.render import renderer as jax_renderer
from supnerf_tpu.utils import vis as jax_vis
from supnerf_tpu_torch.eval.metrics import ssim
from supnerf_tpu_torch.geometry.roi import resize_linear, roi_coord_trans
from supnerf_tpu_torch.models.convert import convert_decoder
from supnerf_tpu_torch.models.nerf_mlp import CodeNeRFDecoder
from supnerf_tpu_torch.ops.render import pack_decoder_params
from supnerf_tpu_torch.render import renderer
from supnerf_tpu_torch.tto.core import make_composite
from supnerf_tpu_torch.utils import draw, vis
from supnerf_tpu_torch.utils.glyphs import GLYPHS

W, LATENT, S, B = 64, 32, 8, 2
ATOL = {"rgb": 3e-4, "depth": 3e-3, "acc": 3e-4}
CHARS = "0123456789.,:- PSNRDETnaif"
# (font scale, thickness) of the panels at vis_im_sz 128, 64 and 256
FACES = ((0.35, 1), (0.175, 1), (0.7, 2))


@pytest.fixture(scope="module")
def scene():
    """A narrow decoder in both packages, two synthetic objects' cameras
    and codes, and the JAX renderer's fixed jitter (PRNGKey(0))."""
    rng = np.random.default_rng(0)
    objs = [make_synthetic_object(seed=30 + i) for i in range(B)]
    codes = (rng.normal(size=(2, B, LATENT)) * 0.3).astype(np.float32)
    jdec = JaxDecoder(shape_blocks=1, texture_blocks=1, W=W, latent_dim=LATENT)
    pts = jnp.zeros((1, S, 3))
    params = jax.tree.map(np.asarray, jdec.init(jax.random.PRNGKey(0), pts, pts,
                                                jnp.asarray(codes[0, 0]),
                                                jnp.asarray(codes[1, 0]))["params"])
    tdec = CodeNeRFDecoder(1, 1, W, LATENT)
    tdec.load_state_dict(convert_decoder(params, 1, 1), strict=True)
    jitter = np.array(jax.random.uniform(jax.random.PRNGKey(0), (S,)))
    return jdec, params, pack_decoder_params(tdec), objs, codes, jitter


def _stack(objs, key):
    return torch.as_tensor(np.stack([np.asarray(o[key], np.float32) for o in objs]))


def _jax_field(jdec, params, sc, tc):
    return lambda x, v: jdec.apply({"params": params}, x, v, jnp.asarray(sc), jnp.asarray(tc))


def _compare(port, ref, names=("rgb", "depth", "acc")):
    for name, a, b in zip(names, port, ref):
        np.testing.assert_allclose(a, b, atol=ATOL[name], rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("kitti2nusc", [False, True])
def test_render_full_image_matches_jax(scene, kitti2nusc):
    """Two objects at once against the JAX render of each, a 20 x 12 grid
    (H != W: the ray grid is (W, H) in both)."""
    jdec, params, wts, objs, codes, jitter = scene
    H, Wd = 20, 12
    cam, K, roi = _stack(objs, "cam_poses"), _stack(objs, "cam_intrinsics"), _stack(objs, "rois")
    diag = torch.linalg.norm(_stack(objs, "wlh"), dim=-1)
    with torch.no_grad():
        out = renderer.render_full_image(
            make_composite(wts, torch.from_numpy(codes[0]), torch.from_numpy(codes[1])), cam, K,
            roi, diag, n_samples=S, im_hw=(H, Wd), shapenet_obj_cood=True,
            kitti2nusc=kitti2nusc, jitter=torch.from_numpy(jitter))
    assert out[0].shape == (B, H, Wd, 3) and out[1].shape == (B, H, Wd)
    for b in range(B):
        ref = jax_renderer.render_full_image(
            _jax_field(jdec, params, codes[0, b], codes[1, b]), jnp.asarray(cam[b].numpy()),
            jnp.asarray(K[b].numpy()), (jnp.asarray(roi[b].numpy()), H, Wd), float(diag[b]),
            n_samples=S, shapenet_obj_cood=True, kitti2nusc=kitti2nusc, chunk=64)
        _compare([o[b].numpy() for o in out], [np.asarray(r) for r in ref])


def test_render_full_image_matches_the_pallas_render(scene):
    """One object through the JAX driver's vis route on accelerators: the
    renderer's composite_fn hook on field_composite_pallas (A1, interpret
    mode) in chunks of 64 rays."""
    jdec, params, wts, objs, codes, jitter = scene
    packed = jax_pack(params, 1, 1)
    sc, tc = jnp.asarray(codes[0, 0]), jnp.asarray(codes[1, 0])
    cam, K, roi = (_stack(objs[:1], k) for k in ("cam_poses", "cam_intrinsics", "rois"))
    diag = torch.linalg.norm(_stack(objs[:1], "wlh"), dim=-1)
    ref = jax_renderer.render_full_image(
        None, jnp.asarray(cam[0].numpy()), jnp.asarray(K[0].numpy()),
        (jnp.asarray(roi[0].numpy()), 8, 8), float(diag[0]), n_samples=S,
        shapenet_obj_cood=True, chunk=64,
        composite_fn=lambda x, v, z: field_composite_pallas(
            packed, x, v, z, sc, tc, shape_blocks=1, texture_blocks=1, dtype=jnp.float32,
            tile_m=32, interpret=True))
    with torch.no_grad():
        out = renderer.render_full_image(
            make_composite(wts, torch.from_numpy(codes[0, :1]), torch.from_numpy(codes[1, :1])),
            cam, K, roi, diag, n_samples=S, im_hw=(8, 8), shapenet_obj_cood=True,
            jitter=torch.from_numpy(jitter))
    _compare([o[0].numpy() for o in out], [np.asarray(r) for r in ref])


def test_render_full_image_default_jitter_is_fixed(scene):
    """Without jitter every call draws the same (S,) vector: a CPU
    torch.Generator seeded 0 (ROADMAP C.15)."""
    assert torch.equal(renderer.full_image_jitter(S, "cpu"),
                       torch.rand(S, generator=torch.Generator().manual_seed(0)))
    _, _, wts, objs, codes, _ = scene
    args = (make_composite(wts, torch.from_numpy(codes[0]), torch.from_numpy(codes[1])),
            _stack(objs, "cam_poses"), _stack(objs, "cam_intrinsics"), _stack(objs, "rois"),
            torch.linalg.norm(_stack(objs, "wlh"), dim=-1))
    with torch.no_grad():
        a = renderer.render_full_image(*args, n_samples=S, im_hw=(4, 4), shapenet_obj_cood=True)
        b = renderer.render_full_image(*args, n_samples=S, im_hw=(4, 4), shapenet_obj_cood=True,
                                       jitter=renderer.full_image_jitter(S, "cpu"))
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_render_virtual_views_matches_jax(scene):
    """The 8-view ring of two objects in one call, 8 x 8 views."""
    jdec, params, wts, objs, codes, jitter = scene
    K = _stack(objs, "cam_intrinsics")
    diag = torch.linalg.norm(_stack(objs, "wlh"), dim=-1)
    sc, tc = (torch.from_numpy(c).repeat_interleave(8, 0) for c in codes)
    with torch.no_grad():
        views = renderer.render_virtual_views(make_composite(wts, sc, tc), diag, K, n_samples=S,
                                              shapenet_obj_cood=True, img_sz=8,
                                              jitter=torch.from_numpy(jitter))
    assert views.shape == (B, 8, 8, 8, 3)
    for b in range(B):
        ref = jax_renderer.render_virtual_views(
            _jax_field(jdec, params, codes[0, b], codes[1, b]), float(diag[b]),
            K[b].numpy(), n_samples=S, shapenet_obj_cood=True, img_sz=8)
        np.testing.assert_allclose(views[b].numpy(), np.asarray(ref), atol=ATOL["rgb"],
                                   rtol=1e-4)


@pytest.mark.parametrize("size", [(37, 29), (5, 3)])
def test_prepare_render_target_matches_jax(size):
    """A crop downsampled (37 x 29 -> 8) and upsampled (5 x 3 -> 8): rgb at
    1e-6, the truncated {-1, 0, 1} mask equal."""
    rng = np.random.default_rng(1)
    img = rng.random(size + (3,)).astype(np.float32)
    mask = rng.integers(-1, 2, size + (1,)).astype(np.float32)
    rgb, occ = renderer.prepare_render_target(img, mask, 8)
    ref_rgb, ref_occ = jax_renderer.prepare_render_target(jnp.asarray(img), jnp.asarray(mask), 8)
    assert rgb.shape == (64, 3) and occ.shape == (64, 1)
    np.testing.assert_allclose(rgb, np.asarray(ref_rgb), atol=1e-6)
    np.testing.assert_array_equal(occ, np.asarray(ref_occ))


# --------------------------------------------------------------------------
# maths helpers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(32, 32, 3), (23, 17, 3), (9, 11), (7, 7)])
def test_ssim_matches_jax(shape):
    """Even and odd sizes (the reflect mode repeats the edge sample), one
    and three channels, a 7-pixel image (one window)."""
    rng = np.random.default_rng(2)
    a = rng.random(shape)
    b = np.clip(a + rng.normal(scale=0.1, size=shape), 0, 1)
    assert abs(ssim(a, b) - jax_ssim(a, b)) <= 1e-6
    assert abs(ssim(a, a) - 1.0) <= 1e-6


@pytest.mark.parametrize("case", [((32, 32, 3), (128, 128), True, 1e-6),
                                  ((40, 30, 3), (13, 9), True, 1e-6),
                                  ((37, 29, 1), (8, 8), False, 1e-6),
                                  ((23, 17, 3), (64, 40), True, 2e-6)])
def test_resize_linear_matches_jax(case):
    """The driver's 32 -> 128 target and downsamples with and without
    antialias at 1e-6; an upsample by a ratio that is not a whole number at
    2e-6: jax.image.resize runs jitted, and XLA's fused float32 arithmetic
    of its weights differs from the same float32 steps run one by one by up
    to 1.8e-6 there (300 random shapes; 1.2e-7 at whole-number ratios)."""
    shape, out, antialias, atol = case
    img = np.random.default_rng(3).random(shape).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(img), tuple(out) + shape[2:], method="linear",
                           antialias=antialias)
    np.testing.assert_allclose(resize_linear(img, out, antialias), np.asarray(ref), atol=atol)


def test_roi_coord_trans_matches_jax():
    rng = np.random.default_rng(4)
    x, y = rng.random((2, 8)).astype(np.float32) * 300
    roi = np.array([0, 0, 310, 240], np.float32)
    for a, b in zip(roi_coord_trans(x, y, roi, 128), jax_roi_coord_trans(x, y, roi, 128)):
        np.testing.assert_allclose(a, b, atol=1e-6)


# --------------------------------------------------------------------------
# drawing, against cv2
# --------------------------------------------------------------------------

def test_line_matches_cv2():
    """Random segments on float32 and uint8 images: inside, crossing the
    edges, far off the image (clipped), single points and vertical,
    horizontal and steep ones; the same pixels and values."""
    rng = np.random.default_rng(5)
    for t in range(3000):
        h, w = (int(v) for v in rng.integers(1, 48, 2))
        lim = [1, 2, 50][t % 3]
        p1 = tuple(int(v) for v in rng.integers(-lim * w, lim * w + 1, 2))
        p2 = p1 if t % 50 == 0 else tuple(int(v) for v in rng.integers(-lim * h, lim * h + 1, 2))
        if t % 7 == 0:
            p2 = (p1[0], p2[1])
        if rng.random() < 0.5:
            img, color = rng.random((h, w, 3)).astype(np.float32), (1.0, 144 / 255, 30 / 255)
        else:
            img, color = rng.integers(0, 256, (h, w, 3)).astype(np.uint8), (3, 200, 77)
        ref, got = img.copy(), img.copy()
        cv2.line(ref, p1, p2, color, 1)
        draw.line(got, p1, p2, color)
        np.testing.assert_array_equal(got, ref, err_msg=f"{(h, w)} {p1} {p2}")


@pytest.mark.parametrize("face", FACES)
def test_put_text_matches_cv2(face):
    """Every glyph alone and in the panels' strings (negative numbers, nan,
    inf), at the panels' origins and cut by each edge of the image, black
    and coloured, on random backgrounds: the same bytes as cv2.putText."""
    scale, thickness = face
    rng = np.random.default_rng(6)
    texts = list(CHARS) + [CHARS, "PSNR: 12.345,  DE: -0.071", "RE: nan,  TE: -inf",
                           "PSNR: inf,  DE: 1000.000"]
    origins = [(5, 10), (2, 5), (-4, 3), (120, 126), (60, 1), (3, 140)]
    for text in texts:
        for org in origins:
            for color in ((0, 0, 0), (255, 144, 30)):
                bg = rng.integers(0, 256, (128, 128, 3)).astype(np.uint8)
                ref, got = bg.copy(), bg.copy()
                cv2.putText(ref, text, org, cv2.FONT_HERSHEY_SIMPLEX, scale, color, thickness)
                draw.put_text(got, text, org, scale, color, thickness)
                np.testing.assert_array_equal(got, ref, err_msg=f"{text!r} at {org}")


def test_font_face_is_cv2s():
    """font_face's size and weight reproduce cv2.putText's Hershey call
    through cv2's FontFace form, over scales 0.1-1.5 and thickness 1-3."""
    text = "PSNR: 10.123,  DE: -0.456"
    for scale in np.round(np.arange(0.1, 1.5, 0.0125), 4):
        for thickness in (1, 2, 3):
            ref = np.full((60, 500, 3), 128, np.uint8)
            cv2.putText(ref, text, (5, 40), cv2.FONT_HERSHEY_SIMPLEX, float(scale), (0, 0, 0),
                        thickness)
            size, weight = draw.font_face(float(scale), thickness)
            got = np.full((60, 500, 3), 128, np.uint8)
            cv2.putText(got, text, (5, 40), (0, 0, 0), cv2.FontFace("sans"), size, weight)
            np.testing.assert_array_equal(got, ref, err_msg=f"{scale} {thickness}")
    assert sorted(GLYPHS) == sorted(draw.font_face(s, t) for s, t in FACES)


def test_draw_refuses_what_it_cannot_draw():
    """A thickness-2 line, once refused, draws cv2's pixels
    (tests/test_torch_qa.py holds thick lines at length); text at a font
    size without glyphs, or a character without one, is still refused."""
    img = np.zeros((16, 16, 3), np.uint8)
    ref = img.copy()
    cv2.line(ref, (0, 0), (5, 5), (1, 1, 1), 2)
    np.testing.assert_array_equal(draw.line(img, (0, 0), (5, 5), (1, 1, 1), thickness=2), ref)
    with pytest.raises(NotImplementedError, match="font size"):
        draw.put_text(img, "1", (2, 10), 0.5, (0, 0, 0))
    with pytest.raises(ValueError, match="no glyph"):
        draw.put_text(img, "1e-05", (2, 10), 0.35, (0, 0, 0))


# --------------------------------------------------------------------------
# panels, against the JAX package's utils/vis (cv2)
# --------------------------------------------------------------------------

def test_render_box_matches_jax():
    """The driver's call (linewidth 1, one colour) on float images, boxes
    inside, across and far outside the image."""
    rng = np.random.default_rng(7)
    for t in range(200):
        img = rng.random((64, 64, 3)).astype(np.float32)
        corners = rng.normal(size=(2, 8)) * [32, 32][t % 2] * (1 + 20 * (t % 5 == 0)) + 32
        colors = ((1, 144 / 255, 30 / 255),) * 3 if t % 2 else ((0, 0, 1), (1, 0, 0), (0, 0, 0))
        ref = jax_vis.render_box(img.copy(), corners, colors=colors, linewidth=1)
        got = vis.render_box(img.copy(), corners, colors=colors, linewidth=1)
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("H", [128, 64])
def test_panel_matches_jax(H):
    """[render | depth | target] with both text lines (values of every
    sign, nan, inf), only one, or none; vis_im_sz 128 and 64."""
    rng = np.random.default_rng(8)
    metrics = [dict(psnr=14.2345, depth_err=0.5, rot_err=-0.1234, trans_err=2.0),
               dict(psnr=float("nan"), depth_err=float("inf"), rot_err=None, trans_err=None),
               dict(psnr=None, depth_err=None, rot_err=3.14159, trans_err=-float("inf")), {}]
    for m in metrics:
        rendered = rng.random((H, H, 3)) * 1.2 - 0.1
        depth = rng.random((H, H)) * 30
        gt = rng.random((H, H, 3))
        ref = jax_vis.panel_rgb_depth_gt(rendered, depth, gt, **m)
        got = vis.panel_rgb_depth_gt(rendered, depth, gt, **m)
        assert got.dtype == np.uint8 and got.shape == (H, 3 * H, 3)
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("n", [8, 5, 1])
def test_virtual_view_sheet_and_depth_normalisation_match_jax(n):
    rng = np.random.default_rng(9)
    views = rng.random((n, 6, 5, 3)).astype(np.float32) * 1.2 - 0.1
    np.testing.assert_array_equal(vis.virtual_view_sheet(views), jax_vis.virtual_view_sheet(views))
    depth = rng.random((6, 5)) * 40
    np.testing.assert_array_equal(vis.normalize_for_vis(depth), jax_vis.normalize_for_vis(depth))
