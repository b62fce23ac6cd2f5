"""The port's dataset QA and its drawing against cv2 5.0.0, matplotlib and the
JAX package on the CPU: utils/draw's thick lines (thickness 2, 3, 5),
circles (radius 2, thickness -1 and 1) and rectangles (thickness 2), bit for
bit against cv2 on uint8 and float32 images with end points inside, on and
beyond the image's edges; colorize_depth and the hsv table against
matplotlib; utils/vis's KITTI debug images (compute_box_3d to 1e-9,
draw_projected_box3d, show_image_with_boxes, show_lidar_on_image) and
data/debug's debug_sample_panel (nuScenes and KITTI fixture samples, with
and without an error pose and lidar) bit for bit against the JAX
functions; dataset_statistics' dict against JAX's to 1e-6 and its
histogram JSON against np.histogram; and the readers' debug panels at the
JAX readers' file names."""
import json
import os

import cv2
import matplotlib
import numpy as np
import pytest

import torch_threads  # noqa: F401
from supnerf_tpu.data import debug as jax_debug
from supnerf_tpu.data.kitti import KittiData as JaxKittiData
from supnerf_tpu.data.kitti_format import KittiObjectDataset as JaxKittiObjectDataset
from supnerf_tpu.utils import vis as jax_vis
from supnerf_tpu_torch.data import debug, nusc_tables
from supnerf_tpu_torch.data.kitti import KittiData
from supnerf_tpu_torch.data.kitti_format import KittiObjectDataset
from supnerf_tpu_torch.data.waymo import WaymoData
from supnerf_tpu_torch.utils import draw, vis
from supnerf_tpu_torch.utils.colormaps import HSV_255, MAGMA_BYTES
from supnerf_tpu_torch.utils.image_io import read_png
from tests.test_torch_data import _kitti_root, _make, _make_jax
from tests.test_torch_data import nusc_roots  # noqa: F401  (a fixture)

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

H, W = 40, 56


def _segments(rng, n):
    """End points inside, on the edges and corners, just beyond them and
    far outside the H x W image, and zero-length segments."""
    edge_x, edge_y = [0, W - 1, -1, W, W // 2], [0, H - 1, -1, H, H // 2]
    for t in range(n):
        scale = (0.4, 1.3, 4.0, 40.0)[t % 4]
        p1 = tuple(int(v) for v in rng.normal(size=2) * [W * scale / 2, H * scale / 2]
                   + [W / 2, H / 2])
        p2 = tuple(int(v) for v in rng.normal(size=2) * [W * scale / 2, H * scale / 2]
                   + [W / 2, H / 2])
        if t % 5 == 1:
            p1 = (int(rng.choice(edge_x)), int(rng.choice(edge_y)))
        if t % 7 == 2:
            p2 = (int(rng.choice(edge_x)), int(rng.integers(-3, H + 3)))
        if t % 11 == 3:
            p2 = p1
        yield p1, p2


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("thickness", [2, 3, 5])
def test_thick_line_and_rectangle_match_cv2(dtype, thickness):
    """cv2.line and cv2.rectangle at LINE_8, 400 segments each, colours that
    round (uint8: saturate_cast) or not (float32)."""
    rng = np.random.default_rng(thickness)
    color = (10.5, 200.5, 255.7) if dtype == np.uint8 else (0.1, 0.55, 0.9)
    for p1, p2 in _segments(rng, 400):
        img = (rng.random((H, W, 3)) * (255 if dtype == np.uint8 else 1)).astype(dtype)
        for name, ref_fn, fn in (("line", cv2.line, draw.line),
                                 ("rectangle", cv2.rectangle, draw.rectangle)):
            ref, got = img.copy(), img.copy()
            ref_fn(ref, p1, p2, color, thickness)
            fn(got, p1, p2, color, thickness)
            np.testing.assert_array_equal(got, ref, err_msg=f"{name} {p1} {p2}")


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("thickness", [-1, 1])
def test_circle_matches_cv2(dtype, thickness):
    """cv2.circle at LINE_8, radius 2 (and 0, 1, 3, 7), centres inside, on
    and beyond the edges; draw.circles (the lidar splat) as the same calls
    in order, overlapping."""
    rng = np.random.default_rng(10 + thickness)
    color = (250.5, 3.5, 99.4) if dtype == np.uint8 else (0.25, 0.5, 0.125)
    for p1, _ in _segments(rng, 200):
        img = (rng.random((H, W, 3)) * (255 if dtype == np.uint8 else 1)).astype(dtype)
        for radius in (2, 0, 1, 3, 7):
            ref, got = img.copy(), img.copy()
            cv2.circle(ref, p1, radius, color, thickness)
            draw.circle(got, p1, radius, color, thickness)
            np.testing.assert_array_equal(got, ref, err_msg=f"{p1} r {radius}")
    centers = np.stack([rng.integers(-3, W + 3, 300), rng.integers(-3, H + 3, 300)], 1)
    colors = rng.random((300, 3)) * (255 if dtype == np.uint8 else 1)
    img = (rng.random((H, W, 3)) * (255 if dtype == np.uint8 else 1)).astype(dtype)
    ref, got = img.copy(), img.copy()
    for c, col in zip(centers, colors):
        cv2.circle(ref, (int(c[0]), int(c[1])), 2, tuple(float(v) for v in col), thickness)
    draw.circles(got, centers, 2, colors, thickness)
    np.testing.assert_array_equal(got, ref)


def test_draw_on_a_grey_image():
    """(H, W) images take a scalar colour, as in cv2."""
    rng = np.random.default_rng(3)
    for p1, p2 in _segments(rng, 60):
        img = rng.integers(0, 256, (H, W)).astype(np.uint8)
        ref, got = img.copy(), img.copy()
        cv2.line(ref, p1, p2, 77, 3)
        cv2.circle(ref, p1, 2, 200, -1)
        draw.line(got, p1, p2, 77, 3)
        draw.circle(got, p1, 2, 200, -1)
        np.testing.assert_array_equal(got, ref)


def test_colour_tables_are_matplotlibs():
    """MAGMA_BYTES is magma's bytes lookup and HSV_255 the hsv table of
    show_lidar_on_image, exactly; colorize_depth as the JAX function
    (matplotlib with bytes=True) on values with ties at 0 and 1, NaN and
    infinities, with and without vmin/vmax."""
    magma = matplotlib.colormaps["magma"]
    np.testing.assert_array_equal(np.asarray(MAGMA_BYTES, np.uint8),
                                  magma(np.linspace(0, 1, 256), bytes=True)[:, :3])
    hsv = np.asarray(plt.get_cmap("hsv")(np.linspace(0, 1, 256)))[:, :3] * 255
    np.testing.assert_array_equal(np.asarray(HSV_255), hsv)
    rng = np.random.default_rng(0)
    for t in range(60):
        d = rng.normal(size=(9, 13)) * 10
        if t % 3 == 0:
            d[0, :3] = [np.nan, np.inf, -np.inf]
        if t % 7 == 0:
            d[:] = 3.0
        kw = {} if t % 2 else {"vmin": -5.0, "vmax": 5.0}
        np.testing.assert_array_equal(vis.colorize_depth(d, **kw),
                                      jax_vis.colorize_depth(d, **kw))
    x = np.linspace(0, 1, 1025)[None]
    np.testing.assert_array_equal(vis.colorize_depth(x, 0.0, 1.0),
                                  jax_vis.colorize_depth(x, 0.0, 1.0))


# --------------------------------------------------------------------------
# the KITTI debug images
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def kitti_frames(tmp_path_factory):
    """Each package's loader on the KITTI fixture, its frames' labels plus
    boxes across the image's edges and behind the camera, and lidar points
    over the whole field of view besides the fixture's."""
    root, hp = _kitti_root(tmp_path_factory.mktemp("qa"), "kitti")
    return root, hp, JaxKittiObjectDataset(root, "training"), KittiObjectDataset(root,
                                                                                 "training")


def test_kitti_debug_images_match_jax(kitti_frames):
    _, _, jload, pload = kitti_frames
    rng = np.random.default_rng(4)
    for idx in range(2):
        jcal, pcal = jload.get_calibration(idx), pload.get_calibration(idx)
        img = pload.get_image(idx)
        np.testing.assert_array_equal(img, jload.get_image(idx))
        extra = ["Pedestrian 0.00 0 0.0 -30 100 80 420 1.7 0.6 0.8 -6.0 1.6 9.0 1.2",
                 "Cyclist 0.00 1 0.0 1100 20 1250 300 1.7 0.6 1.8 7.5 1.6 10.0 -0.7",
                 "Car 0.00 0 0.0 500 150 700 250 1.5 1.8 4.0 0.0 1.5 1.0 0.4",
                 "Van 0.00 0 0.0 300 150 400 250 2.0 1.9 5.0 -3.0 1.8 20.0 0.1"]
        jobjs = jload.get_label_objects(idx) + [type(jload.get_label_objects(idx)[0])(x)
                                               for x in extra]
        pobjs = pload.get_label_objects(idx) + [type(pload.get_label_objects(idx)[0])(x)
                                               for x in extra]
        for jo, po in zip(jobjs, pobjs):
            (jc2, jc3), (pc2, pc3) = (jax_vis.compute_box_3d(jo, jcal.P),
                                      vis.compute_box_3d(po, pcal.P))
            np.testing.assert_allclose(pc3, jc3, atol=1e-9, rtol=0)
            assert (pc2 is None) == (jc2 is None)
            if pc2 is not None:
                np.testing.assert_allclose(pc2, jc2, atol=1e-9, rtol=0)
                for thickness in (1, 2, 3):
                    np.testing.assert_array_equal(
                        vis.draw_projected_box3d(img.copy(), pc2, (255, 0, 9), thickness),
                        jax_vis.draw_projected_box3d(img.copy(), jc2, (255, 0, 9), thickness))
        for got, ref in zip(vis.show_image_with_boxes(img, pobjs, pcal),
                            jax_vis.show_image_with_boxes(img, jobjs, jcal)):
            np.testing.assert_array_equal(got, ref)
        pc = jload.get_lidar(idx)
        np.testing.assert_array_equal(pc, pload.get_lidar(idx))
        spread = np.stack([rng.uniform(2.5, 60, 3000), rng.uniform(-30, 30, 3000),
                           rng.uniform(-3, 2, 3000), np.ones(3000)], 1).astype(np.float32)
        pc = np.concatenate([pc, spread])
        np.testing.assert_array_equal(
            vis.show_lidar_on_image(pc, img, pcal, img.shape[1], img.shape[0]),
            jax_vis.show_lidar_on_image(pc, img, jcal, img.shape[1], img.shape[0]))


# --------------------------------------------------------------------------
# data/debug.py and the readers' debug panels
# --------------------------------------------------------------------------

def _panel_cases(sample):
    """The sample as read, without its error pose, and without its lidar."""
    no_err = dict(sample, obj_poses_w_err=sample["obj_poses"].copy())
    no_lidar = dict(sample, lidar_u=np.zeros(0, np.float32), lidar_v=np.zeros(0, np.float32),
                    lidar_depth=np.zeros(0, np.float32))
    return {"as read": sample, "no error pose": no_err, "no lidar": no_lidar}


def test_debug_panel_matches_jax_on_kitti(kitti_frames, tmp_path):
    """KITTI samples in pose-error modes 0 and 1, each as read, without its
    error box and without lidar: the panel bit for bit; the reader's
    debug=True writes it to {NAME}_{frame}_{object}.png (Waymo through the
    same reader)."""
    _, hp, *_ = kitti_frames
    for mode in (0, 1):
        jds = JaxKittiData(hp, split="val", add_pose_err=mode, seed=3)
        pds = KittiData(hp, split="val", add_pose_err=mode, seed=3, debug=True,
                        debug_dir=str(tmp_path / f"kitti{mode}"))
        for i in range(len(jds)):
            psample = pds[i]
            for name, s in _panel_cases(jds[i]).items():
                ref = jax_debug.debug_sample_panel(s, is_kitti=True)
                np.testing.assert_array_equal(debug.debug_sample_panel(s, is_kitti=True), ref,
                                              err_msg=f"mode {mode} {name}")
            data_idx, obj_idx = pds.all_valid_samples[i]
            written = read_png(str(tmp_path / f"kitti{mode}"
                                   / f"kitti_{data_idx}_{obj_idx}.png"))
            np.testing.assert_array_equal(
                written, jax_debug.debug_sample_panel(psample, is_kitti=True))
        assert len(os.listdir(tmp_path / f"kitti{mode}")) == len(jds)
    wroot, whp = _kitti_root(tmp_path / "w", "waymo")
    wds = WaymoData(whp, split="val", debug=True, debug_dir=str(tmp_path / "waymo"))
    wds[0]
    assert os.listdir(tmp_path / "waymo") == ["waymo_{}_{}.png".format(*wds.all_valid_samples[0])]


def test_debug_panel_matches_jax_on_nuscenes(nusc_roots, tmp_path):
    """nuScenes fixture samples (1600 x 900) in modes 0 and 1 through the
    port's table reader, as read, without the error box and without lidar:
    the panel bit for bit against the JAX function on the same sample; the
    reader's debug=True writes it to {anntoken}_{camera}.png."""
    _, copy, _ = nusc_roots
    for mode in (0, 1):
        out = tmp_path / f"nusc{mode}"
        pds = _make(nusc_tables, copy, "train", add_pose_err=mode, seed=6, debug=True,
                    debug_dir=str(out))
        for i in range(2):
            s = pds[i]
            cases = _panel_cases(s) if mode else {"as read": s}
            for name, c in cases.items():
                np.testing.assert_array_equal(debug.debug_sample_panel(c),
                                              jax_debug.debug_sample_panel(c),
                                              err_msg=f"mode {mode} {name}")
            anntoken, cam = pds.all_valid_samples[i]
            np.testing.assert_array_equal(read_png(str(out / f"{anntoken}_{cam}.png")),
                                          jax_debug.debug_sample_panel(s))
        assert len(os.listdir(out)) == 2


def _hist(path):
    with open(path) as f:
        return json.load(f)


def test_dataset_statistics_match_jax(kitti_frames, nusc_roots, tmp_path):
    """The stats dict against the JAX function's to 1e-6 on KITTI (the
    occlusion levels) and on nuScenes, without a visibility table (no level,
    as JAX) and with one in the port's schema and in the JAX reader's
    tables; the histograms' JSON holds np.histogram of the same values
    (bins "auto" for the distance, [0, 1, 2, 3] / [1, 2, 3, 4, 5] for the
    levels) where JAX writes PDFs."""
    _, hp, *_ = kitti_frames
    root, copy, _ = nusc_roots

    def check(jds, pds, name, level_file):
        ref = jax_debug.dataset_statistics(jds, str(tmp_path / f"j{name}"), print_every=0)
        got = debug.dataset_statistics(pds, str(tmp_path / f"p{name}"), print_every=0)
        assert set(got) == set(ref)
        for key, value in ref.items():
            if isinstance(value, str):
                assert got[key] == value, key
            else:
                np.testing.assert_allclose(got[key], value, atol=1e-6, rtol=0, err_msg=key)
        dist = [float(np.linalg.norm(np.asarray(pds[i]["obj_poses"])[:, 3]))
                for i in range(len(pds))]
        counts, edges = np.histogram(dist, bins="auto")
        prefix = getattr(pds, "NAME", type(pds).__name__.lower())
        h = _hist(str(tmp_path / f"p{name}" / f"{prefix}_dist_hist.json"))
        assert h["counts"] == counts.tolist() and h["bin_edges"] == edges.tolist()
        files = os.listdir(tmp_path / f"p{name}")
        if level_file is None:
            assert "levels" not in got and len(files) == 1
            return got
        bins = [0, 1, 2, 3] if level_file.endswith("occ_hist.json") else [1, 2, 3, 4, 5]
        h = _hist(str(tmp_path / f"p{name}" / level_file))
        counts, edges = np.histogram(got["levels"], bins=bins)
        assert h["counts"] == counts.tolist() and h["bin_edges"] == edges.tolist()
        assert h["xlabel"] == got["level_label"]
        return got

    got = check(JaxKittiData(hp, split="val"), KittiData(hp, split="val"), "kitti",
                "kitti_occ_hist.json")
    assert got["level_label"] == "Occlusion" and got["n_samples"] == 2
    jds = _make_jax(root, "train")
    pds = _make(nusc_tables, copy, "train")
    check(jds, pds, "nuscenesdata", None)
    # a visibility table: visibility.json and the annotations' tokens
    vis_rows = [{"token": str(k), "level": lvl, "description": ""}
                for k, lvl in enumerate(["v0-40", "v40-60", "v60-80", "v80-100"], 1)]
    ann_file = os.path.join(copy, "v1.0-mini", "sample_annotation.json")
    anns = json.load(open(ann_file))
    level_of = {a["token"]: str(1 + i % 4) for i, a in enumerate(anns)}
    with open(ann_file, "w") as f:
        json.dump([dict(a, visibility_token=level_of[a["token"]]) for a in anns], f)
    with open(os.path.join(copy, "v1.0-mini", "visibility.json"), "w") as f:
        json.dump(vis_rows, f)
    try:
        pds = _make(nusc_tables, copy, "train")
        jds.nusc._by_token["visibility"] = {r["token"]: r for r in vis_rows}
        for token, row in jds.nusc._by_token["sample_annotation"].items():
            row["visibility_token"] = level_of[token]
        got = check(jds, pds, "nusc_vis", "nuscenesdata_vis_hist.json")
        assert got["level_label"] == "Visibility (6 CAM)" and len(set(got["levels"])) > 1
    finally:
        with open(ann_file, "w") as f:
            json.dump(anns, f)
        os.remove(os.path.join(copy, "v1.0-mini", "visibility.json"))
