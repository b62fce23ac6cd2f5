"""The port's data layer against the JAX package's on the CPU, on generated
fixtures: data/common.py and roi_resize against the JAX helpers; KittiData
and WaymoData against the JAX readers on tests/test_data_kitti's fixture
(the same curation, the same index JSON, every sample key equal, images
and masks bit for bit, pose-error modes 0, 1 and 3); NuScenesData against
the JAX reader through the devkit shim (tests/nusc_devkit_shim.py) and
through the port's own table reader (data/nusc_tables.py) on a copy of the
shim's fixture in nuScenes' own schema, whose boxes and lidar points were
moved out through ego and sensor poses that are not the identity; the table
reader's quaternions against scipy; and the training CLI on nuScenes."""
import json
import os
import shutil
import types

import numpy as np
import pytest
from scipy.spatial.transform import Rotation

import supnerf_tpu.data.common as jax_common
import torch_threads  # noqa: F401
from supnerf_tpu.data.kitti import KittiData as JaxKittiData
from supnerf_tpu.data.waymo import WaymoData as JaxWaymoData
from supnerf_tpu.data.kitti_format import Object3d
from supnerf_tpu.geometry.roi import roi_resize as jax_roi_resize
from supnerf_tpu_torch.data import common, nusc_tables
from supnerf_tpu_torch.data.kitti import KittiData
from supnerf_tpu_torch.data.nuscenes import NuScenesData
from supnerf_tpu_torch.data.waymo import WaymoData
from supnerf_tpu_torch.geometry.roi import roi_resize
from tests import nusc_devkit_shim as shim
from tests.test_data_kitti import HPAMS as KITTI_HPAMS
from tests.test_data_kitti import make_kitti_fixture


def assert_samples_equal(a: dict, b: dict, tol: dict | None = None):
    """Every key of the JAX sample `a` in `b`, arrays with the same shape and
    dtype and equal values (within tol[key] where given)."""
    tol = tol or {}
    assert set(a) == set(b)
    for k, va in a.items():
        vb = b[k]
        if isinstance(va, np.ndarray):
            assert va.shape == vb.shape and va.dtype == vb.dtype, k
            if k in tol:
                np.testing.assert_allclose(vb, va, atol=tol[k], rtol=0, err_msg=k)
            else:
                np.testing.assert_array_equal(vb, va, err_msg=k)
        else:
            assert va == vb, k


# --------------------------------------------------------------------------
# data/common.py, roi_resize
# --------------------------------------------------------------------------

def test_common_helpers_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    corners = np.asarray(shim._box_corners(shim._rot_yaw(0.4), [1.0, 0.5, 12.0], shim.WLH))
    pts = corners.mean(1, keepdims=True) + rng.normal(size=(3, 200)) * 1.5
    for top in (1.0, 0.9):
        np.testing.assert_array_equal(common.pts_in_box_np(pts, corners, top),
                                      jax_common.pts_in_box_np(pts, corners, top))
    for a, b in (([0, 0, 10, 10], [5, 0, 15, 10]), ([0, 0, 1, 1], [2, 2, 3, 3]),
                 ([3.5, 1, 9, 7.25], [2, 2, 8.5, 9])):
        assert common.box_iou_xyxy(a, b) == jax_common.box_iou_xyxy(a, b)
    masks = [np.zeros((40, 60), np.uint8) for _ in range(3)]
    masks[0][5:30, 10:40] = 255
    masks[1][20:35, 30:55] = 255
    masks[2][0:8, 0:8] = 255
    for i in range(3):
        np.testing.assert_array_equal(common.get_mask_occ_from_ins(masks, i),
                                      jax_common.get_mask_occ_from_ins(masks, i))
    preds = {"labels": ["car", "person", "car"],
             "boxes": [[10, 5, 40, 30], [30, 20, 55, 35], [0, 0, 8, 8]]}
    lidar = np.vstack([rng.uniform(0, 60, 50), rng.uniform(0, 40, 50), np.ones(50)])
    assert (common.get_tgt_ins_from_maskrcnn(preds, masks, "car", [9, 4, 41, 31], lidar)
            == jax_common.get_tgt_ins_from_maskrcnn(preds, masks, "car", [9, 4, 41, 31], lidar))
    assert common.get_tgt_ins_from_maskrcnn(preds, masks, "bus", [0, 0, 1, 1], lidar)[0] is None
    # get_associate_box_3d, both branches
    K = np.asarray(shim.K_FIX)
    det = {"classes": ["car", "truck", "car"],
           "corners_3d": [(np.asarray(shim._box_corners(shim._rot_yaw(y), [x, 0.85, 14.0],
                                                         shim.WLH)).T).tolist()
                          for x, y in ((-2.2, 0.3), (0.0, 0.0), (2.2, -0.4))]}
    big = np.zeros((900, 1600), np.uint8)
    big[380:560, 500:760] = 255
    assert (common.get_associate_box_3d(det, big, "vehicle.car", K)
            == jax_common.get_associate_box_3d(det, big, "vehicle.car", K))
    objs = [Object3d("Car 0.00 0 0.0 480 370 770 570 1.6 1.9 4.4 0 1.6 15 0.3"),
            Object3d("Van 0.00 0 0.0 500 380 760 560 1.6 1.9 4.4 0 1.6 15 0.3")]
    assert (common.get_associate_box_3d(objs, big, "Car")
            == jax_common.get_associate_box_3d(objs, big, "Car"))
    assert common.get_associate_box_3d(objs, np.zeros((4, 4)), "Car") == (-1, 0.0)
    # load_instance_masks through the port's PNG reader
    from PIL import Image

    with open(tmp_path / "img.json", "w") as f:
        json.dump(preds, f)
    for i, m in enumerate(masks):
        Image.fromarray(m).save(tmp_path / f"img_{i}.png")
    p_preds, p_masks = common.load_instance_masks(str(tmp_path), "img")
    j_preds, j_masks = jax_common.load_instance_masks(str(tmp_path), "img")
    assert p_preds == j_preds
    for a, b in zip(p_masks, j_masks):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(common.NUSC_CAR_WLH_MEAN, jax_common.NUSC_CAR_WLH_MEAN)
    np.testing.assert_array_equal(common.NUSC_CAR_WLH_STD, jax_common.NUSC_CAR_WLH_STD)


@pytest.mark.parametrize("ratio", [1.0, 1.2, 0.75])
def test_roi_resize_matches_jax(ratio):
    for roi in ([10, 20, 110, 70], [0.5, 3.25, 17.0, 9.5]):
        assert roi_resize(roi, ratio) == jax_roi_resize(roi, ratio)


# --------------------------------------------------------------------------
# KITTI and Waymo
# --------------------------------------------------------------------------

def _kitti_root(tmp_path, layout):
    root = tmp_path / layout
    make_kitti_fixture(str(root))
    if layout == "waymo":
        tr = root / "training"
        (tr / "image_2").rename(tr / "image")
        (tr / "label_2").rename(tr / "label")
    ds = dict(KITTI_HPAMS["dataset"], data_dir=str(root), split_dir=str(root / "ImageSets"),
              waymo_cat="Car")
    return str(root), {"dataset": ds}


@pytest.mark.parametrize("layout", ["kitti", "waymo"])
@pytest.mark.parametrize("mode", [0, 1, 3])
def test_kitti_waymo_readers_match_jax(tmp_path, monkeypatch, layout, mode):
    """The same curation and index JSON (each package reads the other's
    index), every sample key equal, images and masks bit for bit; mode 1's
    signs and mode 3's detection pose are the JAX reader's."""
    root, hp = _kitti_root(tmp_path, layout)
    jcls, pcls = (JaxKittiData, KittiData) if layout == "kitti" else (JaxWaymoData, WaymoData)
    index = os.path.join(root, f"{layout}.val.Car.json")
    jds = jcls(hp, split="val", add_pose_err=mode, seed=3)
    jindex = open(index).read()
    os.remove(index)
    pds = pcls(hp, split="val", add_pose_err=mode, seed=3)
    assert open(index).read() == jindex
    assert pds.all_valid_samples == jds.all_valid_samples and len(pds) == len(jds) == 2
    for i in range(len(jds)):
        assert_samples_equal(jds[i], pds[i])
    # the port reads the JAX package's index without curating again
    monkeypatch.setattr(pcls, "preprocess_dataset", None)
    assert pcls(hp, split="val", add_pose_err=mode).all_valid_samples == jds.all_valid_samples


def test_kitti_reader_mode2_draws_the_jax_integer(tmp_path):
    """Mode 2 takes one integer from the reader's stream, as the JAX reader;
    the pose itself is the port's get_random_pose2 on a CPU generator seeded
    by it (ROADMAP.md C.11): at depth 20 in the KITTI frame, and every other
    key equal to the JAX reader's, the mode-1 signs after it included."""
    _, hp = _kitti_root(tmp_path, "kitti")
    jds = JaxKittiData(hp, split="val", add_pose_err=2, seed=4)
    pds = KittiData(hp, split="val", add_pose_err=2, seed=4)
    for i in range(len(jds)):
        a, b = jds[i], pds[i]
        pose = b.pop("obj_poses_w_err")
        a.pop("obj_poses_w_err")
        assert_samples_equal(a, b)
        assert pose[2, 3] == pytest.approx(20.0, abs=1e-3)
    assert int(jds.rng.integers(0, 2**31)) == int(pds.rng.integers(0, 2**31))


# --------------------------------------------------------------------------
# nuScenes through the devkit shim
# --------------------------------------------------------------------------

NUSC_HPAMS = {"dataset": {
    "nusc_cat": "vehicle.car", "seg_cat": "car", "box_iou_th": 0.5, "max_dist": 40,
    "min_lidar_cnt": 5, "mask_pixels": 2500, "img_h": shim.IMG_H, "img_w": shim.IMG_W}}
SHIM_TABLES = types.SimpleNamespace(NuScenes=shim.ShimNuScenes, BoxVisibility=shim.BoxVisibility)


@pytest.fixture(scope="module")
def nusc_roots(tmp_path_factory):
    """(shim fixture root, its nuScenes-schema copy, the copy's meta)."""
    root = tmp_path_factory.mktemp("nusc_shim")
    shim.build_fixture(str(root))
    write_det3d(str(root))
    copy = str(tmp_path_factory.mktemp("nusc_schema") / "data")
    schema = write_nusc_schema(str(root), copy)
    uninstall = shim.install_shim()
    yield str(root), copy, schema
    uninstall()


def write_det3d(root):
    """Third-party detections (mode 3) per image: the annotated boxes of the
    image shifted 0.4 m and turned 0.1 rad, in the reference's JSON."""
    meta = json.load(open(os.path.join(root, "fixture_meta.json")))
    out = os.path.join(root, "det3d", "CAM_FRONT")
    os.makedirs(out, exist_ok=True)
    cam_file = {s["token"]: os.path.basename(sd["filename"])[:-4]
                for s in meta["sample"] for sd in meta["sample_data"]
                if sd["token"] == s["data"]["CAM_FRONT"]}
    by_image = {}
    for ann in meta["sample_annotation"]:
        center = np.asarray(ann["center"]) + [0.4, 0.0, 0.3]
        yaw = 0.1 + np.arctan2(-np.asarray(ann["rotation_matrix"])[2, 0],
                               np.asarray(ann["rotation_matrix"])[0, 0])
        corners = shim._box_corners(ann["rotation_matrix"], center, ann["size"])
        det = by_image.setdefault(cam_file[ann["sample_token"]], {
            "classes": [], "corners_3d": [], "boxes_yaw": [], "boxes_center": []})
        det["classes"].append("car")
        det["corners_3d"].append(np.asarray(corners).T.tolist())
        det["boxes_yaw"].append(float(yaw))
        det["boxes_center"].append(center.tolist())
    for stem, det in by_image.items():
        with open(os.path.join(out, stem + ".json"), "w") as f:
            json.dump(det, f)


def _make(tables, root, split="train", **kw):
    return NuScenesData(NUSC_HPAMS, split=split, data_dir=root, nusc_version="v1.0-mini",
                        tables=tables, **kw)


def _make_jax(root, split="train", **kw):
    from supnerf_tpu.data.nuscenes import NuScenesData as JaxNuScenesData

    return JaxNuScenesData(NUSC_HPAMS, split=split, data_dir=root, nusc_version="v1.0-mini",
                           **kw)


@pytest.mark.parametrize("split,mode", [("train", 0), ("train", 1), ("val", 3)])
def test_nuscenes_through_the_shim_matches_jax(nusc_roots, split, mode):
    """Curation, the index, every sample and get_ins_samples as the JAX
    reader's through the same table API; mode 3 reads det3d/ (reference
    detections), mode 1 the reader's sign stream."""
    root = nusc_roots[0]
    kw = dict(add_pose_err=mode, seed=2,
              det3d_path=os.path.join(root, "det3d") if mode == 3 else None)
    jds = _make_jax(root, split, **kw)
    index = os.path.join(root, f"nusc.v1.0-mini.{split}.vehicle.car.json")
    jindex = open(index).read()
    pds = _make(SHIM_TABLES, root, split, **kw)
    assert open(index).read() == jindex
    assert pds.all_valid_samples == jds.all_valid_samples
    assert len(pds) == (4 if split == "train" else 2)
    for i in range(len(jds)):
        assert_samples_equal(jds[i], pds[i])
    for ins in jds.anntokens_per_ins:
        for a, b in zip(jds.get_ins_samples(ins), pds.get_ins_samples(ins)):
            assert_samples_equal(a, b)
    if mode == 3:
        s = pds[0]
        assert not np.allclose(s["obj_poses_w_err"], s["obj_poses"])


def test_nuscenes_curation_from_scratch_and_demo_objects(nusc_roots, tmp_path):
    """Curation with no index in the data directory (the port writes the
    JAX reader's index), and get_objects_in_image, the demo's input."""
    root = str(tmp_path / "nusc")
    shutil.copytree(nusc_roots[0], root)
    for f in os.listdir(root):
        if f.startswith("nusc.v1.0-mini"):
            os.remove(os.path.join(root, f))
    pds = _make(SHIM_TABLES, root, "val")
    index = os.path.join(root, "nusc.v1.0-mini.val.vehicle.car.json")
    pindex = open(index).read()
    jds = _make_jax(nusc_roots[0], "val")
    assert pindex == open(os.path.join(nusc_roots[0], os.path.basename(index))).read()
    assert all(a.startswith("ann1_") for a, _ in pds.all_valid_samples)   # night log dropped
    jout, pout = jds.get_objects_in_image("img_0_0.png"), pds.get_objects_in_image("img_0_0.png")
    np.testing.assert_array_equal(pout["img"], jout["img"])
    assert len(pout["objects"]) == len(jout["objects"]) == 3
    for a, b in zip(jout["objects"], pout["objects"]):
        assert_samples_equal(a, b)


def test_nuscenes_trainval_needs_an_index(nusc_roots, tmp_path):
    root = str(tmp_path / "nusc")
    shutil.copytree(nusc_roots[0], root)
    with pytest.raises(FileNotFoundError, match="devkit's scene lists"):
        NuScenesData(NUSC_HPAMS, split="val", data_dir=root, nusc_version="v1.0-trainval",
                     tables=SHIM_TABLES)
    # an index with the same thresholds is read as is
    src = os.path.join(nusc_roots[0], "nusc.v1.0-mini.val.vehicle.car.json")
    _make_jax(nusc_roots[0], "val")
    shutil.copy(src, os.path.join(root, "nusc.v1.0-trainval.val.vehicle.car.json"))
    ds = NuScenesData(NUSC_HPAMS, split="val", data_dir=root, nusc_version="v1.0-trainval",
                      tables=SHIM_TABLES)
    assert len(ds) == 2


# --------------------------------------------------------------------------
# nuScenes through the port's table reader
# --------------------------------------------------------------------------

# sensor and ego poses of the schema copy ([w, x, y, z] quaternions). Their
# rotations are signed permutations (a camera looking along the ego's x, a
# lidar turned -90 degrees, egos turned 180 and 90 degrees) and their
# translations multiples of 2^-8 m, so that the reader's float32 steps
# (lidar -> ego -> global -> ego -> camera) are exact on lidar points on a
# 2^-19 m grid within 32 m of every frame's origin, which the points of the
# cars are (checked in write_nusc_schema): those points reach the camera
# frame within 2^-20 m per coordinate of the shim's, 8e-5 px at 13 m.
CAM_CS = {"rotation": [0.5, -0.5, 0.5, -0.5], "translation": [1.703125, 0.015625, 1.5078125]}
LIDAR_CS = {"rotation": [np.sqrt(0.5), 0.0, 0.0, -np.sqrt(0.5)],
            "translation": [0.94140625, 0.0, 1.83984375]}
EGO_CAM = {"rotation": [0.0, 0.0, 0.0, 1.0], "translation": [2.5, -3.25, 0.125]}
EGO_LIDAR = {"rotation": [np.sqrt(0.5), 0.0, 0.0, np.sqrt(0.5)],
             "translation": [2.0, -3.5, 0.125]}
GRID = 2.0 ** -19


def _rot(q):
    """[w, x, y, z] -> 3x3, through scipy (independent of nusc_tables)."""
    return Rotation.from_quat([q[1], q[2], q[3], q[0]]).as_matrix()


def _quat(R):
    x, y, z, w = Rotation.from_matrix(R).as_quat()
    return [float(w), float(x), float(y), float(z)]


def write_nusc_schema(src: str, dst: str) -> dict:
    """Copy the shim fixture at src to dst and write its tables in nuScenes'
    own schema (dst/v1.0-mini/*.json) and its lidar sweeps as .pcd.bin: the
    camera-frame boxes and points of fixture_meta.json moved out to the
    global frame through the poses above, each sample_data with its own ego
    pose (the egos drift 1/16 m per sample)."""
    shutil.copytree(src, dst)
    meta = json.load(open(os.path.join(src, "fixture_meta.json")))
    K = np.asarray(shim.K_FIX)
    tables = {k: [] for k in nusc_tables.TABLES}
    tables["category"] = [dict(c, description="") for c in meta["category"]]
    tables["sensor"] = [{"token": "sensor_cam", "channel": "CAM_FRONT", "modality": "camera"},
                        {"token": "sensor_lidar", "channel": "LIDAR_TOP", "modality": "lidar"}]
    tables["calibrated_sensor"] = [
        dict(CAM_CS, token="cs_front", sensor_token="sensor_cam", camera_intrinsic=shim.K_FIX),
        dict(LIDAR_CS, token="cs_lidar", sensor_token="sensor_lidar", camera_intrinsic=[])]
    tables["log"] = [dict(lg, vehicle="n008", date_captured="2018-08-01", location="boston")
                     for lg in meta["log"]]
    tables["scene"] = [dict(sc, description="", nbr_samples=0) for sc in meta["scene"]]
    tables["instance"] = [dict(i, nbr_annotations=0) for i in meta["instance"]]
    R_cam, t_cam = _rot(CAM_CS["rotation"]), np.asarray(CAM_CS["translation"])
    R_lid, t_lid = _rot(LIDAR_CS["rotation"]), np.asarray(LIDAR_CS["translation"])
    ego_of, car_extent = {}, 0.0
    for si, smp in enumerate(meta["sample"]):
        tables["sample"].append({"token": smp["token"], "scene_token": smp["scene_token"],
                                 "timestamp": 1533151603547590 + si})
        for ch, base in (("CAM_FRONT", EGO_CAM), ("LIDAR_TOP", EGO_LIDAR)):
            sd = smp["data"][ch]
            t = np.asarray(base["translation"]) + [si / 16, 0.0, 0.0]
            ego_of[sd] = (_rot(base["rotation"]), t)
            tables["ego_pose"].append({"token": f"ep_{sd}", "rotation": base["rotation"],
                                       "translation": t.tolist(), "timestamp": 0})
            rec = {"token": sd, "sample_token": smp["token"], "ego_pose_token": f"ep_{sd}",
                   "is_key_frame": True, "timestamp": 0, "prev": "", "next": ""}
            if ch == "CAM_FRONT":
                fn = next(s["filename"] for s in meta["sample_data"] if s["token"] == sd)
                rec.update(calibrated_sensor_token="cs_front", filename=fn, fileformat="png",
                           width=shim.IMG_W, height=shim.IMG_H)
            else:
                fn = f"samples/LIDAR_TOP/{sd}.pcd.bin"
                rec.update(calibrated_sensor_token="cs_lidar", filename=fn, fileformat="pcd",
                           width=0, height=0)
            tables["sample_data"].append(rec)
    cam_of = {s["token"]: s["data"]["CAM_FRONT"] for s in meta["sample"]}
    for ann in meta["sample_annotation"]:
        R_e, t_e = ego_of[cam_of[ann["sample_token"]]]
        center = R_e @ (R_cam @ np.asarray(ann["center"]) + t_cam) + t_e
        R_g = R_e @ R_cam @ np.asarray(ann["rotation_matrix"])
        tables["sample_annotation"].append({
            "token": ann["token"], "sample_token": ann["sample_token"],
            "instance_token": ann["instance_token"], "size": ann["size"],
            "translation": center.tolist(), "rotation": _quat(R_g), "visibility_token": "4",
            "attribute_tokens": [], "num_lidar_pts": 0, "num_radar_pts": 0,
            "prev": "", "next": ""})
    os.makedirs(os.path.join(dst, "samples", "LIDAR_TOP"), exist_ok=True)
    for key, rec in meta["lidar"].items():
        sd_lid, sd_cam = key.split("|")
        uv, depth = np.asarray(rec["uv"]), np.asarray(rec["depth"])
        cam = np.linalg.inv(K) @ uv * depth
        R_ec, t_ec = ego_of[sd_cam]
        R_el, t_el = ego_of[sd_lid]
        glob = R_ec @ (R_cam @ cam + t_cam[:, None]) + t_ec[:, None]
        lidar = R_lid.T @ (R_el.T @ (glob - t_el[:, None]) - t_lid[:, None])
        lidar = np.round(lidar / GRID) * GRID
        ego_l = R_lid @ lidar + t_lid[:, None]
        glob = R_el @ ego_l + t_el[:, None]
        ego_c = R_ec.T @ (glob - t_ec[:, None])
        frames = (lidar, ego_l, glob, ego_c, R_cam.T @ (ego_c - t_cam[:, None]))
        cars = depth < 20                                # the boxes' points, not the ground's
        car_extent = max(car_extent, *(np.abs(f[:, cars]).max() for f in frames))
        pts = np.zeros((lidar.shape[1], 5), np.float32)
        pts[:, :3] = lidar.T
        pts[:, 3] = 7.0
        pts.tofile(os.path.join(dst, "samples", "LIDAR_TOP", f"{sd_lid}.pcd.bin"))
    assert car_extent < 32
    os.makedirs(os.path.join(dst, "v1.0-mini"))
    for name, rows in tables.items():
        with open(os.path.join(dst, "v1.0-mini", name + ".json"), "w") as f:
            json.dump(rows, f)
    return tables


def test_table_reader_quaternions_and_index(nusc_roots):
    rng = np.random.default_rng(5)
    for _ in range(20):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        np.testing.assert_allclose(nusc_tables.Quaternion(q).rotation_matrix, _rot(q),
                                   atol=1e-12)
        p = rng.normal(size=4)
        p /= np.linalg.norm(p)
        np.testing.assert_allclose((nusc_tables.Quaternion(q) * nusc_tables.Quaternion(p))
                                   .rotation_matrix, _rot(q) @ _rot(p), atol=1e-12)
        np.testing.assert_allclose(nusc_tables.Quaternion(q).inverse.rotation_matrix,
                                   _rot(q).T, atol=1e-12)
    nusc = nusc_tables.NuScenes("v1.0-mini", nusc_roots[1])
    smp = nusc.get("sample", "smp0_1")
    assert smp["data"] == {"CAM_FRONT": "sdc0_1", "LIDAR_TOP": "sdl0_1"}
    assert smp["anns"] == ["ann0_1_0", "ann0_1_1", "ann0_1_2"]
    assert nusc.get("sample_data", "sdc0_1")["channel"] == "CAM_FRONT"
    assert nusc.field2token("sample_annotation", "instance_token", "ins0_1") == [
        "ann0_0_1", "ann0_1_1"]
    # the visibility filter: the third car of scene-0061 is partly out of frame
    _, boxes, K = nusc.get_sample_data("sdc0_0", nusc_tables.BoxVisibility.ALL,
                                       ["ann0_0_0", "ann0_0_2"])
    assert [b.token for b in boxes] == ["ann0_0_0"]
    np.testing.assert_array_equal(K, shim.K_FIX)


def test_nuscenes_through_the_table_reader_matches_jax(nusc_roots):
    """The port's reader on the schema copy against the JAX reader on the
    shim's fixture: the same curation and index entries, poses within 1e-5,
    lidar pixels within 1e-4 px (depths 1e-5 m), images and masks equal;
    get_ins_samples and the demo's get_objects_in_image too."""
    root, copy, _ = nusc_roots
    tol = {"obj_poses": 1e-5, "obj_poses_w_err": 1e-5, "cam_poses": 1e-5,
           "lidar_u": 1e-4, "lidar_v": 1e-4, "lidar_depth": 1e-5}
    for split in ("train", "val"):
        jds = _make_jax(root, split, add_pose_err=1, seed=6)
        pds = _make(nusc_tables, copy, split, add_pose_err=1, seed=6)
        assert pds.all_valid_samples == jds.all_valid_samples
        for key in ("anntokens_per_ins", "instoken_per_ann", "sample_attr"):
            assert getattr(pds, key) == getattr(jds, key), key
        for i in range(len(jds)):
            a, b = jds[i], pds[i]
            assert len(a["lidar_u"]) >= 5
            assert_samples_equal(a, b, tol)
    for ins in jds.anntokens_per_ins:
        for a, b in zip(jds.get_ins_samples(ins), pds.get_ins_samples(ins)):
            assert_samples_equal(a, b, tol)
    jout, pout = jds.get_objects_in_image("img_1_0.png"), pds.get_objects_in_image("img_1_0.png")
    assert len(pout["objects"]) == len(jout["objects"]) > 0
    for a, b in zip(jout["objects"], pout["objects"]):
        assert_samples_equal(a, b)


def test_train_cli_on_nuscenes_reads_the_index(nusc_roots, tmp_path, monkeypatch):
    """cli.train --dataset nusc (split train) through the table reader: the
    instance table comes from the reader's instoken_per_ann without loading
    a sample (as the JAX trainer's), then one step on the 4 train objects."""
    from supnerf_tpu_torch.cli import train

    config = {"arch": "supnerf", "n_rays": 32, "n_samples": 8, "in_img_sz": 32,
              "net_hyperparams": {"shape_blocks": 1, "texture_blocks": 1, "latent_dim": 32,
                                  "pose_shortcut": 1, "pred_wlh": 0},
              "dataset": dict(NUSC_HPAMS["dataset"], name="nusc", train_data_dir=nusc_roots[1],
                              train_nusc_version="v1.0-mini")}
    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps(config))
    loads = []
    real = NuScenesData.__getitem__
    monkeypatch.setattr(NuScenesData, "__getitem__", lambda self, i: loads.append(i)
                        or real(self, i))
    import supnerf_tpu_torch.training.trainer as trainer_mod

    init = trainer_mod.init_train_state

    def spy_init(*a, **k):
        assert loads == [], "the instance table loaded samples"
        return init(*a, **k)

    monkeypatch.setattr(trainer_mod, "init_train_state", spy_init)
    out = train.main(["--config_file", str(cfg), "--batch_size", "4", "--epochs", "1",
                      "--device", "cpu", "--save_dir", str(tmp_path / "run")])
    assert out["steps"] == 1 and np.isfinite(out["metrics"][0]["loss_total"])
    assert json.loads((tmp_path / "run" / "instoken2idx.json").read_text()) == {
        "ins0_0": 0, "ins0_1": 1}


def test_demo_cli_on_a_nuscenes_image(nusc_roots, tmp_path):
    """cli.demo --dataset nusc --img_name through the table reader at a tiny
    config on the CPU: the cars the segmentation found in that image (the
    small occluder included, the pedestrian not), each optimized to finite
    curves, and the composed frames finite."""
    from supnerf_tpu_torch.cli import demo
    from tests.test_torch_demo import TINY_DEMO

    config = dict(TINY_DEMO, model_dir=str(tmp_path / "no_checkpoint"),
                  dataset=dict(NUSC_HPAMS["dataset"], name="nusc", test_data_dir=nusc_roots[1],
                               test_nusc_version="v1.0-mini"))
    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps(config))
    out = demo.main(["--config_file", str(cfg), "--dataset", "nusc", "--img_name", "img_1_1.png",
                     "--device", "cpu", "--save_dir", str(tmp_path / "demo"),
                     "--render_scale", "16"])
    res = out["results"]
    assert set(res["psnr_eval"]) == {f"demo_img_1_1_{i}_CAM_FRONT" for i in range(2)}
    assert all(len(v) == 6 and np.isfinite(v).all() for v in res["psnr_eval"].values())
    assert all(np.isfinite(img).all() for img in out["images"])


def test_nuscenes_test_size_and_legacy_shards_match_jax(nusc_roots, tmp_path):
    """The fixed random test subset (test_size, its rand_data_ids written
    into the index) and the legacy num_subset / id_subset shard of the
    reader, as the JAX reader's, on copies of the shim's fixture."""
    for kw in ({"test_size": 1}, {"num_subset": 2, "id_subset": 1}):
        roots = []
        for who in ("jax", "port"):
            root = str(tmp_path / f"{who}_{len(kw)}")
            shutil.copytree(nusc_roots[0], root)
            roots.append(root)
        jds = _make_jax(roots[0], "val", seed=3, **kw)
        pds = _make(SHIM_TABLES, roots[1], "val", seed=3, **kw)
        assert len(pds) == len(jds) == 1
        assert pds.all_valid_samples == jds.all_valid_samples
        name = "nusc.v1.0-mini.val.vehicle.car.json"
        assert (json.load(open(os.path.join(roots[1], name)))
                == json.load(open(os.path.join(roots[0], name))))


@pytest.mark.parametrize("argv,n", [([], 3), (["--num_subset", "2", "--id_subset", "1"], 1),
                                    (["--num-samples2eval", "1"], 1), (["--pred_box2d", "1"], 3)],
                         ids=["all", "shard", "samples2eval", "pred_box2d"])
def test_build_dataset_matches_jax_on_kitti(tmp_path, argv, n):
    """cli.common.build_dataset's KITTI dataset, its strided shard and its
    first --num-samples2eval objects against the JAX CLI's build_dataset;
    --pred_box2d does not reach the KITTI reader in either."""
    import argparse

    from supnerf_tpu.cli.common import add_optimize_args as jax_add_optimize_args
    from supnerf_tpu.cli.common import build_dataset as jax_build_dataset
    from supnerf_tpu_torch.cli.common import add_optimize_args, build_dataset

    make_kitti_fixture(str(tmp_path), n_frames=3)
    hp = {"dataset": dict(KITTI_HPAMS["dataset"], name="kitti", data_dir=str(tmp_path),
                          split_dir=str(tmp_path / "ImageSets"))}
    full = argv + ["--add_pose_err", "1"]
    jds = jax_build_dataset(hp, jax_add_optimize_args(argparse.ArgumentParser()).parse_args(full))
    pds = build_dataset(hp, add_optimize_args(argparse.ArgumentParser()).parse_args(full))
    assert len(pds) == len(jds) == n
    for i in range(n):
        assert_samples_equal(jds[i], pds[i])
