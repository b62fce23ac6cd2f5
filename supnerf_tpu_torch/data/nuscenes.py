"""nuScenes object dataset; the port of supnerf_tpu/data/nuscenes.py
(reference data_nuscenes.py NuScenesData :214).

Per-(annotation, camera) samples of the target category with
  - curation (scene split, night logs (hour >= 18) dropped, the
    segmentation's instance associated by lidar-point voting, mask-pixel /
    box-IoU / area-ratio / distance / lidar-count thresholds) cached to the
    JAX package's index JSON (nusc.{version}.{split}.{cat}.json), so either
    package reads the other's index;
  - occupancy masks (1 target / 0 occluder / -1 background), camera and
    object poses, wlh, sparse lidar depth pixels;
  - pose-error injection modes 0/1/2/3;
  - per-instance retrieval and whole-image object extraction for the demo.

The tables come from `tables`, a module-like object with NuScenes and
BoxVisibility: data.nusc_tables by default (nuScenes' own JSON schema), or
the devkit's API. Images are decoded by the port's baseline JPEG decoder
or PNG reader, chosen by the file's signature; masks by the PNG reader.

Curation needs the version's scene split. v1.0-mini's is below; the
trainval and test lists live only in the devkit, so for those versions the
reader reads an existing index (written by the JAX package or by this
reader) and otherwise raises.

Pose-error mode 2 (and 3 without a matching detection) draws one integer
from the reader's numpy generator, as the JAX reader does, so the stream
stays aligned, and seeds a CPU torch.Generator with it for
geometry.poses.get_random_pose2; the bits of that pose differ from the JAX
reader's (ROADMAP.md C.11). The TTO driver reads it in mode 3 only.

debug=True writes each sample's QA panel (data/debug.debug_sample_panel)
to debug_dir/{anntoken}_{camera}.png as the JAX reader does.
"""
from __future__ import annotations

import json
import os

import numpy as np

from supnerf_tpu_torch.data import nusc_tables
from supnerf_tpu_torch.data.debug import debug_sample_panel
from supnerf_tpu_torch.data.common import (
    NUSC_CAR_WLH_MEAN,
    get_associate_box_3d,
    get_mask_occ_from_ins,
    get_tgt_ins_from_maskrcnn,
    load_instance_masks,
    pts_in_box_np,
)
from supnerf_tpu_torch.data.jpeg import is_jpeg, read_jpeg
from supnerf_tpu_torch.data.kitti import random_pose_from_rng
from supnerf_tpu_torch.geometry.roi import roi_resize
from supnerf_tpu_torch.utils.image_io import PNG_SIGNATURE, read_png

MINI_TRAIN = [
    "scene-0061", "scene-0553", "scene-0655", "scene-0757",
    "scene-0796", "scene-1077", "scene-1094", "scene-1100",
]
MINI_VAL = ["scene-0103", "scene-0916"]


def _splits(nusc_version: str, split: str):
    if "mini" in nusc_version:
        return MINI_TRAIN if split == "train" else MINI_VAL
    raise FileNotFoundError(
        f"no valid curation index for nuScenes {nusc_version} ({split}): curating it needs "
        "the devkit's scene lists (nuscenes.utils.splits), which are not in this repository. "
        "An index written by the JAX package or the reference "
        "(nusc.<version>.<split>.<category>.json in the data directory, with the same "
        "thresholds) is read as is.")


def read_image(path: str) -> np.ndarray:
    """A camera image as np.asarray(PIL.Image.open(path)): JPEG or PNG by the
    file's signature."""
    with open(path, "rb") as f:
        head = f.read(8)
    if is_jpeg(head):
        return read_jpeg(path)
    if head == PNG_SIGNATURE:
        return read_png(path)
    raise ValueError(f"{path}: neither a JPEG nor a PNG file")


class NuScenesData:
    def __init__(self, hpams, split: str = "train", out_gt_depth: bool = True,
                 add_pose_err: int = 0, init_rot_err: float = 0.2,
                 init_trans_err: float = 0.1, rand_angle_lim: float = np.pi / 9,
                 det3d_path: str | None = None, test_size: int = 5000,
                 pred_box2d: bool = False, box2d_rz_ratio: float = 1.2,
                 num_subset: int = 1, id_subset: int = 0,
                 data_dir: str | None = None, seg_dir: str | None = None,
                 nusc_version: str | None = None, seed: int = 0, tables=nusc_tables,
                 debug: bool = False, debug_dir: str = "debug_vis"):
        ds_cfg = hpams["dataset"]
        self.nusc_cat = ds_cfg["nusc_cat"]
        self.seg_cat = ds_cfg.get("seg_cat", "car")
        self.box_iou_th = ds_cfg.get("box_iou_th", 0.5)
        self.max_dist = ds_cfg.get("max_dist", 40)
        self.min_lidar_cnt = ds_cfg.get("min_lidar_cnt", 5)
        self.mask_pixels = ds_cfg.get("mask_pixels", 2500)
        self.img_h = ds_cfg.get("img_h", 900)
        self.img_w = ds_cfg.get("img_w", 1600)
        self.split = split
        self.add_pose_err = add_pose_err
        self.init_rot_err = init_rot_err
        self.init_trans_err = init_trans_err
        self.rand_angle_lim = rand_angle_lim
        self.det3d_path = det3d_path
        self.pred_box2d = pred_box2d
        self.box2d_rz_ratio = box2d_rz_ratio
        self.out_gt_depth = out_gt_depth
        self.debug, self.debug_dir = debug, debug_dir
        self.rng = np.random.default_rng(seed)
        self.box_vis_all = tables.BoxVisibility.ALL

        key = "train_data_dir" if split == "train" else "test_data_dir"
        self.data_dir = data_dir or ds_cfg.get(key, "data/NuScenes")
        self.seg_dir = seg_dir or os.path.join(self.data_dir, "pred_instance")
        version_key = "train_nusc_version" if split == "train" else "test_nusc_version"
        self.version = nusc_version or ds_cfg.get(
            version_key, ds_cfg.get("train_nusc_version", "v1.0-trainval"))

        self.nusc = tables.NuScenes(version=self.version, dataroot=self.data_dir)
        self.all_valid_samples = []
        self.anntokens_per_ins = {}
        self.instoken_per_ann = {}
        self.sample_attr = {}

        index_file = os.path.join(
            self.data_dir, f"nusc.{self.version}.{split}.{self.nusc_cat}.json")
        thresholds = {
            "box_iou_th": self.box_iou_th, "max_dist": self.max_dist,
            "mask_pixels": self.mask_pixels, "min_lidar_cnt": self.min_lidar_cnt,
            "seg_type": "instance",
        }
        subset = _load_json(index_file)
        if subset is not None and all(subset.get(k) == v for k, v in thresholds.items()):
            self.all_valid_samples = subset["all_valid_samples"]
            self.anntokens_per_ins = subset["anntokens_per_ins"]
            self.instoken_per_ann = subset["instoken_per_ann"]
            self.sample_attr = subset["sample_attr"]
        else:
            self.preprocess_dataset(split, index_file, thresholds)

        # fixed random test subset (reference :298-307)
        if split != "train" and len(self.all_valid_samples) > test_size:
            subset = _load_json(index_file)
            if ("rand_data_ids" not in subset
                    or len(subset["rand_data_ids"]) != test_size):
                ids = self.rng.permutation(len(self.all_valid_samples))[:test_size]
                subset["rand_data_ids"] = ids.tolist()
                with open(index_file, "w") as f:
                    json.dump(subset, f, indent=4)
            self.all_valid_samples = [
                self.all_valid_samples[i] for i in subset["rand_data_ids"]]

        # legacy manual sharding
        set_size = len(self.all_valid_samples) // num_subset
        self.all_valid_samples = self.all_valid_samples[
            id_subset * set_size:(id_subset + 1) * set_size]
        self.lenids = len(self.all_valid_samples)

        # image name -> camera sample_data, for the demo path
        self.cam_data_dict = {}
        for sd in self.nusc.sample_data:
            if "CAM" in sd["channel"]:
                self.cam_data_dict[os.path.basename(sd["filename"])] = sd

    # -- curation -------------------------------------------------------------
    def preprocess_dataset(self, split: str, index_file: str, thresholds: dict):
        scene_names = set(_splits(self.version, split))
        for instance in self.nusc.instance:
            if self.nusc.get("category", instance["category_token"])["name"] != self.nusc_cat:
                continue
            instoken = instance["token"]
            anntokens = self.nusc.field2token("sample_annotation", "instance_token", instoken)
            for anntoken in anntokens:
                ann = self.nusc.get("sample_annotation", anntoken)
                rec = self.nusc.get("sample", ann["sample_token"])
                scene = self.nusc.get("scene", rec["scene_token"])
                if scene["name"] not in scene_names:
                    continue
                # night filtering by log hour (reference :360-363)
                log_file = self.nusc.get("log", scene["log_token"])["logfile"]
                if int(log_file.split("-")[4]) >= 18:
                    continue
                if "LIDAR_TOP" not in rec["data"]:
                    continue
                cams = [k for k in rec["data"] if "CAM" in k]
                for cam in self.rng.permutation(cams):
                    data_path, boxes, K = self.nusc.get_sample_data(
                        rec["data"][cam], box_vis_level=self.box_vis_all,
                        selected_anntokens=[anntoken])
                    if len(boxes) != 1:
                        continue
                    box = boxes[0]
                    corners = K @ box.corners()
                    corners = corners[:2] / corners[2:3]
                    box_2d = [corners[0].min(), corners[1].min(),
                              corners[0].max(), corners[1].max()]

                    lidar_im, lidar_depth, _ = self.nusc.explorer.map_pointcloud_to_image(
                        rec["data"]["LIDAR_TOP"], rec["data"][cam])
                    lidar_cam = np.linalg.inv(K) @ lidar_im * lidar_depth
                    in_box = pts_in_box_np(lidar_cam, box.corners(), 0.9)
                    lidar_im_ann = lidar_im[:, in_box]

                    stem = os.path.basename(data_path)[:-4]
                    try:
                        preds, masks = load_instance_masks(
                            os.path.join(self.seg_dir, cam), stem)
                    except FileNotFoundError:
                        continue
                    tgt_id, cnt, area_ratio, iou, lidar_cnt = get_tgt_ins_from_maskrcnn(
                        preds, masks, self.seg_cat, box_2d, lidar_im_ann)
                    if (tgt_id is not None and cnt > self.mask_pixels
                            and iou > self.box_iou_th and area_ratio > self.box_iou_th
                            and np.linalg.norm(box.center) < self.max_dist
                            and lidar_cnt >= self.min_lidar_cnt):
                        self.all_valid_samples.append([anntoken, cam])
                        self.anntokens_per_ins.setdefault(instoken, []).append(
                            [anntoken, cam])
                        self.instoken_per_ann[anntoken] = instoken
                        self.sample_attr.setdefault(anntoken, {})[cam] = {
                            "seg_id": int(tgt_id), "lidar_cnt": float(lidar_cnt)}

        subset = {
            "all_valid_samples": self.all_valid_samples,
            "anntokens_per_ins": self.anntokens_per_ins,
            "instoken_per_ann": self.instoken_per_ann,
            "sample_attr": self.sample_attr, **thresholds,
        }
        with open(index_file, "w") as f:
            json.dump(subset, f, indent=4)

    # -- samples --------------------------------------------------------------
    def __len__(self):
        return self.lenids

    def _load_ann(self, anntoken: str, cam: str):
        ann = self.nusc.get("sample_annotation", anntoken)
        rec = self.nusc.get("sample", ann["sample_token"])
        data_path, boxes, K = self.nusc.get_sample_data(
            rec["data"][cam], box_vis_level=self.box_vis_all, selected_anntokens=[anntoken])
        img = read_image(data_path).astype(np.float32) / 255.0
        box = boxes[0]
        obj_pose = np.concatenate(
            [box.orientation.rotation_matrix, box.center[:, None]], axis=1
        ).astype(np.float32)
        return ann, rec, data_path, img, box, K.astype(np.float32), obj_pose

    def __getitem__(self, idx):
        anntoken, cam = self.all_valid_samples[idx]
        ann, rec, data_path, img, box, K, obj_pose = self._load_ann(anntoken, cam)
        R_c2o = obj_pose[:, :3].T
        cam_pose = np.concatenate([R_c2o, -R_c2o @ obj_pose[:, 3:4]], axis=1)

        corners = K @ box.corners().astype(np.float32)
        corners = corners[:2] / corners[2:3]
        box_2d = np.array([corners[0].min(), corners[1].min(),
                           corners[0].max(), corners[1].max()])

        stem = os.path.basename(data_path)[:-4]
        preds, masks = load_instance_masks(os.path.join(self.seg_dir, cam), stem)
        tgt_id = self.sample_attr[anntoken][cam]["seg_id"]
        mask_occ = get_mask_occ_from_ins(masks, tgt_id).astype(np.float32)
        if self.pred_box2d:
            box_2d = np.asarray(roi_resize(preds["boxes"][tgt_id], self.box2d_rz_ratio))

        sample = {
            "imgs": img,
            "masks_occ": mask_occ,
            "rois": box_2d.astype(np.int32),
            "cam_intrinsics": K,
            "cam_poses": cam_pose.astype(np.float32),
            "obj_poses": obj_pose,
            "wlh": np.asarray(ann["size"], np.float32),
            "instoken": self.instoken_per_ann[anntoken],
            "anntoken": anntoken,
            "cam_ids": cam,
        }
        sample["obj_poses_w_err"] = self._pose_with_err(
            sample, K, obj_pose, masks, tgt_id, data_path)
        if self.out_gt_depth:
            self._add_lidar_pixels(sample, rec, cam, K, box)
        else:
            sample["lidar_u"] = sample["lidar_v"] = sample["lidar_depth"] = \
                np.zeros(0, np.float32)
        if self.debug:
            lidar_cnt = self.sample_attr[anntoken][cam].get("lidar_cnt", -1)
            print(f"        tgt instance id: {tgt_id}, lidar pts cnt: {lidar_cnt} ")
            try:
                vis_rec = self.nusc.get("visibility", ann["visibility_token"])
                print(f"        Visibility: {vis_rec}")
            except (KeyError, AttributeError):
                pass  # tables without a visibility table
            debug_sample_panel(sample, save_path=os.path.join(self.debug_dir,
                                                              f"{anntoken}_{cam}.png"))
        return sample

    def _pose_with_err(self, sample, K, obj_pose, masks, tgt_id, data_path):
        if self.add_pose_err == 1:
            yaw_err = self.rng.choice([1.0, -1.0]) * self.init_rot_err
            c, s = np.cos(yaw_err), np.sin(yaw_err)
            rot_err = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
            t_ratio = 1.0 + self.rng.choice([1.0, -1.0]) * self.init_trans_err
            out = obj_pose.copy()
            out[:, :3] = obj_pose[:, :3] @ rot_err
            out[:, 3] = obj_pose[:, 3] * t_ratio
            return out.astype(np.float32)
        if self.add_pose_err == 3 and self.det3d_path is not None:
            cam = sample["cam_ids"]
            det_file = os.path.join(self.det3d_path, cam,
                                    os.path.basename(data_path)[:-4] + ".json")
            objects_pred = _load_json(det_file)
            if objects_pred is not None:
                aid, iou = get_associate_box_3d(objects_pred, masks[tgt_id], self.nusc_cat, K)
                if aid >= 0 and iou > 0:
                    ry = objects_pred["boxes_yaw"][aid]
                    c, s = np.cos(ry), np.sin(ry)
                    R_yaw = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
                    R_unit = np.array([[1.0, 0, 0], [0, 0, -1], [0, 1, 0]], np.float32)
                    T_obj = np.asarray(objects_pred["boxes_center"][aid],
                                       np.float32).reshape(3, 1)
                    return np.concatenate([R_yaw @ R_unit, T_obj], axis=1)
        if self.add_pose_err >= 2:
            return random_pose_from_rng(self.rng, K, sample["rois"], self.rand_angle_lim, False)
        return obj_pose.astype(np.float32)

    def _add_lidar_pixels(self, sample, rec, cam, K, box):
        lidar_im, lidar_depth, _ = self.nusc.explorer.map_pointcloud_to_image(
            rec["data"]["LIDAR_TOP"], rec["data"][cam])
        lidar_cam = np.linalg.inv(K) @ lidar_im * lidar_depth
        in_box = pts_in_box_np(lidar_cam, box.corners(), 0.9)
        u = lidar_im[0, in_box]
        v = lidar_im[1, in_box]
        d = lidar_depth[in_box]
        ui = np.clip(u.astype(np.int32), 0, self.img_w - 1)
        vi = np.clip(v.astype(np.int32), 0, self.img_h - 1)
        on_mask = sample["masks_occ"][vi, ui] > 0
        sample["lidar_u"] = u[on_mask].astype(np.float32)
        sample["lidar_v"] = v[on_mask].astype(np.float32)
        sample["lidar_depth"] = d[on_mask].astype(np.float32)

    # -- multiview / demo -----------------------------------------------------
    def get_ins_samples(self, instoken: str):
        """Every sample of one instance still in the sample list (reference
        get_ins_samples :716), through an index of the list."""
        if not hasattr(self, "_sample_idx"):
            self._sample_idx = {tuple(s): i for i, s in enumerate(self.all_valid_samples)}
        out = []
        for anntoken, cam in self.anntokens_per_ins.get(instoken, []):
            idx = self._sample_idx.get((anntoken, cam))
            if idx is not None:
                out.append(self[idx])
        return out

    def get_objects_in_image(self, img_name: str):
        """Every detected target-category object of one image from the
        segmentation alone, no ground truth (reference get_objects_in_image
        :956, the demo's input). Returns {'img', 'objects': [sample dicts]}.
        Other categories' masks read as background (-1), and every ROI is the
        predicted box enlarged by box2d_rz_ratio (reference :981-994)."""
        sd = self.cam_data_dict[img_name]
        cam = sd["channel"]
        data_path = os.path.join(self.data_dir, sd["filename"])
        img = read_image(data_path).astype(np.float32) / 255.0
        calib = self.nusc.get("calibrated_sensor", sd["calibrated_sensor_token"])
        K = np.asarray(calib["camera_intrinsic"], np.float32)

        stem = os.path.basename(data_path)[:-4]
        preds, masks = load_instance_masks(os.path.join(self.seg_dir, cam), stem)
        ins_masks, boxes = [], []
        for i, label in enumerate(preds["labels"]):
            if self.seg_cat in label:
                ins_masks.append(np.asarray(masks[i]))
                boxes.append(np.asarray(roi_resize(preds["boxes"][i], self.box2d_rz_ratio)))
        objects = []
        for i, box in enumerate(boxes):
            objects.append({
                "imgs": img,
                "masks_occ": get_mask_occ_from_ins(ins_masks, i).astype(np.float32),
                "rois": box.astype(np.int32),
                "cam_intrinsics": K,
                "obj_poses": np.concatenate(
                    [np.eye(3, dtype=np.float32),
                     np.asarray([[0.0], [0.0], [20.0]], np.float32)], axis=1),
                "wlh": NUSC_CAR_WLH_MEAN.copy(),
                "instoken": f"demo_{stem}_{i}",
                "anntoken": f"demo_{stem}_{i}",
                "cam_ids": cam,
                "lidar_u": np.zeros(0, np.float32),
                "lidar_v": np.zeros(0, np.float32),
                "lidar_depth": np.zeros(0, np.float32),
            })
        return {"img": img, "objects": objects}


def _load_json(path: str):
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)
