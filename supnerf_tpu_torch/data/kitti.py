"""KITTI (and Waymo-in-KITTI-format) object datasets; the port of
supnerf_tpu/data/kitti.py (reference data_kitti.py KittiData :206,
data_waymo.py WaymoData :206).

Curation over the split (occlusion < 3, truncation 0, box-IoU / mask-area /
distance / depth / lidar-count thresholds) is cached to the JAX package's
index JSON ({name}.{split}.{cat}.json under the data directory), so either
package reads the other's index. Samples hold occupancy masks from the
segmentation's instance masks, the object pose in the KITTI object frame
(x front, y down, z left, box centre on the ground), the pose-error
injection modes and the sparse lidar depth pixels, in the sample dict of
data.synthetic.make_synthetic_object.

Pose-error modes 2 (and 3 without a matching detection) draw one integer
from the reader's numpy generator, as the JAX reader does, and seed a CPU
torch.Generator with it for geometry.poses.get_random_pose2; the JAX reader
seeds a JAX key with it, so the bits of that pose differ (ROADMAP.md C.11).
The TTO driver reads the reader's pose in mode 3 only.

debug=True writes each sample's QA panel (data/debug.debug_sample_panel,
KITTI's corner convention) to debug_dir/{NAME}_{data_idx}_{obj_idx}.png as
the JAX reader does.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from supnerf_tpu_torch.data.debug import debug_sample_panel
from supnerf_tpu_torch.data.common import (
    get_associate_box_3d,
    get_mask_occ_from_ins,
    get_tgt_ins_from_maskrcnn,
    load_instance_masks,
    pts_in_box_np,
)
from supnerf_tpu_torch.data.kitti_format import KittiObjectDataset, get_lidar_in_image_fov
from supnerf_tpu_torch.geometry.poses import get_random_pose2
from supnerf_tpu_torch.geometry.roi import roi_resize


def _kitti_obj_pose(obj, K, P):
    """Object pose in the camera frame from a KITTI label (reference
    data_kitti.py:437-445): R a yaw about y; T lifted by the P[:, 3] offset."""
    c, s = np.cos(obj.ry), np.sin(obj.ry)
    R = np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]], np.float32)
    T = np.asarray(obj.t, np.float64).reshape(3, 1) + np.linalg.inv(K) @ P[:, 3:]
    return np.concatenate([R, T.astype(np.float32)], axis=1)


def _corners_kitti_np(pose, wlh):
    w, l, h = wlh
    x = l / 2 * np.array([1, 1, 1, 1, -1, -1, -1, -1])
    y = h / 2 * np.array([-2, -2, 0, 0, -2, -2, 0, 0])
    z = w / 2 * np.array([1, -1, -1, 1, 1, -1, -1, 1])
    return pose[:, :3] @ np.vstack([x, y, z]) + pose[:, 3:4]


def random_pose_from_rng(rng, K, roi, angle_lim, is_kitti):
    """The readers' mode-2 pose: one integer from the reader's numpy stream
    seeds a CPU torch.Generator for get_random_pose2 (trans_lim 0.3)."""
    g = torch.Generator().manual_seed(int(rng.integers(0, 2**31)))
    pose = get_random_pose2(torch.as_tensor(np.asarray(K, np.float32))[None],
                            torch.as_tensor(np.asarray(roi, np.float32))[None], g,
                            angle_lim=angle_lim, trans_lim=0.3, is_kitti=is_kitti)
    return pose[0].numpy()


class KittiData:
    LAYOUT = "kitti"
    NAME = "kitti"

    def __init__(self, hpams, split: str = "val", out_gt_depth: bool = True,
                 add_pose_err: int = 0, init_rot_err: float = 0.2,
                 init_trans_err: float = 0.01, rand_angle_lim: float = 0.0,
                 pred_box2d: bool = False, box2d_rz_ratio: float = 1.2,
                 data_dir: str | None = None, seed: int = 0, debug: bool = False,
                 debug_dir: str = "debug_vis"):
        ds_cfg = hpams["dataset"]
        self.cat = ds_cfg.get(f"{self.NAME}_cat", "Car")
        self.seg_cat = ds_cfg.get("seg_cat", "car")
        self.box_iou_th = ds_cfg.get("box_iou_th", 0.5)
        self.max_dist = ds_cfg.get("max_dist", 40)
        self.min_depth = ds_cfg.get("min_depth", 3)
        self.min_lidar_cnt = ds_cfg.get("min_lidar_cnt", 10)
        self.mask_pixels = ds_cfg.get("mask_pixels", 1600)
        self.split_dir = ds_cfg.get("split_dir", "")
        self.data_dir = data_dir or ds_cfg.get("data_dir", "")
        self.add_pose_err = add_pose_err
        self.init_rot_err = init_rot_err
        self.init_trans_err = init_trans_err
        self.rand_angle_lim = rand_angle_lim
        self.pred_box2d = pred_box2d
        self.box2d_rz_ratio = box2d_rz_ratio
        self.out_gt_depth = out_gt_depth
        self.debug, self.debug_dir = debug, debug_dir
        self.rng = np.random.default_rng(seed)

        sub = "training" if split != "test" else "testing"
        self.loader = KittiObjectDataset(self.data_dir, split=sub, layout=self.LAYOUT)
        self.seg_dir = os.path.join(self.data_dir, sub, "pred_instance")

        self.all_valid_samples = []
        self.sample_attr = {}
        index_file = os.path.join(self.data_dir, f"{self.NAME}.{split}.{self.cat}.json")
        thresholds = {
            "box_iou_th": self.box_iou_th, "max_dist": self.max_dist,
            "min_depth": self.min_depth, "mask_pixels": self.mask_pixels,
            "min_lidar_cnt": self.min_lidar_cnt, "seg_type": "instance",
        }
        subset = None
        if os.path.exists(index_file):
            with open(index_file) as f:
                subset = json.load(f)
        if subset is not None and all(subset.get(k) == v for k, v in thresholds.items()):
            self.all_valid_samples = subset["all_valid_samples"]
            self.sample_attr = subset["sample_attr"]
        else:
            self.preprocess_dataset(split, index_file, thresholds)
        self.lenids = len(self.all_valid_samples)

    # -- curation -------------------------------------------------------------
    def preprocess_dataset(self, split: str, index_file: str, thresholds: dict):
        with open(os.path.join(self.split_dir, split + ".txt")) as f:
            data_ids = [ln.rstrip() for ln in f if ln.strip()]

        for data_idx in data_ids:
            pc_velo = self.loader.get_lidar(int(data_idx))[:, :3]
            calib = self.loader.get_calibration(int(data_idx))
            img = self.loader.get_image(int(data_idx))
            objects = self.loader.get_label_objects(int(data_idx))
            H, W = img.shape[:2]
            K = calib.P[:, :3]

            imgfov_pc_velo, pts_2d, fov_inds = get_lidar_in_image_fov(
                pc_velo, calib, 0, 0, W, H, True)
            lidar_pts_im = pts_2d[fov_inds].T
            imgfov_pc_rect = calib.project_velo_to_rect(imgfov_pc_velo).T

            try:
                preds, ins_masks = load_instance_masks(self.seg_dir, data_idx)
            except FileNotFoundError:
                continue

            for obj_idx, obj in enumerate(objects):
                if obj.type != self.cat:
                    continue
                obj_pose = _kitti_obj_pose(obj, K, calib.P)
                wlh = np.array([obj.w, obj.l, obj.h], np.float32)
                corners_3d = _corners_kitti_np(obj_pose, wlh)
                in_box = pts_in_box_np(imgfov_pc_rect, corners_3d, 0.9)
                lidar_im_ann = lidar_pts_im[:, in_box]
                lidar_im_ann = np.concatenate(
                    [lidar_im_ann, np.ones((1, lidar_im_ann.shape[1]))], axis=0)

                tgt_id, cnt, area_ratio, iou, lidar_cnt = get_tgt_ins_from_maskrcnn(
                    preds, ins_masks, self.seg_cat, obj.box2d, lidar_im_ann)
                T = obj_pose[:, 3]
                if (tgt_id is not None and cnt > self.mask_pixels
                        and iou > self.box_iou_th and area_ratio > self.box_iou_th
                        and np.linalg.norm(T) < self.max_dist
                        and T[2] > self.min_depth and lidar_cnt >= self.min_lidar_cnt
                        and obj.occlusion < 3 and obj.truncation == 0):
                    self.all_valid_samples.append([data_idx, str(obj_idx)])
                    self.sample_attr.setdefault(data_idx, {})[str(obj_idx)] = {
                        "seg_id": int(tgt_id), "lidar_cnt": float(lidar_cnt)}

        subset = {"all_valid_samples": self.all_valid_samples,
                  "sample_attr": self.sample_attr, **thresholds}
        with open(index_file, "w") as f:
            json.dump(subset, f, indent=4)

    # -- samples --------------------------------------------------------------
    def __len__(self):
        return self.lenids

    def __getitem__(self, idx):
        data_idx, obj_idx = self.all_valid_samples[idx]
        calib = self.loader.get_calibration(int(data_idx))
        img = self.loader.get_image(int(data_idx)).astype(np.float32) / 255.0
        objects = self.loader.get_label_objects(int(data_idx))
        H, W = img.shape[:2]
        K = calib.P[:, :3].astype(np.float32)
        obj = objects[int(obj_idx)]

        obj_pose = _kitti_obj_pose(obj, K, calib.P)
        wlh = np.array([obj.w, obj.l, obj.h], np.float32)
        R_c2o = obj_pose[:, :3].T
        cam_pose = np.concatenate([R_c2o, -R_c2o @ obj_pose[:, 3:4]], axis=1)

        preds, ins_masks = load_instance_masks(self.seg_dir, data_idx)
        tgt_id = self.sample_attr[data_idx][obj_idx]["seg_id"]
        mask_occ = get_mask_occ_from_ins(ins_masks, tgt_id).astype(np.float32)
        box_2d = np.asarray(obj.box2d)
        if self.pred_box2d:
            box_2d = np.asarray(roi_resize(preds["boxes"][tgt_id], self.box2d_rz_ratio))

        sample = {
            "imgs": img,
            "masks_occ": mask_occ,
            "rois": box_2d.astype(np.int32),
            "cam_intrinsics": K,
            "cam_poses": cam_pose.astype(np.float32),
            "obj_poses": obj_pose.astype(np.float32),
            "wlh": wlh,
            "instoken": f"{self.NAME}_{data_idx}_{obj_idx}",
            "anntoken": f"{data_idx}_{obj_idx}",
            "cam_ids": "CAM_FRONT" if self.NAME == "waymo" else "CAM2",
            "occlusion": float(obj.occlusion),
        }
        sample["obj_poses_w_err"] = self._pose_with_err(sample, K, obj_pose, ins_masks, tgt_id,
                                                        int(data_idx), calib)
        if self.out_gt_depth:
            self._add_lidar_pixels(sample, int(data_idx), calib, obj_pose, wlh, W, H)
        else:
            sample["lidar_u"] = sample["lidar_v"] = sample["lidar_depth"] = \
                np.zeros(0, np.float32)
        if self.debug:
            lidar_cnt = self.sample_attr[data_idx][obj_idx].get("lidar_cnt", -1)
            print(f"        obj {data_idx}/{obj_idx}: occlusion {obj.occlusion}, "
                  f"lidar pts cnt: {lidar_cnt}")
            # the poses are in the KITTI object frame: KITTI's corner convention
            debug_sample_panel(sample, is_kitti=True, save_path=os.path.join(
                self.debug_dir, f"{self.NAME}_{data_idx}_{obj_idx}.png"))
        return sample

    def _pose_with_err(self, sample, K, obj_pose, ins_masks, tgt_id, data_idx, calib):
        if self.add_pose_err == 1:
            yaw_err = self.rng.choice([1.0, -1.0]) * self.init_rot_err
            c, s = np.cos(yaw_err), np.sin(yaw_err)
            rot_err = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
            t_ratio = 1.0 + self.rng.choice([1.0, -1.0]) * self.init_trans_err
            out = obj_pose.copy()
            out[:, :3] = obj_pose[:, :3] @ rot_err
            out[:, 3] = obj_pose[:, 3] * t_ratio
            return out.astype(np.float32)
        if self.add_pose_err == 3:
            objects_pred = self.loader.get_pred_objects(data_idx)
            aid, iou = get_associate_box_3d(objects_pred, ins_masks[tgt_id], self.cat)
            if aid >= 0 and iou > 0:
                return _kitti_obj_pose(objects_pred[aid], K, calib.P).astype(np.float32)
        if self.add_pose_err >= 2:
            return random_pose_from_rng(self.rng, K, sample["rois"], self.rand_angle_lim, True)
        return obj_pose.astype(np.float32)

    def _add_lidar_pixels(self, sample, data_idx, calib, obj_pose, wlh, W, H):
        pc_velo = self.loader.get_lidar(data_idx)[:, :3]
        imgfov_pc_velo, pts_2d, fov_inds = get_lidar_in_image_fov(
            pc_velo, calib, 0, 0, W, H, True)
        lidar_im = pts_2d[fov_inds].T
        rect = calib.project_velo_to_rect(imgfov_pc_velo).T
        corners_3d = _corners_kitti_np(obj_pose, wlh)
        in_box = pts_in_box_np(rect, corners_3d, 0.9)
        u = lidar_im[0, in_box]
        v = lidar_im[1, in_box]
        d = rect[2, in_box]
        # only pixels on the target mask (reference depth eval selection)
        ui = np.clip(u.astype(np.int32), 0, W - 1)
        vi = np.clip(v.astype(np.int32), 0, H - 1)
        on_mask = sample["masks_occ"][vi, ui] > 0
        sample["lidar_u"] = u[on_mask].astype(np.float32)
        sample["lidar_v"] = v[on_mask].astype(np.float32)
        sample["lidar_depth"] = d[on_mask].astype(np.float32)
