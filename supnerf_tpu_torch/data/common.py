"""Dataset-agnostic curation helpers in numpy; the port of
supnerf_tpu/data/common.py (reference data_nuscenes.py: get_mask_occ_from_ins
:114, get_tgt_ins_from_masksrcnn_v2 :129, get_associate_box_3d :175). The
instance masks are decoded by the port's own PNG reader, not PIL."""
from __future__ import annotations

import json
import os

import numpy as np

from supnerf_tpu_torch.utils.image_io import read_png

# nuScenes car-category wlh statistics (reference optimizer_nuscenes.py:27-28):
# the demo's default box size (data.nuscenes.get_objects_in_image)
NUSC_CAR_WLH_MEAN = np.array([1.9446588, 4.641784, 1.7103361], np.float32)
NUSC_CAR_WLH_STD = np.array([0.1611075, 0.3961748, 0.20885137], np.float32)


def pts_in_box_np(pts_3d, corners_3d, keep_top_portion: float = 1.0):
    """Boolean mask of the points (3, N) inside the oriented box of corners
    (3, 8); keep_top_portion < 1 shrinks the height axis (reference
    utils.check_pts_in_box)."""
    v1 = corners_3d[:, 1:2] - corners_3d[:, 0:1]
    v2 = (corners_3d[:, 3:4] - corners_3d[:, 0:1]) * keep_top_portion
    v3 = corners_3d[:, 4:5] - corners_3d[:, 0:1]
    v_test = pts_3d - corners_3d[:, 0:1]
    ins = np.ones(pts_3d.shape[1], bool)
    for v in (v1, v2, v3):
        proj = (v.T @ v_test)[0]
        ins &= (proj > 0) & (proj < float((v.T @ v)[0, 0]))
    return ins


def box_iou_xyxy(a, b) -> float:
    """IoU of two [xmin, ymin, xmax, ymax] boxes."""
    ax0, ay0, ax1, ay1 = [float(v) for v in a]
    bx0, by0, bx1, by1 = [float(v) for v in b]
    x_left, y_top = max(ax0, bx0), max(ay0, by0)
    x_right, y_bottom = min(ax1, bx1), min(ay1, by1)
    if x_right < x_left or y_bottom < y_top:
        return 0.0
    inter = (x_right - x_left) * (y_bottom - y_top)
    union = (ax1 - ax0) * (ay1 - ay0) + (bx1 - bx0) * (by1 - by0) - inter
    return inter / union


def get_mask_occ_from_ins(masks, tgt_ins_id: int) -> np.ndarray:
    """Occupancy mask from the instance masks: target 1, other foreground
    (potential occluders) 0, background -1."""
    tgt_mask = np.asarray(masks[tgt_ins_id])
    mask_occ = np.zeros_like(tgt_mask, dtype=np.int32)
    mask_union = np.sum(np.asarray(masks), axis=0)
    mask_occ[mask_union == 0] = -1
    mask_occ[tgt_mask > 0] = 1
    return mask_occ


def get_tgt_ins_from_maskrcnn(preds: dict, masks, tgt_cat: str, tgt_box,
                              lidar_pts_im: np.ndarray):
    """The instance of category tgt_cat whose mask covers the most of the
    annotation's lidar pixels lidar_pts_im (3, N). Returns (ins_id, ins_area,
    area_ratio, box_iou, lidar_cnt); ins_id None without a candidate."""
    indices = [i for i, label in enumerate(preds["labels"]) if tgt_cat in label]
    if len(indices) == 0 or lidar_pts_im.shape[1] == 0:
        return None, 0, 0.0, 0.0, 0

    boxes = np.asarray(preds["boxes"], dtype=np.float64)[indices]
    masks_sel = np.asarray(masks, dtype=np.float64)[indices] / 255
    lidar_reads = masks_sel[:, lidar_pts_im[1, :].astype(np.int32),
                            lidar_pts_im[0, :].astype(np.int32)]
    lidar_cnts = np.sum(lidar_reads, axis=1)
    max_id = int(np.argmax(lidar_cnts))
    lidar_cnt = lidar_cnts[max_id]

    out_ins_id = indices[max_id]
    out_mask = masks_sel[max_id]
    out_ins_area = int(np.sum(out_mask > 0))
    out_box = boxes[max_id]
    out_box_area = (out_box[2] - out_box[0]) * (out_box[3] - out_box[1])
    area_ratio = float(out_ins_area) / out_box_area
    iou = box_iou_xyxy(tgt_box, out_box)
    return out_ins_id, out_ins_area, area_ratio, iou, lidar_cnt


def get_associate_box_3d(objects, tgt_mask: np.ndarray, tgt_cat: str,
                         cam_intrinsic: np.ndarray | None = None):
    """The third-party 3D detection whose 2D box best overlaps the target
    mask's box. objects: {'classes', 'corners_3d' (8, 3 lists)} with
    cam_intrinsic (nuScenes), or KITTI Object3d-likes (.type, .box2d)
    without. Returns (index, iou), (-1, 0.0) without a match."""
    ys, xs = np.where(np.asarray(tgt_mask) > 0)
    if len(xs) == 0:
        return -1, 0.0
    tgt_box = [xs.min(), ys.min(), xs.max(), ys.max()]
    best_id, best_iou = -1, 0.0

    if cam_intrinsic is not None:
        for i, cls_label in enumerate(objects["classes"]):
            if cls_label != tgt_cat.rsplit(".")[-1]:
                continue
            c3d = np.asarray(objects["corners_3d"][i]).T  # (3, 8)
            uv = cam_intrinsic @ c3d
            uv = uv[:2] / uv[2:3]
            box = [uv[0].min(), uv[1].min(), uv[0].max(), uv[1].max()]
            iou = box_iou_xyxy(tgt_box, box)
            if iou > best_iou:
                best_id, best_iou = i, iou
    else:
        for i, obj in enumerate(objects):
            if obj.type != tgt_cat:
                continue
            iou = box_iou_xyxy(tgt_box, obj.box2d)
            if iou > best_iou:
                best_id, best_iou = i, iou
    return best_id, best_iou


def load_instance_masks(seg_dir: str, stem: str):
    """The segmentation's prediction json and per-instance mask PNGs
    (reference data_nuscenes.py:492-498): (preds, [masks (H, W)]), each mask
    as PIL reads it (read_png): uint8, bool at 1 bit."""
    with open(os.path.join(seg_dir, stem + ".json")) as f:
        preds = json.load(f)
    masks = [read_png(os.path.join(seg_dir, f"{stem}_{box_id}.png"))
             for box_id in range(len(preds["boxes"]))]
    return preds, masks
