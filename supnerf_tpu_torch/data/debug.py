"""Dataset QA: a per-sample debug panel and a statistics walk; the port of
supnerf_tpu/data/debug.py (reference data_nuscenes.py:660-711 debug
rendering, :1010-1092 statistics; data_kitti.py:606-665).

debug_sample_panel draws with utils/draw.py and utils/vis.py (cv2's
pixels, matplotlib's magma table) and writes the PNG with
utils/image_io.write_png; its uint8 panel is the JAX function's.
dataset_statistics returns the JAX function's stats dict; where JAX draws
its two histograms into PDFs with matplotlib, it writes what they draw as
JSON: {name}_dist_hist.json (np.histogram with bins="auto", plt.hist's
call) and {name}_occ_hist.json (KITTI, Waymo: the occlusion labels over
the bins [0, 1, 2, 3]) or {name}_vis_hist.json (nuScenes: the visibility
level over [1, 2, 3, 4, 5]), each {"xlabel", "title", "bin_edges",
"counts"}, as eval.pdf became eval.json (eval/aggregate.write_eval_json).
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from supnerf_tpu_torch.geometry.boxes import corners_of_box, view_points
from supnerf_tpu_torch.utils.draw import circles, rectangle
from supnerf_tpu_torch.utils.image_io import write_png
from supnerf_tpu_torch.utils.vis import colorize_depth, render_box


def _boxes_uv(pose, wlh, K, is_kitti: bool) -> np.ndarray:
    """The box's 8 corners projected to pixels, (2, 8), in float32."""
    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32))

    uv = view_points(corners_of_box(t(pose), t(wlh), is_kitti=is_kitti), t(K), normalize=True)
    return uv[:2].numpy()


def _mask_vis(img, mask_occ):
    """The occupancy panel: the target green, occluders red, the rest
    dimmed (the {-1, 0, 1} encoding the pipeline consumes)."""
    vis = img * 0.35
    tgt = mask_occ > 0.5
    occ = np.abs(mask_occ) < 0.5
    vis[tgt] = vis[tgt] * 0.3 + np.array([0.1, 0.8, 0.2]) * 0.7
    vis[occ] = vis[occ] * 0.3 + np.array([0.85, 0.15, 0.1]) * 0.7
    return vis


def _scatter_lidar(im, u, v, depth):
    """The lidar pixels as filled circles of radius 2, magma-coloured by
    depth, in order."""
    if len(u) == 0:
        return im
    colors = colorize_depth(np.asarray(depth).reshape(1, -1))[0] / 255.0
    centers = np.stack([np.rint(np.asarray(u, np.float64)),
                        np.rint(np.asarray(v, np.float64))], 1).astype(np.int64)
    return circles(im, centers, 2, colors, -1)


def debug_sample_panel(sample, *, is_kitti: bool = False, save_path=None):
    """[image + ground-truth box (+ the error box) + lidar | occupancy mask
    + 2D ROI + lidar] for one dataset sample dict. Returns the uint8 panel
    and writes it as a PNG when save_path is given."""
    img = np.asarray(sample["imgs"], np.float32).copy()
    left = img.copy()
    g = ((0.0, 0.8, 0.0),) * 3
    left = render_box(left, _boxes_uv(sample["obj_poses"], sample["wlh"],
                                      sample["cam_intrinsics"], is_kitti), colors=g)
    pose_err = sample.get("obj_poses_w_err")
    if pose_err is not None and not np.allclose(pose_err, sample["obj_poses"]):
        r = ((0.9, 0.1, 0.1),) * 3
        left = render_box(left, _boxes_uv(pose_err, sample["wlh"], sample["cam_intrinsics"],
                                          is_kitti), colors=r)
    right = _mask_vis(img, np.asarray(sample["masks_occ"]))
    x0, y0, x1, y1 = [int(v) for v in np.asarray(sample["rois"]).tolist()]
    rectangle(right, (x0, y0), (x1, y1), (0.95, 0.9, 0.1), 2)
    for im in (left, right):
        _scatter_lidar(im, sample.get("lidar_u", []), sample.get("lidar_v", []),
                       sample.get("lidar_depth", []))
    panel = (np.clip(np.concatenate([left, right], axis=1), 0, 1) * 255).astype(np.uint8)
    if save_path:
        os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
        write_png(save_path, panel)
    return panel


def _write_hist(path: str, values, bins, xlabel: str, title: str) -> None:
    counts, edges = np.histogram(np.asarray(values), bins=bins)
    with open(path, "w") as f:
        json.dump({"xlabel": xlabel, "title": title, "bin_edges": edges.tolist(),
                   "counts": counts.tolist()}, f, indent=1)


def dataset_statistics(dataset, out_dir: str, *, max_samples: int | None = None,
                       name: str | None = None, print_every: int = 50):
    """Walk the dataset (its first max_samples) and return {"n_samples",
    "wlh_mean", "wlh_std", "dist_mean"} plus "level_label" and "levels"
    where a level exists: the sample's KITTI/Waymo "occlusion", or the
    nuScenes visibility level from the reader's tables (skipped where the
    tables have no visibility). Writes the histograms' JSON into out_dir
    (the module docstring)."""
    os.makedirs(out_dir, exist_ok=True)
    name = name or getattr(dataset, "NAME", type(dataset).__name__.lower())
    n = len(dataset) if max_samples is None else min(len(dataset), max_samples)

    distance_all, wlh_all, level_all = [], [], []
    level_label = None
    nusc = getattr(dataset, "nusc", None)
    for i in range(n):
        s = dataset[i]
        distance_all.append(float(np.linalg.norm(np.asarray(s["obj_poses"])[:, 3])))
        wlh_all.append(np.asarray(s["wlh"], np.float32))
        if "occlusion" in s:
            level_label = "Occlusion"
            level_all.append(float(s["occlusion"]))
        elif nusc is not None and "anntoken" in s:
            try:
                ann = nusc.get("sample_annotation", s["anntoken"])
                lvl = int(nusc.get("visibility", ann["visibility_token"])["token"])
                level_label = "Visibility (6 CAM)"
                level_all.append(lvl)
            except (KeyError, AttributeError):
                pass  # tables without a visibility table
        if print_every and (i + 1) % print_every == 0:
            print(f"Finish {i + 1} / {n}")

    wlh_all = np.stack(wlh_all)
    stats = {
        "n_samples": n,
        "wlh_mean": wlh_all.mean(axis=0).tolist(),
        "wlh_std": wlh_all.std(axis=0).tolist(),
        "dist_mean": float(np.mean(distance_all)),
    }
    print(f"wlh mean: {stats['wlh_mean']},  wlh std: {stats['wlh_std']}")
    _write_hist(os.path.join(out_dir, f"{name}_dist_hist.json"), distance_all, "auto",
                "Distance", "Histogram of object distance")
    if level_all:
        occ = level_label == "Occlusion"
        _write_hist(os.path.join(out_dir, f"{name}_{'occ' if occ else 'vis'}_hist.json"),
                    level_all, [0, 1, 2, 3] if occ else [1, 2, 3, 4, 5], level_label,
                    f"Histogram of {level_label.lower()} level")
        stats["level_label"] = level_label
        stats["levels"] = level_all
    return stats
