"""Saved TTO results re-scored: the port's own copy of
supnerf_tpu/eval/aggregate.py (reference utils.py:786-988
collect_eval_results, scripts/eval_saved_result.py). A result file is the
driver's codes+poses.pkl or a reference-format .pth; the per-iteration
means over objects (PSNR, lidar-weighted depth error, rotation and
translation error) are printed at the standard iterations and, with a
cross_eval file, the off-diagonal cross-view means. The JAX module draws
them into a 2x2 matplotlib figure; here figure_entry gives the same curves
as data under the figure's panel names, and write_eval_json writes them.
"""
from __future__ import annotations

import json
import math
import os
import pickle

import numpy as np
import torch

PRINT_ITERS = (0, 3, 5, 10, 20, 50, 99)
# the 2x2 figure's panels, as the JAX module titles them
PANELS = ("PSNR", "Depth Err", "Rot Err", "Trans Err")


def _torch_to_numpy(obj):
    """Tensors to numpy arrays, through dicts, lists and tuples."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: _torch_to_numpy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        seq = [_torch_to_numpy(v) for v in obj]
        return tuple(seq) if isinstance(obj, tuple) else seq
    return obj


def load_result_file(path: str) -> dict:
    """A result dict: a pickle of the drivers, or a reference torch .pth
    (loaded with weights_only=False: reference result files hold numpy
    scalars, which torch's default loader refuses), its tensors as numpy."""
    if path.endswith(".pth"):
        return _torch_to_numpy(torch.load(path, map_location="cpu", weights_only=False))
    with open(path, "rb") as f:
        return pickle.load(f)


def aggregate_metrics(result: dict, max_iter: int = 100, rot_outlier_ignore: bool = False,
                      sample_keys=None) -> dict:
    """Mean curves over objects (those of sample_keys, default all): psnr
    (T,), depth_err (T,) weighted by lidar counts, rot_err_deg (T,) (with
    rot_outlier_ignore, an error past 0.9 pi after iteration 0 counts as its
    distance from pi, a flipped car), trans_err (T,), and n_objects."""
    keys = list(result["psnr_eval"]) if sample_keys is None else list(sample_keys)
    psnr = np.asarray([np.asarray(result["psnr_eval"][k])[:max_iter] for k in keys])
    psnr = np.nan_to_num(psnr, posinf=0.0, neginf=0.0)
    psnr[psnr < 0] = 0
    out = {"psnr": psnr.mean(0), "n_objects": len(keys)}
    if result.get("depth_err_mean"):
        d_keys = [k for k in keys if k in result["depth_err_mean"]]
        d = np.asarray([np.asarray(result["depth_err_mean"][k])[:max_iter] for k in d_keys])
        cnt = np.asarray([result["lidar_pts_cnt"][k] for k in d_keys], np.float64)
        out["depth_err"] = (d * cnt[:, None]).sum(0) / max(cnt.sum(), 1e-8)
    if result.get("R_eval"):
        R = np.nan_to_num(np.asarray([np.asarray(result["R_eval"][k])[:max_iter] for k in keys]))
        if rot_outlier_ignore:
            r0 = R[:, 0].copy()
            R[R > np.pi * 0.9] = np.abs(R[R > np.pi * 0.9] - np.pi)
            R[:, 0] = r0
        T = np.asarray([np.asarray(result["T_eval"][k])[:max_iter] for k in keys])
        out["rot_err_deg"] = R.mean(0) / np.pi * 180
        out["trans_err"] = T.mean(0)
    return out


def aggregate_cross_eval(cross: dict) -> dict:
    """Off-diagonal cross-view PSNR and depth means at each CODE_SAVE_ITERS;
    instances with fewer than 2 views are skipped."""
    iters = cross["CODE_SAVE_ITERS_"]
    psnr_acc = [[] for _ in iters]
    depth_acc = [[] for _ in iters]
    for ins, mats in cross["psnr_eval_mat_per_ins"].items():
        n = mats[0].shape[0]
        if n < 2:
            continue
        r, c = np.where(~np.eye(n, dtype=bool))
        for i in range(len(iters)):
            psnr_acc[i] += mats[i][r, c].tolist()
            depth_acc[i] += cross["depth_eval_mat_per_ins"][ins][i][r, c].tolist()
    return {"iters": np.asarray(iters),
            "psnr_cross": np.asarray([np.mean(p) if p else np.nan for p in psnr_acc]),
            "depth_cross": np.asarray([np.mean(d) if d else np.nan for d in depth_acc])}


def collect_eval_results(result_file: str, max_iter: int = 100,
                         cross_eval_file: str | None = None, print_iters=PRINT_ITERS,
                         rot_outlier_ignore: bool = False, sample_keys=None) -> dict:
    """Print the reference's metric table of one result file (and, where
    cross_eval_file exists, its cross-view rows) and return the aggregate
    (aggregate_metrics), with the cross-view aggregate under "cross"."""
    print(f"Processing {result_file}")
    agg = aggregate_metrics(load_result_file(result_file), max_iter, rot_outlier_ignore,
                            sample_keys)
    pi = [i for i in print_iters if i < len(agg["psnr"])]
    print(f"    psnr: {np.round(agg['psnr'][pi], 2)}")
    if "depth_err" in agg:
        print(f"    depth err: {np.round(agg['depth_err'][pi], 2)}")
    if "rot_err_deg" in agg:
        print(f"    R err: {np.round(agg['rot_err_deg'][pi], 2)}")
        print(f"    T err: {np.round(agg['trans_err'][pi], 2)}")
    if cross_eval_file is not None and os.path.exists(cross_eval_file):
        cross = aggregate_cross_eval(load_result_file(cross_eval_file))
        agg["cross"] = cross
        print(f"    psnr cross-view: {np.round(cross['psnr_cross'], 2)}")
        print(f"    depth err cross-view: {np.round(cross['depth_cross'], 2)}")
    return agg


def _floats(values):
    """A JSON list: non-finite values become null."""
    return [float(v) if math.isfinite(float(v)) else None for v in np.asarray(values).ravel()]


def figure_entry(result_file: str, agg: dict, color: str = "b",
                 legend: str | None = None) -> dict:
    """One result file's part of the 2x2 figure as data: its curves per
    panel (a panel the results lack is left out) and the cross-view points
    (code snapshot iterations and means) on the PSNR and Depth Err panels."""
    keys = dict(zip(PANELS, ("psnr", "depth_err", "rot_err_deg", "trans_err")))
    entry = {"file": result_file, "color": color, "legend": legend,
             "curves": {p: _floats(agg[k]) for p, k in keys.items() if k in agg}}
    if "cross" in agg:
        cross = agg["cross"]
        entry["cross_view"] = {
            p: {"iters": [int(i) for i in cross["iters"]], "values": _floats(cross[k])}
            for p, k in (("PSNR", "psnr_cross"), ("Depth Err", "depth_cross"))}
    return entry


def write_eval_json(path: str, entries: list):
    """The figure's data, {"panels": PANELS, "results": entries}, as JSON at
    path. The port has no matplotlib, so a .pdf path is refused."""
    if path.lower().endswith(".pdf"):
        raise ValueError(f"{path}: the port writes the 2x2 figure's curves as JSON (no "
                         "matplotlib on the card's machine); give a .json path")
    with open(path, "w") as f:
        json.dump({"panels": list(PANELS), "results": entries}, f, indent=1)
