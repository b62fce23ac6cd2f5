"""Per-iteration means of saved TTO results; the port's own copy of
aggregate_metrics and aggregate_cross_eval of supnerf_tpu/eval/aggregate.py
(reference utils.py:786-988 collect_eval_results), without the plots."""
from __future__ import annotations

import numpy as np

PRINT_ITERS = (0, 3, 5, 10, 20, 50, 99)


def aggregate_metrics(result: dict, max_iter: int = 100) -> dict:
    """Mean curves over objects: psnr (T,), depth_err (T,) weighted by lidar
    counts, rot_err_deg (T,), trans_err (T,), and n_objects."""
    keys = list(result["psnr_eval"])
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


def print_eval_results(agg: dict, cross: dict | None = None):
    """The reference's metric table at PRINT_ITERS."""
    pi = [i for i in PRINT_ITERS if i < len(agg["psnr"])]
    print(f"    psnr: {np.round(agg['psnr'][pi], 2)}")
    if "depth_err" in agg:
        print(f"    depth err: {np.round(agg['depth_err'][pi], 2)}")
    if "rot_err_deg" in agg:
        print(f"    R err: {np.round(agg['rot_err_deg'][pi], 2)}")
        print(f"    T err: {np.round(agg['trans_err'][pi], 2)}")
    if cross is not None:
        print(f"    psnr cross-view: {np.round(cross['psnr_cross'], 2)}")
        print(f"    depth err cross-view: {np.round(cross['depth_cross'], 2)}")
