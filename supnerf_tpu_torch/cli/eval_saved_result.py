"""Re-score saved TTO results (the port of supnerf_tpu/cli/eval_saved_result.py;
reference scripts/eval_saved_result.py): prints each result file's metric
table at the standard iterations and writes the 2x2 figure's curves as
JSON (eval.aggregate.write_eval_json; the JAX CLI draws them into a PDF).

Explicit result files (.pkl of the drivers, or reference .pth):
    python -m supnerf_tpu_torch.cli.eval_saved_result RESULT.pkl [RESULT2.pth ...] \\
        [--cross_eval CROSS.pkl] [--out eval.json] [--max_iter 100] [--rot_outlier_ignore]

The reference folder convention (scripts/eval_saved_result.py:10-15):
    python -m supnerf_tpu_torch.cli.eval_saved_result \\
        --model-folder checkpoints/supnerf --test-folder test_nuscenes... \\
        --legend-name SUPNeRF-nuScenes --plot-cross-view [--save-dir eval_summary]
"""
from __future__ import annotations

import argparse
import os

from supnerf_tpu_torch.eval.aggregate import (
    collect_eval_results,
    figure_entry,
    write_eval_json,
)

COLORS = ["b", "r", "g", "m", "c", "k"]


def _find_result(folder: str, stem: str):
    """stem.pkl (the drivers') or stem.pth (the reference's) in folder."""
    for ext in (".pkl", ".pth"):
        path = os.path.join(folder, stem + ext)
        if os.path.exists(path):
            return path
    return None


def main(argv=None):
    """Returns {'out': the JSON path, 'aggregates': one aggregate per file}."""
    p = argparse.ArgumentParser("supnerf_tpu_torch eval_saved_result")
    p.add_argument("results", nargs="*")
    p.add_argument("--cross_eval", type=str, default=None)
    p.add_argument("--out", type=str, default="eval.json")
    p.add_argument("--max_iter", type=int, default=100)
    p.add_argument("--rot_outlier_ignore", action="store_true")
    p.add_argument("--model-folder", dest="model_folder", default=None)
    p.add_argument("--test-folder", dest="test_folder", default="test_nuscenes")
    p.add_argument("--legend-name", dest="legend_name", default=None)
    p.add_argument("--plot-cross-view", dest="plot_cross_view", action="store_true")
    p.add_argument("--save-dir", dest="save_dir", default="eval_summary")
    args = p.parse_args(argv)

    results, cross_eval, out = list(args.results), args.cross_eval, args.out
    if args.model_folder is not None:
        if results or args.cross_eval or args.out != "eval.json":
            p.error("--model-folder mode is mutually exclusive with explicit result files / "
                    "--cross_eval / --out")
        folder = os.path.join(args.model_folder, args.test_folder)
        path = _find_result(folder, "codes+poses")
        if path is None:
            raise SystemExit(f"no codes+poses result under {folder}")
        results = [path]
        if args.plot_cross_view:
            cross_eval = _find_result(folder, "cross_eval")
        os.makedirs(args.save_dir, exist_ok=True)
        out = os.path.join(args.save_dir, (args.legend_name or "eval") + ".json")
    elif not results:
        p.error("provide result files or --model-folder/--test-folder")

    if args.legend_name:
        print(f"==================== Evaluating {args.legend_name} ====================")
    aggs, entries = [], []
    for i, path in enumerate(results):
        agg = collect_eval_results(path, max_iter=args.max_iter, cross_eval_file=cross_eval,
                                   rot_outlier_ignore=args.rot_outlier_ignore)
        aggs.append(agg)
        entries.append(figure_entry(path, agg, COLORS[i % len(COLORS)], args.legend_name))
    write_eval_json(out, entries)
    print(f"saved {out}")
    return {"out": out, "aggregates": aggs}


if __name__ == "__main__":
    main()
