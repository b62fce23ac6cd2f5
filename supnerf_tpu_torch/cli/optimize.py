"""Test-time optimization CLI of the port (reference optimize_nuscenes.py).

    python -m supnerf_tpu_torch.cli.optimize \\
        --config_file jsonfiles/supnerf.nusc.vehicle.car.json \\
        --dataset synthetic --num_objects 2 --batch_size 2 [--device cpu]

Optimizes every object, writes codes+poses.pkl (+ .pth) and cross_eval.pkl,
and prints the aggregated metric table (the eval.pdf plot is not ported yet).
"""
from __future__ import annotations

import argparse
import os

from supnerf_tpu_torch.cli.common import add_optimize_args, build_dataset, load_model_and_codes
from supnerf_tpu_torch.config import find_config, load_hpams
from supnerf_tpu_torch.device import resolve_device
from supnerf_tpu_torch.eval.aggregate import (
    aggregate_cross_eval,
    aggregate_metrics,
    print_eval_results,
)
from supnerf_tpu_torch.tto.driver import TTODriver


def _save_postfix(args) -> str:
    """The reference's protocol-descriptive folder name (optimize_nuscenes.py:89-119)."""
    post = f"_synthetic_opt_pose_{args.opt_pose}"
    if args.add_pose_err == 2:
        post += "_poss_err_full"
    return post + f"_reg_iters_{args.reg_iters}"


def main(argv=None):
    """Returns {'save_dir', 'aggregate', 'cross', 'phase_seconds'}."""
    p = argparse.ArgumentParser("supnerf_tpu_torch optimize")
    args = add_optimize_args(p).parse_args(argv)
    device = resolve_device(args.device)
    hpams = load_hpams(find_config(args.config_file))
    model, mean_shape, mean_texture = load_model_and_codes(hpams, device, args.model_epoch,
                                                           args.seed)
    dataset = build_dataset(hpams, args)
    save_dir = args.save_dir or os.path.join(
        hpams.get("model_dir", "checkpoints"),
        f"test{_save_postfix(args)}{args.save_postfix}")
    driver = TTODriver(
        model, mean_shape, mean_texture, hpams, dataset, save_dir, device=device,
        opt_pose=args.opt_pose, reg_iters=args.reg_iters, add_pose_err=args.add_pose_err,
        batch_size=args.batch_size, save_freq=args.save_freq, seed=args.seed,
        rand_angle_lim=args.rand_angle_lim)
    result = driver.run()
    cross = aggregate_cross_eval(driver.eval_cross_view())
    agg = aggregate_metrics(result, max_iter=hpams["optimize"]["num_opts"])
    print(f"Processing {os.path.join(save_dir, 'codes+poses.pkl')}")
    print_eval_results(agg, cross)
    print("phase seconds: " + ", ".join(f"{k} {v:.2f}" for k, v in driver.timer.seconds.items()))
    return {"save_dir": save_dir, "aggregate": agg, "cross": cross,
            "phase_seconds": dict(driver.timer.seconds)}


if __name__ == "__main__":
    main()
