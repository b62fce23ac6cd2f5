"""Test-time optimization CLI of the port (reference optimize_nuscenes.py,
optimize_kitti.py, optimize_waymo.py; JAX supnerf_tpu/cli/optimize.py).

    python -m supnerf_tpu_torch.cli.optimize \\
        --config_file jsonfiles/supnerf.nusc.vehicle.car.json [--dataset nusc] [--device cpu]
    python -m supnerf_tpu_torch.cli.optimize --dataset synthetic --num_objects 2

The dataset comes from --dataset or the config (nusc, kitti, waymo or
synthetic); KITTI and Waymo run in the KITTI object frame
(cli.optimize_kitti and cli.optimize_waymo add their reference defaults).
Optimizes every object, writes codes+poses.pkl (+ .pth), and for nusc and
synthetic the cross-view evaluation's cross_eval.pkl, prints the
aggregated metric table (eval.aggregate.collect_eval_results) and writes
eval.json, the 2x2 figure's curves as data (the JAX CLI's eval.pdf). The
protocol flags: --opt_pose 0|1|2 (2: the PnP bootstrap), --pred_wlh
0|1|2, --code_level 0|1|2; --opt_multiview 1 runs the multiview TTO
(codes_multiview.pkl) and stops; --cross_eval_folder DIR evaluates DIR's
codes+poses.pkl again without optimizing; --vis 1|2 writes each object's
panels (opt{t:03d}.png, virt_final.png) into <save_dir>/<annotation>_<camera>/
and fills ssim_eval. From the config, as in the JAX
CLI: the regularisers "sym_aug": 1 and "obj_sz_reg": 1 (with
"loss_obj_sz_coef"), and the pose parameters "euler_rot": 1 and
"optimize": {"opt_cam_pose": 1}. --device cuda|cpu; --profile_dir DIR
writes a torch.profiler trace of the optimization (the span JAX's
maybe_profile wraps) to DIR/trace.json. The JAX CLI's --devices, --gpu,
--coordinator and --num_workers are accepted and select nothing
(cli/common.add_device_args).
"""
from __future__ import annotations

import argparse
import os
import pickle

from supnerf_tpu_torch.cli.common import (
    add_optimize_args,
    build_dataset,
    dataset_name,
    device_from_args,
    load_model_and_codes,
    maybe_profile,
)
from supnerf_tpu_torch.config import find_config, load_hpams
from supnerf_tpu_torch.eval.aggregate import (
    collect_eval_results,
    figure_entry,
    write_eval_json,
)
from supnerf_tpu_torch.tto.driver import TTODriver


def _auto_save_postfix(args, hpams: dict, ds_name: str) -> str:
    """The reference's protocol-descriptive results-folder postfix
    (optimize_nuscenes.py:89-119, optimize_kitti.py:71-88), by which the
    evaluation scripts find a run's folder; the JAX CLI's."""
    post = f"_{'nuscenes' if ds_name == 'nusc' else ds_name}"
    if args.opt_multiview:
        post += "_multiview"
    post += f"_opt_pose_{args.opt_pose}"
    if args.add_pose_err == 1:
        # the driver's fallback chain: flag, then config, then default
        rot = (args.init_rot_err if args.init_rot_err is not None
               else hpams.get("init_rot_err", 0.0))
        trans = (args.init_trans_err if args.init_trans_err is not None
                 else hpams.get("init_trans_err", 0.2))
        post += f"_rot_err_{rot}_trans_err_{trans}"
    elif args.add_pose_err == 2:
        post += "_poss_err_full"
    elif args.add_pose_err == 3:
        post += "_poss_pred_det3d"
    if hpams.get("arch") == "supnerf":
        post += f"_reg_iters_{args.reg_iters}"
    if hpams.get("net_hyperparams", {}).get("pred_wlh", 0) > 0 and args.pred_wlh:
        post += f"_pred_wlh{args.pred_wlh}"
    if args.pred_box2d:
        post += "_pred_box2d"
    if ds_name == "nusc":
        # the version NuScenesData resolves, so default-trainval runs are
        # named '_full_val' as the reference's
        ds_cfg = hpams.get("dataset", {})
        version = args.nusc_version or ds_cfg.get(
            "test_nusc_version", ds_cfg.get("train_nusc_version", "v1.0-trainval"))
        if "trainval" in version:
            post += "_full_val"
    if args.num_subset != 1:
        post += f"_subset_{args.id_subset}_of_{args.num_subset}"
    return post


def main(argv=None):
    """Returns {'save_dir', 'aggregate' (None for --opt_multiview), 'cross'
    (None for KITTI and Waymo), 'phase_seconds', 'loss' (per object, or per
    instance with --opt_multiview, the per-iteration TTO loss),
    'n_objects', 'pnp_translations' (opt_pose 2: the objects whose PnP
    translation was taken), 'multiview' (the multiview results dict)}."""
    p = argparse.ArgumentParser("supnerf_tpu_torch optimize")
    args = add_optimize_args(p).parse_args(argv)
    device = device_from_args(args)
    hpams = load_hpams(find_config(args.config_file))
    ds_name = dataset_name(hpams, args)
    model, mean_shape, mean_texture = load_model_and_codes(hpams, device, args.model_epoch,
                                                           args.seed)
    dataset = build_dataset(hpams, args, split="val")
    save_dir = args.cross_eval_folder or args.save_dir or os.path.join(
        hpams.get("model_dir", "checkpoints"),
        f"test{_auto_save_postfix(args, hpams, ds_name)}{args.save_postfix}")
    driver = TTODriver(
        model, mean_shape, mean_texture, hpams, dataset, save_dir, device=device,
        opt_pose=args.opt_pose, reg_iters=args.reg_iters,
        dataset_frame=ds_name if ds_name in ("kitti", "waymo") else "nusc",
        pred_wlh=args.pred_wlh, add_pose_err=args.add_pose_err, batch_size=args.batch_size,
        save_freq=args.save_freq, seed=args.seed, init_rot_err=args.init_rot_err,
        init_trans_err=args.init_trans_err, rand_angle_lim=args.rand_angle_lim,
        code_level=args.code_level, vis=args.vis)
    summary = {"save_dir": save_dir, "aggregate": None, "cross": None, "n_objects": len(dataset),
               "multiview": None}
    result_file = os.path.join(save_dir, "codes+poses.pkl")
    if args.cross_eval_folder:
        # evaluation only, from a finished run's codes (JAX cli/optimize.py:87-110)
        with open(result_file, "rb") as f:
            saved = pickle.load(f)
        for key in ("optimized_shapecodes", "optimized_texturecodes", "optimized_poses"):
            setattr(driver, key, saved[key])
        driver.code_level = saved.get("code_level", 2)
    elif args.opt_multiview:
        with maybe_profile(args):
            summary["multiview"] = driver.run_multiview(opt_pose=args.opt_pose > 0)
    else:
        with maybe_profile(args):
            driver.run()
    if not args.opt_multiview:
        cross = driver.eval_cross_view() if ds_name in ("nusc", "synthetic") else None
        agg = collect_eval_results(
            result_file, max_iter=hpams["optimize"]["num_opts"],
            cross_eval_file=os.path.join(save_dir, "cross_eval.pkl") if cross else None)
        write_eval_json(os.path.join(save_dir, "eval.json"), [figure_entry(result_file, agg)])
        summary.update(aggregate=agg, cross=agg.get("cross"))
    print("phase seconds: " + ", ".join(f"{k} {v:.2f}" for k, v in driver.timer.seconds.items()))
    return dict(summary, phase_seconds=dict(driver.timer.seconds), loss=driver.loss_curve,
                pnp_translations=driver.pnp_translations if args.opt_pose == 2 else None)


if __name__ == "__main__":
    main()
