"""Full-image demo of the port (supnerf_tpu/cli/demo.py; reference
scripts/demo.py): reconstruct every car of one image by test-time
optimization with AABB-bounded loss renders, then re-render the composed
scene from manipulated object poses.

    python -m supnerf_tpu_torch.cli.demo --dataset synthetic [--device cpu]

Writes input.png and one PNG per manipulated frame (scene_00.png, ...;
utils/image_io.py says why not a GIF) into --save_dir, beside the TTO
driver's codes+poses files. --dataset nusc --img_name <file name> takes
every car the segmentation found in that camera image of the config's
nuScenes test data (data.nuscenes.get_objects_in_image); --dataset
synthetic builds a 900 x 1600 scene of three synthetic cars. The device
flags are the optimize CLI's: --devices N splits the scene's cars, the
demo's one batch, over N ranks, so N must divide their number (checked
before any file is written); rank 0 composes the frames. --profile_dir is
accepted and traces nothing, as in the JAX demo.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from supnerf_tpu_torch.cli.common import (
    add_device_args,
    device_from_args,
    launch_plan,
    load_model_and_codes,
)
from supnerf_tpu_torch.config import find_config, load_hpams
from supnerf_tpu_torch.data.synthetic import make_synthetic_object
from supnerf_tpu_torch.ops.render import conditioned_latents, decoder_field, decoder_plain
from supnerf_tpu_torch.parallel.mesh import launch
from supnerf_tpu_torch.render.compositor import render_scene_window, scene_window_from_objects
from supnerf_tpu_torch.tto.driver import TTODriver, tto_config_from_hpams
from supnerf_tpu_torch.utils.image_io import image_float_to_uint8, write_png

# translations added to every object's pose, one frame each
MANIPULATIONS = [[0, 0, 0], [-1, 0, 1], [-2, 0, 2], [-3, 0, 3], [-4, 0, 4], [-5, 0, 5]]


def synthetic_scene(n_objects: int = 3, img_h: int = 900, img_w: int = 1600):
    """A multi-object synthetic image with per-object masks and ROIs."""
    objs = []
    for i in range(n_objects):
        s = make_synthetic_object(seed=200 + i, img_h=img_h, img_w=img_w)
        s.update(instoken=f"demo_ins_{i}", anntoken=f"demo_ann_{i}", cam_ids="CAM_FRONT")
        objs.append(s)
    img = np.ones((img_h, img_w, 3), np.float32)
    for s in objs:
        m = s["masks_occ"] > 0
        img[m] = s["imgs"][m]
    return img, objs


def main(argv=None):
    """Returns {'save_dir', 'frames' (paths), 'images' (float frames),
    'tto_seconds', 'phase_seconds' (the driver's), 'frame_seconds', 'win_hw',
    'results', 'wlh_used', 'hit_share' (per object and iteration, the share
    of the loss render's rays that hit the box)}: with --devices, rank 0's,
    and None on the other ranks."""
    p = argparse.ArgumentParser("supnerf_tpu_torch demo")
    p.add_argument("--config_file", type=str, default="hpam_demo.json")
    p.add_argument("--seed", type=int, default=0)
    add_device_args(p)
    p.add_argument("--dataset", type=str, default="synthetic", help="synthetic or nusc")
    p.add_argument("--img_name", type=str, default=None,
                   help="the nuScenes camera image to run on (--dataset nusc)")
    p.add_argument("--save_dir", type=str, default="demo_output")
    p.add_argument("--num_opts", type=int, default=None)
    p.add_argument("--n_objects", type=int, default=3)
    p.add_argument("--render_scale", type=int, default=4,
                   help="downscale factor for the composed scene render")
    args = p.parse_args(argv)
    if args.dataset not in ("synthetic", "nusc"):
        raise ValueError(f"dataset {args.dataset!r}: the demo runs synthetic or nusc, as the "
                         "JAX demo")
    if args.dataset == "nusc" and not args.img_name:
        raise ValueError("--dataset nusc needs --img_name")
    known = {"the scene's cars": args.n_objects} if args.dataset == "synthetic" else {}
    plan = launch_plan(args, **known)
    return launch(plan, _demo, args)


def _demo(group, args):
    """The run on one rank of `group`, or alone (group None)."""
    device = device_from_args(args, group)
    hpams = load_hpams(find_config(args.config_file))
    if args.num_opts:
        hpams["optimize"]["num_opts"] = args.num_opts
    model, mean_shape, mean_texture = load_model_and_codes(hpams, device, seed=args.seed)

    if args.dataset == "nusc":
        from supnerf_tpu_torch.data.nuscenes import NuScenesData

        found = NuScenesData(hpams, split="val", add_pose_err=2).get_objects_in_image(
            args.img_name)
        img, objects = found["img"], found["objects"]
        if not objects:
            raise ValueError(f"{args.img_name}: the segmentation found no "
                             f"{hpams['dataset'].get('seg_cat', 'car')}")
    else:
        ds_cfg = hpams.get("dataset", {})
        img, objects = synthetic_scene(args.n_objects, ds_cfg.get("img_h", 900),
                                       ds_cfg.get("img_w", 1600))
    if group is not None and len(objects) % group.world:
        raise ValueError(f"the scene's cars {len(objects)} do not split over {group.world} "
                         "ranks: each rank takes an equal share")
    if group is None or group.main:
        os.makedirs(args.save_dir, exist_ok=True)
        write_png(os.path.join(args.save_dir, "input.png"), image_float_to_uint8(img))

    # the reference demo optimizes with AABB-bounded sampling (rend_aabb=True,
    # scripts/demo.py:616)
    cfg = tto_config_from_hpams(hpams, reg_iters=3,
                                pred_wlh=hpams["net_hyperparams"].get("pred_wlh", 0))
    cfg = dataclasses.replace(cfg, use_aabb_render=True)
    driver = TTODriver(model, mean_shape, mean_texture, hpams, objects, args.save_dir,
                       device=device, cfg=cfg, opt_pose=1, reg_iters=3, add_pose_err=2,
                       batch_size=len(objects), seed=args.seed, group=group)
    t0 = time.perf_counter()
    results = driver.run()
    tto_seconds = time.perf_counter() - t0
    if not driver.main:
        return None
    for k, share in driver.hit_share.items():
        print(f"  {k}: loss rays in the box {np.mean(share):.4f} on average "
              f"({np.min(share):.4f} .. {np.max(share):.4f})")

    # the final codes and poses; the scene uses the annotated box sizes
    keys = [(s["anntoken"], s["cam_ids"]) for s in objects]
    shapecodes = torch.as_tensor(
        np.stack([driver.optimized_shapecodes[a][c][-1] for a, c in keys]), device=device)
    texturecodes = torch.as_tensor(
        np.stack([driver.optimized_texturecodes[a][c][-1] for a, c in keys]), device=device)
    poses0 = np.stack([driver.optimized_poses[a][c][-1] for a, c in keys])
    wlhs = np.stack([np.asarray(s["wlh"], np.float32) for s in objects])
    K = objects[0]["cam_intrinsics"]
    img_h, img_w = img.shape[:2]

    # one static window covering every manipulated position
    all_poses = []
    for dt in MANIPULATIONS:
        pp = poses0.copy()
        pp[:, :, 3] += np.asarray(dt, np.float32)
        all_poses.append(pp)
    window = scene_window_from_objects(np.concatenate(all_poses),
                                       np.tile(wlhs, (len(MANIPULATIONS), 1)), K, img_h, img_w,
                                       margin=8)
    sc = args.render_scale
    win_hw = (max(int(window[2] - window[0]) // sc, 16), max(int(window[3] - window[1]) // sc, 16))
    K_scaled = torch.as_tensor(np.diag([1 / sc, 1 / sc, 1.0]).astype(np.float32) @ K,
                               device=device)
    window_scaled = torch.as_tensor(window / sc, device=device)
    wts = driver.wts

    if getattr(wts, "field_dtype", "float32") == "bfloat16":
        def field_fn(xyz, vd, s_code, t_code):
            # as the JAX compositor's model.apply: flax TorchDense's bfloat16
            # contract (models/nerf_mlp.decode_bf16), not the kernels'
            sigma, rgb = decoder_field(driver.model, xyz, vd[:, :, None, :], s_code, t_code)
            return sigma[..., 0], rgb
    else:
        def field_fn(xyz, vd, s_code, t_code):
            return decoder_plain(wts, xyz, vd, *conditioned_latents(wts, s_code, t_code))

    print("Novel-view rendering frame by frame ...")
    frames, images, frame_seconds = [], [], []
    for fi, pp in enumerate(all_poses):
        t0 = time.perf_counter()
        with torch.no_grad():
            rgb, _ = render_scene_window(
                field_fn, torch.as_tensor(pp, device=device),
                torch.as_tensor(wlhs, device=device), shapecodes, texturecodes, K_scaled,
                window_scaled, win_hw, n_samples=hpams["n_samples"],
                shapenet_obj_cood=bool(hpams.get("shapenet_obj_cood", 1)), chunk=1024, generator=torch.Generator(device=device).manual_seed(fi))
            rgb = rgb.cpu().numpy()
        frame_seconds.append(time.perf_counter() - t0)
        path = os.path.join(args.save_dir, f"scene_{fi:02d}.png")
        write_png(path, image_float_to_uint8(rgb))
        frames.append(path)
        images.append(rgb)
    print(f"saved {len(frames)} frames of {win_hw[0]} x {win_hw[1]} to {args.save_dir}")
    return {"save_dir": args.save_dir, "frames": frames, "images": images,
            "tto_seconds": tto_seconds, "phase_seconds": dict(driver.timer.seconds),
            "frame_seconds": frame_seconds, "win_hw": win_hw,
            "results": results, "wlh_used": driver.wlh_used, "hit_share": driver.hit_share}


if __name__ == "__main__":
    main()
