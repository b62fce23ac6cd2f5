"""Training CLI of the port (reference train_nuscenes.py).

    python -m supnerf_tpu_torch.cli.train \\
        --config_file jsonfiles/supnerf.nusc.vehicle.car.json \\
        --dataset synthetic --num_objects 16 --batch_size 8 --epochs 2 [--device cpu]

Trains the config's arch from fresh weights (seeded): SUP-NeRF with the
unified loss, the baselines (autorf, autorfmix, autorf_original, codenerf)
with the NeRF-only loss, as the JAX CLI chooses. The JAX CLI's flags, each
under its name: --aug_box2d, --aug_wlh, --finetune_wlh (booleans),
--im_enc_rate, --render_sz (overrides the config's), --num_workers (batches
prepared ahead on that many threads; 0, the default where JAX's is 4,
prepares each before its step: training/trainer.py says why),
--pred_box2d (nuScenes' detected boxes), --save_every, --check_iter,
--seg_source, --nusc-version. --pretrained_model_dir is refused: the JAX
CLI parses it and reads it nowhere. The config json's grad_clip,
lr_schedule_type ("step" or "cosine") and cosine_total_steps set the
optimizer (training/trainer.train_config_from_hpams); the run takes cuDNN's
deterministic algorithms (device.deterministic_cudnn). Writes
epoch_{n}.pth, models.pth, epoch_{n}_optim.pth, instoken2idx.json and
hpam.json into --save_dir, and the training log into --save_dir/runs/:
metrics.jsonl (one line of losses per step) and train_panel_{step:07d}.png
(a [render | target] panel every --check_iter steps);
--resume_from_epoch continues from a checkpoint. --device cuda|cpu;
--profile_dir DIR writes a torch.profiler trace of the training loop (the
span JAX's maybe_profile wraps) to DIR/trace.json. The JAX CLI's --devices,
--gpu, --coordinator and --gpus (taken as --devices where that is not
given) are accepted and select nothing (cli/common.add_device_args).
"""
from __future__ import annotations

import argparse
import os
import time
from datetime import date

from supnerf_tpu_torch.cli.common import (
    add_device_args,
    build_dataset,
    device_from_args,
    maybe_profile,
    str2bool,
)
from supnerf_tpu_torch.config import find_config, load_hpams
from supnerf_tpu_torch.device import deterministic_cudnn
from supnerf_tpu_torch.models.factory import build_model, init_model
from supnerf_tpu_torch.training.trainer import UnifiedTrainer


def add_train_args(p: argparse.ArgumentParser):
    p.add_argument("--config_file", type=str, default="supnerf.nusc.vehicle.car.json")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--epochs", type=int, default=40)
    p.add_argument("--save_dir", type=str, default=None)
    p.add_argument("--resume_from_epoch", type=int, default=None)
    p.add_argument("--resume_dir", type=str, default=None)
    p.add_argument("--seed", type=int, default=0)
    add_device_args(p)
    p.add_argument("--gpus", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--dataset", type=str, default=None,
                   help="nusc (split train) or synthetic (default: the config's)")
    p.add_argument("--nusc-version", dest="nusc_version", type=str, default=None)
    p.add_argument("--seg_source", type=str, default="instance")
    p.add_argument("--num_objects", type=int, default=32, help="synthetic dataset size")
    p.add_argument("--save_every", type=int, default=1,
                   help="checkpoint every N epochs (the last epoch is always saved)")
    p.add_argument("--check_iter", type=int, default=1000,
                   help="print the losses and write a render panel every N steps")
    p.add_argument("--im_enc_rate", type=float, default=1.0,
                   help="the share of steps that use the encoder, in [0, 1]")
    p.add_argument("--aug_box2d", type=str2bool, default=False,
                   help="jitter each 2D box's scale and position")
    p.add_argument("--aug_wlh", type=str2bool, default=False,
                   help="jitter the box size the refiner's losses see")
    p.add_argument("--finetune_wlh", type=str2bool, default=False,
                   help="train the encoder's wlh head (a config with pred_wlh)")
    p.add_argument("--render_sz", type=int, default=None,
                   help="sample the rays on a render_sz square grid (overrides the config's)")
    p.add_argument("--num_workers", type=int, default=0,
                   help="host threads preparing batches ahead of the step; 0 (the default): "
                        "each batch before its step")
    p.add_argument("--pred_box2d", type=int, default=0,
                   help="nuScenes: detected 2D boxes instead of the projected ground truth")
    p.add_argument("--pretrained_model_dir", type=str, default=None,
                   help="refused: the JAX CLI parses it and reads it nowhere")
    return p


def main(argv=None):
    """Returns {'save_dir', 'metrics' (one dict per step), 'phase_seconds',
    'seconds', 'steps'}."""
    args = add_train_args(argparse.ArgumentParser("supnerf_tpu_torch train")).parse_args(argv)
    if args.pretrained_model_dir is not None:
        raise ValueError("--pretrained_model_dir: the JAX CLI parses it and reads it nowhere, so "
                         "a warm start from it would be a feature the JAX package lacks")
    if not 0.0 <= args.im_enc_rate <= 1.0:
        raise ValueError(f"--im_enc_rate {args.im_enc_rate}: a rate in [0, 1]")
    if args.num_workers < 0:
        raise ValueError("--num_workers: 0 or more")
    if args.devices is None and args.gpus:
        args.devices = args.gpus
    device = device_from_args(args)
    hpams = load_hpams(find_config(args.config_file))
    if args.render_sz:
        hpams["render_sz"] = args.render_sz
    model = init_model(build_model(hpams["arch"], hpams["net_hyperparams"]), args.seed)
    dataset = build_dataset(hpams, args, split="train")
    save_dir = args.save_dir or os.path.join(
        "checkpoints", hpams["arch"], f"train_{date.today().strftime('%Y_%m_%d')}")
    loss_mode = "unified" if hpams["arch"] == "supnerf" else "nerf_only"
    trainer = UnifiedTrainer(model, hpams, dataset, save_dir, device=device,
                             batch_size=args.batch_size, loss_mode=loss_mode,
                             im_enc_rate=args.im_enc_rate, aug_wlh=args.aug_wlh,
                             aug_box2d=args.aug_box2d, finetune_wlh=args.finetune_wlh,
                             seed=args.seed, check_iter=args.check_iter,
                             save_every=args.save_every)
    cfg = trainer.cfg
    print(f"optimizer: AdamW, lr {cfg.lr_model} (model) / {cfg.lr_codes} (codes), schedule "
          f"{cfg.lr_schedule_type}" + (f" over {cfg.cosine_total_steps} steps"
                                       if cfg.lr_schedule_type == "cosine" else "")
          + f", grad_clip {cfg.grad_clip or 'off'}")
    if args.resume_from_epoch is not None:
        trainer.resume_from_epoch(args.resume_dir or save_dir, args.resume_from_epoch)
    t0 = time.perf_counter()
    with deterministic_cudnn(), maybe_profile(args):
        trainer.train(args.epochs, num_workers=args.num_workers)
    seconds = time.perf_counter() - t0
    steps = len(trainer.metrics_history)
    phase_seconds = {**trainer.timer.seconds, **trainer.host_seconds}
    print(f"training done: {steps} steps in {seconds:.2f} s; checkpoints in {save_dir}")
    print("phase seconds: " + ", ".join(f"{k} {v:.2f}" for k, v in phase_seconds.items()))
    return {"save_dir": save_dir, "metrics": trainer.metrics_history,
            "phase_seconds": phase_seconds, "seconds": seconds, "steps": steps}


if __name__ == "__main__":
    main()
