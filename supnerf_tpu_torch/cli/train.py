"""Training CLI of the port (reference train_nuscenes.py).

    python -m supnerf_tpu_torch.cli.train \\
        --config_file jsonfiles/supnerf.nusc.vehicle.car.json \\
        --dataset synthetic --num_objects 16 --batch_size 8 --epochs 2 [--device cpu]

Trains the unified SUP-NeRF model from fresh weights (seeded) and writes
epoch_{n}.pth, models.pth, epoch_{n}_optim.pth, instoken2idx.json and
hpam.json into --save_dir; --resume_from_epoch continues from a checkpoint.
"""
from __future__ import annotations

import argparse
import os
import time
from datetime import date

from supnerf_tpu_torch.cli.common import build_dataset
from supnerf_tpu_torch.config import find_config, load_hpams
from supnerf_tpu_torch.device import resolve_device
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
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="cuda (default; fails without a card) or cpu")
    p.add_argument("--dataset", type=str, default=None,
                   help="nusc (split train) or synthetic (default: the config's)")
    p.add_argument("--nusc-version", dest="nusc_version", type=str, default=None)
    p.add_argument("--seg_source", type=str, default="instance")
    p.add_argument("--num_objects", type=int, default=32, help="synthetic dataset size")
    p.add_argument("--save_every", type=int, default=1,
                   help="checkpoint every N epochs (the last epoch is always saved)")
    p.add_argument("--check_iter", type=int, default=1000, help="print the losses every N steps")
    p.add_argument("--im_enc_rate", type=float, default=1.0,
                   help="1 (other rates are queued in ROADMAP.md)")
    for flag in ("aug_box2d", "aug_wlh", "finetune_wlh"):
        p.add_argument(f"--{flag}", type=int, default=0, choices=[0, 1],
                       help="0 (1 is queued in ROADMAP.md)")
    return p


def main(argv=None):
    """Returns {'save_dir', 'metrics' (one dict per step), 'phase_seconds',
    'seconds', 'steps'}."""
    args = add_train_args(argparse.ArgumentParser("supnerf_tpu_torch train")).parse_args(argv)
    for flag in ("aug_box2d", "aug_wlh", "finetune_wlh"):
        if getattr(args, flag):
            raise NotImplementedError(f"--{flag} 1 is queued in ROADMAP.md; no published "
                                      "training run sets it")
    device = resolve_device(args.device)
    hpams = load_hpams(find_config(args.config_file))
    model = init_model(build_model(hpams["arch"], hpams["net_hyperparams"]), args.seed)
    dataset = build_dataset(hpams, args, split="train")
    save_dir = args.save_dir or os.path.join(
        "checkpoints", hpams["arch"], f"train_{date.today().strftime('%Y_%m_%d')}")
    trainer = UnifiedTrainer(model, hpams, dataset, save_dir, device=device,
                             batch_size=args.batch_size, im_enc_rate=args.im_enc_rate,
                             seed=args.seed, check_iter=args.check_iter,
                             save_every=args.save_every)
    if args.resume_from_epoch is not None:
        trainer.resume_from_epoch(args.resume_dir or save_dir, args.resume_from_epoch)
    t0 = time.perf_counter()
    trainer.train(args.epochs)
    seconds = time.perf_counter() - t0
    steps = len(trainer.metrics_history)
    print(f"training done: {steps} steps in {seconds:.2f} s; checkpoints in {save_dir}")
    print("phase seconds: " + ", ".join(f"{k} {v:.2f}" for k, v in trainer.timer.seconds.items()))
    return {"save_dir": save_dir, "metrics": trainer.metrics_history,
            "phase_seconds": dict(trainer.timer.seconds), "seconds": seconds, "steps": steps}


if __name__ == "__main__":
    main()
