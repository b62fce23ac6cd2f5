"""The TTO driver's pipelined run against its serial order on the card.

    python -m supnerf_tpu_torch.bench.tto_pipeline_ab [--objects 8] [--batch_size 2]

On the card only. TTODriver over `objects` synthetic objects at the
published config (jsonfiles/supnerf.nusc.vehicle.car.json, random weights
from seed 0, add_pose_err 2), after one warm-up batch, four times: a loop
of optimize_object_batch (the serial order), run (pipelined), run, the
loop again. Prints each run's wall time on the host's clock to the card's
last result, its launch counts and phase seconds, whether the four
codes+poses.pkl are the same bytes, and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile
import time

import numpy as np
import torch

from supnerf_tpu_torch.bench.prep_overlap import PUBLISHED
from supnerf_tpu_torch.cli.common import SyntheticDataset
from supnerf_tpu_torch.config import load_hpams
from supnerf_tpu_torch.models.factory import build_model, init_model
from supnerf_tpu_torch.ops import render
from supnerf_tpu_torch.tto.driver import TTODriver


def measure(objects: int = 8, batch_size: int = 2) -> dict:
    hpams = load_hpams(PUBLISHED)
    model = init_model(build_model(hpams["arch"], hpams["net_hyperparams"]), 0).cuda()
    zeros = np.zeros(hpams["net_hyperparams"]["latent_dim"], np.float32)
    runs, files = [], []
    with tempfile.TemporaryDirectory() as d:        # warm-up: the kernels' build, cuDNN
        TTODriver(model, zeros, zeros, hpams, SyntheticDataset(batch_size), d, device="cuda",
                  batch_size=batch_size).optimize_object_batch(list(range(batch_size)))
    for order in ("serial", "pipelined", "pipelined", "serial"):
        with tempfile.TemporaryDirectory() as d:
            drv = TTODriver(model, zeros, zeros, hpams, SyntheticDataset(objects), d,
                            device="cuda", batch_size=batch_size, add_pose_err=2, seed=0)
            render.reset_launch_counts()
            t0 = time.perf_counter()
            if order == "serial":
                for start in range(0, objects, batch_size):
                    drv.optimize_object_batch(list(range(start, min(start + batch_size,
                                                                    objects))))
                drv.save_results()
                drv.save_results_pth()
            else:
                drv.run()
            torch.cuda.synchronize()
            runs.append({"order": order, "wall_s": time.perf_counter() - t0,
                         "launches": {k: v for k, v in render.LAUNCHES.items() if v},
                         "phase_seconds": dict(drv.timer.seconds)})
            with open(os.path.join(d, "codes+poses.pkl"), "rb") as f:
                files.append(f.read())
    return {"objects": objects, "batch_size": batch_size, "runs": runs,
            "results_same_bytes": all(f == files[0] for f in files)}


def main(argv=None):
    p = argparse.ArgumentParser("supnerf_tpu_torch tto_pipeline_ab")
    p.add_argument("--objects", type=int, default=8)
    p.add_argument("--batch_size", type=int, default=2)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tto_pipeline_ab runs on the card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps(measure(args.objects, args.batch_size)))


if __name__ == "__main__":
    main()
