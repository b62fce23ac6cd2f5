"""What the batch-layout-exact arithmetic of run_tto_batch costs on the card.

    python -m supnerf_tpu_torch.bench.tto_layout_ab [--batches 4 16]

On the card only. run_tto_batch on `batch` synthetic objects at the
published config (jsonfiles/supnerf.nusc.vehicle.car.json, random weights
from seed 0, the driver's TTO settings, draws from seed 0), for each batch
size after one warm-up run, in the order A B C C B A:

    A  the program: the latent projections as one batched (1, latent) row
       product per object and layer, the refiner one object at a time;
    B  rows_at_once: one latent einsum and one refiner Linear over all B
       rows, as the port ran them before (an object's rows then round with
       B on the CPU);
    C  loop: the latent projections one object at a time, a Python loop of
       B einsums per projection.

Prints, per run, the card's time of run_tto_batch's encode_refine and
tto_loop phases (CUDA events) and the wall time on the host's clock to the
card's last result, then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from supnerf_tpu_torch.bench.prep_overlap import PUBLISHED
from supnerf_tpu_torch.cli.common import SyntheticDataset
from supnerf_tpu_torch.config import load_hpams
from supnerf_tpu_torch.models.factory import build_model, init_model
from supnerf_tpu_torch.ops import field, render
from supnerf_tpu_torch.timing import PhaseTimer
from supnerf_tpu_torch.tto import core
from supnerf_tpu_torch.tto.driver import TTODriver


def _swapped(latents=None, refiner=None):
    """A context manager that runs run_tto_batch with conditioned_latents
    and/or the refiner's pose_update swapped."""
    @contextlib.contextmanager
    def swapped():
        own = (render.conditioned_latents, field.conditioned_latents, core.fw_pose_refine)
        if latents is not None:
            render.conditioned_latents = field.conditioned_latents = latents
        if refiner is not None:
            core.fw_pose_refine = lambda _fn, *a, **kw: own[2](refiner, *a, **kw)
        try:
            yield
        finally:
            render.conditioned_latents, field.conditioned_latents, core.fw_pose_refine = own

    return swapped()


def rows_at_once(model):
    """The latent projections and the refiner's layers over all B rows at
    once (a context manager)."""
    def latents(wts, shapecode, texturecode):
        return (F.relu(torch.einsum("bl,jlw->bjw", shapecode, wts.w_shape_latent)
                       + wts.b_shape_latent),
                F.relu(torch.einsum("bl,jlw->bjw", texturecode, wts.w_tex_latent)
                       + wts.b_tex_latent))

    return _swapped(latents, model.pose_update)


def latents_loop():
    """The latent projections one object at a time (a context manager)."""
    def each(code, w, b):
        return torch.cat([F.relu(torch.einsum("bl,jlw->bjw", code[i:i + 1], w) + b)
                          for i in range(len(code))])

    def latents(wts, shapecode, texturecode):
        return (each(shapecode, wts.w_shape_latent, wts.b_shape_latent),
                each(texturecode, wts.w_tex_latent, wts.b_tex_latent))

    return _swapped(latents)


def measure(batch: int) -> dict:
    hpams = load_hpams(PUBLISHED)
    model = init_model(build_model(hpams["arch"], hpams["net_hyperparams"]), 0).cuda()
    zeros = np.zeros(hpams["net_hyperparams"]["latent_dim"], np.float32)
    with tempfile.TemporaryDirectory() as d:
        driver = TTODriver(model, zeros, zeros, hpams, SyntheticDataset(batch), d,
                           device="cuda", batch_size=batch)
        _, _, arrays = driver._prep_arrays(list(range(batch)))
    cfg = driver.cfg
    objects = core.ObjectBatch.from_numpy(arrays, "cuda")
    draws = core.tto_draws(cfg, batch, torch.Generator(device="cuda").manual_seed(0), "cuda")
    wts = core.render_decoder(model)
    means = [torch.as_tensor(m, device="cuda") for m in (zeros, zeros)]
    variants = {"program": contextlib.nullcontext, "rows_at_once": lambda: rows_at_once(model),
                "loop": latents_loop}

    def run(variant):
        timer = PhaseTimer("cuda")
        with variants[variant]():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            core.run_tto_batch(model, wts, objects, *means, cfg, timer=timer, **draws)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        timer.collect()
        return {"variant": variant, "wall_s": wall, **timer.seconds}

    run("program")                      # warm-up: the kernels' build, cuBLAS's choices
    return {"batch": batch, "num_opts": cfg.num_opts,
            "runs": [run(v) for v in ("program", "rows_at_once", "loop",
                                      "loop", "rows_at_once", "program")]}


def main(argv=None):
    p = argparse.ArgumentParser("supnerf_tpu_torch tto_layout_ab")
    p.add_argument("--batches", type=int, nargs="+", default=[4, 16])
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tto_layout_ab runs on the card")
    for batch in args.batches:
        print(json.dumps(measure(batch)))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])


if __name__ == "__main__":
    main()
