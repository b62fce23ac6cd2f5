"""A B B A timing of the training loop on the card: cuDNN's deterministic
algorithms on and off, each batch prepared on the main thread before its
step (num_workers 0) and ahead of it on the prefetch thread (4).

    python -m supnerf_tpu_torch.bench.train_loop_ab [--batches 8 48] [--steps 21] [--out PATH]

For each batch size, one epoch of `steps` steps of the published config
(supnerf.nusc.vehicle.car.json, seed 0) per setting, each from a fresh
trainer, the four settings run in the order A B C D D C B A. The epoch's
objects are 2 x batch synthetic objects, cycled (each row still draws its
own rays from (seed, epoch, index)). Per run: the loop's steps/s and its
mean step split (ms) over the steps after the first, which pays its
batch's prep and the warm-up; and a digest of the state the run ends in
(parameters, BatchNorm buffers, code tables, both optimizers' moments),
so that runs which end bit for bit alike share it. Prints one JSON object
with the card's name and power limit (and writes it to --out); needs a
card.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import tempfile

import numpy as np
import torch

SETTINGS = [(False, 0), (False, 4), (True, 0), (True, 4)]   # (deterministic, num_workers)
SPLIT = ("forward", "render", "backward", "optimizer", "producer_prep", "producer_upload",
         "main_wait_batch")


class _Cycled:
    """n objects cycling through `base`, instance i // 2 as the synthetic
    set names them."""

    def __init__(self, base, n: int):
        self.base, self.n = base, n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return dict(self.base[i % len(self.base)], instoken=f"ins_{i // 2}",
                    anntoken=f"ann_{i}")


def _digest(state) -> str:
    h = hashlib.sha256()
    for t in ([*state.model.state_dict().values(), state.shape_codes, state.texture_codes]
              + [*state.opt_model.m, *state.opt_model.v, *state.opt_codes.m,
                 *state.opt_codes.v]):
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def _run(hp, dataset, batch, deterministic, workers, save_dir):
    from supnerf_tpu_torch.models.factory import build_model, init_model
    from supnerf_tpu_torch.training.trainer import UnifiedTrainer

    tr = UnifiedTrainer(init_model(build_model("supnerf", hp["net_hyperparams"]), 0), hp,
                        dataset, save_dir, device="cuda", batch_size=batch, log_writer=False)
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = deterministic
    try:
        tr.training_epoch(num_workers=workers)
    finally:
        torch.backends.cudnn.deterministic = before
    timed = tr.metrics_history[1:]
    step_ms = {"total": 1e3 * float(np.mean([m["seconds"] for m in timed]))}
    step_ms.update({k: 1e3 * float(np.mean([m["phase_seconds"].get(k, 0.0) for m in timed]))
                    for k in SPLIT})
    return {"deterministic": deterministic, "num_workers": workers,
            "steps_per_s": len(timed) / sum(m["seconds"] for m in timed), "step_ms": step_ms,
            "losses": [m["loss_total"] for m in tr.metrics_history],
            "state": _digest(tr.state)}


def main(argv=None):
    p = argparse.ArgumentParser("train_loop_ab")
    p.add_argument("--batches", type=int, nargs="+", default=[8, 48])
    p.add_argument("--steps", type=int, default=21)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    from supnerf_tpu_torch.cli.common import SyntheticDataset
    from supnerf_tpu_torch.config import find_config, load_hpams
    from supnerf_tpu_torch.device import resolve_device

    resolve_device("cuda")
    hp = load_hpams(find_config("supnerf.nusc.vehicle.car.json"))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    out = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi.stdout.strip(),
           "steps": args.steps, "order": "A B C D D C B A", "batches": {}}
    with tempfile.TemporaryDirectory() as tmp:
        for batch in args.batches:
            dataset = _Cycled(SyntheticDataset(2 * batch), batch * args.steps)
            runs = []
            for i, (det, workers) in enumerate(SETTINGS + SETTINGS[::-1]):
                runs.append(_run(hp, dataset, batch, det, workers,
                                 os.path.join(tmp, f"b{batch}_{i}")))
                r = runs[-1]
                print(f"batch {batch} deterministic {det} num_workers {workers}: "
                      f"{r['steps_per_s']:.4f} steps/s, step {r['step_ms']['total']:.2f} ms, "
                      f"state {r['state']}", flush=True)
            out["batches"][str(batch)] = runs
    print(json.dumps(out))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
