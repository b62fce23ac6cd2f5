"""What a host prep beside the TTO loop costs the loop, in a thread and in a
process: the measurement behind the TTO driver's prep worker (tto/driver.py
_PrepWorker).

    python -m supnerf_tpu_torch.bench.prep_overlap [--decodes 2] [--objects 2]

On the card only. One batch of `objects` synthetic objects goes through
run_tto_batch at the published config (jsonfiles/supnerf.nusc.vehicle.car.json:
W 256, 3 + 1 blocks, ResNet34, 100 iterations, random weights from seed 0),
timed on the host's clock up to the card's last result:
- alone;
- with a thread beside it that decodes the committed 1600 x 900 JPEG
  (tests/fixtures/nusc_cam_1600x900.jpg) `decodes` times, a nuScenes
  batch's prep (one camera image an object);
- with a process beside it doing the same, forked once before the runs
  (as the driver forks its worker once a run; workers_start_s is the
  thread's and the fork's start).
Runs go in the order alone, thread, process, process, thread, alone, twice,
after one warm-up run. Each run also reports the decodes' own seconds and the
wall time until both were done. Prints the card's name and power limit and
one JSON object.
"""
from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import queue
import subprocess
import tempfile
import threading
import time

import numpy as np
import torch

from supnerf_tpu_torch.bench.decode_seconds import FIXTURE_JPEG
from supnerf_tpu_torch.cli.common import SyntheticDataset
from supnerf_tpu_torch.config import load_hpams
from supnerf_tpu_torch.data.jpeg import read_jpeg
from supnerf_tpu_torch.models.factory import build_model, init_model
from supnerf_tpu_torch.tto.core import run_tto_batch
from supnerf_tpu_torch.tto.driver import TTODriver

PUBLISHED = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "jsonfiles", "supnerf.nusc.vehicle.car.json")


def _decode(n: int) -> float:
    t0 = time.perf_counter()
    for _ in range(n):
        read_jpeg(FIXTURE_JPEG)
    return time.perf_counter() - t0


class _ThreadSide:
    """A thread that decodes `n` times on each go(), as the driver's
    worker would if it were a thread."""

    def __init__(self, n):
        self.go_q, self.done_q = queue.Queue(), queue.Queue()
        self.thread = threading.Thread(target=self._serve, args=(n,), daemon=True)
        self.thread.start()

    def _serve(self, n):
        while self.go_q.get():
            self.done_q.put(_decode(n))

    def go(self):
        self.go_q.put(True)

    def wait(self):
        return self.done_q.get()

    def close(self):
        self.go_q.put(False)
        self.thread.join()


def _serve_decodes(conn, n, threads):
    torch.set_num_threads(threads)
    while conn.recv():
        conn.send(_decode(n))


class _ProcessSide:
    """A process forked once (as the driver forks its worker once a run)
    that decodes `n` times on each go()."""

    def __init__(self, n):
        ctx = multiprocessing.get_context("fork")
        self.conn, child = ctx.Pipe()
        self.proc = ctx.Process(target=_serve_decodes, args=(child, n, torch.get_num_threads()),
                                daemon=True)
        self.proc.start()
        child.close()

    def go(self):
        self.conn.send(True)

    def wait(self):
        return self.conn.recv()

    def close(self):
        self.conn.send(False)
        self.proc.join()


def one_run(loop, mode: str, side) -> dict:
    """loop() alone or beside one go() of side: the loop's seconds (to
    the card's last result), the decodes' seconds and the wall time until
    both were done."""
    t0 = time.perf_counter()
    if side is not None:
        side.go()
    loop()
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    decode_s = side.wait() if side is not None else None
    return {"mode": mode, "loop_s": loop_s, "decode_s": decode_s,
            "both_done_s": time.perf_counter() - t0}


def measure(decodes: int = 2, objects: int = 2) -> dict:
    hpams = load_hpams(PUBLISHED)
    model = init_model(build_model(hpams["arch"], hpams["net_hyperparams"]), 0).cuda()
    zeros = np.zeros(hpams["net_hyperparams"]["latent_dim"], np.float32)
    with tempfile.TemporaryDirectory() as d:
        drv = TTODriver(model, zeros, zeros, hpams, SyntheticDataset(objects), d, device="cuda")
        _, _, batch = drv._prep(list(range(objects)))

    def loop():
        run_tto_batch(drv.model, drv.wts, batch, drv.mean_shape, drv.mean_texture, drv.cfg,
                      generator=drv.render_gen)

    one_run(loop, "alone", None)                     # warm-up
    decode_alone = _decode(decodes)
    t0 = time.perf_counter()
    sides = {"alone": None, "thread": _ThreadSide(decodes), "process": _ProcessSide(decodes)}
    fork_s = time.perf_counter() - t0
    try:
        runs = [one_run(loop, m, sides[m]) for m in ("alone", "thread", "process", "process",
                                                      "thread", "alone") * 2]
    finally:
        for side in sides.values():
            if side is not None:
                side.close()
    mean = {m: {k: float(np.mean([r[k] for r in runs if r["mode"] == m]))
                for k in ("loop_s", "both_done_s")} for m in ("alone", "thread", "process")}
    for m in ("thread", "process"):
        # of the decodes' serial seconds, the share that the overlap saved
        serial = mean["alone"]["loop_s"] + decode_alone
        mean[m]["hidden_share"] = (serial - mean[m]["both_done_s"]) / decode_alone
        mean[m]["loop_slowdown"] = mean[m]["loop_s"] / mean["alone"]["loop_s"] - 1.0
    return {"objects": objects, "iterations": drv.cfg.num_opts, "decodes": decodes,
            "decode_alone_s": decode_alone, "workers_start_s": fork_s, "runs": runs,
            "mean": mean}


def main(argv=None):
    p = argparse.ArgumentParser("supnerf_tpu_torch prep_overlap")
    p.add_argument("--decodes", type=int, default=2)
    p.add_argument("--objects", type=int, default=2)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("prep_overlap runs on the card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps(measure(args.decodes, args.objects)))


if __name__ == "__main__":
    main()
