"""The thread rule of the port's test files (tests/torch_threads.py, ROADMAP
C.5): under pytest-xdist a worker runs torch on cores // workers intra-op
threads (at least one) and hands the same count to the processes its tests
start; run serially, torch keeps its default. ~3 s (one child imports
torch)."""
import os
import subprocess
import sys

import torch

import torch_threads


def test_a_worker_takes_its_share_of_the_cores():
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT") or 0)
    if workers:
        share = max(1, len(os.sched_getaffinity(0)) // workers)
        assert torch_threads.THREADS == share
        assert os.environ["OMP_NUM_THREADS"] == str(share)
    assert torch.get_num_threads() == torch_threads.THREADS


def test_a_started_process_takes_the_same_count():
    out = subprocess.run([sys.executable, "-c", "import torch; print(torch.get_num_threads())"],
                         capture_output=True, text=True, check=True, timeout=120)
    assert int(out.stdout) == torch_threads.THREADS
