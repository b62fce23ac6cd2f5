"""The thread rule of the port's test files: under pytest-xdist each worker
runs torch (and numpy's BLAS) on its share of the cores, cores // workers
intra-op threads and at least one, and so does every process a test
starts (OMP_NUM_THREADS); run serially, the defaults stand. Six workers
each spinning eight OpenMP threads over eight cores beside XLA's pools
ran a file's cases up to ~24x their serial time.

Every tests/test_torch_*.py imports it before its first test runs:

    import torch_threads  # noqa: F401

so a worker sets it when it collects the first such file. A test that
holds the bits of two port runs runs both at THREADS (or sets one count
for both itself)."""
import os

import torch

WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT") or 0)
THREADS = max(1, len(os.sched_getaffinity(0)) // WORKERS) if WORKERS else torch.get_num_threads()

if WORKERS:
    torch.set_num_threads(THREADS)
    os.environ["OMP_NUM_THREADS"] = str(THREADS)
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:         # numpy's BLAS keeps its pool
        pass
    else:
        threadpool_limits(THREADS, user_api="blas")
