"""A profiler trace of a span of a run (--profile_dir of the CLIs); the
counterpart of supnerf_tpu/utils/profiling.py's trace (a jax.profiler
device trace).

trace(log_dir) runs the span under torch.profiler.profile with the CPU
activity and, where a card is present, the CUDA activity (CUPTI: every
kernel launch with its kernel's name, e.g. render_fwd_kernel), and writes
a Chrome trace, log_dir/trace.json (chrome://tracing or Perfetto).
"""
from __future__ import annotations

import contextlib
import os

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block; write log_dir/trace.json when it ends."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
