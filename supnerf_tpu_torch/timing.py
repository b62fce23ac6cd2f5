"""Wall-clock phase timing that waits for the card at each phase's end, so
device work is charged to the phase that queued it."""
from __future__ import annotations

import contextlib
import time

import torch


class PhaseTimer:
    def __init__(self, device):
        self.sync = torch.device(device).type == "cuda"
        self.seconds = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.sync:
                torch.cuda.synchronize()
            self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - t0
