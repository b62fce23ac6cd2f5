"""Phase timing. phase() is wall-clock time that waits for the card at the
phase's end, so device work is charged to the phase that queued it. The
pipelined TTO driver must not wait for the whole card, so it times with
host() (wall-clock time of host work, waiting for nothing) and device(): on
a CUDA device, the card's time between two events recorded on the current
stream at the phase's start and end, added by collect() once the end event
has completed; on the CPU, wall-clock time."""
from __future__ import annotations

import contextlib
import time

import torch


class PhaseTimer:
    def __init__(self, device):
        self.sync = torch.device(device).type == "cuda"
        self.seconds = {}
        self.log = []           # (name, seconds) of each phase, in the order they were added
        self._events = []       # (name, start, end) of device phases not yet collected

    def add(self, name: str, seconds: float):
        self.seconds[name] = self.seconds.get(name, 0.0) + seconds
        self.log.append((name, seconds))

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.sync:
                torch.cuda.synchronize()
            self.add(name, time.perf_counter() - t0)

    @contextlib.contextmanager
    def host(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0)

    @contextlib.contextmanager
    def device(self, name: str):
        if not self.sync:
            with self.host(name):
                yield
            return
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        try:
            yield
        finally:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self._events.append((name, start, end))

    def collect(self):
        """Add the device phases whose end event has completed."""
        pending = []
        for name, start, end in self._events:
            if end.query():
                self.add(name, start.elapsed_time(end) / 1e3)
            else:
                pending.append((name, start, end))
        self._events = pending
