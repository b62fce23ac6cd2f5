"""Where a single-host group of parallel.launch meets (ROADMAP C.26).

A port picked when the launch is planned (bind port 0, read it, close it)
and bound by the group only after the ranks start can be taken in between
by any other process on the host, and the launch then fails. Here a
socket listening on any port that the plan names plays that other
process, so such a race is lost every time rather than now and then. A
single-host plan names no port: launch makes a file rendezvous in a
directory of its own and removes it after the ranks are done.

Each case takes ~5 s serially (two spawned gloo ranks import the port)."""
import os
import re
import socket
import tempfile

import pytest

import torch_threads  # noqa: F401
import torch_parallel_worker as worker
from supnerf_tpu_torch.parallel.mesh import launch, plan_launch


def _take_named_port(plan):
    """A socket listening on the 127.0.0.1 port that plan's init_method
    names, or None when it names none."""
    m = re.fullmatch(r"tcp://127\.0\.0\.1:(\d+)", plan.init_method or "")
    if m is None:
        return None
    s = socket.socket()
    s.bind(("127.0.0.1", int(m.group(1))))
    s.listen()
    return s


@pytest.mark.parametrize("devices", [1, 2])
def test_single_host_group_holds_no_port_open_to_others(devices, tmp_path, monkeypatch):
    """--devices 1 (in this process) and 2 (spawned ranks) on gloo: the
    group forms and all-reduces although another socket holds any port the
    plan named, and the launch leaves nothing in the temporary
    directory."""
    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    plan = plan_launch(devices, None, "cpu")
    squatter = _take_named_port(plan)
    try:
        ranks = launch(plan, worker.group_probe)
    finally:
        if squatter is not None:
            squatter.close()
    total = devices * (devices + 1) / 2
    assert ranks == [(r, devices, "gloo", total) for r in range(devices)]
    assert os.listdir(tmp_path) == []
