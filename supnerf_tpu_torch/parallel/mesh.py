"""Data parallelism over cards and hosts on torch.distributed; the port's
counterpart of supnerf_tpu/parallel/mesh.py.

The reference trains with torch DataParallel over up to 4 GPUs (reference
README.md:276, trainer_unified_nuscenes.py:227-229). The JAX package builds
a 1-D mesh over N devices under one controller: training shards the batch
axis over it, test-time optimization the object axis, and the state is
replicated. The port takes torch's idiom instead, one process per card:

  --devices N on one host     N ranks, each a process started with
                              torch.multiprocessing (start method spawn):
                              rank r on cuda:r with NCCL, or, with --device
                              cpu, a CPU process on gloo. N = 1 runs in the
                              calling process, in a group of one (as JAX
                              builds a 1-device mesh).
  --coordinator host:port     one group over JAX_NUM_PROCESSES hosts; this
  (or JAX_COORDINATOR_ADDRESS) host is JAX_PROCESS_ID (the JAX flag's and
                              env names). --devices N counts the ranks of
                              all hosts, as JAX's mesh counts the global
                              devices (default: one a host); each host runs
                              N / hosts of them, and host p's local rank l
                              is global rank p * (N / hosts) + l. The
                              coordinator is global rank 0's store address:
                              host 0 listens there.
  neither                     no group: the caller runs as before.

plan_launch checks the request before any work: --devices 0, more ranks on
a host than it has cards, a batch that the ranks do not divide and a
coordinator without its process count or id raise ValueError. Nothing falls
back: a failed NCCL init fails the run, a rank that raises fails it with
the rank's traceback (torch.multiprocessing ends the others), and nothing
drops to gloo or to one process.

What the ranks exchange (each counted in COUNTS): the training step's one
all-reduce of its gradients, metrics and trained rows (all_reduce_flat),
BatchNorm's global statistics, forward and backward (all_reduce_sum, which
autograd differentiates), and test-time optimization's results, gathered
to rank 0 (gather_to_main). This module imports nothing of the JAX world.
"""
from __future__ import annotations

import dataclasses
import inspect
import os
import pickle
import socket
import tempfile

import torch
import torch.distributed as dist

ENV_COORDINATOR = "JAX_COORDINATOR_ADDRESS"
ENV_NUM_PROCESSES = "JAX_NUM_PROCESSES"
ENV_PROCESS_ID = "JAX_PROCESS_ID"

# collectives launched since the group formed (launch) or reset_counts():
# the training step's flat all-reduce, BatchNorm's statistics (forward and
# backward), and the gathers of test-time optimization's results
COUNTS = {"grad_all_reduce": 0, "stat_all_reduce": 0, "gather": 0}


def reset_counts():
    for k in COUNTS:
        COUNTS[k] = 0


@dataclasses.dataclass(frozen=True)
class Plan:
    """A launch: `world` ranks in all, `local` of them on this host, which
    is host `host`; the group forms at init_method on `backend` ("nccl" for
    cuda, "gloo" for cpu)."""

    world: int
    local: int
    host: int
    init_method: str
    device: str

    @property
    def backend(self) -> str:
        return "nccl" if self.device == "cuda" else "gloo"


@dataclasses.dataclass(frozen=True)
class Group:
    """One rank's view of the group: its global rank, the world size, its
    rank on this host and its device."""

    rank: int
    world: int
    local_rank: int
    device: torch.device

    @property
    def main(self) -> bool:
        """Rank 0, which writes the files and does the work JAX does not
        shard."""
        return self.rank == 0


def is_main(group) -> bool:
    """True without a group and on rank 0."""
    return group is None or group.main


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env_int(name, value):
    if value is not None:
        return int(value)
    if name not in os.environ:
        return None
    return int(os.environ[name])


def plan_launch(devices: int | None, coordinator: str | None, device: str = "cuda",
                batch_sizes: dict | None = None, num_processes: int | None = None,
                process_id: int | None = None) -> Plan | None:
    """The launch that --devices and --coordinator (or
    JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES, JAX_PROCESS_ID) ask for, or
    None for neither. batch_sizes: {what: size} of the batches the ranks
    split, each of which the world size must divide. Raises before any
    work: ValueError for a request that cannot run as asked, RuntimeError
    for device "cuda" without a card."""
    coordinator = coordinator or os.environ.get(ENV_COORDINATOR)
    if devices is None and not coordinator:
        return None
    if devices is not None and devices < 1:
        raise ValueError(f"--devices {devices}: one rank or more")
    if device not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    if coordinator:
        hosts = _env_int(ENV_NUM_PROCESSES, num_processes)
        host = _env_int(ENV_PROCESS_ID, process_id)
        if hosts is None or host is None:
            raise ValueError(f"coordinator {coordinator!r}: {ENV_NUM_PROCESSES} and "
                             f"{ENV_PROCESS_ID} name the hosts and this one's index")
        if hosts < 1 or not 0 <= host < hosts:
            raise ValueError(f"{ENV_PROCESS_ID} {host} of {ENV_NUM_PROCESSES} {hosts}")
        world = devices or hosts
        if world % hosts:
            raise ValueError(f"--devices {world} ranks over {hosts} hosts: each host runs "
                             "the same number")
        init_method = f"tcp://{coordinator}"
    else:
        hosts, host, world = 1, 0, devices
        init_method = f"tcp://127.0.0.1:{free_port()}"
    local = world // hosts
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' "
                               "(--device cpu) to run on the CPU")
        if local > torch.cuda.device_count():
            raise ValueError(f"{local} ranks on this host and {torch.cuda.device_count()} "
                             "cards: a rank a card, and nothing runs on fewer")
    for what, size in (batch_sizes or {}).items():
        if size % world:
            raise ValueError(f"{what} {size} does not split over {world} ranks: each rank "
                             "takes an equal share")
    return Plan(world=world, local=local, host=host, init_method=init_method, device=device)


def _run_rank(local_rank: int, plan: Plan, fn, args):
    """fn(group, *args) as rank host * local + local_rank, the group formed
    before and destroyed after."""
    from supnerf_tpu_torch.device import resolve_device

    rank = plan.host * plan.local + local_rank
    kw = {}
    if plan.device == "cuda":
        torch.cuda.set_device(local_rank)
        device = resolve_device(f"cuda:{local_rank}")
        if "device_id" in inspect.signature(dist.init_process_group).parameters:
            kw["device_id"] = device       # NCCL forms its communicator now, not lazily
    else:
        device = resolve_device("cpu")
    dist.init_process_group(plan.backend, init_method=plan.init_method, world_size=plan.world,
                            rank=rank, **kw)
    reset_counts()
    try:
        return fn(Group(rank=rank, world=plan.world, local_rank=local_rank, device=device), *args)
    finally:
        dist.destroy_process_group()


def _spawned(local_rank: int, plan: Plan, fn, args, result_path: str):
    out = _run_rank(local_rank, plan, fn, args)
    if local_rank == 0:
        with open(result_path, "wb") as f:
            pickle.dump(out, f)


def launch(plan: Plan | None, fn, *args):
    """fn(group, *args) on each of this host's ranks of `plan`; returns
    local rank 0's result. Without a plan, fn(None, *args) here; with one
    local rank, in this process; with more, in that many spawned processes
    (each rank's fn must be a module-level function), after the kernels are
    built once for them on the card."""
    if plan is None:
        return fn(None, *args)
    if plan.local == 1:
        return _run_rank(0, plan, fn, args)
    if plan.device == "cuda":
        from supnerf_tpu_torch.ops.render import build_kernels

        build_kernels()
    with tempfile.TemporaryDirectory(prefix="supnerf_ranks_") as d:
        path = os.path.join(d, "local_rank0.pkl")
        torch.multiprocessing.start_processes(_spawned, args=(plan, fn, args, path),
                                              nprocs=plan.local, start_method="spawn")
        with open(path, "rb") as f:
            return pickle.load(f)


def row_slice(group: Group | None, n: int) -> slice:
    """The rank's rows of an n-row batch: [rank n / world, (rank + 1) n /
    world); all n without a group."""
    if group is None:
        return slice(0, n)
    share = n // group.world
    return slice(group.rank * share, (group.rank + 1) * share)


def all_reduce_flat(tensors) -> list:
    """Each tensor summed over the ranks, in one all-reduce of their
    float32 concatenation; returns the sums (views of one buffer) in the
    tensors' shapes."""
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat)
    COUNTS["grad_all_reduce"] += 1
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view(t.shape))
        at += t.numel()
    return out


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks whose gradient is the sum of the ranks' output
    gradients: every rank's loss depends on every rank's input. (torch's
    torch.distributed.nn.functional.all_reduce does the same, but recent
    torch deprecates it with a warning on every call, in favour of a
    private module; and this one counts its launches in COUNTS.)"""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        COUNTS["stat_all_reduce"] += 1
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g)
        COUNTS["stat_all_reduce"] += 1
        return g


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """x summed over the ranks, differentiable (BatchNorm's global
    statistics)."""
    return _AllReduceSum.apply(x)


def gather_to_main(group: Group, obj):
    """Every rank's picklable obj, in rank order, on rank 0; None
    elsewhere."""
    out = [None] * group.world
    dist.all_gather_object(out, obj)
    COUNTS["gather"] += 1
    return out if group.main else None
