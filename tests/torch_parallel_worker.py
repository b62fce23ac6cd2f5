"""What the ranks of tests/test_torch_parallel.py run: module-level
functions that parallel.launch can hand to spawned processes. It imports
only the port, torch and numpy, so a rank's interpreter holds nothing of
the JAX world (each function reports what it finds), and the test module,
which imports JAX, is never imported by a rank.

    python tests/torch_parallel_worker.py SPEC.pkl OUT.pkl

runs train_steps under the group that JAX_COORDINATOR_ADDRESS,
JAX_NUM_PROCESSES and JAX_PROCESS_ID name (one rank a process) and writes
its result, the form a host of a multi-host run takes."""
from __future__ import annotations

import hashlib
import pickle
import sys

import numpy as np
import torch

from supnerf_tpu_torch.data.synthetic import make_synthetic_object
from supnerf_tpu_torch.models.factory import build_model
from supnerf_tpu_torch.models.layers import BatchStatNorm2d, batch_stat_updates, global_batch_stats
from supnerf_tpu_torch.parallel.mesh import (
    COUNTS,
    all_reduce_sum,
    gather_to_main,
    is_main,
    launch,
    plan_launch,
    row_slice,
)
from supnerf_tpu_torch.training.trainer import UnifiedTrainer
from supnerf_tpu_torch.tto import driver as driver_mod
from supnerf_tpu_torch.tto.driver import TTODriver

JAX_WORLD = ("jax", "jaxlib", "flax", "optax", "supnerf_tpu", "cv2", "PIL", "matplotlib",
             "imageio")


def jax_world_modules() -> list:
    """The modules of the JAX world this interpreter has imported."""
    return sorted(m for m in sys.modules
                  if any(m == b or m.startswith(b + ".") for b in JAX_WORLD))


class PoseErrData:
    """n synthetic objects (two views an instance), each with an
    injected-error source pose (pose-error mode 1), so both packages'
    trainers take the dataset's source poses instead of drawing their
    own."""

    add_pose_err = 1

    def __init__(self, n: int, first_seed: int = 70):
        self.samples = []
        for i in range(n):
            s = make_synthetic_object(seed=first_seed + i)
            err = np.asarray(s["obj_poses"], np.float32).copy()
            err[:, 3] += np.float32([0.3, -0.1, 0.5]) * (i + 1)
            s.update(instoken=f"ins_{i // 2}", anntoken=f"ann_{i}", cam_ids="CAM_FRONT",
                     obj_poses_w_err=err)
            self.samples.append(s)

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]


def state_arrays(state) -> dict:
    """A TrainState as numpy: the model's state_dict (parameters and
    BatchNorm buffers), both code tables, optimized_idx and niter."""
    out = {f"model.{k}": v.detach().cpu().numpy().copy()
           for k, v in state.model.state_dict().items()}
    out.update(shape_codes=state.shape_codes.detach().cpu().numpy().copy(),
               texture_codes=state.texture_codes.detach().cpu().numpy().copy(),
               optimized_idx=state.optimized_idx.detach().cpu().numpy().copy(),
               niter=np.asarray(state.niter))
    return out


def digest(arrays: dict) -> str:
    h = hashlib.sha256()
    for k in sorted(arrays):
        h.update(k.encode())
        h.update(np.ascontiguousarray(arrays[k]).tobytes())
    return h.hexdigest()


def train_steps(group, spec: dict) -> dict:
    """For each epoch e of spec["resume_epochs"]: UnifiedTrainer on
    PoseErrData(spec["n_objects"]) resumed from spec["ckpt_dir"]'s
    epoch_{e}, then one epoch (batch_size = n_objects: one step). Returns
    each step's metrics and end state, whether every rank's end states are
    the same bits (the digests gathered to rank 0), the collectives' counts
    and the JAX-world modules this process imported."""
    torch.set_num_threads(1)
    hp = spec["hpams"]
    trainer = UnifiedTrainer(build_model(hp["arch"], hp["net_hyperparams"]), hp,
                             PoseErrData(spec["n_objects"]), spec["out_dir"], device="cpu",
                             batch_size=spec["n_objects"], log_writer=False, group=group)
    steps = []
    for e in spec["resume_epochs"]:
        trainer.resume_from_epoch(spec["ckpt_dir"], e)
        trainer.training_epoch()
        m = trainer.metrics_history[-1]
        steps.append({"metrics": {k: v for k, v in m.items() if k != "phase_seconds"},
                      "state": state_arrays(trainer.state)})
    mine = [digest(s["state"]) for s in steps]
    digests = [mine] if group is None else gather_to_main(group, mine)
    if not is_main(group):
        return None
    return {"steps": steps, "ranks_equal": all(d == digests[0] for d in digests),
            "world": 1 if group is None else group.world, "collectives": dict(COUNTS),
            "jax_world": jax_world_modules()}


def rank_imports(group):
    """Each rank's JAX-world modules, in rank order, on rank 0."""
    return gather_to_main(group, jax_world_modules())


def group_probe(group):
    """The group as each rank sees it, in rank order, on rank 0: (rank,
    world, backend, the sum over the ranks of rank + 1)."""
    x = torch.tensor([group.rank + 1.0])
    torch.distributed.all_reduce(x)
    return gather_to_main(group, (group.rank, group.world, torch.distributed.get_backend(),
                                  float(x)))


def batchnorm_share(group, spec: dict):
    """BatchStatNorm2d under global_batch_stats on this rank's rows of
    spec["x"] (float64, (n, C, H, W)), the running statistics moving:
    returns (output rows, their input gradient, the weight and bias
    gradients summed over the ranks, running mean, running var) of the loss
    sum(output * spec["cot"]) on rank 0."""
    torch.set_num_threads(1)
    sl = row_slice(group, len(spec["x"]))
    x = torch.from_numpy(spec["x"][sl]).requires_grad_(True)
    bn = BatchStatNorm2d(x.shape[1]).double()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(spec["weight"]))
        bn.bias.copy_(torch.from_numpy(spec["bias"]))
    with global_batch_stats(bn, all_reduce_sum), batch_stat_updates(bn):
        y = bn(x)
    (y * torch.from_numpy(spec["cot"][sl])).sum().backward()
    g_w, g_b = (all_reduce_sum(t) for t in (bn.weight.grad, bn.bias.grad))
    rows = (y.detach().numpy(), x.grad.numpy())
    parts = gather_to_main(group, rows)
    if not group.main:
        return None
    return (np.concatenate([p[0] for p in parts]), np.concatenate([p[1] for p in parts]),
            g_w.numpy(), g_b.numpy(), bn.running_mean.numpy(), bn.running_var.numpy())


def tto_samples(n: int, first_seed: int) -> list:
    """n synthetic objects, two views an instance, for test-time
    optimization."""
    samples = []
    for i in range(n):
        s = make_synthetic_object(seed=first_seed + i)
        s.update(instoken=f"ins_{i // 2}", anntoken=f"ann_{i}", cam_ids="CAM_FRONT")
        samples.append(s)
    return samples


def tto_run(group, spec: dict) -> dict:
    """TTODriver.run on spec's synthetic objects (two views an instance)
    with spec's weights (a state_dict file), its initial poses
    (spec["poses"], in place of the driver's own draws) and, where given,
    its render draws (spec["draws"]: a list of tto_draws' dicts as numpy,
    one a batch, in place of the driver's generator), its opt_pose (default
    1) and, with spec["pnp_moves"], a PnP solve that moves every object's
    translation by 5 % (so every object takes it). Returns results_dict()
    on rank 0, the count of PnP translations taken and the JAX-world
    modules this process imported."""
    torch.set_num_threads(1)
    hp = spec["hpams"]
    model = build_model(hp["arch"], hp["net_hyperparams"])
    model.load_state_dict(torch.load(spec["weights"], weights_only=False), strict=True)
    samples = tto_samples(spec["n_objects"], spec["first_seed"])
    zeros = np.zeros(hp["net_hyperparams"]["latent_dim"], np.float32)
    drv = TTODriver(model, zeros, zeros, hp, samples, spec["out_dir"], device="cpu",
                    reg_iters=spec["reg_iters"], add_pose_err=2,
                    batch_size=spec["batch_size"], opt_pose=spec.get("opt_pose", 1), group=group)
    poses = list(spec["poses"])
    drv._initial_poses = lambda batch_samples: [poses.pop(0) for _ in batch_samples]
    # the driver module's functions replaced for this run only: a rank of
    # one runs in the caller's process, whose later runs must see the
    # driver's own
    patched = {}
    if spec.get("draws") is not None:
        batches = list(spec["draws"])

        def given(cfg, B, generator, device):
            draws = batches.pop(0)
            return {"jitter": tuple(torch.from_numpy(d) for d in draws["jitter"]),
                    "sym_flips": torch.from_numpy(draws["sym_flips"]),
                    "obj_sz_draws": None}

        patched["tto_draws"] = given
    if spec.get("pnp_moves"):
        patched["pnp_bootstrap"] = lambda uv, roi, wlh, K, src: np.concatenate(
            [src[:, :3], src[:, 3:] * 1.05], 1)
    own = {name: getattr(driver_mod, name) for name in patched}
    for name, fn in patched.items():
        setattr(driver_mod, name, fn)
    try:
        res = drv.run()
    finally:
        for name, fn in own.items():
            setattr(driver_mod, name, fn)
    if not is_main(group):
        return None
    return {"results": res, "pnp_translations": drv.pnp_translations,
            "collectives": dict(COUNTS), "jax_world": jax_world_modules()}


def main(argv):
    spec_path, out_path = argv
    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    out = launch(plan_launch(None, None, "cpu"), train_steps, spec)
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main(sys.argv[1:])
