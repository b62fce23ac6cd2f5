"""The port's data parallelism (supnerf_tpu_torch/parallel/) on the CPU: 2
gloo ranks, processes that parallel.launch spawns and that import only the
port (tests/torch_parallel_worker.py runs in them), against the JAX
package's mesh on the virtual 8-device CPU mesh (tests/conftest.py) and
against the port's own one-process run.

Training compares each step from the same state, as
tests/test_torch_train_step.py does: the JAX UnifiedTrainer(n_devices=2)
runs epochs 1 and 2 of 4 objects (batch 4, one step each, both learning
rates halved every step) from its initial state, and the port resumes from
that state and from JAX's state after epoch 1, converted
(models/convert.convert_train_state), on 2 ranks and on one process. A
free-running float32 comparison parts after the first AdamW step, whose
update is lr * sign(g) for gradient components that are float32 noise
(BatchNorm over the 1 x 1 maps of 4 images; the one-process float32
encoder gradient itself lies up to 9 % from float64's there, where 2 ranks
and one process agree to 4e-12 in float64). Against JAX, the tolerances of
test_torch_train_step.py: losses rtol 1e-4, parameters and tables rtol
5e-3 / atol 3e-4, BatchNorm running statistics rtol 1e-5 / atol 5e-5;
optimized_idx and niter exactly (measured: losses 1.9e-5, parameters
2.0e-4 absolute, tables 2.6e-6, running statistics 1.6e-5). Against one
process (the same package, only the sums' order differs), ONE_PROCESS:
losses rtol 5e-5, parameters rtol 5e-3 / atol 2.5e-4 (2 lr and rounding: a
noise component's first AdamW step can take either sign), tables atol
1e-5, running statistics rtol 1e-5 / atol 1e-5, BatchNorm's counts
exactly (measured: 1.6e-5, 2.0e-4, 7.2e-7, 6.2e-6). The ranks' end states
are the same bits.

TTO: the optimize CLI on 6 objects, batch 4 (the second batch padded
with its last row), add_pose_err 2 and sym_aug on 2 ranks against one
process, each drawing its own randomness (psnr atol 1e-4, poses and codes
atol 1e-5; measured 5e-7 and 2e-6); and the driver on 4 objects in two
batches of 2 fed the JAX driver's initial poses and render draws, on 2
ranks and in one process at batch 1 (an object a batch, as each rank
holds one: a batch of 2 in one process rounds apart from it by 1.3e-4
in a pose), against JAX's TTODriver at n_devices=2: psnr atol 2e-3 and rotations atol 1e-4
(tests/test_tto_mesh.py's; measured 1.2e-5 and 1.4e-5), translations atol
1e-3 (tests/test_torch_tto.py's for the port's final pose against JAX;
measured 8.8e-4 on 2 ranks and the same in one process: the port's own
distance from JAX after two AdamW steps, ROADMAP C.14), and 2 ranks
against one process at atol 1e-5 (measured 0: the same bits).
"""
import json
import os
import pickle
import shutil
import subprocess
import sys
import types

import numpy as np
import jax
import pytest
import torch

import torch_parallel_worker as worker
from supnerf_tpu.models import build_model as jax_build_model
from supnerf_tpu.models import init_model_variables
from supnerf_tpu.training.trainer import UnifiedTrainer as JaxTrainer
from supnerf_tpu.tto.driver import TTODriver as JaxTTODriver
from supnerf_tpu_torch.models.convert import convert_supnerf_variables, convert_train_state
from supnerf_tpu_torch.parallel.mesh import free_port, launch, plan_launch
from supnerf_tpu_torch.training.checkpoints import save_checkpoint
from supnerf_tpu_torch.training.trainer import UnifiedTrainer, train_config_from_hpams
from torch_memory import release_memory_after_module  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_NET = {"shape_blocks": 1, "texture_blocks": 1, "latent_dim": 32, "pose_shortcut": 1,
            "pred_wlh": 0}
TRAIN_HP = {"arch": "supnerf", "net_hyperparams": TINY_NET, "n_rays": 32, "n_samples": 8,
            "in_img_sz": 32, "roi_margin": 5, "shapenet_obj_cood": 1,
            "lr_schedule": [{"lr": 1e-4, "interval": 1}] * 2}
N_TRAIN = 4
TTO_HP = {"arch": "supnerf", "net_hyperparams": TINY_NET, "n_samples": 8, "render_im_sz": 8,
          "in_img_sz": 32, "roi_margin": 5, "loss_occ_coef": 0.1, "shapenet_obj_cood": 1,
          "sym_aug": 1, "optimize": {"num_opts": 6, "lr_shape": 0.02, "lr_texture": 0.02,
                                     "lr_pose": 0.01, "lr_half_interval": 1000}}
N_TTO, TTO_SEED, TTO_REG = 4, 60, 2
# 2 ranks against one process: losses (rtol), parameters, tables and
# running statistics (assert_allclose keywords)
ONE_PROCESS = {"losses": 5e-5, "params": {"rtol": 5e-3, "atol": 2.5e-4},
               "tables": {"atol": 1e-5}, "stats": {"rtol": 1e-5, "atol": 1e-5}}
LOSSES = ("loss_total", "loss_rgb", "loss_occ", "psnr", "loss_reg", "loss_code",
          "loss_pose_direct", "loss_pose_iter1", "loss_pose_iter2", "loss_pose_iter3")


def _cpu2():
    return plan_launch(2, None, "cpu")


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------

class _Orders:
    """The JAX trainer's epoch-order stream, replaced by the port's orders
    (default_rng((seed, epoch))) from epoch 1 on."""

    def __init__(self, ds, first_epoch=1):
        self.ds, self.epoch = ds, first_epoch

    def permutation(self, n):
        order = UnifiedTrainer.epoch_order(types.SimpleNamespace(seed=0, dataset=self.ds),
                                           self.epoch)
        self.epoch += 1
        return order


@pytest.fixture(scope="module")
def jax_train(tmp_path_factory):
    """JAX's 2-device mesh: epochs 1 and 2 from its initial state; the
    initial state and the state after epoch 1 written as the port's
    checkpoints epoch_0 and epoch_1 (1.5 GB with the ResNet34 encoder,
    removed after the module), and each epoch's metrics and end state
    (converted)."""
    d = tmp_path_factory.mktemp("jax_train")
    ds = worker.PoseErrData(N_TRAIN)
    jtr = JaxTrainer(jax_build_model("supnerf", TINY_NET), TRAIN_HP, ds, str(d / "jax"),
                     batch_size=N_TRAIN, n_devices=2, log_writer=False, img_upload_dtype=None,
                     steps_per_dispatch=1)
    jtr.rng, jtr.nepoch = _Orders(ds), 1
    cfg = train_config_from_hpams(TRAIN_HP)
    ckpt = str(d / "ckpt")
    ends, metrics = [], []
    for e in (0, 1, 2):
        state = convert_train_state(jax.device_get(jtr.state), TRAIN_HP, cfg=cfg)
        if e < 2:
            save_checkpoint(ckpt, state, e, jtr.instoken2idx)
        if e > 0:
            ends.append(worker.state_arrays(state))
        if e < 2:
            jtr.training_epoch(num_workers=1)
            metrics.append(jtr.metrics_history[-1])
            jtr.nepoch += 1
    yield {"ckpt": ckpt, "states": ends, "metrics": metrics}
    shutil.rmtree(d, ignore_errors=True)


@pytest.fixture(scope="module")
def port_train(jax_train, tmp_path_factory):
    """The port's steps from JAX's states: on 2 ranks, and on one process."""
    d = tmp_path_factory.mktemp("port_train")
    spec = {"hpams": TRAIN_HP, "n_objects": N_TRAIN, "ckpt_dir": jax_train["ckpt"],
            "resume_epochs": [0, 1]}
    two = launch(_cpu2(), worker.train_steps, dict(spec, out_dir=str(d / "two")))
    threads = torch.get_num_threads()
    try:
        one = launch(None, worker.train_steps, dict(spec, out_dir=str(d / "one")))
    finally:
        torch.set_num_threads(threads)
    return {"two": two, "one": one, "spec": spec, "dir": d}


def _groups(state, counters=True):
    """(parameters, tables, running statistics, the exact entries) of a
    state_arrays dict; BatchNorm's num_batches_tracked among the exact ones
    unless counters is False (the JAX package keeps no such count)."""
    stats = {k for k in state if k.endswith(("running_mean", "running_var"))}
    tables = {"shape_codes", "texture_codes"}
    tracked = {k for k in state if k.endswith("num_batches_tracked")}
    exact = {"optimized_idx", "niter"} | (tracked if counters else set())
    params = set(state) - stats - tables - tracked - {"optimized_idx", "niter"}
    return params, tables, stats, exact


def test_two_ranks_train_like_the_jax_mesh(jax_train, port_train):
    """Each of the two steps on 2 ranks against JAX's 2-device mesh from the
    same state: losses, parameters, code tables, BatchNorm running
    statistics (global over both ranks' rows), optimized_idx and niter."""
    for t, (got, want, jm) in enumerate(zip(port_train["two"]["steps"], jax_train["states"],
                                           jax_train["metrics"])):
        for k in LOSSES:
            np.testing.assert_allclose(got["metrics"][k], jm[k], rtol=1e-4,
                                       err_msg=f"step {t + 1} {k}")
        params, tables, stats, exact = _groups(want, counters=False)
        for k in params | tables:
            np.testing.assert_allclose(got["state"][k], want[k], rtol=5e-3, atol=3e-4,
                                       err_msg=f"step {t + 1} {k}")
        for k in stats:
            np.testing.assert_allclose(got["state"][k], want[k], rtol=1e-5, atol=5e-5,
                                       err_msg=f"step {t + 1} {k}")
        for k in exact:
            np.testing.assert_array_equal(got["state"][k], want[k], err_msg=f"step {t + 1} {k}")


def test_two_ranks_train_like_one_process(port_train):
    """2 ranks against the port's one process from the same states, at the
    tighter tolerances of the module docstring; the ranks end each step
    with the same bits; one gradient all-reduce a step; no rank imported
    anything of the JAX world."""
    two, one = port_train["two"], port_train["one"]
    assert two["world"] == 2 and two["ranks_equal"]
    assert two["collectives"]["grad_all_reduce"] == 2
    assert two["collectives"]["stat_all_reduce"] > 0
    assert two["jax_world"] == []
    for t, (got, want) in enumerate(zip(two["steps"], one["steps"])):
        for k in LOSSES:
            np.testing.assert_allclose(got["metrics"][k], want["metrics"][k],
                                       rtol=ONE_PROCESS["losses"], err_msg=f"step {t + 1} {k}")
        _assert_like_one_process(got["state"], want["state"], f"step {t + 1}")


def _assert_like_one_process(got, want, label):
    params, tables, stats, exact = _groups(want)
    for keys, tol in ((params, ONE_PROCESS["params"]), (tables, ONE_PROCESS["tables"]),
                      (stats, ONE_PROCESS["stats"])):
        for k in keys:
            np.testing.assert_allclose(got[k], want[k], **tol, err_msg=f"{label} {k}")
    for k in exact:
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{label} {k}")


def test_two_hosts_from_the_jax_names(port_train, tmp_path):
    """Two processes that form one group from JAX_COORDINATOR_ADDRESS,
    JAX_NUM_PROCESSES and JAX_PROCESS_ID on localhost, one rank each,
    train the first step to the bits of the 2-rank run's first step."""
    spec = dict(port_train["spec"], resume_epochs=[0], out_dir=str(tmp_path / "hosts"))
    spec_path = tmp_path / "spec.pkl"
    spec_path.write_bytes(pickle.dumps(spec))
    port = free_port()
    procs = []
    for pid in range(2):
        env = dict(os.environ, JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   JAX_NUM_PROCESSES="2", JAX_PROCESS_ID=str(pid), OMP_NUM_THREADS="1",
                   PYTHONPATH=REPO)
        env.pop("PYTEST_CURRENT_TEST", None)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(REPO, "tests", "torch_parallel_worker.py"),
             str(spec_path), str(tmp_path / f"host{pid}.pkl")],
            env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=240)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rc, out, err in outs:
        assert rc == 0, err[-3000:]
    host0 = pickle.loads((tmp_path / "host0.pkl").read_bytes())
    assert pickle.loads((tmp_path / "host1.pkl").read_bytes()) is None
    assert host0["world"] == 2 and host0["ranks_equal"]
    want = port_train["two"]["steps"][0]
    got = host0["steps"][0]
    assert worker.digest(got["state"]) == worker.digest(want["state"])
    assert [got["metrics"][k] for k in LOSSES] == [want["metrics"][k] for k in LOSSES]


def test_batchnorm_statistics_over_two_ranks():
    """BatchStatNorm2d on 2 ranks' halves of a batch against one process on
    the whole batch, in float64: outputs, input gradients, the ranks'
    summed weight and bias gradients and the running statistics."""
    rng = np.random.default_rng(0)
    spec = {"x": rng.normal(size=(4, 3, 2, 2)) * 3 + 1, "cot": rng.normal(size=(4, 3, 2, 2)),
            "weight": np.array([1.0, 2.0, 0.5]), "bias": np.array([0.1, -0.2, 0.3])}
    got = launch(_cpu2(), worker.batchnorm_share, spec)
    from supnerf_tpu_torch.models.layers import BatchStatNorm2d, batch_stat_updates

    x = torch.from_numpy(spec["x"]).requires_grad_(True)
    bn = BatchStatNorm2d(3).double()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(spec["weight"]))
        bn.bias.copy_(torch.from_numpy(spec["bias"]))
    with batch_stat_updates(bn):
        y = bn(x)
    (y * torch.from_numpy(spec["cot"])).sum().backward()
    want = (y.detach().numpy(), x.grad.numpy(), bn.weight.grad.numpy(), bn.bias.grad.numpy(),
            bn.running_mean.numpy(), bn.running_var.numpy())
    for name, a, b in zip(("out", "dx", "dweight", "dbias", "running_mean", "running_var"),
                          got, want):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12, err_msg=name)


# --------------------------------------------------------------------------
# TTO
# --------------------------------------------------------------------------

def _jax_draws(key, B, T, S):
    """The JAX loop's draws (obj_key = split(key, B)[b], it_key =
    fold_in(obj_key, t)), as tto_draws' dict: the loss render's jitter from
    it_key, the lidar render's from fold_in(it_key, 1), the flip
    bernoulli(fold_in(it_key, 3)); (T, B, ...) each."""
    obj_keys = jax.random.split(key, B)
    it_keys = [[jax.random.fold_in(obj_keys[b], t) for b in range(B)] for t in range(T)]

    def each(fn):
        return np.asarray([[np.asarray(fn(k)) for k in row] for row in it_keys])

    return {"jitter": (each(lambda k: jax.random.uniform(k, (S,))),
                       each(lambda k: jax.random.uniform(jax.random.fold_in(k, 1), (S,)))),
            "sym_flips": each(lambda k: jax.random.bernoulli(jax.random.fold_in(k, 3)))}


def test_two_ranks_tto_like_the_jax_mesh(tmp_path):
    """The driver on 2 ranks (4 objects in two batches of 2, add_pose_err 2,
    sym_aug) and in one process at batch 1 (each object alone, as on a
    rank), fed the JAX driver's initial poses and render draws (each
    batch's) against JAX's TTODriver at n_devices=2, at the module
    docstring's tolerances: every psnr curve and saved pose; the 2 ranks'
    distance from JAX is the one process's."""
    jmodel = jax_build_model("supnerf", TINY_NET)
    variables = jax.tree.map(np.asarray, init_model_variables(jmodel, jax.random.PRNGKey(0),
                                                              img_size=32))
    n_objects, batch = N_TTO, N_TTO // 2
    spec = {"hpams": TTO_HP, "n_objects": n_objects, "first_seed": TTO_SEED, "batch_size": batch,
            "reg_iters": TTO_REG, "weights": str(tmp_path / "weights.pt"),
            "out_dir": str(tmp_path / "port")}
    torch.save(convert_supnerf_variables(variables, TINY_NET), spec["weights"])
    samples = worker.tto_samples(n_objects, TTO_SEED)
    zeros = np.zeros(32, np.float32)
    jdrv = JaxTTODriver(jmodel, variables, zeros, zeros, TTO_HP, samples, str(tmp_path / "jax"),
                        batch_size=batch, reg_iters=TTO_REG, n_devices=2, add_pose_err=2)
    batches = [list(range(s, min(s + batch, n_objects))) for s in range(0, n_objects, batch)]
    prep_key = jdrv.prep_key
    spec["poses"] = [np.asarray(p) for idxs in batches
                     for p in jdrv._initial_poses([samples[i] for i in idxs])]
    jdrv.prep_key = prep_key
    cfg, key, spec["draws"] = jdrv.cfg, jdrv.key, []
    for idxs in batches:    # each dispatch splits the driver's key over the padded batch
        key, k = jax.random.split(key)
        draws = _jax_draws(k, batch, cfg.num_opts, cfg.n_samples)
        spec["draws"].append({"jitter": tuple(d[:, :len(idxs)] for d in draws["jitter"]),
                              "sym_flips": draws["sym_flips"][:, :len(idxs)]})
    flips = np.concatenate([d["sym_flips"] for d in spec["draws"]], 1)
    assert flips.any() and not flips.all()
    for idxs in batches:
        jdrv.optimize_object_batch(idxs)
    runs = {2: launch(plan_launch(2, None, "cpu"), worker.tto_run,
                      dict(spec, out_dir=str(tmp_path / "ranks2")))}
    # one process at batch 1: each object alone, as each of the 2 ranks
    # holds one, with its rows of the same draws
    alone = [{"jitter": tuple(d[:, i:i + 1] for d in draws["jitter"]),
              "sym_flips": draws["sym_flips"][:, i:i + 1]}
             for draws in spec["draws"] for i in range(batch)]
    threads = torch.get_num_threads()
    try:
        runs[1] = launch(None, worker.tto_run, dict(spec, out_dir=str(tmp_path / "ranks1"),
                                                    batch_size=1, draws=alone))
    finally:
        torch.set_num_threads(threads)
    assert runs[2]["jax_world"] == [] and runs[2]["collectives"]["gather"] == len(batches)
    diffs = {}
    for n, got in runs.items():
        res = got["results"]
        assert set(res["psnr_eval"]) == set(jdrv.psnr_eval)
        poses = {a: res["optimized_poses"][a]["CAM_FRONT"] - np.asarray(v["CAM_FRONT"])
                 for a, v in jdrv.optimized_poses.items()}
        diffs[n] = {"psnr": max(np.abs(np.asarray(res["psnr_eval"][k]) - np.asarray(v)).max()
                                for k, v in jdrv.psnr_eval.items()),
                    "rotation": max(np.abs(d[..., :3]).max() for d in poses.values()),
                    "translation": max(np.abs(d[..., 3]).max() for d in poses.values())}
    print(f"against the JAX mesh: 2 ranks {diffs[2]}, 1 rank {diffs[1]}")
    assert diffs[2]["psnr"] <= 2e-3 and diffs[2]["rotation"] <= 1e-4
    assert diffs[2]["translation"] <= 1e-3
    for a, v in runs[1]["results"]["optimized_poses"].items():
        np.testing.assert_allclose(runs[2]["results"]["optimized_poses"][a]["CAM_FRONT"],
                                   v["CAM_FRONT"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(diffs[2]["translation"], diffs[1]["translation"], atol=1e-5)


def _tto_cli(cfg_path, out, *extra):
    from supnerf_tpu_torch.cli import optimize

    return optimize.main(["--config_file", str(cfg_path), "--dataset", "synthetic",
                          "--num_objects", "6", "--batch_size", "4", "--device", "cpu",
                          "--save_dir", str(out), *extra])


def test_two_ranks_tto_cli_like_one_process(tmp_path, monkeypatch):
    """cli.optimize --devices 2 --device cpu against the same CLI in one
    process, each with its own draws: 6 objects in batches of 4 (the second
    padded), add_pose_err 2, sym_aug, opt_pose 2 (the PnP bootstrap); the
    same result keys and objects, psnr within 1e-4, every saved pose and
    code within 1e-5, the same count of PnP translations taken (the
    padding's rows counted nowhere); only rank 0's summary comes back."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps(dict(TTO_HP, model_dir=str(tmp_path / "no_checkpoint"))))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = _tto_cli(cfg, tmp_path / "one", "--opt_pose", "2")
    finally:
        torch.set_num_threads(threads)
    two = _tto_cli(cfg, tmp_path / "two", "--opt_pose", "2", "--devices", "2")
    assert two["n_objects"] == one["n_objects"] == 6
    print(f"PnP translations taken: one process {one['pnp_translations']}, 2 ranks "
          f"{two['pnp_translations']}")
    assert two["pnp_translations"] == one["pnp_translations"]
    res = {}
    for name in ("one", "two"):
        with open(tmp_path / name / "codes+poses.pkl", "rb") as f:
            res[name] = pickle.load(f)
    a, b = res["one"], res["two"]
    assert set(a) == set(b) and set(a["psnr_eval"]) == set(b["psnr_eval"]) and len(a["psnr_eval"]) == 6
    for k in a["psnr_eval"]:
        np.testing.assert_allclose(b["psnr_eval"][k], a["psnr_eval"][k], rtol=0, atol=1e-4)
    for key in ("optimized_poses", "optimized_shapecodes", "optimized_texturecodes"):
        for ann, v in a[key].items():
            np.testing.assert_allclose(b[key][ann]["CAM_FRONT"], v["CAM_FRONT"], rtol=0,
                                       atol=1e-5, err_msg=f"{key} {ann}")
    assert os.path.exists(tmp_path / "two" / "cross_eval.pkl")


def test_two_ranks_count_pnp_translations_once(tmp_path):
    """opt_pose 2 on 2 ranks, 6 objects in batches of 4 (the second padded
    with its last row, which rank 1 then holds twice), with a PnP solve
    that every object takes: the driver counts 6 translations taken, as one
    process does, and its results are one process's: psnr and every saved
    pose atol 1e-4 (measured 4.1e-6 and 3.7e-5: translations of 16-40 m
    after three AdamW steps)."""
    from supnerf_tpu_torch.models.factory import build_model, init_model

    samples = worker.tto_samples(6, TTO_SEED)
    spec = {"hpams": TTO_HP, "n_objects": 6, "first_seed": TTO_SEED, "batch_size": 4,
            "reg_iters": TTO_REG, "weights": str(tmp_path / "weights.pt"), "opt_pose": 2,
            "pnp_moves": True, "poses": [np.asarray(s["obj_poses"], np.float32)
                                         for s in samples]}
    torch.save(init_model(build_model("supnerf", TINY_NET), 0).state_dict(), spec["weights"])
    threads = torch.get_num_threads()
    try:
        one = launch(None, worker.tto_run, dict(spec, out_dir=str(tmp_path / "one")))
    finally:
        torch.set_num_threads(threads)
    two = launch(_cpu2(), worker.tto_run, dict(spec, out_dir=str(tmp_path / "two")))
    assert one["pnp_translations"] == two["pnp_translations"] == 6
    for k, v in one["results"]["psnr_eval"].items():
        np.testing.assert_allclose(two["results"]["psnr_eval"][k], v, rtol=0, atol=1e-4)
    for a, v in one["results"]["optimized_poses"].items():
        np.testing.assert_allclose(two["results"]["optimized_poses"][a]["CAM_FRONT"],
                                   v["CAM_FRONT"], rtol=0, atol=1e-4)


# --------------------------------------------------------------------------
# the training CLI's device flags
# --------------------------------------------------------------------------

TRAIN_CONFIG = {"arch": "supnerf", "net_hyperparams": TINY_NET, "n_rays": 32, "n_samples": 8,
                "in_img_sz": 32}


def _state_of(run_dir):
    """The state of run_dir's epoch_1.pth and the names of the files there;
    run_dir is removed (each checkpoint takes 0.8 GB)."""
    saved = torch.load(os.path.join(run_dir, "epoch_1.pth"), weights_only=False)
    out = {f"model.{k}": v.numpy() for k, v in saved["model_params"].items()}
    out.update(shape_codes=saved["shape_code_params"]["weight"].numpy(),
               texture_codes=saved["texture_code_params"]["weight"].numpy(),
               optimized_idx=saved["optimized_idx"].numpy(), niter=np.asarray(saved["niter"]))
    files = sorted(os.listdir(run_dir))
    shutil.rmtree(run_dir)
    return out, files


def test_train_cli_resumes_on_two_ranks(tmp_path, monkeypatch):
    """cli.train resumed from one epoch_0 (4 synthetic objects, batch 4,
    one step): --devices 2, --gpus 2 and --coordinator with
    JAX_NUM_PROCESSES 2 (two processes, JAX_PROCESS_ID 0 and 1) end with
    the same bits, and within the one-process tolerances of the module
    docstring of the run resumed on one process; only rank 0 wrote
    files."""
    from supnerf_tpu_torch.cli import train

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps(TRAIN_CONFIG))
    base = ["--config_file", str(cfg), "--dataset", "synthetic", "--num_objects", "4",
            "--batch_size", "4", "--device", "cpu", "--check_iter", "1"]
    resume = ["--epochs", "2", "--resume_dir", str(tmp_path / "first"), "--resume_from_epoch",
              "0"]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        train.main(base + ["--epochs", "1", "--save_dir", str(tmp_path / "first")])
        one = train.main(base + resume + ["--save_dir", str(tmp_path / "one")])
    finally:
        torch.set_num_threads(threads)
    want, want_files = _state_of(tmp_path / "one")
    runs, got = {}, {}
    for flag in ("devices", "gpus"):
        runs[flag] = train.main(base + resume + ["--save_dir", str(tmp_path / flag),
                                                 f"--{flag}", "2"])
        got[flag], files = _state_of(tmp_path / flag)
        assert files == want_files
    port = free_port()
    procs = []
    for pid in range(2):
        env = dict(os.environ, JAX_NUM_PROCESSES="2", JAX_PROCESS_ID=str(pid),
                   OMP_NUM_THREADS="1", PYTHONPATH=REPO)
        env.pop("PYTEST_CURRENT_TEST", None)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "supnerf_tpu_torch.cli.train", *base, *resume,
             "--save_dir", str(tmp_path / "coordinator"), "--coordinator",
             f"127.0.0.1:{port}"], env=env, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    try:
        for p in procs:
            _, err = p.communicate(timeout=240)
            assert p.returncode == 0, err[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for flag, summary in runs.items():
        assert summary["world"] == 2 and summary["backend"] == "gloo" and summary["rank"] == 0
        assert summary["collectives"]["grad_all_reduce"] == summary["steps"] == 1
        assert summary["metrics"][0]["loss_total"] == runs["devices"]["metrics"][0]["loss_total"]
        np.testing.assert_allclose(summary["metrics"][0]["loss_total"],
                                   one["metrics"][0]["loss_total"], rtol=ONE_PROCESS["losses"])
    got["coordinator"], _ = _state_of(tmp_path / "coordinator")
    shutil.rmtree(tmp_path / "first")
    assert worker.digest(got["gpus"]) == worker.digest(got["devices"])
    assert worker.digest(got["coordinator"]) == worker.digest(got["devices"])
    _assert_like_one_process(got["devices"], want, "--devices 2")


# --------------------------------------------------------------------------
# the aligned draws and the launch plan
# --------------------------------------------------------------------------

@pytest.mark.parametrize("render", ["frustum", "aabb"])
def test_tto_draws_are_the_runs_own(render):
    """run_tto_batch given tto_draws' draws for its batch (what each rank
    takes its rows of) is, to the bit, the run that draws them itself from
    the same generator state: the frustum render with sym_aug and
    obj_sz_reg, and the AABB render."""
    from supnerf_tpu_torch.data.synthetic import prepare_object_inputs
    from supnerf_tpu_torch.models.factory import build_model, init_model
    from supnerf_tpu_torch.tto import core

    model = init_model(build_model("supnerf", TINY_NET), 0)
    cfg = core.TTOConfig(num_opts=4, reg_iters=1, n_samples=8, render_im_sz=8, in_img_sz=32,
                         n_lidar=16, sym_aug=render == "frustum",
                         obj_sz_reg=render == "frustum", use_aabb_render=render == "aabb")
    rows = [prepare_object_inputs(s, in_img_sz=32, render_im_sz=8, n_lidar=16,
                                  pose_init=np.asarray(s["obj_poses"], np.float32))
            for s in worker.tto_samples(3, TTO_SEED)]
    batch = core.ObjectBatch.from_numpy({k: np.stack([r[k] for r in rows]) for k in rows[0]},
                                        "cpu")
    zeros = torch.zeros(32)
    wts = core.render_decoder(model)
    own = core.run_tto_batch(model, wts, batch, zeros, zeros, cfg,
                             generator=torch.Generator().manual_seed(5))
    draws = core.tto_draws(cfg, 3, torch.Generator().manual_seed(5), "cpu")
    assert (draws["sym_flips"] is not None) == cfg.sym_aug
    assert (draws["obj_sz_draws"] is not None) == cfg.obj_sz_reg
    given = core.run_tto_batch(model, wts, batch, zeros, zeros, cfg, **draws)
    for k in own:
        assert torch.equal(own[k], given[k]), k


def test_launch_plan_from_the_jax_names(monkeypatch):
    """plan_launch reads the coordinator and the hosts from the JAX names:
    --devices counts every host's ranks (default one a host), each host
    runs its share, and the group forms at the coordinator; without either
    flag there is no plan."""
    for name in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    assert plan_launch(None, None, "cpu") is None
    plan = plan_launch(4, None, "cpu", {"batch_size": 8})
    assert (plan.world, plan.local, plan.host, plan.backend) == (4, 4, 0, "gloo")
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "10.0.0.1:1234")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "2")
    monkeypatch.setenv("JAX_PROCESS_ID", "1")
    plan = plan_launch(None, None, "cpu")
    assert (plan.world, plan.local, plan.host, plan.init_method) == (
        2, 1, 1, "tcp://10.0.0.1:1234")
    plan = plan_launch(4, "10.0.0.2:99", "cpu")
    assert (plan.world, plan.local, plan.host, plan.init_method) == (
        4, 2, 1, "tcp://10.0.0.2:99")
    with pytest.raises(ValueError, match="each host runs the same number"):
        plan_launch(3, None, "cpu")
    monkeypatch.setenv("JAX_PROCESS_ID", "2")
    with pytest.raises(ValueError, match="JAX_PROCESS_ID 2"):
        plan_launch(None, None, "cpu")
