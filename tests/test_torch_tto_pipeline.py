"""The port's pipelined TTODriver.run (supnerf_tpu_torch/tto/driver.py) on the
CPU at a tiny size (W 32, one shape and one texture block, in_img_sz 32,
6 iterations):
- against a loop of optimize_object_batch (the serial order) over the same
  batches, bit for bit: results_dict(), codes+poses.pkl and its .pth twin,
  cross_eval.pkl and the --vis PNGs, byte for byte; 5 synthetic objects at
  batch 2 (the last batch short and padded) with add_pose_err 1 and 2, 3
  with --vis 1, and the nuScenes test fixture (tests/nusc_devkit_shim.py,
  read through the port's table reader) in mode 2, whose reader draws per
  read: after the run and the cross-view evaluation its stream stands where
  the serial loop leaves it;
- its order of prep submissions, dispatches, bookkeepings and saves against
  the JAX driver's own run (supnerf_tpu/tto/driver.py) with the batch
  methods replaced by recorders (nothing compiles), 7 objects at batch 2
  with save_freq 4, so that saves fall between batches;
- a sample that raises in the prep worker, and a worker that dies, raise out
  of run with the worker ended and no results written; a run of one batch
  starts no worker.
Serially the file takes ~28 s on an 8-core x86 CPU: 2–8 s for each
bit-for-bit case, about 1 s for each of the others."""
import concurrent.futures
import os
import pickle
import types

import numpy as np
import pytest

from supnerf_tpu.tto.driver import TTODriver as JaxTTODriver
from supnerf_tpu_torch.cli.common import SyntheticDataset
from supnerf_tpu_torch.data.nuscenes import NuScenesData
from supnerf_tpu_torch.models.factory import build_model, init_model
from supnerf_tpu_torch.tto import driver as driver_mod
from supnerf_tpu_torch.tto.driver import TTODriver
from tests import nusc_devkit_shim as shim
from tests.test_torch_data import NUSC_HPAMS, write_nusc_schema

TINY = {"arch": "supnerf",
        "net_hyperparams": {"shape_blocks": 1, "texture_blocks": 1, "latent_dim": 32,
                            "pose_shortcut": 1, "pred_wlh": 0},
        "render_im_sz": 8, "n_samples": 8, "in_img_sz": 32, "optimize": {"num_opts": 6}}
ZEROS = np.zeros(32, np.float32)


@pytest.fixture(scope="module")
def model():
    return init_model(build_model("supnerf", TINY["net_hyperparams"]), 0)


@pytest.fixture(scope="module")
def nusc_root(tmp_path_factory):
    """The shim's nuScenes fixture in nuScenes' own schema."""
    root = tmp_path_factory.mktemp("nusc_shim")
    shim.build_fixture(str(root))
    copy = str(tmp_path_factory.mktemp("nusc_schema") / "data")
    write_nusc_schema(str(root), copy)
    return copy


def _files(out_dir):
    """{relative path: bytes} of every file a run wrote."""
    got = {}
    for where, _, names in os.walk(out_dir):
        for name in names:
            path = os.path.join(where, name)
            with open(path, "rb") as f:
                got[os.path.relpath(path, out_dir)] = f.read()
    return got


CASES = {"pose_err1": dict(n=5, add_pose_err=1), "pose_err2": dict(n=5, add_pose_err=2),
         "vis1": dict(n=3, add_pose_err=2, vis=1, vis_im_sz=64),
         "nusc_mode2": dict(nusc=True, batch_size=3)}


@pytest.mark.parametrize("case", list(CASES))
def test_pipelined_run_equals_the_serial_loop(model, nusc_root, tmp_path, case):
    kw = dict(CASES[case])
    nusc, n = kw.pop("nusc", False), kw.pop("n", None)
    hp = dict(TINY, **NUSC_HPAMS) if nusc else TINY
    out, drivers = {}, {}
    for order in ("serial", "pipelined"):
        if nusc:
            dataset = NuScenesData(hp, split="train", data_dir=nusc_root, nusc_version="v1.0-mini",
                                   add_pose_err=2, seed=5)
        else:
            dataset = SyntheticDataset(n)
        drv = TTODriver(model, ZEROS, ZEROS, hp, dataset, str(tmp_path / order), device="cpu",
                        reg_iters=2, seed=3, **dict(dict(batch_size=2, add_pose_err=2), **kw))
        if order == "serial":
            for s in range(0, len(dataset), drv.batch_size):
                drv.optimize_object_batch(list(range(s, min(s + drv.batch_size, len(dataset)))))
            drv.save_results()
            drv.save_results_pth()
        else:
            drv.run()
        drv.eval_cross_view()
        out[order], drivers[order] = _files(str(tmp_path / order)), drv
    a, b = drivers["serial"], drivers["pipelined"]
    assert pickle.dumps(b.results_dict()) == pickle.dumps(a.results_dict())
    assert set(out["pipelined"]) == set(out["serial"])
    assert {"codes+poses.pkl", "codes+poses.pth", "cross_eval.pkl"} <= set(out["serial"])
    if kw.get("vis"):
        assert sum(name.endswith(".png") for name in out["serial"]) == 3 * 3
    for name, data in out["serial"].items():
        assert out["pipelined"][name] == data, name
    sa, sb = a._stream_state(), b._stream_state()
    assert np.array_equal(sa.pop("prep_gen"), sb.pop("prep_gen")) and sa == sb
    if nusc:
        assert a.dataset.rng.bit_generator.state["state"]["state"] != np.random.default_rng(
            5).bit_generator.state["state"]["state"]
        one, two = a.dataset[0], b.dataset[0]
        for k, v in one.items():
            assert np.array_equal(v, two[k]) if isinstance(v, np.ndarray) else v == two[k], k


def _recorded_jax_run(n, batch_size, save_freq, monkeypatch):
    """The JAX driver's run with its batch methods recording, prep
    submissions recorded where they are submitted."""
    events = []

    class InlineExecutor:
        def __init__(self, max_workers):
            assert max_workers == 1

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def submit(self, fn, idxs):
            events.append(("prep", list(idxs)))
            fut = concurrent.futures.Future()
            fut.set_result(fn(idxs))
            return fut

    monkeypatch.setattr(concurrent.futures, "ThreadPoolExecutor", InlineExecutor)
    drv = object.__new__(JaxTTODriver)
    drv.dataset, drv.batch_size, drv.save_freq = list(range(n)), batch_size, save_freq
    drv.timer = types.SimpleNamespace(report=lambda: "")
    drv._prep_batch = lambda idxs: (None, None)
    drv._dispatch_batch = lambda idxs, prepped: events.append(("dispatch", list(idxs)))
    drv._postprocess_batch = lambda idxs, samples, prepped, res: events.append(
        ("bookkeep", list(idxs)))
    drv.save_results = lambda: events.append(("save",))
    drv.save_results_pth = lambda: events.append(("save_pth",))
    drv.results_dict = dict
    JaxTTODriver.run(drv)
    monkeypatch.undo()
    return events


def test_run_follows_the_jax_drivers_order(model, tmp_path, monkeypatch):
    n, batch_size, save_freq = 7, 2, 4
    want = _recorded_jax_run(n, batch_size, save_freq, monkeypatch)
    events = []
    drv = TTODriver(model, ZEROS, ZEROS, TINY, SyntheticDataset(n), str(tmp_path), device="cpu",
                    batch_size=batch_size, save_freq=save_freq)
    submit = driver_mod._PrepWorker.submit

    def recorded_submit(worker, idxs):
        events.append(("prep", list(idxs)))
        submit(worker, idxs)

    monkeypatch.setattr(driver_mod._PrepWorker, "submit", recorded_submit)
    here = os.getpid()

    def prep_batch(idxs):       # batch 0 here, the others in the worker (seen at submit)
        if os.getpid() == here:
            events.append(("prep", list(idxs)))
        return [], [], {}, 0.0

    drv._prep_batch = prep_batch

    def dispatch(idxs, prep):
        events.append(("dispatch", list(idxs)))
        return list(idxs)

    drv._dispatch_batch = dispatch
    drv._postprocess_batch = lambda idxs: events.append(("bookkeep", idxs))
    drv.save_results = lambda: events.append(("save",))
    drv.save_results_pth = lambda: events.append(("save_pth",))
    drv.run()
    assert events == want
    assert want.count(("save",)) == 3 and want[:3] == [("prep", [0, 1]), ("prep", [2, 3]),
                                                      ("dispatch", [0, 1])]


class _Failing(SyntheticDataset):
    """Synthetic objects whose sample 3 raises, or ends its process."""

    def __init__(self, n, how):
        super().__init__(n)
        self.how = how

    def __getitem__(self, idx):
        if idx == 3:
            if self.how == "exits":
                os._exit(3)
            raise ValueError("sample 3 cannot be read")
        return super().__getitem__(idx)


@pytest.mark.parametrize("how", ["raises", "exits"])
def test_a_failing_prep_raises_out_of_run(model, tmp_path, monkeypatch, how):
    workers = []
    start = driver_mod._PrepWorker.__init__

    def kept(worker, *a):
        start(worker, *a)
        workers.append(worker)

    monkeypatch.setattr(driver_mod._PrepWorker, "__init__", kept)
    drv = TTODriver(model, ZEROS, ZEROS, TINY, _Failing(6, how), str(tmp_path), device="cpu",
                    batch_size=2, save_freq=2)
    with pytest.raises(ValueError if how == "raises" else RuntimeError,
                       match="sample 3 cannot be read" if how == "raises"
                       else "prep worker .* ended with exit code 3"):
        drv.run()
    assert len(workers) == 1 and not workers[0].proc.is_alive()
    assert workers[0].proc.exitcode is not None and workers[0].conn.closed
    assert not os.path.exists(tmp_path / "codes+poses.pkl") and drv.psnr_eval == {}
    drv = TTODriver(model, ZEROS, ZEROS, TINY, SyntheticDataset(2), str(tmp_path / "one"),
                    device="cpu", batch_size=2)
    drv.run()
    assert len(workers) == 1 and len(drv.psnr_eval) == 2
