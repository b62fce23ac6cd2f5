"""The port's epoch machinery on the CPU: the threaded prefetch
(supnerf_tpu_torch/training/prefetch.py, UnifiedTrainer.training_epoch with
num_workers > 0) against the serial epoch (num_workers 0), bit for bit, in
the batched prep and the per-row one (render_sz); PrefetchBatcher's failure
rules; resume from a checkpoint without its optimizer file
(training/checkpoints.py); the train CLI's new flags; and the CLI's run
under deterministic cuDNN.

The trainers run CodeNeRF at latent 32 (no encoder, a small checkpoint);
equal means equal bits (torch.equal), except where a case says otherwise."""
import dataclasses
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401
from supnerf_tpu_torch.cli import train
from supnerf_tpu_torch.cli.common import SyntheticDataset
from supnerf_tpu_torch.models.factory import build_model, init_model
from supnerf_tpu_torch.training import train_step as port
from supnerf_tpu_torch.training.prefetch import THREAD_NAME, PrefetchBatcher
from supnerf_tpu_torch.training.trainer import UnifiedTrainer

HP = {"arch": "codenerf", "net_hyperparams": {"shape_blocks": 1, "texture_blocks": 1,
                                              "latent_dim": 32},
      "n_rays": 32, "n_samples": 8, "in_img_sz": 32, "render_im_sz": 8}


@pytest.fixture(scope="module")
def dataset():
    return SyntheticDataset(8)


def _trainer(save_dir, dataset, hpams=HP, **kw):
    model = init_model(build_model("codenerf", hpams["net_hyperparams"]), 0)
    return UnifiedTrainer(model, hpams, dataset, str(save_dir), device="cpu", batch_size=2,
                          loss_mode="nerf_only", log_writer=False, **kw)


def _no_producer_left(timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if not any(t.name == THREAD_NAME for t in threading.enumerate()):
            return True
        time.sleep(0.05)
    return False


@pytest.mark.parametrize("prep", ["batched", "per_row"])
def test_threaded_epoch_equals_the_serial_epoch(tmp_path, dataset, prep):
    """Two epochs (4 steps each) with num_workers 2 and with 0, from one
    seed: the same losses, the same state after them, bit for bit; the
    per-row prep (a render_sz config with sym_aug) on the pool of 2."""
    hpams = dict(HP, render_sz=16, sym_aug=1) if prep == "per_row" else HP
    runs = []
    for workers in (2, 0):
        tr = _trainer(tmp_path / str(workers), dataset, hpams, aug_box2d=True, aug_wlh=True)
        for _ in range(2):
            tr.training_epoch(num_workers=workers)
            tr.nepoch += 1
        runs.append(tr)
    threaded, serial = runs
    assert len(threaded.metrics_history) == len(serial.metrics_history) == 8
    for a, b in zip(threaded.metrics_history, serial.metrics_history):
        for k in port.metric_names("nerf_only", threaded.cfg):
            assert a[k] == b[k], k
        assert {"producer_prep", "producer_upload", "main_wait_batch"} <= set(a["phase_seconds"])
    for k, v in serial.state.model.state_dict().items():
        assert torch.equal(threaded.state.model.state_dict()[k], v), k
    for name in ("shape_codes", "texture_codes", "optimized_idx"):
        assert torch.equal(getattr(threaded.state, name), getattr(serial.state, name)), name
    assert threaded.state.niter == serial.state.niter == 8
    assert _no_producer_left()


def test_producer_exception_is_raised_on_the_consumer():
    def prepare(idxs):
        if 4 in idxs:
            raise KeyError("sample 4 is missing")
        return idxs

    batches = PrefetchBatcher(None, lambda rows, seconds: rows, range(8), 2, num_workers=1,
                              batch_prepare_fn=prepare)
    got = []
    with pytest.raises(KeyError, match="sample 4 is missing"):
        for b in batches:
            got.append(b)
    assert got == [[0, 1], [2, 3]]
    assert _no_producer_left()


def test_early_exit_leaves_no_producer():
    """A consumer that takes one batch of many and stops: the producer,
    blocked on the full queue, sees the stop and ends."""
    batches = iter(PrefetchBatcher(lambda i: i, lambda rows, seconds: rows, range(40), 2,
                                   num_workers=2))
    assert next(batches) == [0, 1]
    time.sleep(0.3)           # the producer fills the queue and blocks
    batches.close()
    assert _no_producer_left()
    with pytest.raises(ValueError, match="num_workers"):
        PrefetchBatcher(lambda i: i, None, range(4), 2, num_workers=0)


def test_resume_without_optimizer_state(tmp_path, dataset, capsys):
    """A checkpoint whose epoch_0_optim.pth is gone: weights, tables,
    optimized_idx and niter restored, both optimizers fresh (zero moments,
    count 0), a line says so; the first resumed step's learning-rate factor
    (a cosine schedule here) is the uninterrupted run's at that step."""
    run = _trainer(tmp_path / "run", dataset)
    run.cfg = dataclasses.replace(run.cfg, lr_schedule_type="cosine", cosine_total_steps=10)
    scales = []
    step = run.state.opt_model.step
    run.state.opt_model.step = lambda g, scale: (scales.append(scale), step(g, scale))
    run.train(2, num_workers=0)
    saved = torch.load(tmp_path / "run" / "epoch_0.pth", weights_only=False)
    os.remove(tmp_path / "run" / "epoch_0_optim.pth")

    resumed = _trainer(tmp_path / "resumed", dataset)
    resumed.cfg = run.cfg
    resumed.resume_from_epoch(str(tmp_path / "run"), 0)
    assert "not found: both optimizers start fresh" in capsys.readouterr().out
    st = resumed.state
    for k, v in saved["model_params"].items():
        assert torch.equal(st.model.state_dict()[k], v), k
    assert torch.equal(st.shape_codes, saved["shape_code_params"]["weight"])
    assert torch.equal(st.texture_codes, saved["texture_code_params"]["weight"])
    assert torch.equal(st.optimized_idx, saved["optimized_idx"])
    assert st.niter == saved["niter"] == 4 and resumed.nepoch == 1
    for opt in (st.opt_model, st.opt_codes):
        assert opt.count == 0
        assert all(float(t.abs().max()) == 0.0 for t in opt.m + opt.v)
    got = []
    step2 = st.opt_model.step
    st.opt_model.step = lambda g, scale: (got.append(scale), step2(g, scale))
    resumed.train(2, num_workers=0)
    assert got[0] == scales[4] == port.cosine_scale(4, 10) and st.opt_model.count == 4
    assert all(np.isfinite(m["loss_total"]) for m in resumed.metrics_history)


def test_train_cli_takes_the_new_flags(tmp_path, monkeypatch):
    """cli.train with the augmentations, im_enc_rate, render_sz (over the
    config's) and num_workers runs to its checkpoints; --pred_box2d reaches
    build_dataset."""
    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps(dict(HP, model_dir=str(tmp_path / "none"))))
    argv = ["--config_file", str(cfg), "--dataset", "synthetic", "--num_objects", "4",
            "--batch_size", "2", "--epochs", "1", "--device", "cpu", "--check_iter", "100"]
    out = train.main(argv + ["--save_dir", str(tmp_path / "run"), "--aug_box2d", "true",
                             "--aug_wlh", "yes", "--im_enc_rate", "0.5", "--render_sz", "8",
                             "--num_workers", "2"])
    assert out["steps"] == 2 and all(np.isfinite(m["loss_total"]) for m in out["metrics"])
    assert json.loads((tmp_path / "run" / "hpam.json").read_text())["render_sz"] == 8
    assert {"producer_prep", "producer_upload", "main_wait_batch"} <= set(out["phase_seconds"])

    seen = {}

    class Reached(Exception):
        pass

    def build_dataset(hpams, args, split):
        seen.update(pred_box2d=args.pred_box2d, split=split)
        raise Reached

    monkeypatch.setattr(train, "build_dataset", build_dataset)
    with pytest.raises(Reached):
        train.main(argv + ["--pred_box2d", "1"])
    assert seen == {"pred_box2d": 1, "split": "train"}


def test_card_runs_take_deterministic_cudnn(tmp_path, monkeypatch):
    """The train CLI runs its epochs with cuDNN's deterministic algorithms,
    so that two training runs from one seed repeat each other on the card,
    and puts the setting back afterwards; resolve_device leaves it alone
    (test-time optimization runs without it) and takes float32
    convolutions and matmuls on the card."""
    from supnerf_tpu_torch.device import resolve_device

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", False)
    seen = []
    real = train.UnifiedTrainer.train

    def recording(self, *args, **kwargs):
        seen.append(torch.backends.cudnn.deterministic)
        return real(self, *args, **kwargs)

    monkeypatch.setattr(train.UnifiedTrainer, "train", recording)
    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps(dict(HP, model_dir=str(tmp_path / "none"))))
    train.main(["--config_file", str(cfg), "--dataset", "synthetic", "--num_objects", "2",
                "--batch_size", "2", "--epochs", "1", "--device", "cpu", "--check_iter", "100",
                "--num_workers", "0", "--save_dir", str(tmp_path / "run")])
    assert seen == [True] and not torch.backends.cudnn.deterministic

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", torch.backends.cudnn.allow_tf32)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32",
                        torch.backends.cuda.matmul.allow_tf32)
    assert resolve_device("cuda").type == "cuda"
    assert not torch.backends.cudnn.deterministic
    assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32
