"""The port's visualisation through the TTO driver and the trainer's log sink
on the CPU at a tiny size (latent and width 32, 8 samples), against the JAX
package: TTODriver._save_vis at vis 1 (vis_im_sz 128) and vis 2 (64) and
the JAX driver's _save_vis on the same objects, decoder weights and TTO
results, with the JAX renderer's fixed jitter fed in (every panel and sheet
within 1 level: the renders agree to 3e-4 and the box and text are cv2's,
bit for bit, tests/test_torch_vis.py; ssim_eval within 1e-4); the TTO's
per-iteration codes and poses (emit_code_curves) against its snapshots;
--vis through the optimize CLI; the trainer's metrics.jsonl and panel
against the JAX trainer's _log and _log_vis given a capturing writer on the
same state (panel within 1 level), the CLI's log at --check_iter 2, and a
failed panel that raises."""
import json
import os
import pickle
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_threads  # noqa: F401
from supnerf_tpu.data.synthetic import make_synthetic_object
from supnerf_tpu.models.nerf_mlp import CodeNeRFDecoder as JaxDecoder
from supnerf_tpu.training.trainer import UnifiedTrainer as JaxTrainer
from supnerf_tpu.tto import TTOConfig as JaxTTOConfig
from supnerf_tpu.tto.driver import TTODriver as JaxTTODriver
from supnerf_tpu_torch.cli import optimize, train
from supnerf_tpu_torch.models.convert import convert_decoder
from supnerf_tpu_torch.models.factory import build_model, init_model
from supnerf_tpu_torch.render import renderer
from supnerf_tpu_torch.training import trainer as port_trainer
from supnerf_tpu_torch.tto import core
from supnerf_tpu_torch.tto.driver import TTODriver
from supnerf_tpu_torch.utils.image_io import read_png

TINY_HP = {"shape_blocks": 1, "texture_blocks": 1, "latent_dim": 32, "pose_shortcut": 1,
           "pred_wlh": 0}
S, REG, ITERS = 8, 2, 5
HPAMS = {"arch": "supnerf", "net_hyperparams": TINY_HP, "n_samples": S, "render_im_sz": 8,
         "in_img_sz": 32, "roi_margin": 5, "n_rays": 32, "optimize": {"num_opts": ITERS}}


class Views:
    """Synthetic objects with the driver's bookkeeping keys."""

    def __init__(self, n=2):
        self.samples = []
        for i in range(n):
            s = make_synthetic_object(seed=70 + i)
            s.update(instoken=f"ins_{i}", anntoken=f"ann_{i}", cam_ids="CAM_FRONT")
            self.samples.append(s)

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]


@pytest.fixture(scope="module")
def models():
    """The JAX decoder (the JAX driver's and trainer's field on their flax
    path) and a port SUP-NeRF with its weights: random encoder and refiner
    from seed 0, the decoder converted from the JAX one."""
    jdec = JaxDecoder(shape_blocks=1, texture_blocks=1, W=32, latent_dim=32)
    pts = jnp.zeros((1, S, 3))
    params = jax.tree.map(np.asarray, jdec.init(jax.random.PRNGKey(1), pts, pts, jnp.zeros(32),
                                                jnp.zeros(32))["params"])
    tmodel = init_model(build_model("supnerf", TINY_HP), 0)
    missing, unexpected = tmodel.load_state_dict(convert_decoder(params, 1, 1), strict=False)
    assert not unexpected and not any(k.startswith(("encoding_", "sigma", "rgb", "shape_",
                                                    "texture_")) for k in missing)
    return jdec, params, tmodel


@pytest.fixture
def jax_jitter(monkeypatch):
    """The port's full-image renders take the JAX renderer's fixed draw."""
    draw = torch.from_numpy(np.array(jax.random.uniform(jax.random.PRNGKey(0), (S,))))
    monkeypatch.setattr(renderer, "full_image_jitter", lambda n, device: draw.to(device))


def _jax_driver_stub(jdec, params, save_dir, vis, sz):
    """What JaxTTODriver._save_vis reads, on its flax path."""
    stub = types.SimpleNamespace(
        save_dir=save_dir, vis=vis, vis_im_sz=sz, ssim_eval={}, model=jdec,
        variables={"params": params}, _pallas_field=None,
        cfg=JaxTTOConfig(num_opts=ITERS, reg_iters=REG, n_samples=S, render_im_sz=8,
                         in_img_sz=32, shapenet_obj_cood=True))
    for name in ("_field_for", "_composite_for", "_composite_for_v"):
        setattr(stub, name, types.MethodType(getattr(JaxTTODriver, name), stub))
    return stub


def _assert_pngs_close(port_dir, jax_dir, expect):
    assert sorted(os.listdir(port_dir)) == sorted(os.listdir(jax_dir)) == sorted(expect)
    for name in expect:
        a = read_png(os.path.join(port_dir, name)).astype(int)
        b = read_png(os.path.join(jax_dir, name)).astype(int)
        assert a.shape == b.shape, name
        assert np.abs(a - b).max() <= 1, (name, np.abs(a - b).max())


@pytest.mark.parametrize("vis,sz", [(1, 128), (2, 64)])
def test_save_vis_matches_jax(models, jax_jitter, tmp_path, vis, sz):
    """One batch of 2 objects: TTO results from the port's run_tto_batch,
    then each driver's _save_vis on them. vis 1 writes opt000 and opt100 (the
    first and last snapshot, the last one's metrics at iteration num_opts -
    1), vis 2 every iteration's panel; both the 8-view sheet."""
    jdec, params, tmodel = models
    drv = TTODriver(tmodel, np.zeros(32, np.float32), np.zeros(32, np.float32), HPAMS, Views(),
                    str(tmp_path / "port"), device="cpu", reg_iters=REG, batch_size=2, vis=vis,
                    vis_im_sz=sz)
    assert drv.cfg.emit_code_curves == (vis == 2)
    samples, prepped, batch = drv._prep([0, 1])
    res = core.run_tto_batch(tmodel, drv.wts, batch, drv.mean_shape, drv.mean_texture, drv.cfg,
                             generator=drv.render_gen)
    res = {k: v.detach().numpy() for k, v in res.items()}
    names = drv._bookkeep([0, 1], samples, prepped, res)
    drv._save_vis(names, prepped, res)
    stub = _jax_driver_stub(jdec, params, str(tmp_path / "jax"), vis, sz)
    with jax.disable_jit():     # op by op: each render's lax.map would compile anew
        for i, name in enumerate(names):
            JaxTTODriver._save_vis(stub, name, prepped[i], res, i)
    frames = [0, 100] if vis == 1 else range(ITERS)
    for name in names:
        _assert_pngs_close(tmp_path / "port" / name, tmp_path / "jax" / name,
                           [f"opt{t:03d}.png" for t in frames] + ["virt_final.png"])
        panel = read_png(tmp_path / "port" / name / "opt000.png")
        assert panel.shape == (sz, 3 * sz, 3)
        assert read_png(tmp_path / "port" / name / "virt_final.png").shape == (
            2 * min(sz, 64), 4 * min(sz, 64), 3)
    assert set(drv.ssim_eval) == set(stub.ssim_eval) == set(names)
    for name in names:
        np.testing.assert_allclose(drv.ssim_eval[name], stub.ssim_eval[name], atol=1e-4)


def test_code_curves_agree_with_the_snapshots(models, tmp_path):
    """emit_code_curves: (B, num_opts, ...) codes and poses taken before each
    update, equal to the snapshots at the CODE_SAVE_ITERS below num_opts; the
    pose of the last entry is the saved final pose; nothing else moves."""
    _, _, tmodel = models
    drv = TTODriver(tmodel, np.zeros(32, np.float32), np.zeros(32, np.float32), HPAMS, Views(),
                    str(tmp_path), device="cpu", reg_iters=REG)
    _, _, batch = drv._prep([0, 1])
    runs = []
    for emit in (False, True):
        cfg = core.TTOConfig(**{**drv.cfg.__dict__, "emit_code_curves": emit})
        runs.append(core.run_tto_batch(tmodel, drv.wts, batch, drv.mean_shape, drv.mean_texture,
                                       cfg, generator=torch.Generator().manual_seed(3)))
    plain, curves = runs
    assert curves["shapecode_curve"].shape == (2, ITERS, 32)
    assert curves["pose_curve"].shape == (2, ITERS, 3, 4)
    for i, t in enumerate(core.CODE_SAVE_ITERS):
        if t < ITERS:
            assert torch.equal(curves["shapecode_curve"][:, t], curves["shapecodes_saved"][:, i])
            assert torch.equal(curves["texturecode_curve"][:, t],
                               curves["texturecodes_saved"][:, i])
            assert torch.equal(curves["pose_curve"][:, t], curves["poses_saved"][:, i])
    assert torch.equal(curves["pose_curve"][:, -1], curves["final_pose"])
    assert not torch.equal(curves["shapecode_curve"][:, -1], curves["final_shapecode"])
    for k, v in plain.items():
        assert torch.equal(v, curves[k]), k
    assert "shapecode_curve" not in plain


@pytest.mark.parametrize("vis", [1, 2])
def test_optimize_cli_writes_the_panels(tmp_path, vis):
    """--vis through the CLI: each object's folder holds the panels and the
    sheet, and the results file has one finite SSIM in [-1, 1] per object."""
    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps(dict(HPAMS, model_dir=str(tmp_path / "no_checkpoint"))))
    out = tmp_path / "run"
    n = 2 if vis == 1 else 1
    optimize.main(["--config_file", str(cfg), "--dataset", "synthetic", "--num_objects", str(n),
                   "--batch_size", "2", "--device", "cpu", "--save_dir", str(out),
                   "--vis", str(vis)])
    with open(out / "codes+poses.pkl", "rb") as f:
        res = pickle.load(f)
    assert set(res["ssim_eval"]) == {f"ann_{i}_CAM_FRONT" for i in range(n)}
    for name, values in res["ssim_eval"].items():
        assert len(values) == 1 and -1.0 <= values[0] <= 1.0
        frames = [0, 100] if vis == 1 else range(ITERS)
        assert sorted(os.listdir(out / name)) == sorted(
            [f"opt{t:03d}.png" for t in frames] + ["virt_final.png"])
        assert read_png(out / name / "opt000.png").shape == (128, 384, 3)
        assert read_png(out / name / "virt_final.png").shape == (128, 256, 3)


# --------------------------------------------------------------------------
# the trainer's log sink
# --------------------------------------------------------------------------

class Capture:
    """A tensorboard writer that keeps what it is given."""

    def __init__(self):
        self.scalars, self.images = [], []

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, value, step))

    def add_image(self, tag, img, step):
        self.images.append((tag, img, step))


def _port_trainer(tmodel, save_dir, dataset, **kw):
    return port_trainer.UnifiedTrainer(tmodel, HPAMS, dataset, str(save_dir), device="cpu",
                                       batch_size=2, **kw)


def test_trainer_log_matches_jax(models, jax_jitter, tmp_path):
    """The same step's metrics through the JAX trainer's _log and the
    port's: one metrics.jsonl line holding the capture's scalars at its
    step; the panel of the same sample, codes and decoder through the JAX
    trainer's _log_vis and the port's: within 1 level, at the same step."""
    jdec, params, tmodel = models
    ds = Views(2)
    ours = _port_trainer(tmodel, tmp_path / "port", ds)
    ours.state.niter = 7
    names = port_trainer.METRIC_NAMES["unified"]
    metrics = {k: float(i) / 3 for i, k in enumerate(names)}
    cap = Capture()
    stub = types.SimpleNamespace(
        writer=cap, metrics_history=[], dataset=ds, instoken2idx=ours.instoken2idx, hpams=HPAMS,
        model=jdec, state=types.SimpleNamespace(
            niter=7, params=params, batch_stats={},
            shape_codes=ours.state.shape_codes.numpy().copy(),
            texture_codes=ours.state.texture_codes.numpy().copy()))
    JaxTrainer._log(stub, metrics, 0.25, 7, fetched=True)
    ours._log(metrics, 0.25, 7)
    lines = (tmp_path / "port" / "runs" / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == 1
    assert json.loads(lines[0]) == {"step": 7, **{tag: v for tag, v, _ in cap.scalars}}
    assert {step for _, _, step in cap.scalars} == {7}

    JaxTrainer._log_vis(stub, 1)
    ours._log_vis(1)
    (tag, img, step), = cap.images
    assert tag == "train_panel" and step == 7
    panel = read_png(tmp_path / "port" / "runs" / "train_panel_0000007.png").astype(int)
    ref = img.transpose(1, 2, 0).astype(int)
    assert panel.shape == ref.shape == (64, 128, 3)
    assert np.abs(panel - ref).max() <= 1


def test_cli_train_writes_the_log(tmp_path):
    """cli.train at --check_iter 2: 8 objects, batch 2, 1 epoch (4 steps,
    one checkpoint): a finite line per step with JAX's scalar names, panels
    at steps 2 and 4 of the epoch's first sample."""
    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps(dict(HPAMS, model_dir=str(tmp_path / "no_checkpoint"))))
    out = tmp_path / "run"
    train.main(["--config_file", str(cfg), "--dataset", "synthetic", "--num_objects", "8",
                "--batch_size", "2", "--epochs", "1", "--device", "cpu", "--save_dir", str(out),
                "--check_iter", "2"])
    runs = out / "runs"
    assert sorted(os.listdir(runs)) == ["metrics.jsonl", "train_panel_0000002.png",
                                        "train_panel_0000004.png"]
    lines = [json.loads(x) for x in (runs / "metrics.jsonl").read_text().splitlines()]
    assert [x["step"] for x in lines] == [1, 2, 3, 4]
    for x in lines:
        assert set(x) == {"step", "time/train", *port_trainer.METRIC_NAMES["unified"]}
        assert all(np.isfinite(v) for v in x.values())
    assert read_png(runs / "train_panel_0000004.png").shape == (64, 128, 3)


def test_trainer_vis_failure_raises(models, tmp_path, monkeypatch):
    """A failed panel stops training (the JAX trainer prints and goes on);
    log_writer=False writes no log and renders no panel."""
    _, _, tmodel = models

    def fail(*args, **kwargs):
        raise RuntimeError("render failed")

    monkeypatch.setattr(port_trainer, "render_full_image", fail)
    ours = _port_trainer(tmodel, tmp_path / "on", Views(2), check_iter=1)
    with pytest.raises(RuntimeError, match="render failed"):
        ours.training_epoch()
    quiet = _port_trainer(tmodel, tmp_path / "off", Views(2), check_iter=1, log_writer=False)
    quiet.training_epoch()
    assert not (tmp_path / "off" / "runs").exists()
    assert len(quiet.metrics_history) == 1
