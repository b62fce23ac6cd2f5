"""The training options of the port's step (supnerf_tpu_torch/training/
train_step.py) against the JAX package's make_train_step on its flax path
on the CPU, at the tiny shapes of test_torch_train_step.py: the unified loss
with im_enc_rate 0.5, finetune_wlh (a net with the wlh head), gradient
clipping and the cosine schedule, and the NeRF-only loss (AutoRFMix) with
im_enc_rate 0.5, each over a step with the encoder off and one with it on.
enc_active is JAX's draw for the step's key, fed to the port (ROADMAP
C.17); each port step starts from the JAX state before it
(models/convert.convert_train_state). Beside them, clip_by_global_norm
against optax on random gradients on both sides of its trigger, and the
cosine factor against optax.cosine_decay_schedule.

Tolerances, as test_torch_train_step.py states them: losses rtol 1e-4;
parameters and code tables rtol 5e-3 / atol 3e-4; each tensor's mean update
rtol 1e-2; the first moments to 1e-3 of each tensor's largest value for the
pose refiner and the wlh head and 1e-2 elsewhere (the ResNet trunk's,
float32 noise of BatchNorm over 1 x 1 maps, not compared); BatchNorm
running statistics rtol 1e-5 with a 5e-5 floor; optimized_idx and the counts
exactly. The clipped gradients and the schedule's factor rtol 1e-6 (float32
and float64 evaluations of the same formula)."""
import copy

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

import torch_threads  # noqa: F401
from supnerf_tpu.data.synthetic import make_synthetic_object
from supnerf_tpu.models import build_model as jax_build_model
from supnerf_tpu.training import TrainBatch as JaxBatch
from supnerf_tpu.training import TrainConfig as JaxConfig
from supnerf_tpu.training import init_train_state as jax_init_state
from supnerf_tpu.training import make_train_step
from supnerf_tpu.training.ray_prep import prepare_train_sample as jax_prepare
from supnerf_tpu_torch.models.convert import convert_train_state
from supnerf_tpu_torch.optim import clip_by_global_norm
from supnerf_tpu_torch.training import train_step as port
from torch_memory import release_memory_after_module  # noqa: F401

CODE_IDX = (0, 1, 0, 2)
RATE = 0.5
# the unified case: every option of this slice at once. CLIP lies below the
# model's gradient norm (~650, most of it the ResNet trunk's, whose norm the
# two packages agree on to ~1e-4 though its small components are float32
# noise) and above the tables' (~0.02), checked below; it scales the
# model's gradients by ~0.015, far above AdamW's eps, where the update is
# insensitive to that noise

CLIP, COSINE_T = 10.0, 3
UNIFIED = {"arch": "supnerf", "net_hyperparams": {"shape_blocks": 1, "texture_blocks": 1,
                                                  "latent_dim": 32, "pose_shortcut": 1,
                                                  "pred_wlh": 1},
           "jax": dict(latent_dim=32, im_enc_rate=RATE, finetune_wlh=True, loss_wlh_coef=0.5,
                       grad_clip=CLIP, lr_schedule_type="cosine",
                       cosine_total_steps=COSINE_T)}
NERF_ONLY = {"arch": "autorfmix", "net_hyperparams": {"shape_blocks": 2, "texture_blocks": 1,
                                                      "latent_dim": 32},
             "jax": dict(latent_dim=32, im_enc_rate=RATE, lr_interval_model=1,
                         lr_interval_codes=1)}
FIRST_MOMENT_TIGHT = ("pose_layer_", "regress_layer_", "out_delta_layer", "img_encoder.fc_wlh")


def _batch():
    """Synthetic objects through the JAX prep (compact rays); each refiner
    source pose its ground truth turned 0.2 rad and moved 0.5 m; the
    corners and the sizes the refiner sees augmented by fixed factors."""
    rng = np.random.default_rng(0)
    c, s_ = np.cos(0.2), np.sin(0.2)
    turn = np.array([[c, 0, s_], [0, 1, 0], [-s_, 0, c]], np.float32)
    fac = np.float32([1.06, 0.95, 1 / (1.06 * 0.95)])
    rows = []
    for i, idx in enumerate(CODE_IDX):
        s = make_synthetic_object(seed=20 + i)
        gt = np.asarray(s["obj_poses"], np.float32)
        src = np.concatenate([turn @ gt[:, :3], gt[:, 3:] + [[0.5], [0.0], [0.5]]], 1)

        def corners(wlh):
            w, l, h = wlh
            box = (np.array([[1, 1, 1, 1, -1, -1, -1, -1], [1, -1, -1, 1, 1, -1, -1, 1],
                             [1, 1, -1, -1, 1, 1, -1, -1]]) * np.array([[l], [w], [h]]) / 2)
            uvz = s["cam_intrinsics"] @ (gt[:, :3] @ box + gt[:, 3:])
            return (uvz / uvz[2:])[:2].astype(np.float32)

        row = jax_prepare(s, n_rays=32, n_samples=8, in_img_sz=32, rng=rng,
                          src_pose=src.astype(np.float32), code_idx=idx, compact_rays=True,
                          tgt_uv=corners(s["wlh"]))
        row["wlh_aug"] = (row["wlh"] * fac).astype(np.float32)
        row["tgt_uv_aug"] = corners(row["wlh_aug"])
        rows.append(row)
    return {k: np.stack([r[k] for r in rows]) for k in rows[0]}


def _keys_off_then_on():
    """The first two PRNG keys whose step draws the encoder off, then on
    (JAX's train step: uniform(split(key)[0]) < im_enc_rate)."""
    found = {}
    for k in range(64):
        key = jax.random.PRNGKey(k)
        on = bool(jax.random.uniform(jax.random.split(key)[0], ()) < RATE)
        found.setdefault(on, key)
        if len(found) == 2:
            return [(found[False], False), (found[True], True)]
    raise AssertionError("no key drew both encoder states")


@pytest.fixture(scope="module", params=["unified", "nerf_only"])
def run(request):
    """Two JAX steps from the initial state (encoder off, then on) and each
    port step from the converted JAX state before it, with JAX's
    enc_active."""
    mode = request.param
    case = UNIFIED if mode == "unified" else NERF_ONLY
    hpams = {"arch": case["arch"], "net_hyperparams": case["net_hyperparams"]}
    jmodel = jax_build_model(case["arch"], case["net_hyperparams"])
    jcfg = JaxConfig(field_impl="flax", **case["jax"])
    pcfg = port.TrainConfig(**case["jax"])
    state = jax.tree.map(np.asarray, jax_init_state(jmodel, jax.random.PRNGKey(0), n_instances=3,
                                                    cfg=jcfg, img_size=32))
    arrays = _batch()
    jbatch = JaxBatch(**{k: jnp.asarray(v) for k, v in arrays.items()})
    pbatch = port.TrainBatch.from_numpy(arrays, "cpu")
    step = make_train_step(jmodel, jcfg, donate=False, loss_mode=mode)
    converted, out = [convert_train_state(state, hpams, cfg=pcfg)], []
    for key, on in _keys_off_then_on():
        state, jm = step(state, jbatch, key)
        converted.append(convert_train_state(jax.tree.map(np.asarray, state), hpams, cfg=pcfg))
        ours = copy.deepcopy(converted[-2])
        pm = port.train_step(ours, pbatch, pcfg, loss_mode=mode, enc_active=on)
        out.append({"on": on, "before": converted[-2], "port": ours, "port_metrics": pm,
                    "jax": converted[-1], "jax_metrics": jax.device_get(jm)})
    return mode, pcfg, out


def test_option_steps_match_jax(run):
    """Each step: the metrics (loss_wlh among them for finetune_wlh) and
    their values, loss_code 0 on the NeRF-only loss's inactive step;
    parameters, running statistics (moved on both steps), tables, first
    moments, optimized_idx and counts after it; in the unified case the
    first step's clipping engaged on the model and not on the tables."""
    mode, pcfg, steps = run
    for t, r in enumerate(steps):
        jm, pm = r["jax_metrics"], r["port_metrics"]
        assert float(jm["enc_active"]) == pm["enc_active"] == float(r["on"])
        assert list(pm) == sorted(jm) == list(port.metric_names(mode, pcfg))
        for k in pm:
            np.testing.assert_allclose(pm[k], float(jm[k]), rtol=1e-4, atol=1e-7,
                                       err_msg=f"step {t}: {k}")
        if mode == "nerf_only" and not r["on"]:
            assert pm["loss_code"] == 0.0
        ours, ref, start = (r[k].model.state_dict() for k in ("port", "jax", "before"))
        assert set(ours) == set(ref)
        for k, v in ref.items():
            if k.endswith("num_batches_tracked"):
                continue
            if k.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(ours[k], v, rtol=1e-5, atol=5e-5,
                                           err_msg=f"step {t}: {k}")
                assert not torch.equal(ours[k], start[k]), f"step {t}: {k} did not move"
                continue
            np.testing.assert_allclose(ours[k], v, rtol=5e-3, atol=3e-4, err_msg=f"step {t}: {k}")
            np.testing.assert_allclose((ours[k] - start[k]).abs().mean(),
                                       (v - start[k]).abs().mean(), rtol=1e-2,
                                       err_msg=f"step {t}: mean update of {k}")
        p, j = r["port"], r["jax"]
        for got, want in ((p.shape_codes, j.shape_codes), (p.texture_codes, j.texture_codes)):
            np.testing.assert_allclose(got, want, rtol=5e-3, atol=3e-4, err_msg=f"step {t}")
        names = [n for n, _ in p.model.named_parameters()] + ["shape_codes", "texture_codes"]
        for name, a, b in zip(names, p.opt_model.m + p.opt_codes.m, j.opt_model.m + j.opt_codes.m):
            if name.startswith("img_encoder.") and not name.startswith("img_encoder.fc_"):
                continue
            rtol = 1e-3 if name.startswith(FIRST_MOMENT_TIGHT) else 1e-2
            err, scale = float((a - b).abs().max()), float(b.abs().max())
            assert err <= rtol * scale, f"step {t}: first moment of {name}: {err:.3e} of {scale:.3e}"
        assert p.opt_model.count == j.opt_model.count == p.opt_codes.count == t + 1
        np.testing.assert_array_equal(p.optimized_idx, j.optimized_idx)
        assert p.niter == j.niter == t + 1
        if mode == "unified" and t == 0:
            # the first moments are 0.1 x the clipped gradients: the model's
            # at global norm CLIP (clipped), the tables' below it (kept)
            def norm(ms):
                return float(torch.sqrt(sum(torch.sum((m / 0.1) ** 2) for m in ms)))

            np.testing.assert_allclose(norm(p.opt_model.m), CLIP, rtol=1e-4)
            assert norm(p.opt_codes.m) < CLIP


def test_encoder_gate_decides_the_loss(run):
    """loss_total recomposed from the reported terms under each step's
    enc_active (the check chip_smoke.py makes on the card); the encoder
    off: its codes' and corner losses' parameters get no gradient (no first
    moment) beyond what finetune_wlh's term gives the encoder."""
    mode, pcfg, steps = run
    for r in steps:
        m, on = r["port_metrics"], r["on"]
        want = m["loss_rgb"] + pcfg.loss_occ_coef * m["loss_occ"]
        if mode == "unified":
            want += pcfg.loss_wlh_coef * m["loss_wlh"]
            if on:
                want += pcfg.loss_pose_coef * (m["loss_pose_direct"] + (
                    m["loss_pose_iter1"] + m["loss_pose_iter2"] + m["loss_pose_iter3"]) / 3)
                want += pcfg.loss_code_coef * m["loss_code"]
        else:
            want += pcfg.loss_code_coef * m["loss_code"]
        np.testing.assert_allclose(m["loss_total"], want, rtol=1e-5)
    off = steps[0]
    assert not off["on"]
    idle = (("img_encoder.fc_shape", "img_encoder.fc_texture", "img_encoder.fc_uv",
             "img_encoder.fc_pose", "pose_layer_", "regress_layer_", "out_delta_layer")
            if mode == "unified" else ("img_encoder.",))
    names = [n for n, _ in off["port"].model.named_parameters()]
    assert sum(n.startswith(idle) for n in names) > 2
    for name, mom in zip(names, off["port"].opt_model.m):
        if name.startswith(idle):
            assert float(mom.abs().max()) == 0.0, name


@pytest.mark.parametrize("max_norm", [0.5, 50.0], ids=["clipped", "kept"])
def test_clip_by_global_norm_matches_optax(max_norm):
    rng = np.random.default_rng(4)
    tree = [rng.normal(0, 1, s).astype(np.float32) for s in ((7, 3), (5,), (2, 2, 2))]
    norm = np.sqrt(sum(float((a.astype(np.float64) ** 2).sum()) for a in tree))
    assert (norm > max_norm) == (max_norm == 0.5)
    tx = optax.clip_by_global_norm(max_norm)
    want, _ = tx.update([jnp.asarray(a) for a in tree], tx.init(tree))
    got = clip_by_global_norm([torch.from_numpy(a) for a in tree], max_norm)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


def test_cosine_factor_matches_optax():
    """At the count before each update, past T too; lr_scale chooses the
    schedule."""
    T, lr = 7, 3e-4
    sched = optax.cosine_decay_schedule(lr, T)
    cfg = port.TrainConfig(lr_schedule_type="cosine", cosine_total_steps=T)
    for count in (0, 1, 3, 6, 7, 8, 20):
        np.testing.assert_allclose(lr * port.lr_scale(cfg, count, 1), float(sched(count)),
                                   rtol=1e-6, atol=1e-12, err_msg=f"count {count}")
    assert port.lr_scale(port.TrainConfig(), 5, 2) == port.step_scale(5, 2) == 0.25
    with pytest.raises(ValueError, match="lr_schedule_type"):
        port.TrainConfig(lr_schedule_type="linear")


def test_scatter_rows_sums_duplicates_in_batch_order():
    """The tables' scatter-add: the bits of a sequential index_add_ (the
    CPU's), for batches with repeated instances (chip_smoke.py checks that
    it repeats itself on the card)."""
    g = torch.Generator().manual_seed(0)
    for _ in range(20):
        idx = torch.randint(0, 6, (16,), generator=g)
        rows = torch.randn(16, 8, generator=g)
        table = torch.zeros(9, 8)
        assert torch.equal(port.scatter_rows(table, idx, rows),
                           torch.zeros_like(table).index_add_(0, idx, rows))


@pytest.mark.parametrize("keys", [
    {},
    {"grad_clip": 2.5, "lr_schedule_type": "cosine", "cosine_total_steps": 7},
    {"lr_schedule_type": "linear"},
], ids=["defaults", "clip_and_cosine", "unknown_schedule"])
def test_train_config_reads_the_optimizer_options(keys):
    """The trainer's TrainConfig takes grad_clip, lr_schedule_type and
    cosine_total_steps from the config json, TrainConfig's defaults where
    the config has none, and refuses a schedule it does not know."""
    from supnerf_tpu_torch.training.trainer import train_config_from_hpams

    hpams = {"net_hyperparams": {"latent_dim": 32}, **keys}
    if keys.get("lr_schedule_type") == "linear":
        with pytest.raises(ValueError, match="lr_schedule_type"):
            train_config_from_hpams(hpams)
        return
    cfg = train_config_from_hpams(hpams)
    want = {**{k: getattr(port.TrainConfig(), k)
               for k in ("grad_clip", "lr_schedule_type", "cosine_total_steps")}, **keys}
    assert {k: getattr(cfg, k) for k in want} == want
    assert cfg.latent_dim == 32
