"""The port's training slice (supnerf_tpu_torch/training/) against the JAX
package on the CPU, at the tiny shapes of tests/test_train_step.py: the
per-sample ray prep on the same sample and random stream, and one and three
train steps against make_train_step on its flax path, on the same batch
(with a duplicate instance), each step of the port starting from the JAX
TrainState before it (models/convert.convert_train_state).

Tolerances: losses rtol 1e-4; parameters and code tables rtol 5e-3 / atol
3e-4, as test_train_step.py compares its two step implementations (AdamW
divides each gradient by its own magnitude, so a near-zero gradient
component can move by a full step under float32 reassociation); the mean
update of each tensor rtol 1e-2; the optimizers' first moments (0.1 x the
gradient, plus the carried moment) to 1e-3 of each tensor's largest value
for the pose refiner and 1e-2 for the decoder, the encoder's heads and the
code tables;
BatchNorm running statistics rtol 1e-5 with a 5e-5 floor; optimized_idx and
the counts exactly. lr_interval 1 halves both learning rates on every step."""
import copy
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
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
from supnerf_tpu_torch.models.convert import (_adam_moments, convert_supnerf_variables,
                                              convert_train_state)
from supnerf_tpu_torch.optim import AdamW
from supnerf_tpu_torch.training import train_step as port
from supnerf_tpu_torch.training.ray_prep import prepare_train_sample
from torch_memory import release_memory_after_module  # noqa: F401

TINY_HP = {"shape_blocks": 1, "texture_blocks": 1, "latent_dim": 32,
           "pose_shortcut": 1, "pred_wlh": 0}
HPAMS = {"arch": "supnerf", "net_hyperparams": TINY_HP}
CODE_IDX = (0, 1, 0, 2)        # instance 0 twice: its row gradients add up
N_STEPS = 3
PORT_CFG = port.TrainConfig(latent_dim=32, lr_interval_model=1, lr_interval_codes=1)
REFINER = ("pose_layer_", "regress_layer_", "out_delta_layer")
LOSSES = ("loss_total", "loss_rgb", "loss_occ", "psnr", "loss_reg", "loss_code",
          "loss_pose_direct", "loss_pose_iter1", "loss_pose_iter2", "loss_pose_iter3")


def _rows(compact=True, n_rays=32):
    """The batch: synthetic objects through the JAX prep, each refiner source
    pose its ground truth turned by 0.2 rad about the camera's y axis and
    moved 0.5 m, the ground-truth corners projected in numpy."""
    rng = np.random.default_rng(0)
    c, s_ = np.cos(0.2), np.sin(0.2)
    turn = np.array([[c, 0, s_], [0, 1, 0], [-s_, 0, c]], np.float32)
    rows = []
    for i, idx in enumerate(CODE_IDX):
        s = make_synthetic_object(seed=20 + i)
        gt = np.asarray(s["obj_poses"], np.float32)
        src = np.concatenate([turn @ gt[:, :3], gt[:, 3:] + [[0.5], [0.0], [0.5]]], 1)
        w, l, h = s["wlh"]
        corners = (np.array([[1, 1, 1, 1, -1, -1, -1, -1], [1, -1, -1, 1, 1, -1, -1, 1],
                             [1, 1, -1, -1, 1, 1, -1, -1]]) * np.array([[l], [w], [h]]) / 2)
        uvz = s["cam_intrinsics"] @ (gt[:, :3] @ corners + gt[:, 3:])
        rows.append(jax_prepare(s, n_rays=n_rays, n_samples=8, in_img_sz=32, rng=rng,
                                src_pose=src.astype(np.float32), code_idx=idx,
                                compact_rays=compact, tgt_uv=uvz / uvz[2:]))
    return {k: np.stack([r[k] for r in rows]) for k in rows[0]}


@pytest.fixture(scope="module")
def start():
    """The JAX model, its step config, its initial TrainState (numpy leaves)
    and the batch's arrays, shared by the float32 and float64 comparisons."""
    jmodel = jax_build_model("supnerf", TINY_HP)
    jcfg = JaxConfig(latent_dim=32, im_enc_rate=1.0, lr_interval_model=1,
                     lr_interval_codes=1, field_impl="flax")
    state = jax_init_state(jmodel, jax.random.PRNGKey(0), n_instances=3, cfg=jcfg, img_size=32)
    return jmodel, jcfg, jax.tree.map(np.asarray, state), _rows()


@pytest.fixture(scope="module")
def runs(start):
    """N_STEPS steps of the JAX step from its initial state; and each step of
    the port from the JAX state before it (convert_train_state carries the
    parameters, buffers, tables, moments and counts). In float32 the two
    trajectories part within two steps: AdamW's first updates are lr * sign(g)
    and BatchNorm over 1 x 1 maps of 4 images leaves gradient components that
    are float32 noise, whose sign the two packages draw differently. The
    free-running comparison is test_float64_steps_run_free_with_jax."""
    jmodel, jcfg, state, arrays = start
    jbatch = JaxBatch(**{k: jnp.asarray(v) for k, v in arrays.items()})
    pbatch = port.TrainBatch.from_numpy(arrays, "cpu")
    step = make_train_step(jmodel, jcfg, donate=False)
    states, metrics = [state], []
    for t in range(N_STEPS):
        state, jm = step(state, jbatch, jax.random.PRNGKey(t))
        states.append(jax.tree.map(np.asarray, state))
        metrics.append(jax.device_get(jm))
    converted = [convert_train_state(st, HPAMS, cfg=PORT_CFG) for st in states]
    out = []
    for t in range(N_STEPS):
        pstate = copy.deepcopy(converted[t])
        out.append({"before": converted[t], "port": pstate,
                    "port_metrics": port.train_step(pstate, pbatch, PORT_CFG),
                    "jax": converted[t + 1], "jax_metrics": metrics[t]})
    return out


def _float64(tree):
    return jax.tree.map(lambda a: a.astype(np.float64) if a.dtype == np.float32 else a, tree)


@pytest.fixture(scope="module")
def runs64(start):
    """N_STEPS free-running steps of both packages in float64 from the same
    initial state (float32 values, so exact in both): the JAX step under
    jax.enable_x64, the port's step on its plain path with the model, the
    tables, the optimizers and the batch in float64. Returns the JAX states
    (numpy leaves) and metrics, and after each port step its metrics, model
    state_dict, tables, moments, counts and optimized_idx."""
    jmodel, jcfg, state, arrays = start
    states, metrics = [_float64(state)], []
    with jax.enable_x64(True):
        jstate = jax.tree.map(jnp.asarray, states[0])
        jbatch = JaxBatch(**{k: jnp.asarray(v) for k, v in _float64(arrays).items()})
        step = make_train_step(jmodel, jcfg, donate=False)
        for t in range(N_STEPS):
            jstate, jm = step(jstate, jbatch, jax.random.PRNGKey(t))
            states.append(jax.tree.map(np.asarray, jstate))
            metrics.append(jax.device_get(jm))
    assert states[-1].params["decoder"]["sigma"]["kernel"].dtype == np.float64
    p = convert_train_state(state, HPAMS, cfg=PORT_CFG)
    assert p.opt_model.count == p.opt_codes.count == 0
    model = p.model.double()
    sc, tc = p.shape_codes.double(), p.texture_codes.double()
    pstate = port.TrainState(model, sc, tc,
                             AdamW(list(model.parameters()), p.opt_model.lrs, p.opt_model.wd),
                             AdamW([sc, tc], p.opt_codes.lrs, p.opt_codes.wd),
                             p.optimized_idx.double())
    pbatch = port.TrainBatch.from_numpy(arrays, "cpu")
    pbatch = port.TrainBatch(**{f.name: getattr(pbatch, f.name).double()
                                if f.name != "code_idx" else pbatch.code_idx
                                for f in dataclasses.fields(pbatch)})
    ours = []
    for _ in range(N_STEPS):
        m = port.train_step(pstate, pbatch, PORT_CFG)
        ours.append({"metrics": m, "model": copy.deepcopy(pstate.model.state_dict()),
                     "tables": (pstate.shape_codes.clone(), pstate.texture_codes.clone()),
                     "opt_model": copy.deepcopy(pstate.opt_model.state_dict()),
                     "opt_codes": copy.deepcopy(pstate.opt_codes.state_dict()),
                     "optimized_idx": pstate.optimized_idx.clone(), "niter": pstate.niter})
    return states, metrics, ours


def _close_to_max(got, want, rtol, what):
    """|got - want| <= rtol * max|want| over the tensor (gradient sums);
    returns the ratio."""
    err, scale = float((got - want).abs().max()), float(want.abs().max())
    assert err <= rtol * scale, f"{what}: max error {err:.3e} against max |.| {scale:.3e}"
    return err / scale if scale else 0.0


@pytest.mark.parametrize("n", [1, N_STEPS])
def test_train_steps_match_jax(runs, n):
    """Each of the first n steps: losses; parameters, BatchNorm running
    statistics, code tables, optimized_idx and counts after it; the mean
    size of each tensor's update (sensitive to the learning-rate schedule,
    which halves on every step here); and both optimizers' first moments,
    i.e. the gradients (sensitive to what a step differentiates)."""
    for t, r in enumerate(runs[:n]):
        jm, pm = r["jax_metrics"], r["port_metrics"]
        assert list(pm) == sorted(jm) == list(port.METRIC_NAMES["unified"])
        for k in LOSSES:
            np.testing.assert_allclose(pm[k], float(jm[k]), rtol=1e-4, err_msg=f"step {t}: {k}")
        assert pm["enc_active"] == float(jm["enc_active"]) == 1.0
        ours, ref, before = (r[k].model.state_dict() for k in ("port", "jax", "before"))
        assert set(ours) == set(ref)
        for k, v in ref.items():
            if k.endswith("num_batches_tracked"):
                continue
            if k.endswith(("running_mean", "running_var")):
                # 1e-5 relative; the 5e-5 floor covers the float32
                # reassociation of XLA's and torch's convolutions in the
                # variance of 4 samples on a 1 x 1 map (torch's unbiased
                # variance would be 4/3 of it there)
                np.testing.assert_allclose(ours[k], v, rtol=1e-5, atol=5e-5,
                                           err_msg=f"step {t}: {k}")
                continue
            np.testing.assert_allclose(ours[k], v, rtol=5e-3, atol=3e-4, err_msg=f"step {t}: {k}")
            step_ours, step_ref = (ours[k] - before[k]).abs().mean(), (v - before[k]).abs().mean()
            np.testing.assert_allclose(step_ours, step_ref, rtol=1e-2,
                                       err_msg=f"step {t}: mean update of {k}")
        p, j = r["port"], r["jax"]
        for got, want in ((p.shape_codes, j.shape_codes), (p.texture_codes, j.texture_codes)):
            np.testing.assert_allclose(got, want, rtol=5e-3, atol=3e-4, err_msg=f"step {t}")
        names = [name for name, _ in p.model.named_parameters()] + ["shape_codes",
                                                                      "texture_codes"]
        for name, a, b in zip(names, p.opt_model.m + p.opt_codes.m, j.opt_model.m + j.opt_codes.m):
            if name.startswith("img_encoder.") and not name.startswith("img_encoder.fc_"):
                continue     # ResNet trunk: BatchNorm over 1 x 1 maps of 4 images leaves
                             # these gradients to float32 noise (JAX's own float32 and
                             # float64 gradients differ by up to 70% there)
            # the refiner's MLP is well conditioned (float32 differences below 3e-4
            # of the largest component); elsewhere a ReLU of the 32-wide decoder
            # that flips between the two packages moves a gradient by ~6e-3
            rtol = 1e-3 if name.startswith(REFINER) else 1e-2
            _close_to_max(a, b, rtol, f"step {t}: first moment of {name}")
        assert p.opt_model.count == j.opt_model.count == p.opt_codes.count == t + 1
        np.testing.assert_array_equal(p.optimized_idx, j.optimized_idx)
        assert p.niter == j.niter == t + 1


@pytest.mark.parametrize("n", [1, N_STEPS])
def test_float64_steps_run_free_with_jax(runs64, n):
    """The first n of N_STEPS free-running float64 steps: each package
    carries its own state (moments, counts, BatchNorm buffers, tables) from
    step to step. The stated contract: losses rtol 1e-4; parameters and
    code tables rtol 5e-3 / atol 3e-4; BatchNorm running statistics rtol
    1e-5 (atol 1e-9, for running means that cancel to ~1e-5 where the two
    float64 sums differ by ~5e-11); optimized_idx and the counts exactly.
    Beside it, so that a wrong gradient cannot pass: each tensor's update
    since the start to 1e-3 of its largest component, and both optimizers'
    first and second moments of every tensor, the ResNet trunk's included,
    to 1e-5 of theirs (JAX values are rounded to float32 by the conversion,
    6e-8 relative). Run with -s for the worst readings."""
    states, metrics, ours = runs64
    hp, worst = TINY_HP, {}

    def convert(params, stats):
        return convert_supnerf_variables({"params": params, "batch_stats": stats}, hp)

    def diff(a, b):
        return jax.tree.map(lambda x, y: x - y, a, b)

    start_sd = convert(states[0].params, states[0].batch_stats)
    names = [name for name, _ in convert_train_state(states[0], HPAMS, cfg=PORT_CFG)
             .model.named_parameters()]
    for t in range(n):
        o, st, jm = ours[t], states[t + 1], metrics[t]
        for k in LOSSES:
            np.testing.assert_allclose(o["metrics"][k], float(jm[k]), rtol=1e-4,
                                       err_msg=f"step {t}: {k}")
        ref = convert(st.params, st.batch_stats)
        upd = convert(diff(st.params, states[0].params), diff(st.batch_stats,
                                                                states[0].batch_stats))
        assert set(o["model"]) == set(ref)
        for k, v in ref.items():
            got = o["model"][k]
            if k.endswith("num_batches_tracked"):
                assert int(got) == t + 1, k
                continue
            if k.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(got, v.double(), rtol=1e-5, atol=1e-9,
                                           err_msg=f"step {t}: {k}")
                continue
            np.testing.assert_allclose(got, v.double(), rtol=5e-3, atol=3e-4,
                                       err_msg=f"step {t}: {k}")
            r = _close_to_max(got - start_sd[k].double(), upd[k].double(), 1e-3,
                              f"step {t}: update of {k}")
            worst["update"] = max(worst.get("update", 0.0), r)
        for j, tbl in enumerate(("shape_codes", "texture_codes")):
            want, first = getattr(st, tbl), getattr(states[0], tbl)
            np.testing.assert_allclose(o["tables"][j], want, rtol=5e-3, atol=3e-4,
                                       err_msg=f"step {t}: {tbl}")
            r = _close_to_max(o["tables"][j] - torch.from_numpy(first),
                              torch.from_numpy(want - first), 1e-3, f"step {t}: update of {tbl}")
            worst["update"] = max(worst.get("update", 0.0), r)
        def by_name(mom):
            named = convert(mom, st.batch_stats)
            return [named[k] for k in names]

        for opt, tree, labels, conv in (
                ("opt_model", st.opt_state_model, names, by_name),
                ("opt_codes", st.opt_state_codes, ["shape_codes", "texture_codes"],
                 lambda mom: [torch.tensor(np.asarray(a)) for a in mom])):
            count, mu, nu = _adam_moments(tree)
            assert o[opt]["count"] == count == t + 1
            for which, mom in (("m", mu), ("v", nu)):
                for name, got, want in zip(labels, o[opt][which], conv(mom)):
                    r = _close_to_max(got, want.double(), 1e-5,
                                      f"step {t}: {which} of {name}")
                    worst[which] = max(worst.get(which, 0.0), r)
        np.testing.assert_array_equal(o["optimized_idx"], st.optimized_idx)
        assert o["niter"] == int(st.niter) == t + 1
    print(f"float64, {n} step(s): worst update / max {worst['update']:.2e}, "
          f"first moment {worst['m']:.2e}, second moment {worst['v']:.2e}")


def test_running_stats_move_only_in_training(runs):
    """The train step moved the encoder's running buffers; test-time
    optimization's encoder pass (no batch_stat_updates) leaves them."""
    model = runs[0]["port"].model
    before = runs[0]["before"].model.state_dict()["img_encoder.bn1.running_mean"]
    assert float((model.state_dict()["img_encoder.bn1.running_mean"] - before).abs().max()) > 0
    snapshot = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        model.encode_img(torch.rand(2, 32, 32, 3))
    for k, v in model.state_dict().items():
        assert torch.equal(v, snapshot[k]), k


def test_prepare_train_sample_matches_jax():
    """Same sample, same numpy stream: rays, targets, depths and ROI exactly;
    the encoder image at the resize tolerance of test_torch_geometry.py
    (interpolate instead of OpenCV); the projected corners to float32
    rounding (torch instead of jnp)."""
    s = make_synthetic_object(seed=5)
    src = np.asarray(s["obj_poses"], np.float32)
    for compact in (True, False):
        kw = dict(n_rays=64, n_samples=8, in_img_sz=32, src_pose=src, code_idx=2,
                  compact_rays=compact)
        ref = jax_prepare(s, rng=np.random.default_rng(3), **kw)
        ours = prepare_train_sample(s, rng=np.random.default_rng(3), **kw)
        assert set(ours) == set(ref)
        for k in ("xyz", "viewdir", "z_vals", "rgb_tgt", "occ_pixels", "roi", "K", "wlh",
                  "src_pose"):
            np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
        assert int(ours["code_idx"]) == int(ref["code_idx"]) == 2
        np.testing.assert_allclose(ours["img_in"], ref["img_in"], atol=1e-5)
        np.testing.assert_allclose(ours["tgt_uv"], ref["tgt_uv"], rtol=1e-5, atol=1e-3)


def test_expand_compact_rays_matches_expanded_prep():
    """expand_compact_rays on compact rows gives the host-expanded points up
    to float32 reassociation, and one direction per ray."""
    compact, full = _rows(compact=True, n_rays=16), _rows(compact=False, n_rays=16)
    b = port.expand_compact_rays(port.TrainBatch.from_numpy(compact, "cpu"))
    np.testing.assert_allclose(b.xyz.numpy(), full["xyz"], rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(b.viewdir.numpy(), full["viewdir"][:, :, 0], rtol=1e-6)
    e = port.expand_compact_rays(port.TrainBatch.from_numpy(full, "cpu"))
    assert tuple(e.viewdir.shape) == (len(CODE_IDX), 16, 3)


def test_lr_schedule_halves_at_the_count_before_the_update():
    assert [port.step_scale(c, 2) for c in range(5)] == [1.0, 1.0, 0.5, 0.5, 0.25]
