"""An object's TTO run does not depend on the batch it is in (ROADMAP C.27):
run_tto_batch on 8 objects at batch 1, 2 and 4, each object fed the same
draws in every layout (the JAX loop's: fold_in(split(key, 8)[b], t), as
tests/test_torch_tto.py feeds them), at the tiny shapes of
tests/test_torch_tto.py with sym_aug, iterations 0 to 5 (three replayed,
three AdamW steps).

The bound is the JAX package's own spread over the same layouts, objects,
weights and draws (tests/tto_layout_witness.py, which feeds the JAX loop
each object's key whatever its batch): the largest difference from batch 1
at iterations 0-5, over batch 2 and 4, of the codes, the rotation and the
translation of the rendered pose, LAYOUT_SPREAD. JAX's layouts part first
in the refiner (its batched dot over the B objects: ~4e-7 in rotation and
~4e-6 in translation at iteration 1), and Adam carries that on once the
steps start.

The port runs the refiner's layers one object at a time and
conditioned_latents' projections as one batched product of a single row
per object, so every layout gives batch 1's bits (the second test). Run
over all B rows (the witness's --rows batched) they are the
first ops to part, the CPU library rounding each row with the row count:
the refiner's Linear (addmm; 3.0e-8 in its first layer's output), then
the latents' einsum (bmm; 1.9e-9); the decoder's matmuls do not. There,
object 6's batch-2 refined pose lies one float32 step from batch 1's,
where both packages' float32 translation gradient sits 6.7e-5 from
float64's across a component whose float64 value is -5.5e-6, and the
first AdamW step takes the other sign: 2.0e-2 in translation at
iteration 4.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_threads  # noqa: F401
from supnerf_tpu.data.synthetic import make_object_batch
from supnerf_tpu.geometry import poses as jax_poses
from supnerf_tpu.models import build_model as jax_build_model
from supnerf_tpu.models import init_model_variables
from supnerf_tpu_torch.models.convert import convert_supnerf_variables
from supnerf_tpu_torch.models.factory import build_model
from supnerf_tpu_torch.ops.render import pack_decoder_params
from supnerf_tpu_torch.tto import core

TINY_HP = {"shape_blocks": 1, "texture_blocks": 1, "latent_dim": 32, "pose_shortcut": 1,
           "pred_wlh": 0}
N, REG, T = 8, 2, 6
LAYOUTS = (2, 4)
COMMON = dict(num_opts=T, reg_iters=REG, n_samples=8, render_im_sz=8, in_img_sz=32, n_lidar=16,
              shapenet_obj_cood=True, sym_aug=True, emit_code_curves=True)
PORT_CFG = core.TTOConfig(**COMMON)
# JAX's own layout spread, iterations 0-5 (tests/tto_layout_witness.py)
LAYOUT_SPREAD = {"code": 8.28e-5, "rotation": 1.21e-5, "translation": 1.70e-4}


def setup():
    """(the JAX model, its variables, the 8 objects' arrays, the port's
    model, the draws (loss jitter, depth jitter, flips), (T, N, ...) each,
    the objects' keys)."""
    jmodel = jax_build_model("supnerf", TINY_HP)
    variables = jax.tree.map(np.asarray, init_model_variables(
        jmodel, jax.random.PRNGKey(0), img_size=32))
    raw, _ = make_object_batch(N, seed=3, in_img_sz=32, render_im_sz=8, n_lidar=16)
    keys = jax.random.split(jax.random.PRNGKey(7), N)
    raw["pose_init"] = np.asarray(jax.vmap(
        lambda k, K, roi: jax_poses.get_random_pose2(k, K, roi.astype(jnp.float32)))(
        keys, jnp.asarray(raw["K"]), jnp.asarray(raw["roi_nerf"])))
    tmodel = build_model("supnerf", TINY_HP)
    tmodel.load_state_dict(convert_supnerf_variables(variables, TINY_HP), strict=True)
    obj_keys = jax.random.split(jax.random.PRNGKey(0), N)
    it_keys = [[jax.random.fold_in(obj_keys[b], t) for b in range(N)] for t in range(T)]

    def each(fn):
        return np.asarray([[np.asarray(fn(k)) for k in row] for row in it_keys])

    draws = (each(lambda k: jax.random.uniform(k, (8,))),
             each(lambda k: jax.random.uniform(jax.random.fold_in(k, 1), (8,))),
             each(lambda k: jax.random.bernoulli(jax.random.fold_in(k, 3))))
    return jmodel, variables, raw, tmodel, draws, obj_keys


def port_run(tmodel, raw, draws, batch: int) -> dict:
    """run_tto_batch over the 8 objects in batches of `batch`, each batch
    given its objects' rows of the draws; the results concatenated."""
    wts = pack_decoder_params(tmodel)
    outs = []
    for s in range(0, N, batch):
        idx = list(range(s, s + batch))
        b = core.ObjectBatch.from_numpy({k: v[idx] for k, v in raw.items()}, "cpu")
        res = core.run_tto_batch(tmodel, wts, b, torch.zeros(32), torch.zeros(32), PORT_CFG,
                                 jitter=(torch.from_numpy(draws[0][:, idx]),
                                         torch.from_numpy(draws[1][:, idx])),
                                 sym_flips=torch.from_numpy(draws[2][:, idx]))
        outs.append({k: v.detach().numpy() for k, v in res.items()})
    return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}


def spread(a: dict, b: dict) -> dict:
    """The largest difference of b from a at iterations 0..T-1: codes, and
    the rendered pose's rotation and translation."""
    pa, pb = a["pose_curve"], b["pose_curve"]
    return {"code": max(float(np.abs(a[k] - b[k]).max())
                        for k in ("shapecode_curve", "texturecode_curve")),
            "rotation": float(np.abs(pa[..., :3] - pb[..., :3]).max()),
            "translation": float(np.abs(pa[..., 3] - pb[..., 3]).max())}


@pytest.fixture(scope="module")
def runs():
    _, _, raw, tmodel, draws, _ = setup()
    return {batch: port_run(tmodel, raw, draws, batch) for batch in (1,) + LAYOUTS}


@pytest.mark.parametrize("batch", LAYOUTS)
def test_batched_layout_within_jax_layout_spread(runs, batch):
    """Batch 2 and 4 against batch 1, iterations 0-5: codes and the
    rendered pose within the JAX package's own spread over the same
    layouts. On the CPU the bits test below implies this one; the bound
    does its work on the card, where chip_smoke.py's batch-layout phase
    holds the port's layouts to the same LAYOUT_SPREAD."""
    got = spread(runs[1], runs[batch])
    print(f"batch {batch} against batch 1: {got}; JAX's spread {LAYOUT_SPREAD}")
    for k, bound in LAYOUT_SPREAD.items():
        assert got[k] <= bound, (k, got[k], bound)


@pytest.mark.parametrize("batch", LAYOUTS)
def test_batched_layout_is_batch_one_bits(runs, batch):
    """Every result of run_tto_batch (saved and final codes and poses, every
    curve, the refiner's trajectory) at batch 2 and 4 is batch 1's, bit for
    bit."""
    for k, v in runs[1].items():
        np.testing.assert_array_equal(runs[batch][k], v, err_msg=k)
