"""How far 100 float32 TTO iterations of the codes drift apart, at the tiny
shapes and the lr_half_40 case of tests/test_torch_tto_options.py: the
largest code difference at each of CODE_SAVE_ITERS between

  - the port and the JAX loop (run_tto_batch of each package);
  - the JAX loop and JAX itself outside the loop: optax (the loop's
    optimizer, reset and lr halving) stepped on jax.grad of the same loss
    at each iteration's draws;
  - the port and that JAX replay;
  - the port and the port with pose_init moved by 1e-7 of its size;

and, with the pose optimized too, the last iteration's rotation error
(rad) and PSNR of the port and of the port with pose_init so moved.

Run on the CPU: JAX_PLATFORMS=cpu python tests/tto_drift_witness.py
"""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import test_torch_tto_options as options  # noqa: E402
from supnerf_tpu.geometry.boxes import invert_pose  # noqa: E402
from supnerf_tpu.ops.volume_render import occupancy_loss, rgb_loss_masked  # noqa: E402
from supnerf_tpu.render.renderer import render_rays_frustum  # noqa: E402
from supnerf_tpu.tto import ObjectBatch as JaxBatch  # noqa: E402
from supnerf_tpu.tto import TTOConfig as JaxTTOConfig  # noqa: E402
from supnerf_tpu.tto import run_tto_batch as jax_run_tto_batch  # noqa: E402
from supnerf_tpu.tto.core import TTOParams, _make_optimizer  # noqa: E402
from supnerf_tpu_torch.ops.render import pack_decoder_params  # noqa: E402
from supnerf_tpu_torch.tto import core  # noqa: E402
from supnerf_tpu_torch.tto.core import CODE_SAVE_ITERS  # noqa: E402

CODES = ("shapecodes_saved", "texturecodes_saved")


def main():
    jax.config.update("jax_platforms", "cpu")
    jmodel, variables, raw, tmodel = options.tiny.__wrapped__()
    T, opts = options.CASES[options.FULL_LENGTH]
    jcfg = JaxTTOConfig(num_opts=T, field_impl="flax", **options.COMMON, **opts)
    pcfg = core.TTOConfig(num_opts=T, **options.COMMON, **opts)
    jres = jax.tree.map(np.asarray, jax_run_tto_batch(
        jmodel, variables, JaxBatch(**{k: jnp.asarray(v) for k, v in raw.items()}),
        jnp.zeros(32), jnp.zeros(32), jcfg, jax.random.PRNGKey(0)))
    jit_loss, jit_depth = options._jax_jitter(T)
    wts = pack_decoder_params(tmodel)

    def port(arrays):
        res = core.run_tto_batch(tmodel, wts, core.ObjectBatch.from_numpy(arrays, "cpu"),
                                 torch.zeros(32), torch.zeros(32), pcfg,
                                 jitter=(torch.from_numpy(jit_loss), torch.from_numpy(jit_depth)))
        return {k: v.detach().numpy() for k, v in res.items()}

    refined = jres["pose_traj"][:, -1]
    diag = np.linalg.norm(jres["wlh_used"], axis=-1)
    obj_keys = jax.random.split(jax.random.PRNGKey(0), options.B)

    def loss(sc, tc, key, pose, K, roi, dg, rgb, occ):
        out = render_rays_frustum(lambda x, v: jmodel.apply(variables, x, v, sc, tc), key,
                                  invert_pose(pose), K, roi, dg, n_samples=8, im_sz=8,
                                  shapenet_obj_cood=True)
        return rgb_loss_masked(out["rgb"], rgb, occ) + 0.1 * occupancy_loss(out["acc_trans"], occ)

    grad = jax.jit(jax.vmap(jax.grad(loss, argnums=(0, 1))))
    tx, zero = _make_optimizer(jcfg), np.zeros((options.B, 3), np.float32)
    params = TTOParams(jres["shapecodes_saved"][:, 0], jres["texturecodes_saved"][:, 0], zero,
                       zero)
    state, snaps = tx.init(params), {0: params}
    for t in range(options.REG + 1, T):
        if t in CODE_SAVE_ITERS:
            snaps[t] = params
        keys = jnp.stack([jax.random.fold_in(k, t) for k in obj_keys])
        sc_g, tc_g = grad(params.shapecode, params.texturecode, keys, refined, raw["K"],
                          raw["roi_nerf"].astype(np.float32), diag, raw["rgb_tgt"],
                          raw["occ_tgt"])
        if t % jcfg.lr_half_interval == 0:
            state = tx.init(params)
        updates, state = tx.update(TTOParams(sc_g, tc_g, zero, zero), state, params)
        scale = 2.0 ** -(t // jcfg.lr_half_interval)
        params = optax.apply_updates(params, jax.tree.map(lambda u: u * scale, updates))
    snaps[T] = params
    replay = {key: np.stack([np.asarray(getattr(snaps[i], field)) for i in CODE_SAVE_ITERS], 1)
              for key, field in zip(CODES, ("shapecode", "texturecode"))}

    ours = port(raw)
    moved = [dict(raw) for _ in range(3)]
    for seed, arrays in enumerate(moved):
        pose = raw["pose_init"]
        noise = np.random.default_rng(seed).standard_normal(pose.shape)
        arrays["pose_init"] = (pose + 1e-7 * np.maximum(np.abs(pose), 1e-3) * noise).astype(
            np.float32)
    pairs = [("port - JAX loop", ours, jres), ("JAX replay - JAX loop", replay, jres),
             ("port - JAX replay", ours, replay)]
    for seed, arrays in enumerate(moved):
        pairs.append((f"port - port, pose_init moved (seed {seed})", ours, port(arrays)))
    print("largest code difference at iterations", CODE_SAVE_ITERS)
    for name, a, b in pairs:
        diff = np.max([np.abs(a[k] - b[k]).max(axis=(0, 2)) for k in CODES], axis=0)
        print(f"{name:42s}", " ".join(f"{d:.2e}" for d in diff))

    pcfg = dataclasses.replace(pcfg, opt_pose=True)
    print("with the pose optimized: last rotation error (rad) and PSNR per object")
    for name, arrays in [("port", raw)] + [(f"pose_init moved (seed {i})", a)
                                           for i, a in enumerate(moved)]:
        res = port(arrays)
        print(f"{name:42s}", res["rot_err"][:, -1], res["psnr"][:, -1])


if __name__ == "__main__":
    main()
