"""How far an object's TTO run moves with the batch it is in, in the JAX
package and in the port, at the setup of tests/test_torch_batch_layout.py
(8 objects, the tiny net, sym_aug, the JAX loop's draws for each object
whatever its batch): the largest difference from batch 1 at batch 2 and 4
of the codes, the rendered pose's rotation and its translation, at each
iteration and over iterations 0-5 (the test's LAYOUT_SPREAD is the JAX
line of the latter).

The JAX run_tto_batch splits its key over the batch's objects; here each
call is handed its objects' keys of split(PRNGKey(0), 8) in place of that
split, so every layout draws the same per object.

--rows batched runs the port with its refiner layers and conditioned
latents over the whole batch at once (one Linear / einsum over B rows,
supnerf_tpu_torch.bench.tto_layout_ab.rows_at_once), as the port did
before they were made layout-exact.
--num_opts T (default the test's 6) runs longer; --objects N (default
the test's 8) takes the first N objects of the same fixture, and then
prints, per package, how many objects moved past 1e-5 in codes or 1e-4
in translation at iterations 0-5.

Run on the CPU: JAX_PLATFORMS=cpu python tests/tto_layout_witness.py
"""
import argparse
import contextlib
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import test_torch_batch_layout as layout  # noqa: E402
from supnerf_tpu.tto import ObjectBatch as JaxBatch  # noqa: E402
from supnerf_tpu.tto import TTOConfig as JaxTTOConfig  # noqa: E402
from supnerf_tpu.tto import run_tto_batch as jax_run_tto_batch  # noqa: E402
from supnerf_tpu_torch.bench.tto_layout_ab import rows_at_once  # noqa: E402


def jax_run(jmodel, variables, raw, obj_keys, cfg, batch):
    """The JAX run_tto_batch over the objects in batches of `batch`, each
    call's split(key, B) answered with its objects' keys."""
    split, outs = jax.random.split, []
    try:
        for s in range(0, layout.N, batch):
            idx = np.arange(s, s + batch)
            jax.random.split = lambda key, num=2, _k=obj_keys[idx]: _k
            try:
                res = jax_run_tto_batch(
                    jmodel, variables, JaxBatch(**{k: jnp.asarray(v[idx]) for k, v in raw.items()}),
                    jnp.zeros(32), jnp.zeros(32), cfg, jax.random.PRNGKey(0))
            finally:
                jax.random.split = split
            outs.append(jax.tree.map(np.asarray, res))
    finally:
        jax.random.split = split
    return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}


def per_iteration(a, b):
    pa, pb = a["pose_curve"], b["pose_curve"]
    code = np.maximum(*(np.abs(a[k] - b[k]).max(axis=(0, 2))
                        for k in ("shapecode_curve", "texturecode_curve")))
    return (code, np.abs(pa[..., :3] - pb[..., :3]).max(axis=(0, 2, 3)),
            np.abs(pa[..., 3] - pb[..., 3]).max(axis=(0, 2)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", choices=("each", "batched"), default="each")
    ap.add_argument("--num_opts", type=int, default=layout.T)
    ap.add_argument("--objects", type=int, default=layout.N)
    args = ap.parse_args(argv)
    jax.config.update("jax_platforms", "cpu")
    T = args.num_opts
    layout.T, layout.N = T, args.objects
    layout.PORT_CFG = dataclasses.replace(layout.PORT_CFG, num_opts=T)
    jmodel, variables, raw, tmodel, draws, obj_keys = layout.setup()
    jcfg = JaxTTOConfig(field_impl="flax", **dict(layout.COMMON, num_opts=T))
    runs = {"JAX": {b: jax_run(jmodel, variables, raw, obj_keys, jcfg, b)
                    for b in (1,) + layout.LAYOUTS},
            f"port (rows {args.rows})": {}}
    with rows_at_once(tmodel) if args.rows == "batched" else contextlib.nullcontext():
        runs[f"port (rows {args.rows})"] = {b: layout.port_run(tmodel, raw, draws, b)
                                            for b in (1,) + layout.LAYOUTS}
    for name, res in runs.items():
        for b in layout.LAYOUTS:
            code, rot, trans = per_iteration(res[1], res[b])
            print(f"{name} batch {b} vs 1, per iteration t = 0..{T - 1}:")
            for t in range(T):
                print(f"    t {t}: code {code[t]:.3e}  rotation {rot[t]:.3e}  "
                      f"translation {trans[t]:.3e}")
            final = max(float(np.abs(res[1][k] - res[b][k]).max())
                        for k in ("final_shapecode", "final_texturecode"))
            print(f"    final codes {final:.3e}")
        spreads = [layout.spread(res[1], res[b]) for b in layout.LAYOUTS]
        worst = {k: max(s[k] for s in spreads) for k in spreads[0]}
        upto = min(T, 6)
        worst5 = [layout.spread({k: v[:, :upto] for k, v in res[1].items() if "curve" in k},
                                {k: v[:, :upto] for k, v in res[b].items() if "curve" in k})
                  for b in layout.LAYOUTS]
        print(f"{name}: over batch {layout.LAYOUTS} and iterations 0-{upto - 1}: "
              f"{ {k: max(s[k] for s in worst5) for k in worst5[0]} }; all iterations {worst}")
        moved = set()
        for b in layout.LAYOUTS:
            for i in range(layout.N):
                one = layout.spread({k: v[i:i + 1, :upto] for k, v in res[1].items() if "curve" in k},
                                    {k: v[i:i + 1, :upto] for k, v in res[b].items() if "curve" in k})
                if one["code"] > 1e-5 or one["translation"] > 1e-4:
                    moved.add(i)
        print(f"{name}: objects past 1e-5 in codes or 1e-4 in translation at iterations "
              f"0-{upto - 1}: {sorted(moved)} ({len(moved)} of {layout.N})")


if __name__ == "__main__":
    main()
