"""The bfloat16 builds of K1 and K2 against another checkout's (the parent
commit's), on one card:

    python -m supnerf_tpu_torch.bench.bf16_render_ab --parent DIR [--out PATH]

DIR is a checkout of the other commit (`git archive` of it unpacked);
both trees' kernels are built from their own sources and bound through
their own ops/render.py (imported under another name; the models are this
tree's). First this tree's builds are held against their bfloat16 plain
versions (chip_smoke.closer_than_float32) at the TTO shape (2 x 1024 x 64,
all three encodings of K1), the demo's AABB shape (3 x 1024 x 64, a third
of the rays missed, whose outputs must be the constants; on the TTO
shape's decoder, as chip_smoke's phase 18 (a)), and, printed only, an
odd ray count with fewer samples and W 64 and 128; then each kernel of
both trees is timed A B B A (other, this, this, other) at the TTO and
AABB shapes with CUDA events. Prints the card's line and one JSON object,
also written to PATH if given. Card only; about two minutes.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time


def load_render(root: str, tag: str):
    """ops/render.py of the checkout at root, as module render_<tag>."""
    path = os.path.join(root, "supnerf_tpu_torch", "ops", "render.py")
    spec = importlib.util.spec_from_file_location(f"render_{tag}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def small_inputs(W, B, R, S, seed):
    """A random bfloat16 CodeNeRF decoder of width W (3 shape blocks, 1
    texture block) and random rays: (w32, w16, args, cot)."""
    import torch
    import torch.nn.functional as F

    from supnerf_tpu_torch.models.nerf_mlp import CodeNeRFDecoder
    from supnerf_tpu_torch.ops import render

    torch.manual_seed(seed)
    dec = CodeNeRFDecoder(3, 1, W, W).cuda()
    w32 = render.pack_decoder_params(dec)
    w16 = render.with_field_dtype(w32, "bfloat16")
    g = torch.Generator(device="cuda").manual_seed(seed)
    xyz = (torch.rand((B, R, S, 3), generator=g, device="cuda") * 2 - 1).contiguous()
    vd = F.normalize(torch.randn((B, R, 3), generator=g, device="cuda"), dim=-1).contiguous()
    z = (torch.linspace(1, 3, S, device="cuda") + 0.01 * torch.rand(
        (B, S), generator=g, device="cuda")).contiguous()
    codes = torch.randn((2, B, W), generator=g, device="cuda") * 0.3
    zs, zt = render.conditioned_latents(w32, codes[0], codes[1])
    cot = tuple(torch.randn(shape, generator=g, device="cuda")
                for shape in ((B, R, 3), (B, R), (B, R)))
    return w32, w16, (xyz, vd, z, zs.contiguous(), zt.contiguous()), cot


def check(cs, render, label, w32, w16, args, cot, hit=None):
    """This tree's K1 (its encodings) and K2 against their bfloat16 plain
    versions; with hit, the missed rays' outputs exactly. Returns ok."""
    import torch

    ok = True
    print(f"   {label}:")
    for pe in ("doubling", "exact", "train") if hit is None else ("doubling",):
        with torch.no_grad():
            got = render.render_fwd(w16, *args, False, hit, pe=pe)
            torch.cuda.synchronize()
            p16 = render.render_fwd_plain(w16, *args, False, hit, pe=pe)
            p32 = render.render_fwd_plain(w32, *args, False, hit)
        ok &= cs.closer_than_float32([f"{n}({pe})" for n in ("rgb", "depth", "acc")], got, p16,
                                     p32)[1]
    got_b = render.render_bwd(w16, *args, False, *cot, hit)
    torch.cuda.synchronize()
    p16 = render.render_bwd_plain(w16, *args, False, *cot, hit)
    p32 = render.render_bwd_plain(w32, *args, False, *cot, hit)
    ok &= cs.closer_than_float32(("dxyz", "dviewdir", "dz", "dzs", "dzt"), got_b, p16, p32)[1]
    if hit is not None:
        miss = ~hit
        exact = (bool((got[0][miss] == 0).all()) and bool((got[1][miss] == 0).all())
                 and bool((got[2][miss] == 1).all())
                 and all(bool((t[miss] == 0).all()) for t in got_b[:3]))
        print(f"   missed rays: rgb 0, depth 0, acc 1, zero dxyz / dviewdir / dz: "
              f"{'ok' if exact else 'FAIL'}")
        ok &= exact
    return ok


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, help="checkout of the other commit")
    ap.add_argument("--out", help="also write the JSON object to this file")
    args_ns = ap.parse_args(argv)

    import torch

    import chip_smoke as cs
    from supnerf_tpu_torch.ops import render

    if not torch.cuda.is_available():
        raise SystemExit("bf16_render_ab needs a CUDA card")
    card = cs.environment()
    other = load_render(os.path.abspath(args_ns.parent), "other")
    t0 = time.perf_counter()
    for tag, mod in (("this", render), ("other", other)):
        info = mod.build_kernels()
        print(f"   {tag}: built {info['path'].name} in {info['seconds']:.1f} s")
        for line in cs.ptxas_summary(info["log"]):
            if "render_fwd" in line or "render_bwd" in line:
                print("   " + line)
    print(f"   builds: {time.perf_counter() - t0:.1f} s")

    model = cs.published_model(0)
    w32, tto, cot = cs.kernel_inputs(seed=0, model=model)
    w16 = render.with_field_dtype(w32, "bfloat16")
    # the AABB rays run on the TTO shape's decoder, as chip_smoke's phase 18 (a)
    _, aabb, hit, cot_ab = cs.aabb_inputs()
    ok = check(cs, render, "TTO shape, 2 x 1024 x 64", w32, w16, tto, cot)
    ok &= check(cs, render, "AABB shape, 3 x 1024 x 64", w32, w16, aabb, cot_ab, hit)
    # other widths, an odd ray count, fewer samples: printed, not held (a
    # few dozen rays make BF16_POINT_SHARE's 1 % less than one element)
    for W, B, R, S in ((256, 1, 37, 40), (128, 2, 64, 64), (64, 2, 51, 33)):
        check(cs, render, f"W {W}, {B} x {R} x {S}", *small_inputs(W, B, R, S, W + R))

    o16 = other.with_field_dtype(other.pack_decoder_params(model), "bfloat16")
    cases = {
        "render_fwd_bf16": (lambda m, w: m.render_fwd(w, *tto, False), 20),
        "render_bwd_bf16": (lambda m, w: m.render_bwd(w, *tto, False, *cot), 10),
        "render_fwd_aabb_bf16": (lambda m, w: m.render_fwd(w, *aabb, False, hit), 20),
        "render_bwd_aabb_bf16": (lambda m, w: m.render_bwd(w, *aabb, False, *cot_ab, hit), 10),
    }
    packs = {"this": w16, "other": o16}
    mods = {"this": render, "other": other}
    times = {}
    for name, (fn, n) in cases.items():
        times[name] = {"other": [], "this": []}
        for tag in ("other", "this", "this", "other"):
            w = packs[tag]
            with torch.no_grad():
                times[name][tag].append(cs._timed(lambda: fn(mods[tag], w), n))
        t = times[name]
        print(f"   {name}: other {t['other'][0]:.3f} / {t['other'][1]:.3f} ms, this "
              f"{t['this'][0]:.3f} / {t['this'][1]:.3f} ms")
    result = {"card": card, "device": torch.cuda.get_device_name(0), "checks_ok": bool(ok),
              "ms": times}
    if args_ns.out:
        os.makedirs(os.path.dirname(args_ns.out) or ".", exist_ok=True)
        with open(args_ns.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    if not ok:
        raise SystemExit("a bfloat16 build disagrees with its plain version")


if __name__ == "__main__":
    main()
