"""The port's demo slice on the CPU: the encoder and converter with the wlh
head (pred_wlh 1, as hpam_demo.json sets), run_tto_batch with the AABB loss
render, pred_wlh 1 and the nuScenes object frame
(shapenet_obj_cood False) against the JAX run_tto_batch on its flax path
with the same weights, batch and sampling draws, and the demo CLI
(supnerf_tpu_torch.cli.demo) end to end at a tiny size: its files, its PNGs
read back by chip_smoke.read_png, and its refusals."""
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from chip_smoke import read_png
import torch_threads  # noqa: F401
from supnerf_tpu.data.synthetic import make_object_batch
from supnerf_tpu.geometry import poses as jax_poses
from supnerf_tpu.models import SUPNeRF as JaxSUPNeRF
from supnerf_tpu.models import build_model as jax_build_model
from supnerf_tpu.models import init_model_variables
from supnerf_tpu.models.torch_import import export_state_dict
from supnerf_tpu.tto import ObjectBatch as JaxBatch
from supnerf_tpu.tto import TTOConfig as JaxTTOConfig
from supnerf_tpu.tto import run_tto_batch as jax_run_tto_batch
from supnerf_tpu_torch.cli import demo
from supnerf_tpu_torch.models.convert import convert_supnerf_variables
from supnerf_tpu_torch.models.factory import build_model
from supnerf_tpu_torch.geometry.boxes import invert_pose
from supnerf_tpu_torch.geometry.rays import aabb_ray_bounds, get_rays
from supnerf_tpu_torch.ops import render
from supnerf_tpu_torch.render.renderer import AABB_FIELD_SCALE
from supnerf_tpu_torch.tto import core
from supnerf_tpu_torch.utils.image_io import image_float_to_uint8, write_png
from torch_memory import release_memory_after_module  # noqa: F401

TINY_HP = {"shape_blocks": 1, "texture_blocks": 1, "latent_dim": 32, "pose_shortcut": 1,
           "pred_wlh": 1}
REG, T, B, R, S = 2, 5, 2, 64, 8     # reg_iters + 3 iterations, 2 objects, 8 x 8 rays
COMMON = dict(num_opts=T, reg_iters=REG, n_samples=S, render_im_sz=8, in_img_sz=32,
              n_lidar=16, shapenet_obj_cood=False, use_aabb_render=True, pred_wlh_mode=1)


@pytest.fixture(scope="module")
def tiny():
    """A tiny SUPNeRF with the wlh head in both packages, the same weights.
    The head's output bias is set to a car's size (the untrained head
    predicts a box of a few centimetres, which no ray of the loss render
    hits), so the AABB render has rays on and off the box."""
    jmodel = jax_build_model("supnerf", TINY_HP)
    variables = jax.tree.map(np.array, init_model_variables(jmodel, jax.random.PRNGKey(0),
                                                            img_size=32))
    head = variables["params"]["img_encoder"]["fc_wlh_out"]
    head["bias"] = np.asarray([1.9, 4.6, 1.7], np.float32)
    head["kernel"] = head["kernel"] * 0.1
    raw, _ = make_object_batch(B, seed=3, in_img_sz=32, render_im_sz=8, n_lidar=16)
    keys = jax.random.split(jax.random.PRNGKey(7), B)
    raw["pose_init"] = np.asarray(jax.vmap(
        lambda k, K, roi: jax_poses.get_random_pose2(k, K, roi.astype(jnp.float32)))(
        keys, jnp.asarray(raw["K"]), jnp.asarray(raw["roi_nerf"])))
    tmodel = build_model("supnerf", TINY_HP)
    tmodel.load_state_dict(convert_supnerf_variables(variables, TINY_HP), strict=True)
    return jmodel, variables, raw, tmodel


def test_converter_and_encoder_with_wlh_head(tiny):
    """convert_supnerf_variables keeps export_state_dict's keys and values
    with the wlh head; the encoder's five outputs (wlh included) match flax
    at 1e-4 (one image per BatchNorm batch, batch statistics)."""
    jmodel, variables, raw, tmodel = tiny
    ours = convert_supnerf_variables(variables, TINY_HP)
    ref = export_state_dict(jmodel, variables)
    assert set(ours) == set(ref) and any("fc_wlh" in k for k in ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(v), err_msg=k)
    img = raw["img_in"][1:2]
    (jout, _) = jmodel.apply(variables, jnp.asarray(img), True, method=JaxSUPNeRF.encode_img,
                             mutable=["batch_stats"])
    with torch.no_grad():
        tout = tmodel.encode_img(torch.from_numpy(img))
    for name, a, b in zip(("shape", "texture", "pose", "uv", "wlh"), tout, jout):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=1e-4, err_msg=name)


@pytest.fixture(scope="module")
def both_runs(tiny):
    jmodel, variables, raw, tmodel = tiny
    key = jax.random.PRNGKey(0)
    jres = jax.tree.map(np.asarray, jax_run_tto_batch(
        jmodel, variables, JaxBatch(**{k: jnp.asarray(v) for k, v in raw.items()}),
        jnp.zeros(32), jnp.zeros(32), JaxTTOConfig(field_impl="flax", adjust_scale=AABB_FIELD_SCALE, **COMMON), key))
    # the JAX loop's draws: fold_in(obj_key, t) for the AABB loss render,
    # (R, S) per object, and fold_in(it_key, 1) for the lidar depth render
    obj_keys = jax.random.split(key, B)
    it_keys = [[jax.random.fold_in(obj_keys[b], t) for b in range(B)] for t in range(T)]
    jit_loss = np.asarray([[jax.random.uniform(k, (R, S)) for k in row] for row in it_keys])
    jit_depth = np.asarray([[jax.random.uniform(jax.random.fold_in(k, 1), (S,)) for k in row]
                            for row in it_keys])
    batch = core.ObjectBatch.from_numpy(raw, "cpu")
    pres = core.run_tto_batch(tmodel, render.pack_decoder_params(tmodel), batch, torch.zeros(32),
                              torch.zeros(32), core.TTOConfig(**COMMON),
                              jitter=(torch.from_numpy(jit_loss), torch.from_numpy(jit_depth)))
    return jres, {k: v.detach().numpy() for k, v in pres.items()}


def test_aabb_tto_uses_the_predicted_box(both_runs):
    """pred_wlh 1: the refiner, obj_diag and the AABB box take the encoder's
    wlh (1e-4), and the refiner's trajectory on it matches (1e-4)."""
    jres, pres = both_runs
    np.testing.assert_allclose(pres["wlh_pred"], jres["wlh_pred"], atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(pres["wlh_used"], pres["wlh_pred"])
    np.testing.assert_allclose(pres["wlh_used"], jres["wlh_used"], atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(pres["pose_traj"], jres["pose_traj"], atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("curve", ["loss", "psnr", "rot_err", "trans_err", "depth_err"])
def test_aabb_tto_curves_match(both_runs, curve):
    """The curves of the AABB TTO loop, as tests/test_torch_tto.py holds the
    frustum loop's: 1e-4 through the replay iterations, 1e-3 once AdamW
    steps (Adam's per-component normalisation can amplify float32 rounding
    of a near-zero gradient component)."""
    jres, pres = both_runs
    np.testing.assert_allclose(pres[curve][:, :REG + 1], jres[curve][:, :REG + 1],
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(pres[curve], jres[curve], atol=1e-3, rtol=1e-3)


def test_aabb_tto_hit_share(tiny, both_runs):
    """The hit_share curve (B, num_opts) lies in [0, 1], and through the
    replay iterations (the refiner's poses) it is exactly the share of the
    loss rays that the port's ray-box test (held against JAX in
    tests/test_torch_aabb.py) finds inside the box; rays both hit and miss."""
    raw, (_, pres) = tiny[2], both_runs
    share = pres["hit_share"]
    assert share.shape == (B, T) and ((share >= 0) & (share <= 1)).all()
    K, roi = (torch.tensor(raw[k], dtype=torch.float32) for k in ("K", "roi_nerf"))
    for t in range(REG + 1):
        rays_o, vd = get_rays(K, invert_pose(torch.from_numpy(pres["pose_traj"][:, t])), roi,
                              (8, 8))
        _, hit, _ = aabb_ray_bounds(rays_o, vd, torch.from_numpy(pres["wlh_used"]))
        np.testing.assert_array_equal(share[:, t], hit.float().mean(1).numpy())
    assert (share > 0).any() and (share < 1).any()


def test_aabb_tto_updates_and_final_state(both_runs):
    """The loop moves the codes and the pose (the loss render has rays in
    the box), and the final codes and pose match JAX at 1e-3."""
    jres, pres = both_runs
    assert np.abs(pres["final_shapecode"] - pres["shapecodes_saved"][:, 0]).max() > 1e-4
    assert not np.allclose(pres["psnr"][:, REG + 1], pres["psnr"][:, -1])
    for k in ("final_pose", "final_shapecode", "final_texturecode"):
        np.testing.assert_allclose(pres[k], jres[k], atol=1e-3, err_msg=k)


# --------------------------------------------------------------------------
# the demo CLI
# --------------------------------------------------------------------------

TINY_DEMO = {
    "arch": "supnerf",
    "net_hyperparams": dict(TINY_HP, pose_blocks=1),
    "render_im_sz": 8, "n_samples": 8, "in_img_sz": 32, "shapenet_obj_cood": 0,
    "optimize": {"num_opts": 6},
}


def test_demo_cli_writes_its_frames(tmp_path):
    """A tiny-config demo on the CPU (6 iterations, scene at 1/16 scale):
    input.png and one PNG per manipulation, each decoding to the frame the
    CLI rendered, finite curves, and the TTO result files."""
    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps(dict(TINY_DEMO, model_dir=str(tmp_path / "no_checkpoint"))))
    out = tmp_path / "demo"
    summary = demo.main(["--config_file", str(cfg), "--device", "cpu", "--save_dir", str(out),
                         "--render_scale", "16"])
    assert read_png(str(out / "input.png")).shape == (900, 1600, 3)
    assert [os.path.basename(p) for p in summary["frames"]] == [
        f"scene_{i:02d}.png" for i in range(len(demo.MANIPULATIONS))]
    win_w, win_h = summary["win_hw"]
    for path, img in zip(summary["frames"], summary["images"]):
        assert img.shape == (win_h, win_w, 3) and np.isfinite(img).all()
        np.testing.assert_array_equal(read_png(path), image_float_to_uint8(img))
    res = summary["results"]
    assert set(res["psnr_eval"]) == {f"demo_ann_{i}_CAM_FRONT" for i in range(3)}
    assert all(len(v) == 6 and np.isfinite(v).all() for v in res["psnr_eval"].values())
    assert len(summary["wlh_used"]) == 3
    assert set(summary["hit_share"]) == set(res["psnr_eval"])
    assert all(len(v) == 6 and 0 <= min(v) and max(v) <= 1
               for v in summary["hit_share"].values())
    assert (out / "codes+poses.pkl").exists() and (out / "codes+poses.pth").exists()


def test_png_round_trip(tmp_path):
    """write_png -> read_png gives back the image, edge values included."""
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (7, 13, 3), dtype=np.uint8)
    img[0, 0], img[-1, -1] = 0, 255
    write_png(str(tmp_path / "x.png"), img)
    np.testing.assert_array_equal(read_png(str(tmp_path / "x.png")), img)
    with pytest.raises(ValueError):
        write_png(str(tmp_path / "y.png"), img.astype(np.float32))


def test_read_png_refuses_filters_it_does_not_decode(tmp_path):
    """read_png decodes the scanline filters None and Up (Up checked against
    its definition) and raises for Sub, Average and Paeth, which no writer
    of the repository produces."""
    import struct
    import zlib

    def png(rows, w):
        def chunk(kind, body):
            return struct.pack(">I", len(body)) + kind + body + struct.pack(
                ">I", zlib.crc32(kind + body))
        return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, len(rows), 8, 2,
                                                                    0, 0, 0))
                + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b""))

    first, delta = bytes([10, 20, 250, 1, 2, 3]), bytes([5, 10, 10, 0, 1, 255])
    (tmp_path / "up.png").write_bytes(png([b"\x00" + first, b"\x02" + delta], 2))
    expect = np.asarray([list(first), [(a + b) % 256 for a, b in zip(first, delta)]], np.uint8)
    np.testing.assert_array_equal(read_png(str(tmp_path / "up.png")), expect.reshape(2, 2, 3))
    for ftype in (1, 3, 4):
        (tmp_path / "f.png").write_bytes(png([b"\x00" + first, bytes([ftype]) + delta], 2))
        with pytest.raises(ValueError, match="filters"):
            read_png(str(tmp_path / "f.png"))


def test_demo_refuses_other_datasets_and_a_missing_card(monkeypatch, tmp_path):
    with pytest.raises(ValueError, match="synthetic or nusc"):
        demo.main(["--dataset", "kitti", "--save_dir", str(tmp_path)])
    with pytest.raises(ValueError, match="needs --img_name"):
        demo.main(["--dataset", "nusc", "--save_dir", str(tmp_path)])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        demo.main(["--save_dir", str(tmp_path)])


def test_pred_wlh_2_is_refused():
    """pred_wlh 2, once refused here, is ported: the config takes it and
    effective_wlh gives JAX's box (w and h at the nuScenes means, l keeping
    the predicted volume); a mode outside 0-2 is refused."""
    from supnerf_tpu.tto.core import effective_wlh as jax_effective_wlh
    from supnerf_tpu_torch.tto.driver import tto_config_from_hpams

    assert tto_config_from_hpams({}, pred_wlh=2).pred_wlh_mode == 2
    pred = np.array([[1.8, 4.2, 1.5], [2.1, 5.0, 1.9]], np.float32)
    np.testing.assert_allclose(
        core.effective_wlh(torch.ones(2, 3), torch.from_numpy(pred), 2).numpy(),
        np.asarray(jax_effective_wlh(jnp.ones((2, 3)), jnp.asarray(pred), 2)), rtol=1e-6)
    with pytest.raises(ValueError, match="pred_wlh 3"):
        tto_config_from_hpams({}, pred_wlh=3)
    with pytest.raises(ValueError, match="pred_wlh 3"):
        core.effective_wlh(torch.ones(1, 3), torch.ones(1, 3), 3)
