"""The KITTI/Waymo object frame of the port against the JAX package on the
CPU: the KITTI box corners, the point-in-box test and the frame conversions
(geometry/boxes.py), get_random_pose2 in both frames with the JAX draws
passed in, the kitti2nusc rotation of the field's samples, run_tto_batch
with kitti2nusc and box_fac 1.1 against the JAX run_tto_batch (the
tolerances of tests/test_torch_tto.py), the driver's initial and
ground-truth poses in the KITTI frame against the JAX driver's, the
results-folder names against the JAX CLI's, and the KITTI and Waymo CLIs
end to end at a tiny size."""
import json
import os
import pickle
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supnerf_tpu.cli.optimize import _auto_save_postfix as jax_auto_save_postfix
from supnerf_tpu.data.synthetic import make_object_batch
from supnerf_tpu.geometry import boxes as jax_boxes
from supnerf_tpu.geometry import poses as jax_poses
from supnerf_tpu.models import build_model as jax_build_model
from supnerf_tpu.models import init_model_variables
from supnerf_tpu.render import renderer as jax_renderer
from supnerf_tpu.tto import ObjectBatch as JaxBatch
from supnerf_tpu.tto import TTOConfig as JaxTTOConfig
from supnerf_tpu.tto import run_tto_batch as jax_run_tto_batch
from supnerf_tpu.tto.driver import TTODriver as JaxTTODriver
from supnerf_tpu.tto.driver import tto_config_from_hpams as jax_tto_config_from_hpams
from supnerf_tpu_torch.cli import optimize, optimize_kitti, optimize_waymo
from supnerf_tpu_torch.data.kitti import KittiData
from supnerf_tpu_torch.geometry import boxes, poses
from supnerf_tpu_torch.models.convert import convert_supnerf_variables
from supnerf_tpu_torch.models.factory import build_model
from supnerf_tpu_torch.ops.render import pack_decoder_params
from supnerf_tpu_torch.render import renderer
from supnerf_tpu_torch.tto import core
from supnerf_tpu_torch.tto.driver import TTODriver, tto_config_from_hpams
from tests.test_data_kitti import HPAMS as KITTI_HPAMS
from tests.test_data_kitti import make_kitti_fixture
from tests.test_torch_cli import _jax_result_keys
from torch_memory import release_memory_after_module  # noqa: F401

T = torch.from_numpy


def _kitti_poses(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for ry, x, z in zip(rng.uniform(-np.pi, np.pi, n), rng.uniform(-4, 4, n),
                        rng.uniform(8, 30, n)):
        c, s = np.cos(ry), np.sin(ry)
        R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        out.append(np.concatenate([R, [[x], [1.6], [z]]], 1))
    return np.asarray(out, np.float32)


def test_kitti_boxes_and_frame_conversions_match_jax():
    P = _kitti_poses(5, 0)
    wlh = np.asarray(np.random.default_rng(1).uniform(1.4, 4.8, (5, 3)), np.float32)
    for kitti in (False, True):
        for scale in (1.0, 1.1):
            np.testing.assert_allclose(
                boxes.local_corners_of_box(T(wlh), scale, is_kitti=kitti).numpy(),
                np.asarray(jax_boxes.local_corners_of_box(jnp.asarray(wlh), is_kitti=kitti,
                                                          scale=scale)),
                atol=1e-6)
            np.testing.assert_allclose(
                boxes.corners_of_box(T(P), T(wlh), scale, is_kitti=kitti).numpy(),
                np.asarray(jax_boxes.corners_of_box(jnp.asarray(P), jnp.asarray(wlh),
                                                    is_kitti=kitti, scale=scale)),
                atol=1e-5)
    h = wlh[:, 2]
    k2n = boxes.obj_pose_kitti2nusc(T(P), T(h))
    np.testing.assert_allclose(
        k2n.numpy(), np.asarray(jax_boxes.obj_pose_kitti2nusc(jnp.asarray(P), jnp.asarray(h))),
        atol=1e-6)
    np.testing.assert_allclose(boxes.obj_pose_nusc2kitti(k2n, T(h)).numpy(), P, atol=1e-6)
    np.testing.assert_allclose(
        boxes.obj_pose_nusc2kitti(k2n, T(h)).numpy(),
        np.asarray(jax_boxes.obj_pose_nusc2kitti(jnp.asarray(k2n.numpy()), jnp.asarray(h))),
        atol=1e-6)
    # a scalar height, as the driver passes
    np.testing.assert_allclose(boxes.obj_pose_kitti2nusc(T(P[0]), 1.5).numpy(),
                               np.asarray(jax_boxes.obj_pose_kitti2nusc(jnp.asarray(P[0]), 1.5)),
                               atol=1e-6)
    # the KITTI box in the nuScenes frame is the same box
    np.testing.assert_allclose(
        np.sort(boxes.corners_of_box(k2n, T(wlh)).numpy(), -1),
        np.sort(boxes.corners_of_box(T(P), T(wlh), is_kitti=True).numpy(), -1), atol=1e-5)
    corners = boxes.corners_of_box(T(P), T(wlh))
    pts = corners.mean(-1, keepdim=True) + torch.randn(5, 3, 300,
                                                       generator=torch.Generator().manual_seed(2))
    for top in (1.0, 0.9):
        np.testing.assert_array_equal(
            boxes.pts_in_box_3d(pts, corners, top).numpy(),
            np.asarray(jax_boxes.pts_in_box_3d(jnp.asarray(pts.numpy()),
                                               jnp.asarray(corners.numpy()), top)))


@pytest.mark.parametrize("is_kitti", [False, True])
def test_random_pose2_matches_jax_with_its_draws(is_kitti):
    """get_random_pose2 with the JAX function's own uniform draws passed in
    (its keys split into centre shift, yaw and rotation)."""
    K = np.asarray([[721.5, 0, 609.6], [0, 721.5, 172.9], [0, 0, 1]], np.float32)
    rois = np.asarray([[500, 150, 700, 260], [100, 120, 180, 200], [900, 160, 1200, 370]],
                      np.float32)
    keys = jax.random.split(jax.random.PRNGKey(3), 3)
    draws, refs = [], []
    for k, roi in zip(keys, rois):
        k_xy, k_yaw, k_rot = jax.random.split(k, 3)
        draws.append(np.concatenate([np.asarray(jax.random.uniform(k_xy, (2,))),
                                     np.asarray(jax.random.uniform(k_yaw, ()))[None],
                                     np.asarray(jax.random.uniform(k_rot, (3,)))]))
        refs.append(np.asarray(jax_poses.get_random_pose2(
            k, jnp.asarray(K), jnp.asarray(roi), angle_lim=np.pi / 9, trans_lim=0.3,
            is_kitti=is_kitti)))
    got = poses.get_random_pose2(T(np.stack([K] * 3)), T(rois), None, angle_lim=np.pi / 9,
                                 trans_lim=0.3, is_kitti=is_kitti, draws=T(np.stack(draws)))
    np.testing.assert_allclose(got.numpy(), np.stack(refs), atol=2e-5)


@pytest.mark.parametrize("shapenet,flip", [(True, False), (False, True), (True, True)])
def test_kitti2nusc_sample_transform_matches_jax(shapenet, flip):
    rng = np.random.default_rng(4)
    xyz = rng.normal(size=(2, 4, 5, 3)).astype(np.float32)
    vd = rng.normal(size=(2, 4, 3)).astype(np.float32)
    flips = np.asarray([flip, False])
    out = renderer.apply_obj_coord_transform(T(xyz), T(vd), shapenet, T(flips), kitti2nusc=True)
    for b in range(2):
        ref = jax_renderer.apply_obj_coord_transform(
            jnp.asarray(xyz[b]), jnp.asarray(vd[b]), shapenet, kitti2nusc=True,
            sym_flip=jnp.asarray(flips[b]))
        for a, r in zip(out, ref):
            np.testing.assert_array_equal(a[b].numpy(), np.asarray(r))


# --------------------------------------------------------------------------
# run_tto_batch in the KITTI protocol
# --------------------------------------------------------------------------

TINY_HP = {"shape_blocks": 1, "texture_blocks": 1, "latent_dim": 32,
           "pose_shortcut": 1, "pred_wlh": 0}
REG, ITERS, B = 2, 5, 2


def test_run_tto_batch_kitti_frame_matches_jax():
    """kitti2nusc and box_fac 1.1 on the flax path of the JAX run_tto_batch
    and the port's, the same batch, weights and sampling jitter: the
    refiner's trajectory at 1e-4, the curves at 1e-4 through the replays
    and 1e-3 after the updates, the final pose at 1e-3 (the tolerances of
    tests/test_torch_tto.py)."""
    jmodel = jax_build_model("supnerf", TINY_HP)
    variables = jax.tree.map(np.asarray, init_model_variables(jmodel, jax.random.PRNGKey(0),
                                                              img_size=32))
    raw, _ = make_object_batch(B, seed=5, in_img_sz=32, render_im_sz=8, n_lidar=16)
    keys = jax.random.split(jax.random.PRNGKey(8), B)
    raw["pose_init"] = np.asarray(jax.vmap(
        lambda k, K, roi: jax_poses.get_random_pose2(k, K, roi.astype(jnp.float32)))(
        keys, jnp.asarray(raw["K"]), jnp.asarray(raw["roi_nerf"])))
    tmodel = build_model("supnerf", TINY_HP)
    tmodel.load_state_dict(convert_supnerf_variables(variables, TINY_HP), strict=True)
    common = dict(num_opts=ITERS, reg_iters=REG, n_samples=8, render_im_sz=8, in_img_sz=32,
                  n_lidar=16, shapenet_obj_cood=True, kitti2nusc=True, box_fac=1.1)
    key = jax.random.PRNGKey(0)
    jres = jax.tree.map(np.asarray, jax_run_tto_batch(
        jmodel, variables, JaxBatch(**{k: jnp.asarray(v) for k, v in raw.items()}),
        jnp.zeros(32), jnp.zeros(32), JaxTTOConfig(field_impl="flax", **common), key))
    obj_keys = jax.random.split(key, B)
    it_keys = [[jax.random.fold_in(obj_keys[b], t) for b in range(B)] for t in range(ITERS)]
    jit_loss = np.asarray([[jax.random.uniform(k, (8,)) for k in row] for row in it_keys])
    jit_depth = np.asarray([[jax.random.uniform(jax.random.fold_in(k, 1), (8,)) for k in row]
                            for row in it_keys])
    pres = core.run_tto_batch(tmodel, pack_decoder_params(tmodel),
                              core.ObjectBatch.from_numpy(raw, "cpu"), torch.zeros(32),
                              torch.zeros(32), core.TTOConfig(**common),
                              jitter=(T(jit_loss), T(jit_depth)))
    pres = {k: v.detach().numpy() for k, v in pres.items()}
    np.testing.assert_allclose(pres["pose_traj"], jres["pose_traj"], atol=1e-4, rtol=1e-4)
    # box_fac reaches the refiner: box_fac 1.0 gives another trajectory
    traj_1 = core.encode_and_refine(tmodel, core.ObjectBatch.from_numpy(raw, "cpu"),
                                    torch.zeros(32), torch.zeros(32),
                                    core.TTOConfig(**dict(common, box_fac=1.0)))[2]
    assert not np.allclose(traj_1.numpy()[:, 1:], pres["pose_traj"][:, 1:], atol=1e-3)
    for curve in ("loss", "psnr", "rot_err", "trans_err", "depth_err"):
        np.testing.assert_allclose(pres[curve][:, :REG + 1], jres[curve][:, :REG + 1],
                                   atol=1e-4, rtol=1e-4, err_msg=curve)
        np.testing.assert_allclose(pres[curve], jres[curve], atol=1e-3, rtol=1e-3,
                                   err_msg=curve)
    np.testing.assert_allclose(pres["final_pose"], jres["final_pose"], atol=1e-3)


# --------------------------------------------------------------------------
# the driver and the CLIs
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def kitti_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti")
    make_kitti_fixture(str(root))
    return str(root)


def _kitti_hpams(root):
    return {"dataset": dict(KITTI_HPAMS["dataset"], name="kitti", data_dir=root,
                            split_dir=os.path.join(root, "ImageSets"))}


@pytest.mark.parametrize("mode", [1, 3])
def test_driver_prep_in_kitti_frame_matches_jax(kitti_root, mode):
    """The driver's initial poses (mode 1: the JAX driver's sign stream and
    its yaw about the camera's y; mode 3: the reader's detection pose) and
    the prepared pose_init / obj_pose_gt in the nuScenes frame against the
    JAX driver's _initial_pose and _prep_sample."""
    hpams = dict(_kitti_hpams(kitti_root), roi_margin=15)
    ds = KittiData(hpams, split="val", add_pose_err=mode)
    samples = [ds[0], ds[1]]
    jcfg = jax_tto_config_from_hpams(hpams, dataset_frame="kitti", n_lidar=32)
    jstub = types.SimpleNamespace(add_pose_err=mode, dataset_frame="kitti", init_rot_err=0.4,
                                  init_trans_err=0.01, np_rng=np.random.default_rng(7),
                                  cfg=jcfg, hpams=hpams)
    pcfg = tto_config_from_hpams(hpams, n_lidar=32, dataset_frame="kitti")
    assert (pcfg.kitti2nusc, pcfg.box_fac) == (jcfg.kitti2nusc, jcfg.box_fac) == (True, 1.1)
    pstub = types.SimpleNamespace(add_pose_err=mode, kitti_frame=True, init_rot_err=0.4,
                                  init_trans_err=0.01, np_rng=np.random.default_rng(7),
                                  cfg=pcfg, hpams=hpams, prep_gen=None, rand_angle_lim=0.0)
    pstub._pose_with_error = types.MethodType(TTODriver._pose_with_error, pstub)
    p_init = TTODriver._initial_poses(pstub, samples)
    for s, p in zip(samples, p_init):
        j = JaxTTODriver._initial_pose(jstub, s)
        np.testing.assert_array_equal(p, j)
        jin = JaxTTODriver._prep_sample(jstub, s, j)
        pin = TTODriver.prep_sample(pstub, s, p)
        assert set(pin) == set(jin)
        for k in ("pose_init", "obj_pose_gt"):
            np.testing.assert_allclose(pin[k], jin[k], atol=1e-6, err_msg=k)
        assert not np.allclose(pin["pose_init"], s["obj_poses"], atol=1e-3)


def test_auto_save_postfix_matches_jax():
    hp_sup = {"arch": "supnerf", "net_hyperparams": {"pred_wlh": 1}, "init_rot_err": 0.3,
              "dataset": {"test_nusc_version": "v1.0-mini"}}
    hp_nerf = {"arch": "autorf", "net_hyperparams": {"pred_wlh": 0}}
    for hp in (hp_sup, hp_nerf, {"arch": "supnerf"}):
        for ds in ("nusc", "kitti", "waymo", "synthetic"):
            for mode in (0, 1, 2, 3):
                for rot, trans in ((None, None), (0.4, 0.01)):
                    for pred_wlh, box2d, version, subset in ((0, 0, None, 1),
                                                             (1, 1, "v1.0-trainval", 3)):
                        args = types.SimpleNamespace(
                            opt_pose=1, add_pose_err=mode, init_rot_err=rot,
                            init_trans_err=trans, reg_iters=3, pred_wlh=pred_wlh,
                            pred_box2d=box2d, nusc_version=version, num_subset=subset,
                            id_subset=1, opt_multiview=False)
                        assert (optimize._auto_save_postfix(args, hp, ds)
                                == jax_auto_save_postfix(args, hp, ds))


TINY_CONFIG = {
    "arch": "supnerf",
    "net_hyperparams": {"shape_blocks": 1, "texture_blocks": 1, "latent_dim": 32,
                        "pose_shortcut": 1, "pred_wlh": 0},
    "render_im_sz": 8, "n_samples": 8, "in_img_sz": 32, "roi_margin": 15,
    "optimize": {"num_opts": 6},
}


@pytest.mark.parametrize("cli,mode,arch", [(optimize_kitti, 1, "supnerf"),
                                           (optimize_kitti, 3, "supnerf"),
                                           (optimize_waymo, 2, "supnerf"),
                                           (optimize_kitti, 1, "autorfmix"),
                                           (optimize_waymo, 2, "autorfmix")],
                         ids=["kitti-mode1", "kitti-mode3", "waymo-mode2",
                              "kitti-mode1-autorfmix", "waymo-mode2-autorfmix"])
def test_kitti_and_waymo_clis_write_the_jax_schema(tmp_path, cli, mode, arch):
    """cli.optimize_kitti / cli.optimize_waymo on the CPU at a tiny config on
    the KITTI fixture (the Waymo layout for Waymo): the JAX result schema,
    finite curves, and no cross-view evaluation (cross_eval.pkl not
    written), as the JAX CLI for these datasets; for SUP-NeRF and for the
    AutoRFMix baseline of autorfmix.{kitti,waymo}.car.json."""
    root = tmp_path / "data"
    make_kitti_fixture(str(root))
    name = "waymo" if cli is optimize_waymo else "kitti"
    if name == "waymo":
        tr = root / "training"
        (tr / "image_2").rename(tr / "image")
        (tr / "label_2").rename(tr / "label")
    ds = dict(_kitti_hpams(str(root))["dataset"], name=name, waymo_cat="Car")
    cfg = tmp_path / "tiny.json"
    config = dict(TINY_CONFIG, dataset=ds, model_dir=str(tmp_path / "no_checkpoint"))
    if arch != "supnerf":
        config.update(arch=arch, net_hyperparams={"shape_blocks": 2, "texture_blocks": 1,
                                                  "latent_dim": 32})
    cfg.write_text(json.dumps(config))
    out = tmp_path / "run"
    summary = cli.main(["--config_file", str(cfg), "--add_pose_err", str(mode),
                        "--batch_size", "2", "--device", "cpu", "--save_dir", str(out)])
    assert summary["cross"] is None and summary["n_objects"] == 2
    assert not (out / "cross_eval.pkl").exists()
    with open(out / "codes+poses.pkl", "rb") as f:
        res = pickle.load(f)
    assert set(res) == _jax_result_keys()
    assert res["num_obj"] == 2
    assert all(len(v) == 6 and np.isfinite(v).all() for v in res["psnr_eval"].values())
    assert all(np.isfinite(v).all() for v in res["depth_err_mean"].values())
    assert set(res["optimized_poses"]) == {"000000_0", "000001_0"}
    cam = "CAM_FRONT" if name == "waymo" else "CAM2"
    assert res["optimized_poses"]["000000_0"][cam].shape == (6, 3, 4)
