"""The port's batched training prep (supnerf_tpu_torch/training/pixel_prep.py
and UnifiedTrainer.prepare_batch_arrays) against the JAX package's
(supnerf_tpu/training/pixel_prep.py, UnifiedTrainer._prepare_batch_arrays)
on the CPU, on the same samples and random streams.

Tolerances: the encoder input 1e-5 absolute where a crop is resized (the
small-crop branch resizes with torch.nn.functional.interpolate where JAX
calls cv2.resize, the resize tolerance of test_torch_geometry.py); the
projected corners rtol 1e-5 / atol 1e-3 (torch against jnp, as
test_torch_train_step.py holds them); every other array exactly (the same
numpy arithmetic). Against the port's own per-row prep (prepare_row): 2e-5,
the JAX package's own bound between its two paths (tests/test_pixel_prep.py:
float32 against float64 ray arithmetic, and the gathers' bilinear sums).
The JAX trainer is built once, for CodeNeRF (no encoder to initialise), and
its augmentation attributes are set per case; the dataset carries injected
pose errors (pose-error mode 1), so both trainers take its source poses
(the JAX trainer would draw mode-2 poses from its own PRNG)."""
import numpy as np
import pytest

import torch_threads  # noqa: F401
from supnerf_tpu.data.synthetic import make_synthetic_object
from supnerf_tpu.models import build_model as jax_build_model
from supnerf_tpu.training import pixel_prep as jax_pp
from supnerf_tpu.training.trainer import UnifiedTrainer as JaxTrainer
from supnerf_tpu_torch.geometry.roi import roi_process
from supnerf_tpu_torch.models.factory import build_model, init_model
from supnerf_tpu_torch.training import pixel_prep as pp
from supnerf_tpu_torch.training.trainer import UnifiedTrainer

HP = {"arch": "codenerf", "net_hyperparams": {"shape_blocks": 1, "texture_blocks": 1,
                                              "latent_dim": 32},
      "n_rays": 64, "n_samples": 8, "in_img_sz": 32, "roi_margin": 5, "shapenet_obj_cood": 1,
      "lr_schedule": [{"lr": 1e-4, "interval": 1000}] * 2}
CASES = ("none", "aug_box2d", "aug_wlh", "sym_aug")


class PoseErrData:
    """Synthetic objects (the JAX package's) with an injected-error source
    pose each, as a mode-1 reader gives them."""

    add_pose_err = 1

    def __init__(self, n):
        self.samples = []
        for i in range(n):
            s = make_synthetic_object(seed=70 + i)
            err = np.asarray(s["obj_poses"], np.float32).copy()
            err[:, 3] += np.float32([0.3, -0.1, 0.5]) * (i + 1)
            s.update(instoken=f"ins_{i // 2}", obj_poses_w_err=err)
            self.samples.append(s)

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]


@pytest.fixture(scope="module")
def trainers(tmp_path_factory):
    d = tmp_path_factory.mktemp("prep")
    ds = PoseErrData(6)
    jax_tr = JaxTrainer(jax_build_model("codenerf", HP["net_hyperparams"]), HP, ds,
                        str(d / "jax"), batch_size=4, loss_mode="nerf_only", log_writer=False,
                        img_upload_dtype=None, steps_per_dispatch=1)
    ours = UnifiedTrainer(init_model(build_model("codenerf", HP["net_hyperparams"]), 0), HP, ds,
                          str(d / "port"), device="cpu", batch_size=4, loss_mode="nerf_only",
                          log_writer=False)
    return jax_tr, ours


def _set_case(trainer, case):
    trainer.aug_box2d = case == "aug_box2d"
    trainer.aug_wlh = case == "aug_wlh"
    trainer.hpams = dict(HP, sym_aug=int(case == "sym_aug"))


@pytest.mark.parametrize("roi, out_size", [((10, 5, 130, 80), 64), ((40, 30, 70, 50), 64),
                                           ((20, 10, 380, 290), 64), ((0, 0, 400, 300), 32)],
                         ids=["small-down", "small-up", "gather-64", "gather-32"])
def test_resize_masked_from_full_matches_jax(roi, out_size):
    """Both branches: a crop of at most 5 x out_size^2 pixels resized (the
    first two), a larger one gathered from the full image (the last two,
    identical arithmetic to JAX's)."""
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 1, (300, 400, 3)).astype(np.float32)
    mask = rng.choice([-1.0, 0.0, 1.0], (300, 400)).astype(np.float32)
    x0, y0, x1, y1 = roi
    hw = pp.square_resize_hw(y1 - y0, x1 - x0, out_size)
    got = pp.resize_masked_from_full(img, mask, roi, hw, out_size)
    want = jax_pp.resize_masked_from_full(img, mask, roi, hw, out_size)
    assert got.shape == want.shape == (out_size, out_size, 3) and got.dtype == np.float32
    if (y1 - y0) * (x1 - x0) > 5 * out_size ** 2:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=1e-5)


def test_square_resize_hw_matches_jax():
    for h, w, out in ((75, 120, 64), (120, 75, 64), (33, 33, 128), (7, 300, 128), (128, 1, 32)):
        assert pp.square_resize_hw(h, w, out) == jax_pp.square_resize_hw(h, w, out)


@pytest.mark.parametrize("shapenet", [True, False])
def test_batched_train_rays_and_targets_match_jax(shapenet):
    """The batch's rays, depths and pixel coordinates, and each row's
    gathered targets, bit for bit."""
    rng = np.random.default_rng(1)
    B, R, S = 3, 50, 8
    x0, y0 = rng.integers(0, 100, B), rng.integers(0, 60, B)
    rois = np.stack([x0, y0, x0 + rng.integers(20, 90, B), y0 + rng.integers(20, 80, B)], -1)
    ids = np.stack([rng.permutation((r[2] - r[0]) * (r[3] - r[1]))[:R] for r in rois])
    Ks = np.tile(np.float32([[800, 0, 320], [0, 800, 180], [0, 0, 1]]), (B, 1, 1))
    cams = np.concatenate([np.tile(np.eye(3, dtype=np.float32), (B, 1, 1)),
                           rng.normal(0, 5, (B, 3, 1)).astype(np.float32)], -1)
    wlhs = rng.uniform(1, 4, (B, 3)).astype(np.float32)
    zj, flips = rng.random((B, S)), np.array([True, False, True])
    got, ys, xs = pp.batched_train_rays(rois, ids, Ks, cams, wlhs, zj, flips, S, shapenet)
    want, jys, jxs = jax_pp.batched_train_rays(rois, ids, Ks, cams, wlhs, zj, flips, S, shapenet)
    np.testing.assert_array_equal(ys, jys)
    np.testing.assert_array_equal(xs, jxs)
    for k in ("xyz", "viewdir", "z_vals"):
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    img = rng.uniform(0, 1, (200, 250, 3)).astype(np.float32)
    mask = rng.choice([-1.0, 0.0, 1.0], (200, 250)).astype(np.float32)
    for b in range(B):
        for a, w in zip(pp.gather_targets(img, mask, ys[b], xs[b]),
                        jax_pp.gather_targets(img, mask, ys[b], xs[b])):
            np.testing.assert_array_equal(a, w)


@pytest.mark.parametrize("case", CASES)
def test_prepare_batch_arrays_matches_jax(trainers, case):
    """The epoch loop's batch under each augmentation: the same keys, every
    array JAX's (the encoder input and the corners at the stated
    tolerances); the augmentation changed what it should."""
    jax_tr, ours = trainers
    for tr in trainers:
        _set_case(tr, case)
    idxs, salt = [3, 0, 5, 1], 7
    want = jax_tr._prepare_batch_arrays(idxs, salt)
    got = ours.prepare_batch_arrays(idxs, salt)
    assert set(got) == set(want)
    for k, v in want.items():
        if k == "img_in":
            np.testing.assert_allclose(got[k], v, atol=1e-5, err_msg=k)
        elif k in ("tgt_uv", "tgt_uv_aug"):
            np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-3, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        assert got[k].dtype == (np.int64 if k == "code_idx" else np.float32), k
    np.testing.assert_array_equal(got["src_pose"],
                                  [ours.dataset[i]["obj_poses_w_err"] for i in idxs])
    assert (case == "aug_wlh") == (not np.array_equal(got["wlh_aug"], got["wlh"]))
    plain = [roi_process(ours.dataset[i]["rois"], *ours.dataset[i]["imgs"].shape[:2], 5)
             for i in idxs]
    assert (case == "aug_box2d") == (not np.array_equal(got["roi"], plain))


@pytest.mark.parametrize("case", CASES)
def test_prepare_batch_arrays_match_the_per_row_prep(trainers, case):
    """The port's two preps of one batch from the same streams: the
    batched arrays against prepare_row's rows, stacked."""
    _, ours = trainers
    _set_case(ours, case)
    idxs, salt = [2, 4, 0, 1], 3
    got = ours.prepare_batch_arrays(idxs, salt)
    rows = [ours.prepare_row(i, salt) for i in idxs]
    want = {k: np.stack([r[k] for r in rows]) for k in rows[0]}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-5, atol=2e-5, err_msg=k)
        assert got[k].dtype == want[k].dtype, k
