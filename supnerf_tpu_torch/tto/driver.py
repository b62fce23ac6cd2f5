"""Test-time optimization over a dataset in object batches; the port of
supnerf_tpu/tto/driver.py's TTODriver (reference optimizer_nuscenes.py
OptimizerNuScenes :35): initial poses, batching, bookkeeping keyed by
annotation and camera, snapshots at CODE_SAVE_ITERS, the codes+poses result
files, and the cross-view evaluation (eval_cross_view :1279).

It runs every arch of models/factory.py: SUP-NeRF, the AutoRF baselines
(AutoRFMix for "autorf" and "autorfmix", the original AutoRF) and CodeNeRF;
tto/core.py handles their encoders and refiners. The loss, lidar and
cross-view renders of a kernel-compatible decoder run on K1/K2, those of
the original AutoRF on its plain decoder (tto/core.render_decoder). As in
the JAX driver, nothing else depends on the arch.

It covers opt_pose 0 (the codes alone), 1 (codes and pose) and 2 (codes and
pose from a PnP bootstrap: tto/pnp.py solves the encoder's corner
prediction against the annotated box, between the encoder and the refiner
of the one encoder pass), the pose as axis-angle or XYZ Euler angles, of
the object or the camera (hpams euler_rot, optimize.opt_cam_pose), the
annotated, predicted or mean-snapped box size (pred_wlh 0, 1, 2), the
frustum or the AABB loss render, the regularisers sym_aug and obj_sz_reg
(hpams keys, as in the JAX driver), add_pose_err 0 (ground truth), 1 (a yaw
and a depth-ratio error of init_rot_err / init_trans_err), 2 (random) and 3
(the reader's pose from a third-party detection), codes stored per
instance, annotation or (annotation, camera) (code_level 0, 1, 2), the
multiview TTO of each instance's views with shared codes (run_multiview,
tto/multiview.py; it draws no panels, as in JAX), the visualisation (vis
1: [render | depth | target + box] panels of the first and last snapshot,
vis 2: of every iteration, and with either the ring of 8 virtual views and
the final render's SSIM; _save_vis), in the nuScenes object frame or the
KITTI one (dataset_frame "kitti" / "waymo", reference
optimizer_kitti.py:24,638-639): there the initial and ground-truth poses
move to the nuScenes frame in the prep, the refiner sees the box corners
scaled by KITTI_BOX_FAC unless the predicted wlh is used, and the field's
samples rotate into the nuScenes frame.

run pipelines the batches as the JAX driver's run does (driver.py:354-398):
one worker process (_PrepWorker) prepares batch i + 1 while batch i runs,
batch i is dispatched (its launches and its results' copies to pinned
memory enqueued, an event recorded) before batch i - 1 is fetched (that
event waited on, not the card) and bookkept, and the results are saved at
JAX's cadence. optimize_object_batch runs one batch in the serial order,
and run gives the serial loop's results bit for bit: the worker is forked
with the prep's streams as they stand and hands them back at the end, so
that later reads (the cross-view evaluation) see the serial loop's draws.

Data parallelism (group, a parallel.Group; the JAX driver's mesh,
driver.py:184-186, :413-414, :432-433): each batch is padded to batch_size
with its last row, as JAX pads it, and rank r optimizes the r-th of the
world's equal contiguous shares. The loop needs no reduction across ranks:
the loss is a sum over objects and the encoder normalises one object at a
time. The results must be a one-card run's, so the draws stay aligned:
every rank prepares the whole batch (the host streams prep_gen and np_rng
and the readers' own draws advance as on one card) and draws the whole
batch's render randomness (tto_draws: the flips, the jitter, the
object-size draws, in the order of run_tto_batch's iteration_draws),
keeping its objects' rows. A run without a group takes the same path with
all rows its own. The results are gathered to rank 0, which alone keeps
the bookkeeping (opt_pose 2's PnP count over the batch's real rows, not
the padding), writes the result files and the panels, and runs what the
JAX driver does not shard: the cross-view evaluation and multiview.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import multiprocessing
import os
import pickle
import sys
import time
import traceback

import numpy as np
import torch

from supnerf_tpu_torch.data.synthetic import prepare_object_inputs
from supnerf_tpu_torch.device import resolve_device
from supnerf_tpu_torch.eval.metrics import ssim
from supnerf_tpu_torch.geometry import poses as pose_gen
from supnerf_tpu_torch.geometry.boxes import (
    corners_of_box,
    invert_pose,
    obj_pose_kitti2nusc,
    view_points,
)
from supnerf_tpu_torch.geometry.roi import resize_linear, roi_coord_trans
from supnerf_tpu_torch.ops.volume_render import masked_psnr
from supnerf_tpu_torch.parallel.mesh import gather_to_main, is_main, row_slice
from supnerf_tpu_torch.render.renderer import (
    render_full_image,
    render_rays_at_pixels,
    render_rays_frustum,
    render_virtual_views,
)
from supnerf_tpu_torch.timing import PhaseTimer
from supnerf_tpu_torch.tto.core import (
    CODE_SAVE_ITERS,
    ObjectBatch,
    TTOConfig,
    make_composite,
    render_decoder,
    run_tto_batch,
    tto_draws,
)
from supnerf_tpu_torch.tto.multiview import MultiviewBatch, run_multiview_tto
from supnerf_tpu_torch.tto.pnp import pnp_bootstrap
from supnerf_tpu_torch.utils.image_io import write_png
from supnerf_tpu_torch.utils.vis import panel_rgb_depth_gt, render_box, virtual_view_sheet

# cells of the cross-view evaluation rendered per kernel call
_CROSS_VIEW_CHUNK = 64
# the refiner's corner scale in the KITTI and Waymo protocols
KITTI_BOX_FAC = 1.1
# the panels' box colour (RGB) and the virtual views' ring
VIS_BOX_COLOR = (1.0, 144 / 255, 30 / 255)
VIRTUAL_VIEWS = 8
# what the bookkeeping reads of a sample (the rest, the camera image among
# it, stays in the prep worker)
_BOOKKEEPING_KEYS = ("anntoken", "cam_ids", "instoken")


@contextlib.contextmanager
def _one_intraop_thread():
    """torch's CPU ops on one thread for the block. The host prep runs so,
    in the worker and in the serial loop alike: a forked process must not
    enter the pools of threads it inherited (MKL's and OpenMP's hang there),
    and a CPU op's bits can depend on the thread count (F.interpolate's
    bilinear resize of the encoder's crop does), so that both must use
    one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _serve_prep(conn, prep_fn, state_fn):
    """The prep worker's loop: prepare each batch of indices it receives,
    in order, and send back ("batch", prep_fn(idxs)); on None send back
    ("state", state_fn()) and end; on a failure send back ("error", the
    exception, its traceback as a note) and end."""
    torch.set_num_threads(1)
    try:
        while True:
            idxs = conn.recv()
            if idxs is None:
                conn.send(("state", state_fn()))
                return
            conn.send(("batch", prep_fn(idxs)))
    except BaseException as e:          # raised again in the driver's process
        e.add_note("in the TTO prep worker:\n" + "".join(traceback.format_exception(e)))
        try:
            conn.send(("error", e))
        except Exception:               # an exception that does not pickle
            conn.send(("error", RuntimeError(f"{type(e).__name__}: {e}\n" + e.__notes__[-1])))


class _PrepWorker:
    """The one process that prepares run's batches ahead of the card.

    It is forked from the driver's process when run starts, so it holds the
    dataset and the prep's streams as they stand then, without pickling
    either (as torch's DataLoader workers do on Linux); it touches neither
    the card nor the thread pools it inherited (torch's CPU ops on one
    thread, _one_intraop_thread). Batches come back through a pipe in the
    order they were submitted, so every stream advances as in the serial
    loop, and finish() brings back the streams' state for the driver to
    adopt. The prep runs in a process, not a thread, because the prep is
    Python (the JPEG decoder's entropy loop, the readers) and would hold the
    interpreter lock that each of the TTO loop's launches takes (PERF.md §6:
    a thread slowed the loop by a third). A failure raises in the driver's
    process, and a worker that ends without an answer is an error there
    too. The pipe is the standard library's, which pickles a tensor by
    value (torch's multiprocessing would pass it as a shared-memory handle
    that dies with the worker)."""

    def __init__(self, prep_fn, state_fn):
        ctx = multiprocessing.get_context("fork")
        self.conn, child = ctx.Pipe()
        self.proc = ctx.Process(target=_serve_prep, args=(child, prep_fn, state_fn),
                                name="tto-prep", daemon=True)
        # the objects that exist now are left out of the collector's passes
        # until stop(): a pass writes to every object it visits, and each
        # page the driver's process writes while the worker lives is copied
        gc.freeze()
        try:
            self.proc.start()
        except BaseException:
            gc.unfreeze()
            raise
        child.close()

    def submit(self, idxs):
        self.conn.send(list(idxs))

    def _receive(self, kind):
        try:
            got, value = self.conn.recv()
        except EOFError:
            self.proc.join(10)
            raise RuntimeError(f"the TTO prep worker (pid {self.proc.pid}) ended with exit code "
                               f"{self.proc.exitcode} before sending its {kind}") from None
        if got == "error":
            raise value
        return value

    def result(self):
        """The next submitted batch's prep."""
        return self._receive("batch")

    def finish(self):
        """End the worker (every submitted batch taken); returns the state
        of its streams."""
        self.conn.send(None)
        state = self._receive("streams' state")
        self.proc.join()
        return state

    def stop(self):
        if self.proc.is_alive():
            self.proc.terminate()
        self.proc.join()
        self.conn.close()
        gc.unfreeze()


def is_kitti_frame(dataset_frame: str) -> bool:
    if dataset_frame not in ("nusc", "kitti", "waymo"):
        raise ValueError(f"dataset_frame {dataset_frame!r}: nusc, kitti or waymo")
    return dataset_frame != "nusc"


def tto_config_from_hpams(hpams: dict, *, reg_iters: int = 3, n_lidar: int = 256,
                          opt_pose: int = 1, pred_wlh: int = 0,
                          dataset_frame: str = "nusc") -> TTOConfig:
    """The TTO config of a config file's hpams and the CLI's protocol
    flags (JAX tto/driver.py tto_config_from_hpams)."""
    opt = hpams.get("optimize", {})
    if opt_pose not in (0, 1, 2):
        raise ValueError(f"opt_pose {opt_pose}: 0, 1 or 2")
    if pred_wlh not in (0, 1, 2):
        raise ValueError(f"pred_wlh {pred_wlh}: 0, 1 or 2")
    return TTOConfig(
        num_opts=opt.get("num_opts", 100), reg_iters=reg_iters,
        n_samples=hpams.get("n_samples", 64), render_im_sz=hpams.get("render_im_sz", 32),
        in_img_sz=hpams.get("in_img_sz", 128), n_lidar=n_lidar,
        lr_shape=opt.get("lr_shape", 0.02), lr_texture=opt.get("lr_texture", 0.02),
        lr_pose=opt.get("lr_pose", 0.01), lr_half_interval=opt.get("lr_half_interval", 1000),
        loss_occ_coef=hpams.get("loss_occ_coef", 0.1),
        shapenet_obj_cood=bool(hpams.get("shapenet_obj_cood", 1)), pred_wlh_mode=pred_wlh,
        opt_pose=opt_pose > 0, euler_rot=bool(hpams.get("euler_rot", 0)),
        opt_cam_pose=bool(opt.get("opt_cam_pose", 0)),
        sym_aug=bool(hpams.get("sym_aug", 0)), obj_sz_reg=bool(hpams.get("obj_sz_reg", 0)),
        loss_obj_sz_coef=float(hpams.get("loss_obj_sz_coef", 1.0)),
        kitti2nusc=is_kitti_frame(dataset_frame),
        box_fac=KITTI_BOX_FAC if is_kitti_frame(dataset_frame) and not pred_wlh else 1.0,
    )


class TTODriver:
    """Batched TTO over `dataset` (indexable, returning the sample dicts of
    data.synthetic, with 'instoken', 'anntoken' and 'cam_ids' for the
    bookkeeping). model: a model of models/factory.py on `device` with its
    weights loaded.
    cfg: a TTOConfig that replaces the one read from hpams (the demo's AABB
    loss render). init_rot_err / init_trans_err (add_pose_err 1): None
    falls back to the config's keys, then to 0.0 / 0.2. code_level: how
    the optimized codes are stored (JAX driver; reference
    optimizer_nuscenes.py:86-112): 0 flat per instance (the multiview
    schema; run_multiview always stores so), 1 flat per annotation, 2 per
    (annotation, camera), the default; the poses stay per (annotation,
    camera) at every level. vis: 0 none, 1 or 2 the panels of _save_vis
    under save_dir/<annotation>_<camera>/ at vis_im_sz; vis 2 has the TTO
    return every iteration's codes and pose (TTOConfig.emit_code_curves).
    group: a parallel.Group to split each batch's objects with (its world
    size must divide batch_size), or None."""

    def __init__(self, model, mean_shape, mean_texture, hpams: dict, dataset, save_dir: str,
                 *, device, cfg: TTOConfig | None = None, opt_pose: int = 1,
                 reg_iters: int = 3, dataset_frame: str = "nusc", pred_wlh: int = 0,
                 add_pose_err: int = 2, batch_size: int = 16, save_freq: int = 100,
                 seed: int = 0, init_rot_err: float | None = None,
                 init_trans_err: float | None = None, rand_angle_lim: float = 0.0,
                 code_level: int | None = None, vis: int = 0, vis_im_sz: int = 128,
                 group=None):
        if vis not in (0, 1, 2):
            raise ValueError(f"vis {vis}: 0, 1 or 2")
        if add_pose_err not in (0, 1, 2, 3):
            raise ValueError(f"add_pose_err {add_pose_err}: 0, 1, 2 or 3")
        if code_level not in (None, 0, 1, 2):
            raise ValueError(f"code_level {code_level}: 0, 1 or 2")
        if group is not None and batch_size % group.world:
            raise ValueError(f"batch_size {batch_size} does not split over {group.world} ranks")
        if opt_pose == 2 and not hasattr(model, "pose_update"):
            raise ValueError("opt_pose 2 solves PnP on the encoder's box-corner prediction, "
                             f"which {type(model).__name__} does not make (SUP-NeRF does)")
        # the reference pairs non-BatchNorm encoders with a variable-size
        # keep-ratio crop (preprocess_img_keepratio(max_img_sz),
        # optimizer_nuscenes.py:179), which neither package prepares; the
        # JAX driver refuses such a config rather than substitute the square
        # crop, and so does this one (ROADMAP C.22)
        norm = hpams.get("net_hyperparams", {}).get("norm_layer_type", "BatchNorm2d")
        if norm != "BatchNorm2d":
            raise ValueError(
                f"norm_layer_type={norm!r}: the keep-ratio (max_img_sz) encoder preprocessing "
                "the reference pairs with non-BatchNorm encoders needs dynamic input shapes; "
                "use a BatchNorm2d config for TTO")
        self.device = resolve_device(str(device))
        self.model = model.to(self.device)
        self.wts = render_decoder(self.model)
        self.mean_shape = torch.as_tensor(mean_shape, dtype=torch.float32, device=self.device)
        self.mean_texture = torch.as_tensor(mean_texture, dtype=torch.float32,
                                            device=self.device)
        self.hpams, self.dataset, self.save_dir = hpams, dataset, save_dir
        self.add_pose_err, self.opt_pose = add_pose_err, opt_pose
        self.code_level = 2 if code_level is None else code_level
        self.kitti_frame = is_kitti_frame(dataset_frame)
        self.batch_size, self.save_freq = batch_size, save_freq
        self.init_rot_err = (init_rot_err if init_rot_err is not None
                             else hpams.get("init_rot_err", 0.0))
        self.init_trans_err = (init_trans_err if init_trans_err is not None
                               else hpams.get("init_trans_err", 0.2))
        self.rand_angle_lim = rand_angle_lim
        # independent streams: host prep (random initial poses), the renders'
        # jitter, and the signs of the add_pose_err 1 errors (the JAX driver's
        # np.random.default_rng(seed), so those poses are the JAX driver's)
        self.prep_gen = torch.Generator().manual_seed(2 * seed + 1)
        self.render_gen = torch.Generator(device=self.device).manual_seed(2 * seed + 2)
        self.np_rng = np.random.default_rng(seed)
        self.timer = PhaseTimer(self.device)
        self.cfg = cfg if cfg is not None else tto_config_from_hpams(
            hpams, reg_iters=reg_iters, opt_pose=opt_pose, pred_wlh=pred_wlh,
            dataset_frame=dataset_frame)
        self.vis, self.vis_im_sz = vis, vis_im_sz
        if vis >= 2 and not self.cfg.emit_code_curves:
            self.cfg = dataclasses.replace(self.cfg, emit_code_curves=True)
        self.group, self.main = group, is_main(group)
        if self.main:
            os.makedirs(save_dir, exist_ok=True)
        self.optimized_shapecodes, self.optimized_texturecodes = {}, {}
        self.optimized_poses = {}
        self.psnr_eval, self.ssim_eval, self.R_eval, self.T_eval = {}, {}, {}, {}
        self.depth_err_mean, self.lidar_pts_cnt, self.ood_flags = {}, {}, {}
        self.wlh_used = {}      # the box size each object was optimized with
        self.hit_share = {}     # AABB loss render: per iteration, the share of rays in the box
        self.loss_curve = {}    # per iteration, the loss the update descended
        self.pnp_translations = 0   # opt_pose 2: objects whose PnP depth passed the gate

    # ------------------------------------------------------------------ prep
    def _pose_with_error(self, gt):
        """add_pose_err 1 (the JAX driver's _initial_pose): a yaw of
        +-init_rot_err about the object's up axis (the camera's y in the
        KITTI frame) and the translation scaled by 1 +- init_trans_err."""
        yaw_err = self.np_rng.choice([1.0, -1.0]) * self.init_rot_err
        c, s = np.cos(yaw_err), np.sin(yaw_err)
        if self.kitti_frame:
            rot_err = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        else:
            rot_err = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
        t_ratio = 1.0 + self.np_rng.choice([1.0, -1.0]) * self.init_trans_err
        out = gt.copy()
        out[:, :3] = gt[:, :3] @ rot_err
        out[:, 3] = gt[:, 3] * t_ratio
        return out

    def _initial_poses(self, samples):
        """Initial poses in the dataset's frame by error-injection mode
        (reference data_nuscenes.py:511-574): 0 ground truth, 1 a controlled
        error, 2 the random test protocol, 3 the reader's obj_poses_w_err
        (random where a sample has none)."""
        gt = [np.asarray(s["obj_poses"], np.float32) for s in samples]
        if self.add_pose_err == 0:
            return gt
        if self.add_pose_err == 1:
            return [self._pose_with_error(p) for p in gt]
        poses = [np.asarray(s["obj_poses_w_err"], np.float32)
                 if self.add_pose_err == 3 and "obj_poses_w_err" in s else None for s in samples]
        todo = [i for i, p in enumerate(poses) if p is None]
        if todo:
            K = torch.as_tensor(np.stack([samples[i]["cam_intrinsics"] for i in todo]),
                                dtype=torch.float32)
            roi = torch.as_tensor(np.stack([samples[i]["rois"] for i in todo]),
                                  dtype=torch.float32)
            rand = pose_gen.get_random_pose2(K, roi, self.prep_gen, angle_lim=self.rand_angle_lim,
                                             trans_lim=0.3, is_kitti=self.kitti_frame)
            for i, p in zip(todo, rand.numpy()):
                poses[i] = p
        return poses

    def prep_sample(self, sample, pose_init):
        """One object's TTO inputs (data.synthetic.prepare_object_inputs);
        in the KITTI frame pose_init and obj_pose_gt move to the nuScenes
        frame (the JAX driver's _prep_sample)."""
        inputs = prepare_object_inputs(
            sample, in_img_sz=self.cfg.in_img_sz, render_im_sz=self.cfg.render_im_sz,
            roi_margin=self.hpams.get("roi_margin", 5), n_lidar=self.cfg.n_lidar,
            pose_init=pose_init)
        if self.kitti_frame:
            h = float(sample["wlh"][2])
            for key in ("pose_init", "obj_pose_gt"):
                inputs[key] = obj_pose_kitti2nusc(torch.as_tensor(inputs[key]), h).numpy()
        return inputs

    def _prep(self, idxs, poses=None):
        """Objects idxs prepared on the host and uploaded: (samples,
        prepped, ObjectBatch)."""
        samples, prepped, stacked = self._prep_arrays(idxs, poses)
        return samples, prepped, ObjectBatch.from_numpy(stacked, self.device)

    def _prep_arrays(self, idxs, poses=None):
        """Read and prepare objects idxs on the host, on one intra-op thread
        (_one_intraop_thread): (samples, prepped (one dict of numpy arrays
        an object), the arrays stacked)."""
        with _one_intraop_thread():
            samples = [self.dataset[i] for i in idxs]
            if poses is None:
                poses = self._initial_poses(samples)
            prepped = [self.prep_sample(s, p) for s, p in zip(samples, poses)]
        return samples, prepped, {k: np.stack([p[k] for p in prepped]) for k in prepped[0]}

    def _prep_batch(self, idxs):
        """One batch's host prep as the worker sends it back: the samples'
        bookkeeping keys, the prepped arrays, the stacked arrays and the
        seconds it took."""
        t0 = time.perf_counter()
        samples, prepped, stacked = self._prep_arrays(idxs)
        kept = [{k: s[k] for k in _BOOKKEEPING_KEYS if k in s} for s in samples]
        return kept, prepped, stacked, time.perf_counter() - t0

    def _stream_state(self):
        """The state of the prep's random streams: prep_gen, np_rng and the
        reader's own numpy Generator (its attribute rng, C.11), where it has
        one."""
        rng = getattr(self.dataset, "rng", None)
        return {"prep_gen": self.prep_gen.get_state().numpy(),
                "np_rng": self.np_rng.bit_generator.state,
                "dataset_rng": (rng.bit_generator.state if isinstance(rng, np.random.Generator)
                                else None)}

    def _adopt_stream_state(self, state):
        self.prep_gen.set_state(torch.from_numpy(state["prep_gen"]))
        self.np_rng.bit_generator.state = state["np_rng"]
        if state["dataset_rng"] is not None:
            self.dataset.rng.bit_generator.state = state["dataset_rng"]

    # ------------------------------------------------------------------- run
    def run(self):
        """Optimize the whole dataset in batches, pipelined as the JAX
        driver's run: the worker (_PrepWorker, one process, forked once
        batch 0 is prepared) prepares batch i + 1 while batch i runs, and
        batch i is dispatched before batch i - 1 is fetched, bookkept and
        drawn (--vis), so that the host's work of one batch lies under the
        card's work of the next. Results are saved at JAX's cadence, then
        codes+poses.pkl and its .pth twin at the end. The results are those
        of a loop of optimize_object_batch over the same batches. Returns
        results_dict(); with a group, rank 0 does so and the other ranks
        return None. A failure of the worker raises here, after the worker
        is stopped."""
        n = len(self.dataset)
        batches = [list(range(s, min(s + self.batch_size, n)))
                   for s in range(0, n, self.batch_size)]
        every = max(self.save_freq // self.batch_size, 1)
        pending, done, worker = None, 0, None
        # batch 0 is prepared here, as the serial loop does: the card has
        # nothing to run meanwhile, and the worker, forked after it with the
        # streams it advanced, starts beside batch 0's launches
        prep = self._prep_batch(batches[0]) if batches else None
        if len(batches) > 1:
            with self.timer.host("worker_start"):
                worker = _PrepWorker(self._prep_batch, self._stream_state)
        try:
            for bi, idxs in enumerate(batches):
                if bi:
                    with self.timer.host("prep_wait"):
                        prep = worker.result()
                if bi + 1 < len(batches):
                    worker.submit(batches[bi + 1])
                prep = self._take_prep(prep)
                if self.main:
                    print(f"num obj: {idxs[0]}/{n}")
                if pending is not None and self.group is not None:
                    # the gather's collective runs on the card's stream: it
                    # goes before this batch's launches, not behind them
                    self._fetch_batch(pending)
                launched = self._dispatch_batch(idxs, prep)
                if pending is not None:
                    self._postprocess_batch(pending)
                    done += 1
                    if self.main and (done - 1) % every == 0:
                        self.save_results()
                pending = launched
            if pending is not None:
                self._postprocess_batch(pending)
            if worker is not None:
                with self.timer.host("worker_stop"):
                    self._adopt_stream_state(worker.finish())
        finally:
            if worker is not None:
                with self.timer.host("worker_stop"):
                    worker.stop()
        self.timer.collect()
        if not self.main:
            return None
        self.save_results()
        self.save_results_pth()
        return self.results_dict()

    def optimize_object_batch(self, idxs):
        """Prepare, dispatch, fetch and bookkeep one batch synchronously:
        the serial order that run pipelines. Returns the batch's results
        (numpy, one row an object) on rank 0, None elsewhere."""
        prep = self._take_prep(self._prep_batch(idxs))
        return self._postprocess_batch(self._dispatch_batch(idxs, prep))

    def _take_prep(self, prep):
        samples, prepped, stacked, seconds = prep
        self.timer.add("host_prep", seconds)
        # the keys as interned str (a reader's may be numpy.str_), so that the
        # result files pickle each as one object however the samples came
        # (the worker's pipe makes new strings)
        samples = [{k: sys.intern(str(v)) if isinstance(v, str) else v for k, v in s.items()}
                   for s in samples]
        return samples, prepped, stacked

    def _dispatch_batch(self, idxs, prep):
        """Upload one prepared batch and enqueue its TTO (run_tto_batch)
        with the whole batch's draws (tto_draws), on this rank's share: all
        B rows without a group; with one, its rows of the batch padded to
        batch_size with its last row, and of the draws. The results' copies
        to the host are enqueued behind it (into pinned memory on the card)
        with an event that _fetch_batch waits on; nothing here waits for
        the card but opt_pose 2's PnP, which needs the encoder's corners on
        the host. Returns the batch's handle."""
        samples, prepped, stacked = prep
        batch = ObjectBatch.from_numpy(stacked, self.device)
        B = len(batch.img_in)
        draws = tto_draws(self.cfg, B, self.render_gen, self.device)
        n = B if self.group is None else self.batch_size
        pick = torch.arange(n).clamp_(max=B - 1)[row_slice(self.group, n)].to(self.device)
        share = ObjectBatch(**{f.name: getattr(batch, f.name)[pick]
                               for f in dataclasses.fields(ObjectBatch)})
        loss_j, depth_j = draws["jitter"]
        rows = {k: None if draws[k] is None else draws[k][:, pick]
                for k in ("sym_flips", "obj_sz_draws")}
        taken = []
        hook = (lambda uv: self._pnp_poses(uv, share, taken)) if self.opt_pose == 2 else None
        res = run_tto_batch(self.model, self.wts, share, self.mean_shape, self.mean_texture,
                            self.cfg, jitter=(loss_j[:, pick], depth_j[:, pick]),
                            timer=self.timer, pose_hook=hook, **rows)
        if self.device.type == "cuda":
            host = {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True).copy_(
                v.detach(), non_blocking=True) for k, v in res.items()}
            ready = torch.cuda.Event()
            ready.record()
        else:
            host, ready = {k: v.detach() for k, v in res.items()}, None
        return {"idxs": idxs, "samples": samples, "prepped": prepped, "B": B, "host": host,
                "ready": ready, "taken": taken, "res": None, "fetched": False}

    def _fetch_batch(self, handle):
        """Wait for a dispatched batch's results on the host (its event, not
        the whole card) and, with a group, gather them to rank 0; sets
        handle["res"] to the batch's results (numpy, B rows) on rank 0, None
        elsewhere."""
        with self.timer.host("fetch"):
            if handle["ready"] is not None:
                handle["ready"].synchronize()
            part = ({k: v.numpy() for k, v in handle["host"].items()},
                    np.concatenate(handle["taken"]) if handle["taken"] else None)
        self.timer.collect()
        handle["fetched"] = True
        if self.group is None:
            parts = [part]
        else:
            with self.timer.host("gather"):
                parts = gather_to_main(self.group, part)
            if parts is None:
                return
        B = handle["B"]
        if self.opt_pose == 2:
            # the padding's repeated rows are counted nowhere
            took = int(np.concatenate([t for _, t in parts])[:B].sum())
            self.pnp_translations += took
            print(f"PnP bootstrap: {took} of {B} objects took the PnP translation")
        handle["res"] = {k: np.concatenate([p[k] for p, _ in parts])[:B] for k in parts[0][0]}

    def _postprocess_batch(self, handle):
        """Fetch a dispatched batch (unless done) and, on rank 0, bookkeep
        it and draw its --vis panels. Returns its results on rank 0, None
        elsewhere."""
        if not handle["fetched"]:
            self._fetch_batch(handle)
        res = handle["res"]
        if res is None:
            return None
        with self.timer.host("bookkeeping"):
            log_idxs = self._bookkeep(handle["idxs"], handle["samples"], handle["prepped"], res)
        if self.vis:
            with self.timer.host("vis"):
                self._save_vis(log_idxs, handle["prepped"], res)
        return res

    def _corner_uv(self, uv_direct):
        """The encoder's 16-wide direct corner prediction on the host, (B, 16)."""
        return uv_direct.detach().cpu().numpy()

    def _pnp_poses(self, uv_direct, batch: ObjectBatch, taken: list):
        """opt_pose 2 (JAX driver _dispatch_batch; reference
        optimizer_nuscenes.py:464-494): each object's initial pose from
        P3P-RANSAC on its predicted corners (tto/pnp.pnp_bootstrap, with the
        annotated wlh, roi_refine and K), the rotation always, the
        translation where its depth is in (0, 60) m. Appends to `taken`
        whether each object took the PnP translation, (B,) bool."""
        uv = self._corner_uv(uv_direct)
        src = batch.pose_init.detach().cpu().numpy()
        roi, wlh, K = (t.detach().cpu().numpy() for t in (batch.roi_refine, batch.wlh, batch.K))
        out = np.stack([pnp_bootstrap(uv[i], roi[i], wlh[i], K[i], src[i])
                        for i in range(len(src))])
        taken.append(np.array([not np.array_equal(out[i, :, 3], src[i, :, 3])
                               for i in range(len(src))], bool))
        return torch.as_tensor(out, device=batch.pose_init.device)

    def _store_codes(self, ins, ann, cam, sc, tc):
        """One object's code snapshots under the driver's code_level."""
        for store, codes in ((self.optimized_shapecodes, sc), (self.optimized_texturecodes, tc)):
            if self.code_level == 0:
                store[ins] = codes
            elif self.code_level == 1:
                store[ann] = codes
            else:
                store.setdefault(ann, {})[cam] = codes

    def _saved_codes(self, ins, ann, cam):
        """(shape, texture) snapshots of one view under code_level, or None."""
        sc, tc = self.optimized_shapecodes, self.optimized_texturecodes
        key = {0: ins, 1: ann}.get(self.code_level)
        if key is None:     # code_level 2: {ann: {cam: codes}}
            sc, tc, key = sc.get(ann, {}), tc.get(ann, {}), cam
        return (sc[key], tc[key]) if key in sc else None

    def _bookkeep(self, idxs, samples, prepped, res):
        """Record one batch's results (tensors or numpy); returns the
        objects' log indices (<annotation>_<camera>)."""
        res = {k: v.detach().cpu().numpy() if torch.is_tensor(v) else v for k, v in res.items()}
        log_idxs = []
        # out-of-distribution check on the refined pose (reference
        # optimizer_nuscenes.py:656-660): its up axis more than 45 degrees
        # from the camera's up [0, -1, 0]
        refined = res["pose_traj"][:, -1]
        ood = np.abs(np.arccos(np.clip(-refined[:, 1, 2], -1.0, 1.0))) > np.pi / 4
        for i, (sample, idx) in enumerate(zip(samples, idxs)):
            ann = sample.get("anntoken", f"obj{idx}")
            cam = sample.get("cam_ids", "CAM")
            log_idx = f"{ann}_{cam}"
            log_idxs.append(log_idx)
            self._store_codes(sample.get("instoken", ann), ann, cam,
                              res["shapecodes_saved"][i].copy(),
                              res["texturecodes_saved"][i].copy())
            self.optimized_poses.setdefault(ann, {})[cam] = res["poses_saved"][i].copy()
            self.psnr_eval[log_idx] = res["psnr"][i].tolist()
            self.R_eval[log_idx] = res["rot_err"][i].tolist()
            self.T_eval[log_idx] = res["trans_err"][i].tolist()
            self.depth_err_mean[log_idx] = res["depth_err"][i].tolist()
            self.lidar_pts_cnt[log_idx] = int(prepped[i]["lidar_valid"].sum())
            self.ood_flags[log_idx] = bool(ood[i])
            self.wlh_used[log_idx] = res["wlh_used"][i].tolist()
            self.loss_curve[log_idx] = res["loss"][i].tolist()
            if "hit_share" in res:
                self.hit_share[log_idx] = res["hit_share"][i].tolist()
            if ood[i]:
                print("Found out-of-distribution pose")
            print(f"  {log_idx}: psnr {res['psnr'][i, 0]:.2f} -> {res['psnr'][i, -1]:.2f}, "
                  f"RE {res['rot_err'][i, 0]:.3f} -> {res['rot_err'][i, -1]:.3f}, "
                  f"TE {res['trans_err'][i, 0]:.3f} -> {res['trans_err'][i, -1]:.3f}, "
                  f"DE {res['depth_err'][i, 0]:.3f} -> {res['depth_err'][i, -1]:.3f}")
        return log_idxs

    # --------------------------------------------------------- visualisation
    @torch.no_grad()
    def _save_vis(self, log_idxs, prepped, res):
        """One batch's panels (JAX driver _save_vis; reference
        output_single_view_vis :1479, save_virtual_img :1643), written as
        PNGs into save_dir/<log_idx>/:
          opt{t:03d}.png  [render | depth | target + box] at vis_im_sz, with
                          the metrics of iteration min(t, num_opts - 1), for
                          the first and last snapshot (vis 1) or every
                          iteration t (vis 2);
          virt_final.png  the final codes' 8 virtual views at min(vis_im_sz,
                          64), two rows;
        and the final render's SSIM against the target into ssim_eval.
        Each render is one render_full_image of the whole batch (K1 for a
        kernel-compatible decoder on the card); a failure raises."""
        cfg, sz, dev = self.cfg, self.vis_im_sz, self.device
        if self.vis >= 2:
            code_iters = list(range(cfg.num_opts))
            codes = res["shapecode_curve"], res["texturecode_curve"], res["pose_curve"]
            sel = range(cfg.num_opts)
        else:
            code_iters = list(CODE_SAVE_ITERS)
            codes = res["shapecodes_saved"], res["texturecodes_saved"], res["poses_saved"]
            sel = (0, len(code_iters) - 1)

        def stack(key):
            return torch.as_tensor(np.stack([p[key] for p in prepped]), dtype=torch.float32,
                                   device=dev)

        K, roi, wlh = stack("K"), stack("roi_nerf"), stack("wlh")
        diag = torch.linalg.norm(wlh, dim=-1)
        roi_np = np.stack([np.asarray(p["roi_nerf"], np.float32) for p in prepped])
        r = cfg.render_im_sz
        gt_small = [resize_linear(np.asarray(p["rgb_tgt"]).reshape(r, r, 3), (sz, sz))
                    for p in prepped]
        dirs = [os.path.join(self.save_dir, name) for name in log_idxs]
        for d in dirs:
            os.makedirs(d, exist_ok=True)

        def render(sc, tc, pose_obj):
            comp = make_composite(self.wts, torch.as_tensor(sc, device=dev),
                                  torch.as_tensor(tc, device=dev))
            rgb, depth, _ = render_full_image(
                comp, invert_pose(pose_obj), K, roi, diag, n_samples=cfg.n_samples,
                im_hw=(sz, sz), shapenet_obj_cood=cfg.shapenet_obj_cood,
                kitti2nusc=cfg.kitti2nusc)
            return rgb.cpu().numpy(), depth.cpu().numpy()

        for ci in sel:
            pose = torch.as_tensor(codes[2][:, ci], device=dev)
            rgb, depth = render(codes[0][:, ci], codes[1][:, ci], pose)
            uv = view_points(corners_of_box(pose, wlh), K, normalize=True)[:, :2].cpu().numpy()
            t = code_iters[ci]
            m = min(t, cfg.num_opts - 1)
            for b, d in enumerate(dirs):
                x0, y0 = roi_np[b, 0], roi_np[b, 1]
                u2, v2 = roi_coord_trans(uv[b, 0] - x0, uv[b, 1] - y0,
                                         roi_np[b] - np.array([x0, y0, x0, y0]), sz)
                gt_vis = render_box(gt_small[b].copy(), np.stack([u2, v2]),
                                    colors=(VIS_BOX_COLOR,) * 3, linewidth=1)
                panel = panel_rgb_depth_gt(
                    rgb[b], depth[b], gt_vis, psnr=float(res["psnr"][b, m]),
                    depth_err=float(res["depth_err"][b, m]), rot_err=float(res["rot_err"][b, m]),
                    trans_err=float(res["trans_err"][b, m]))
                write_png(os.path.join(d, f"opt{t:03d}.png"), panel)

        sc, tc = res["final_shapecode"], res["final_texturecode"]
        rgb_f, _ = render(sc, tc, torch.as_tensor(res["final_pose"], device=dev))
        for b, name in enumerate(log_idxs):
            self.ssim_eval.setdefault(name, []).append(ssim(rgb_f[b], gt_small[b]))
        comp = make_composite(
            self.wts, torch.as_tensor(sc, device=dev).repeat_interleave(VIRTUAL_VIEWS, 0),
            torch.as_tensor(tc, device=dev).repeat_interleave(VIRTUAL_VIEWS, 0))
        views = render_virtual_views(comp, diag, K, n_samples=cfg.n_samples,
                                     shapenet_obj_cood=cfg.shapenet_obj_cood,
                                     pan_num=VIRTUAL_VIEWS, img_sz=min(sz, 64),
                                     kitti2nusc=cfg.kitti2nusc).cpu().numpy()
        for b, d in enumerate(dirs):
            write_png(os.path.join(d, "virt_final.png"), virtual_view_sheet(views[b]))

    # ------------------------------------------------- cross-view evaluation
    @torch.no_grad()
    def eval_cross_view(self):
        """Render each instance's saved codes into every view of the same
        instance and score PSNR and lidar-depth error (reference
        eval_cross_view :1279-1410). All cells (code snapshot x source view x
        target view) of an instance render as one object batch, with one
        fixed jitter vector. A view's codes are those its code_level stored
        (at level 0 one code per instance, so an instance's rows agree).
        Saves and returns the cross_eval dict."""
        cfg = self.cfg
        jitter = torch.rand(cfg.n_samples, generator=torch.Generator().manual_seed(0))
        by_ins = {}
        for idx in range(len(self.dataset)):
            s = self.dataset[idx]
            ann, cam = s.get("anntoken", f"obj{idx}"), s.get("cam_ids", "CAM")
            codes = self._saved_codes(s.get("instoken", ann), ann, cam)
            if codes is not None:
                by_ins.setdefault(s.get("instoken", str(idx)), []).append((idx, codes))
        psnr_mats, depth_mats = {}, {}
        with self.timer.phase("cross_view"):
            for ins, views in by_ins.items():
                n_v, n_code = len(views), len(CODE_SAVE_ITERS)
                gts = [np.asarray(self.dataset[i]["obj_poses"], np.float32) for i, _ in views]
                _, _, tgt = self._prep([i for i, _ in views], poses=gts)
                # (n_code, n_v, latent) each
                sc, tc = (torch.as_tensor(np.stack([np.asarray(c[k]) for _, c in views], 1),
                                          dtype=torch.float32, device=self.device)
                          for k in (0, 1))
                code_idx = torch.arange(n_code * n_v, device=self.device).repeat_interleave(n_v)
                view_idx = torch.arange(n_v, device=self.device).repeat(n_code * n_v)
                psnr, derr = [], []
                for lo in range(0, len(code_idx), _CROSS_VIEW_CHUNK):
                    ci = code_idx[lo:lo + _CROSS_VIEW_CHUNK]
                    vi = view_idx[lo:lo + _CROSS_VIEW_CHUNK]
                    p, d = self._cross_cells(sc.reshape(-1, sc.shape[-1])[ci],
                                             tc.reshape(-1, tc.shape[-1])[ci], tgt, vi, jitter)
                    psnr.append(p)
                    derr.append(d)
                pm = torch.cat(psnr).reshape(n_code, n_v, n_v).cpu().numpy()
                dm = torch.cat(derr).reshape(n_code, n_v, n_v).cpu().numpy()
                psnr_mats[ins] = [pm[c] for c in range(n_code)]
                depth_mats[ins] = [dm[c] for c in range(n_code)]
        cross = {"psnr_eval_mat_per_ins": psnr_mats, "depth_eval_mat_per_ins": depth_mats,
                 # empty in the reference too (optimizer_nuscenes.py:1396,1400)
                 "cnt_lidar_pts_per_ins": {}, "CODE_SAVE_ITERS_": list(CODE_SAVE_ITERS)}
        with open(os.path.join(self.save_dir, "cross_eval.pkl"), "wb") as f:
            pickle.dump(cross, f)
        return cross

    def _cross_cells(self, sc, tc, tgt: ObjectBatch, vi, jitter):
        """PSNR and lidar-depth error of codes (n, latent) rendered at the
        ground-truth poses of target views vi (n,)."""
        cfg = self.cfg
        pick = {k: getattr(tgt, k)[vi] for k in ("obj_pose_gt", "K", "roi_nerf", "wlh",
                                                 "rgb_tgt", "occ_tgt", "lidar_u", "lidar_v",
                                                 "lidar_depth", "lidar_valid")}
        n = len(vi)
        diag = torch.linalg.norm(pick["wlh"], dim=-1)
        cam = invert_pose(pick["obj_pose_gt"])
        jit = jitter.to(self.device).expand(n, -1)

        comp = make_composite(self.wts, sc, tc)
        out = render_rays_frustum(comp, cam, pick["K"], pick["roi_nerf"], diag,
                                  n_samples=cfg.n_samples, im_sz=cfg.render_im_sz,
                                  shapenet_obj_cood=cfg.shapenet_obj_cood,
                                  kitti2nusc=cfg.kitti2nusc, jitter=jit)
        psnr = masked_psnr(out["rgb"], pick["rgb_tgt"], pick["occ_tgt"], dim=(1, 2))
        outd = render_rays_at_pixels(comp, cam, pick["K"], pick["lidar_u"], pick["lidar_v"], diag,
                                     n_samples=cfg.n_samples,
                                     shapenet_obj_cood=cfg.shapenet_obj_cood,
                                     kitti2nusc=cfg.kitti2nusc, jitter=jit)
        m = pick["lidar_valid"]
        derr = (torch.abs(outd["depth"] - pick["lidar_depth"]) * m).sum(1) / (m.sum(1) + 1e-8)
        return psnr, derr

    # ------------------------------------------------------------------ save
    def results_dict(self):
        """The JAX driver's result schema (supnerf_tpu/tto/driver.py results_dict)."""
        return {
            "num_obj": len(self.psnr_eval),
            "ssim_eval": self.ssim_eval,
            "optimized_shapecodes": self.optimized_shapecodes,
            "optimized_texturecodes": self.optimized_texturecodes,
            "optimized_poses": self.optimized_poses,
            "psnr_eval": self.psnr_eval,
            "R_eval": self.R_eval,
            "T_eval": self.T_eval,
            "depth_err_mean": self.depth_err_mean,
            "lidar_pts_cnt": self.lidar_pts_cnt,
            "ood_flags": self.ood_flags,
            "num_ood": int(sum(self.ood_flags.values())),
            "CODE_SAVE_ITERS_": list(CODE_SAVE_ITERS),
            "code_level": self.code_level,   # the optimized_* codes' schema (__init__)
        }

    def save_results(self, name: str = "codes+poses.pkl"):
        with open(os.path.join(self.save_dir, name), "wb") as f:
            pickle.dump(self.results_dict(), f)

    def save_results_pth(self, name: str = "codes+poses.pth"):
        """The results in the reference's torch format (optimizer_nuscenes.py:
        1464-1477): codes and poses as tensors ({cam: codes} per annotation
        at code_level 2, flat per instance or annotation at 0 and 1), curves
        as float lists, R/T errors as lists of 0-d tensors."""
        def t(x):
            return torch.from_numpy(np.array(x, np.float32))

        def conv(entry):
            return {c: t(v) for c, v in entry.items()} if isinstance(entry, dict) else t(entry)

        saved = {
            "num_obj": len(self.psnr_eval),
            "optimized_shapecodes": {a: conv(v) for a, v in self.optimized_shapecodes.items()},
            "optimized_texturecodes": {a: conv(v) for a, v in self.optimized_texturecodes.items()},
            "optimized_poses": {a: conv(v) for a, v in self.optimized_poses.items()},
            "psnr_eval": {k: [float(x) for x in v] for k, v in self.psnr_eval.items()},
            "ssim_eval": dict(self.ssim_eval),
            "depth_err_mean": {k: [float(x) for x in v] for k, v in self.depth_err_mean.items()},
            "lidar_pts_cnt": dict(self.lidar_pts_cnt),
            "R_eval": {k: [torch.tensor(float(x)) for x in v] for k, v in self.R_eval.items()},
            "T_eval": {k: [torch.tensor(float(x)) for x in v] for k, v in self.T_eval.items()},
        }
        torch.save(saved, os.path.join(self.save_dir, name))

    # ------------------------------------------------------------- multiview
    def run_multiview(self, v_max: int = 4, opt_pose: bool = False, opt_model: bool = False,
                      slack_tex: bool | None = None):
        """Multiview TTO per instance (JAX driver run_multiview; reference
        optimize_objs_multi_anns[_w_pose]): the first v_max views of each
        instance share one shape and one texture code (tto/multiview.py),
        with per-view poses that opt_pose optimizes. slack_tex defaults to
        the reference's dispatch, not opt_pose (optimizer_nuscenes.py:135).
        The codes are stored flat per instance (code_level 0, as the
        reference forces for opt_multiview), the per-iteration PSNR under
        the instance, and codes_multiview.pkl is written."""
        if slack_tex is None:
            slack_tex = not opt_pose
        self.code_level = 0
        by_ins = {}
        for idx in range(len(self.dataset)):
            by_ins.setdefault(self.dataset[idx].get("instoken", str(idx)), []).append(idx)
        for ins, idx_list in by_ins.items():
            with self.timer.phase("host_prep"):
                _, _, batch = self._prep(idx_list[:v_max])
            views = MultiviewBatch.from_object_batch(batch)
            with self.timer.phase("multiview_tto"):
                res = run_multiview_tto(self.model, self.wts, views, self.mean_shape,
                                        self.mean_texture, self.cfg, opt_pose=opt_pose,
                                        opt_model=opt_model, slack_tex=slack_tex,
                                        generator=self.render_gen)
                res = {k: v.detach().cpu().numpy() for k, v in res.items()}
            self.optimized_shapecodes[ins] = res["shapecodes_saved"]
            self.optimized_texturecodes[ins] = res["texturecodes_saved"]
            self.psnr_eval[ins] = res["psnr"].tolist()
            self.loss_curve[ins] = res["loss"].tolist()
            print(f"  multiview {ins} ({len(views.img_in)} views): psnr "
                  f"{res['psnr'][0]:.2f} -> {res['psnr'][-1]:.2f}")
        self.save_results(name="codes_multiview.pkl")
        return self.results_dict()
