"""Test-time optimization over a dataset in object batches; the port of
supnerf_tpu/tto/driver.py's TTODriver (reference optimizer_nuscenes.py
OptimizerNuScenes :35): initial poses, batching, bookkeeping keyed by
annotation and camera, snapshots at CODE_SAVE_ITERS, the codes+poses result
files, and the cross-view evaluation (eval_cross_view :1279).

It covers opt_pose 1 (codes and object pose, axis-angle), the annotated or
the predicted box size (pred_wlh 0 and 1), the frustum or the AABB loss
render, the regularisers sym_aug and obj_sz_reg (hpams keys, as in the JAX
driver), add_pose_err 0 (ground truth), 1 (a yaw and a depth-ratio error of
init_rot_err / init_trans_err), 2 (random) and 3 (the reader's pose from a
third-party detection), codes stored per (annotation, camera) (code_level
2), no visualisation, in the nuScenes object frame or the KITTI one
(dataset_frame "kitti" / "waymo", reference optimizer_kitti.py:24,638-639):
there the initial and ground-truth poses move to the nuScenes frame in the
prep, the refiner sees the box corners scaled by KITTI_BOX_FAC unless the
predicted wlh is used, and the field's samples rotate into the nuScenes
frame. The other options raise NotImplementedError and are queued in
ROADMAP.md (PnP bootstrapping, opt_pose 2, needs a solver without OpenCV).
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from supnerf_tpu_torch.data.synthetic import prepare_object_inputs
from supnerf_tpu_torch.device import resolve_device
from supnerf_tpu_torch.geometry import poses as pose_gen
from supnerf_tpu_torch.geometry.boxes import invert_pose, obj_pose_kitti2nusc
from supnerf_tpu_torch.ops.render import field_composite, pack_decoder_params
from supnerf_tpu_torch.ops.volume_render import masked_psnr
from supnerf_tpu_torch.render.renderer import render_rays_at_pixels, render_rays_frustum
from supnerf_tpu_torch.timing import PhaseTimer
from supnerf_tpu_torch.tto.core import CODE_SAVE_ITERS, ObjectBatch, TTOConfig, run_tto_batch

# cells of the cross-view evaluation rendered per kernel call
_CROSS_VIEW_CHUNK = 64
# the refiner's corner scale in the KITTI and Waymo protocols
KITTI_BOX_FAC = 1.1


def is_kitti_frame(dataset_frame: str) -> bool:
    if dataset_frame not in ("nusc", "kitti", "waymo"):
        raise ValueError(f"dataset_frame {dataset_frame!r}: nusc, kitti or waymo")
    return dataset_frame != "nusc"


def tto_config_from_hpams(hpams: dict, *, reg_iters: int = 3, n_lidar: int = 256,
                          pred_wlh: int = 0, dataset_frame: str = "nusc") -> TTOConfig:
    opt = hpams.get("optimize", {})
    for key, value in (("euler_rot", hpams.get("euler_rot", 0)),
                       ("optimize.opt_cam_pose", opt.get("opt_cam_pose", 0))):
        if value:
            raise NotImplementedError(f"{key} {value} is queued in ROADMAP.md; this slice "
                                      "optimizes the object pose as an axis-angle vector")
    if pred_wlh not in (0, 1):
        raise NotImplementedError(f"pred_wlh {pred_wlh} is queued in ROADMAP.md §A.7; this "
                                  "slice runs pred_wlh 0 and 1")
    return TTOConfig(
        num_opts=opt.get("num_opts", 100), reg_iters=reg_iters,
        n_samples=hpams.get("n_samples", 64), render_im_sz=hpams.get("render_im_sz", 32),
        in_img_sz=hpams.get("in_img_sz", 128), n_lidar=n_lidar,
        lr_shape=opt.get("lr_shape", 0.02), lr_texture=opt.get("lr_texture", 0.02),
        lr_pose=opt.get("lr_pose", 0.01), lr_half_interval=opt.get("lr_half_interval", 1000),
        loss_occ_coef=hpams.get("loss_occ_coef", 0.1),
        shapenet_obj_cood=bool(hpams.get("shapenet_obj_cood", 1)), pred_wlh_mode=pred_wlh,
        sym_aug=bool(hpams.get("sym_aug", 0)), obj_sz_reg=bool(hpams.get("obj_sz_reg", 0)),
        loss_obj_sz_coef=float(hpams.get("loss_obj_sz_coef", 1.0)),
        kitti2nusc=is_kitti_frame(dataset_frame),
        box_fac=KITTI_BOX_FAC if is_kitti_frame(dataset_frame) and not pred_wlh else 1.0,
    )


class TTODriver:
    """Batched TTO over `dataset` (indexable, returning the sample dicts of
    data.synthetic, with 'instoken', 'anntoken' and 'cam_ids' for the
    bookkeeping). model: a SUPNeRF on `device` with its weights loaded.
    cfg: a TTOConfig that replaces the one read from hpams (the demo's AABB
    loss render). init_rot_err / init_trans_err (add_pose_err 1): None
    falls back to the config's keys, then to 0.0 / 0.2."""

    def __init__(self, model, mean_shape, mean_texture, hpams: dict, dataset, save_dir: str,
                 *, device, cfg: TTOConfig | None = None, opt_pose: int = 1,
                 reg_iters: int = 3, dataset_frame: str = "nusc", pred_wlh: int = 0,
                 add_pose_err: int = 2, batch_size: int = 16, save_freq: int = 100,
                 seed: int = 0, init_rot_err: float | None = None,
                 init_trans_err: float | None = None, rand_angle_lim: float = 0.0):
        if opt_pose != 1:
            raise NotImplementedError(
                f"opt_pose {opt_pose} is queued in ROADMAP.md (opt_pose 2, the PnP bootstrap, "
                "needs a PnP solver without OpenCV); this slice runs opt_pose 1")
        if add_pose_err not in (0, 1, 2, 3):
            raise ValueError(f"add_pose_err {add_pose_err}: 0, 1, 2 or 3")
        self.device = resolve_device(str(device))
        self.model = model.to(self.device)
        self.wts = pack_decoder_params(self.model)
        self.mean_shape = torch.as_tensor(mean_shape, dtype=torch.float32, device=self.device)
        self.mean_texture = torch.as_tensor(mean_texture, dtype=torch.float32,
                                            device=self.device)
        self.hpams, self.dataset, self.save_dir = hpams, dataset, save_dir
        self.add_pose_err = add_pose_err
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
            hpams, reg_iters=reg_iters, pred_wlh=pred_wlh, dataset_frame=dataset_frame)
        os.makedirs(save_dir, exist_ok=True)
        self.optimized_shapecodes, self.optimized_texturecodes = {}, {}
        self.optimized_poses = {}
        self.psnr_eval, self.ssim_eval, self.R_eval, self.T_eval = {}, {}, {}, {}
        self.depth_err_mean, self.lidar_pts_cnt, self.ood_flags = {}, {}, {}
        self.wlh_used = {}      # the box size each object was optimized with
        self.hit_share = {}     # AABB loss render: per iteration, the share of rays in the box
        self.loss_curve = {}    # per iteration, the loss the update descended

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
        samples = [self.dataset[i] for i in idxs]
        if poses is None:
            poses = self._initial_poses(samples)
        prepped = [self.prep_sample(s, p) for s, p in zip(samples, poses)]
        stacked = {k: np.stack([p[k] for p in prepped]) for k in prepped[0]}
        return samples, prepped, ObjectBatch.from_numpy(stacked, self.device)

    # ------------------------------------------------------------------- run
    def run(self):
        """Optimize the whole dataset batch by batch; writes codes+poses.pkl
        (and its .pth twin) and returns results_dict()."""
        n = len(self.dataset)
        for bi, start in enumerate(range(0, n, self.batch_size)):
            idxs = list(range(start, min(start + self.batch_size, n)))
            print(f"num obj: {start}/{n}")
            with self.timer.phase("host_prep"):
                samples, prepped, batch = self._prep(idxs)
            res = run_tto_batch(self.model, self.wts, batch, self.mean_shape,
                                self.mean_texture, self.cfg, generator=self.render_gen,
                                timer=self.timer)
            with self.timer.phase("bookkeeping"):
                self._bookkeep(idxs, samples, prepped, res)
            if bi % max(self.save_freq // self.batch_size, 1) == 0:
                self.save_results()
        self.save_results()
        self.save_results_pth()
        return self.results_dict()

    def _bookkeep(self, idxs, samples, prepped, res):
        res = {k: v.detach().cpu().numpy() for k, v in res.items()}
        # out-of-distribution check on the refined pose (reference
        # optimizer_nuscenes.py:656-660): its up axis more than 45 degrees
        # from the camera's up [0, -1, 0]
        refined = res["pose_traj"][:, -1]
        ood = np.abs(np.arccos(np.clip(-refined[:, 1, 2], -1.0, 1.0))) > np.pi / 4
        for i, (sample, idx) in enumerate(zip(samples, idxs)):
            ann = sample.get("anntoken", f"obj{idx}")
            cam = sample.get("cam_ids", "CAM")
            log_idx = f"{ann}_{cam}"
            self.optimized_shapecodes.setdefault(ann, {})[cam] = res["shapecodes_saved"][i].copy()
            self.optimized_texturecodes.setdefault(ann, {})[cam] = (
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

    # ------------------------------------------------- cross-view evaluation
    @torch.no_grad()
    def eval_cross_view(self):
        """Render each instance's saved codes into every view of the same
        instance and score PSNR and lidar-depth error (reference
        eval_cross_view :1279-1410). All cells (code snapshot x source view x
        target view) of an instance render as one object batch, with one
        fixed jitter vector. Saves and returns the cross_eval dict."""
        cfg = self.cfg
        jitter = torch.rand(cfg.n_samples, generator=torch.Generator().manual_seed(0))
        by_ins = {}
        for idx in range(len(self.dataset)):
            s = self.dataset[idx]
            ann, cam = s.get("anntoken", f"obj{idx}"), s.get("cam_ids", "CAM")
            if cam in self.optimized_shapecodes.get(ann, {}):
                by_ins.setdefault(s.get("instoken", str(idx)), []).append((idx, ann, cam))
        psnr_mats, depth_mats = {}, {}
        with self.timer.phase("cross_view"):
            for ins, views in by_ins.items():
                n_v, n_code = len(views), len(CODE_SAVE_ITERS)
                gts = [np.asarray(self.dataset[i]["obj_poses"], np.float32) for i, _, _ in views]
                _, _, tgt = self._prep([i for i, _, _ in views], poses=gts)
                sc = torch.as_tensor(np.stack([self.optimized_shapecodes[a][c] for _, a, c in views],
                                              1), device=self.device)   # (n_code, n_v, latent)
                tc = torch.as_tensor(np.stack([self.optimized_texturecodes[a][c]
                                               for _, a, c in views], 1), device=self.device)
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

        def comp(xyz, vd, z):
            return field_composite(self.wts, xyz, vd, z, sc, tc, impl=cfg.field_impl)

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
            "code_level": 2,     # codes stored per (annotation, camera)
        }

    def save_results(self, name: str = "codes+poses.pkl"):
        with open(os.path.join(self.save_dir, name), "wb") as f:
            pickle.dump(self.results_dict(), f)

    def save_results_pth(self, name: str = "codes+poses.pth"):
        """The results in the reference's torch format (optimizer_nuscenes.py:
        1464-1477): codes and poses as tensors, curves as float lists, R/T
        errors as lists of 0-d tensors."""
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
