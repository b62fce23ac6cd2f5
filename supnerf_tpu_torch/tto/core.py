"""Batched test-time optimization (TTO); the port of supnerf_tpu/tto/core.py
(reference optimizer_nuscenes.py: optimize_objs_w_pose_unified :553,
fw_pose_update :451, set_optimizers_w_poses :1762, update_learning_rate
:1771).

For a batch of objects (axis 0): the encoder with per-object batch
statistics, the feed-forward pose refiner, then num_opts AdamW iterations on
(shape code, texture code, rotation, translation). Every iteration renders
the loss rays with the differentiable fused render (in the frustum shell, or
with use_aabb_render inside the box, as the demo does) and the lidar pixels
with its forward only. The optional regularisers (tto/regularizers.py)
evaluate the per-point field (ops.field.field_apply): obj_sz_reg on box-plane
samples, sym_loss_coef > 0 on the loss render's samples and their mirror
images, which then go through the per-point field and volume_render instead
of the fused render; sym_aug flips the loss render's samples laterally at
random. Loop semantics kept from the reference:
  - iterations 0..reg_iters render the refiner's poses and make no update;
  - AdamW per parameter group (shape, texture, pose) with decoupled weight
    decay scaled by the learning rate; every lr_half_interval iterations the
    moments reset and the updates halve;
  - metrics are taken every iteration before the update, with the pose that
    produced the render; the saved final pose is the last rendered pose.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

from supnerf_tpu_torch.geometry.boxes import invert_pose
from supnerf_tpu_torch.geometry.poses import calc_pose_err
from supnerf_tpu_torch.geometry.rotations import axis_angle_to_matrix, matrix_to_axis_angle
from supnerf_tpu_torch.optim import AdamW
from supnerf_tpu_torch.ops.field import field_apply
from supnerf_tpu_torch.ops.render import field_composite, field_composite_aabb
from supnerf_tpu_torch.ops.volume_render import masked_psnr, occupancy_loss, rgb_loss_masked
from supnerf_tpu_torch.render.renderer import (
    render_rays_aabb,
    render_rays_at_pixels,
    render_rays_frustum,
)
from supnerf_tpu_torch.tto.refiner import fw_pose_refine
from supnerf_tpu_torch.tto.regularizers import SAMPLES_PER_PLANE, obj_sz_loss, sym_loss

# snapshot iterations of the saved codes and poses (reference CODE_SAVE_ITERS_,
# optimizer_nuscenes.py:24); the last equals num_opts and is taken after the loop
CODE_SAVE_ITERS = (0, 5, 10, 20, 50, 100)

@dataclasses.dataclass(frozen=True)
class TTOConfig:
    num_opts: int = 100
    reg_iters: int = 3
    n_samples: int = 64
    render_im_sz: int = 32
    in_img_sz: int = 128
    n_lidar: int = 256
    lr_shape: float = 0.02
    lr_texture: float = 0.02
    lr_pose: float = 0.01
    lr_half_interval: int = 1000
    weight_decay: float = 0.01
    loss_occ_coef: float = 0.1
    shapenet_obj_cood: bool = True
    field_impl: str = "auto"     # "auto" | "cuda" | "plain" (ops.render.field_composite)
    pred_wlh_mode: int = 0       # 0: annotated wlh; 1: the encoder's wlh (refiner, obj_diag, box)
    use_aabb_render: bool = False   # loss render inside the box (reference render_rays_v3)
    sym_aug: bool = False        # random lateral flip of the loss render's samples
    obj_sz_reg: bool = False     # box-limit density regulariser (reference :1412)
    loss_obj_sz_coef: float = 1.0
    sym_loss_coef: float = 0.0   # > 0: the density-symmetry loss (reference :1435)
    kitti2nusc: bool = False     # KITTI/Waymo: field queries rotated into the nuScenes frame
    box_fac: float = 1.0         # refiner corner scale (KITTI/Waymo BOX_FAC 1.1)


@dataclasses.dataclass
class ObjectBatch:
    """Fixed-shape per-object inputs, batched along axis 0 (host-prepared by
    data.synthetic.prepare_object_inputs and stacked)."""

    img_in: torch.Tensor       # (B, in_img_sz, in_img_sz, 3)
    rgb_tgt: torch.Tensor      # (B, R, 3)
    occ_tgt: torch.Tensor      # (B, R, 1) in {-1, 0, 1}
    K: torch.Tensor            # (B, 3, 3)
    K_inv: torch.Tensor        # (B, 3, 3)
    roi_nerf: torch.Tensor     # (B, 4) square-padded ROI of the render
    roi_refine: torch.Tensor   # (B, 4) ROI of the refiner's normalisation
    pose_init: torch.Tensor    # (B, 3, 4)
    wlh: torch.Tensor          # (B, 3)
    obj_pose_gt: torch.Tensor  # (B, 3, 4)
    lidar_u: torch.Tensor      # (B, L) full-image pixels of the lidar hits
    lidar_v: torch.Tensor      # (B, L)
    lidar_depth: torch.Tensor  # (B, L)
    lidar_valid: torch.Tensor  # (B, L) 1 for real entries, 0 for padding

    @classmethod
    def from_numpy(cls, arrays: dict, device):
        return cls(**{f.name: torch.tensor(arrays[f.name], dtype=torch.float32, device=device)
                      for f in dataclasses.fields(cls)})


def pose_param_fns(cfg: TTOConfig):
    """(params_from_obj_pose, obj_pose_from_params): the object pose as an
    axis-angle rotation vector and a translation (reference
    optimizer_nuscenes.py:339-366 with euler_rot 0 and opt_cam_pose 0, the
    published setting; the other parameterisations are queued in ROADMAP.md)."""

    def params_from_obj_pose(pose_obj):
        return matrix_to_axis_angle(pose_obj[..., :3]), pose_obj[..., 3]

    def obj_pose_from_params(rot_vec, trans_vec):
        return torch.cat([axis_angle_to_matrix(rot_vec), trans_vec[..., None]], -1)

    return params_from_obj_pose, obj_pose_from_params


def effective_wlh(wlh_gt, wlh_pred, mode: int):
    """The box size TTO works with (reference optimizer_nuscenes.py:602-615):
    mode 0 the annotation, mode 1 the encoder's prediction. Mode 2 (the
    prediction's volume at the dataset's mean w and h) is queued in
    ROADMAP.md §A.7."""
    if mode == 0:
        return wlh_gt
    if mode == 1:
        return wlh_pred
    raise NotImplementedError(f"pred_wlh {mode} is queued in ROADMAP.md §A.7; this slice "
                              "runs pred_wlh 0 and 1")


def make_composite(wts, shapecode, texturecode, impl: str):
    """The renderers' composite_fn over the fused render for these codes."""
    return lambda xyz, vd, z: field_composite(wts, xyz, vd, z, shapecode, texturecode,
                                              impl=impl)


def make_composite_aabb(wts, shapecode, texturecode):
    """render_rays_aabb's composite_fn over the fused AABB render."""
    return lambda xyz, vd, z, hit: field_composite_aabb(wts, xyz, vd, z, hit, shapecode,
                                                        texturecode)


def tto_loss(wts, shapecode, texturecode, pose_obj, batch: ObjectBatch, obj_diag,
             cfg: TTOConfig, jitter=None, generator=None, wlh=None, sym_flip=None,
             obj_sz_draws=None):
    """Per-object loss of one iteration's loss render and its PSNR:
    rgb_loss_masked + loss_occ_coef * occupancy_loss (reference :729-744),
    plus loss_obj_sz_coef * obj_sz_loss with obj_sz_reg and sym_loss_coef *
    sym_loss when that is > 0 (reference :1412, :1435). jitter: (B, S) draws
    for the frustum render, (B, R, S) for the AABB render, whose box is wlh
    (B, 3) (the effective wlh; the object-size loss's box too). sym_flip (B,)
    bool: the lateral flips of the loss render with sym_aug; obj_sz_draws
    (B, 3, SAMPLES_PER_PLANE): the uniform draws of the object-size loss's
    samples. Draws left None come from `generator`. Returns (loss (B,),
    psnr (B,), hit_share): the loss and psnr differentiable in codes and
    pose_obj; hit_share (B,) the share of the AABB render's rays that hit the
    box, None for the frustum render."""
    B, dev = pose_obj.shape[0], pose_obj.device
    if not cfg.sym_aug:
        sym_flip = None
    elif sym_flip is None:
        sym_flip = torch.rand(B, generator=generator, device=dev) < 0.5

    def field_fn(xyz, vd):
        return field_apply(wts, xyz, vd, shapecode, texturecode)

    hit_share = None
    need_samples = cfg.sym_loss_coef > 0
    if cfg.use_aabb_render:
        out = render_rays_aabb(
            make_composite_aabb(wts, shapecode, texturecode), invert_pose(pose_obj), batch.K,
            batch.roi_nerf, wlh, n_samples=cfg.n_samples, im_sz=cfg.render_im_sz,
            shapenet_obj_cood=cfg.shapenet_obj_cood, kitti2nusc=cfg.kitti2nusc,
            sym_flip=sym_flip, jitter=jitter, generator=generator)
        hit_share = out["hit"].float().mean(1)
    else:
        out = render_rays_frustum(
            make_composite(wts, shapecode, texturecode, cfg.field_impl), invert_pose(pose_obj),
            batch.K, batch.roi_nerf, obj_diag, n_samples=cfg.n_samples,
            im_sz=cfg.render_im_sz, shapenet_obj_cood=cfg.shapenet_obj_cood,
            kitti2nusc=cfg.kitti2nusc, sym_flip=sym_flip,
            field_fn=field_fn if need_samples else None, jitter=jitter, generator=generator)
    loss = (rgb_loss_masked(out["rgb"], batch.rgb_tgt, batch.occ_tgt, dim=(1, 2))
            + cfg.loss_occ_coef * occupancy_loss(out["acc_trans"], batch.occ_tgt, dim=(1, 2)))
    if cfg.obj_sz_reg:
        if obj_sz_draws is None:
            obj_sz_draws = torch.rand((B, 3, SAMPLES_PER_PLANE), generator=generator,
                                      device=dev)
        loss = loss + cfg.loss_obj_sz_coef * obj_sz_loss(field_fn, obj_sz_draws, wlh, obj_diag,
                                                         cfg.shapenet_obj_cood)
    if need_samples:
        loss = loss + cfg.sym_loss_coef * sym_loss(field_fn, out["xyz"], out["viewdir"],
                                                   out["sigmas"], cfg.shapenet_obj_cood)
    psnr = masked_psnr(out["rgb"], batch.rgb_tgt, batch.occ_tgt, dim=(1, 2))
    return loss, psnr, hit_share


@torch.no_grad()
def depth_error(wts, shapecode, texturecode, pose_obj, batch: ObjectBatch, obj_diag,
                cfg: TTOConfig, jitter=None, generator=None):
    """Mean absolute lidar-depth error per object (reference log_eval_depth_v2
    :1736), from a forward-only render of the lidar pixels."""
    out = render_rays_at_pixels(
        make_composite(wts, shapecode, texturecode, cfg.field_impl), invert_pose(pose_obj),
        batch.K, batch.lidar_u, batch.lidar_v, obj_diag, n_samples=cfg.n_samples,
        shapenet_obj_cood=cfg.shapenet_obj_cood, kitti2nusc=cfg.kitti2nusc, jitter=jitter,
        generator=generator)
    err = torch.abs(out["depth"] - batch.lidar_depth) * batch.lidar_valid
    return err.sum(1) / (batch.lidar_valid.sum(1) + 1e-8)


@torch.no_grad()
def encode_and_refine(model, batch: ObjectBatch, mean_shape, mean_texture, cfg: TTOConfig):
    """Encoder (one object per BatchNorm batch, as the reference encodes one
    image at a time) and the feed-forward refiner on the effective box size
    (effective_wlh; the annotation for a model without a wlh head). Returns
    (shapecode0, texturecode0, pose_traj (B, reg_iters + 1, 3, 4),
    uv_direct, wlh_pred, wlh_used)."""
    enc = [model.encode_img(batch.img_in[b:b + 1]) for b in range(len(batch.img_in))]
    sc, tc, pc, uv = (torch.cat([e[i] for e in enc]) for i in range(4))
    if model.pred_wlh:
        wlh_pred = torch.cat([e[4] for e in enc])
        wlh_use = effective_wlh(batch.wlh, wlh_pred, cfg.pred_wlh_mode)
    else:
        wlh_pred, wlh_use = torch.zeros_like(batch.wlh), batch.wlh
    traj = fw_pose_refine(model.pose_update, pc, batch.pose_init, wlh_use, batch.roi_refine,
                          batch.K, batch.K_inv, iters=cfg.reg_iters, box_fac=cfg.box_fac)
    return ((sc + mean_shape) / 2, (tc + mean_texture) / 2, traj, uv, wlh_pred, wlh_use)


def run_tto_batch(model, wts, batch: ObjectBatch, mean_shape, mean_texture, cfg: TTOConfig,
                  generator=None, jitter=None, sym_flips=None, obj_sz_draws=None, timer=None):
    """The full TTO pipeline for a batch of objects.

    wts: ops.render.pack_decoder_params(model). jitter: optional pair
    (loss_jitter, depth_jitter) of uniform draws for the stratified sampling
    of each iteration's two renders, (num_opts, B, S) each, the loss
    render's (num_opts, B, R, S) with use_aabb_render. sym_flips (num_opts,
    B) bool and obj_sz_draws (num_opts, B, 3, SAMPLES_PER_PLANE): the
    regularisers' draws (tto_loss). Draws not given come from `generator`.
    timer: optional timing.PhaseTimer.
    Returns a dict of per-object results (leading dim B): codes and poses at
    CODE_SAVE_ITERS, the final codes and pose, and the per-iteration psnr,
    rot_err, trans_err, depth_err and loss curves (B, num_opts), and with
    use_aabb_render the hit_share curve (B, num_opts): the share of the loss
    render's rays that hit the box."""
    if cfg.use_aabb_render and cfg.sym_loss_coef > 0:
        raise ValueError("sym_loss requires the frustum renderer (sample reuse)")
    phase = timer.phase if timer is not None else (lambda name: contextlib.nullcontext())
    with phase("encode_refine"):
        sc0, tc0, traj, uv_direct, wlh_pred, wlh_use = encode_and_refine(
            model, batch, mean_shape, mean_texture, cfg)
    obj_diag = torch.linalg.norm(wlh_use, dim=-1)
    params_from_obj_pose, obj_pose_from_params = pose_param_fns(cfg)
    rot0, trans0 = params_from_obj_pose(traj[:, -1])
    params = [t.clone().requires_grad_(True) for t in (sc0, tc0, rot0, trans0)]
    sc, tc, rot, trans = params
    opt = AdamW(params, (cfg.lr_shape, cfg.lr_texture, cfg.lr_pose, cfg.lr_pose),
                cfg.weight_decay)

    curves = {k: [] for k in ("psnr", "rot_err", "trans_err", "depth_err", "loss")
              + (("hit_share",) if cfg.use_aabb_render else ())}
    snaps = {"shapecode": {}, "texturecode": {}, "pose": {}}
    pose_obj = traj[:, 0]
    with phase("tto_loop"):
        for t in range(cfg.num_opts):
            replay = t <= cfg.reg_iters
            j_loss = None if jitter is None else jitter[0][t]
            j_depth = None if jitter is None else jitter[1][t]
            reg = {"sym_flip": None if sym_flips is None else sym_flips[t],
                   "obj_sz_draws": None if obj_sz_draws is None else obj_sz_draws[t]}
            if replay:
                pose_obj = traj[:, t]
                with torch.no_grad():
                    loss, psnr, hit_share = tto_loss(wts, sc, tc, pose_obj, batch, obj_diag,
                                                     cfg, j_loss, generator, wlh_use, **reg)
            else:
                pose_obj = obj_pose_from_params(rot, trans)
                loss, psnr, hit_share = tto_loss(wts, sc, tc, pose_obj, batch, obj_diag, cfg,
                                                 j_loss, generator, wlh_use, **reg)
                grads = torch.autograd.grad(loss.sum(), params)
                pose_obj = pose_obj.detach()
            err_R, err_T = calc_pose_err(pose_obj, batch.obj_pose_gt)
            d_err = depth_error(wts, sc, tc, pose_obj, batch, obj_diag, cfg, j_depth, generator)
            for k, v in (("psnr", psnr), ("rot_err", err_R), ("trans_err", err_T),
                         ("depth_err", d_err), ("loss", loss), ("hit_share", hit_share)):
                if k in curves:
                    curves[k].append(v.detach())
            if t in CODE_SAVE_ITERS:
                snaps["shapecode"][t] = sc.detach().clone()
                snaps["texturecode"][t] = tc.detach().clone()
                snaps["pose"][t] = pose_obj.clone()
            if not replay:
                # the reference re-creates the optimizer (fresh moments) when
                # the iteration count reaches each lr-half boundary, before
                # that iteration's step (optimizer_nuscenes.py:780-783)
                if t > 0 and t % cfg.lr_half_interval == 0:
                    opt.reset()
                opt.step(grads, 2.0 ** -(t // cfg.lr_half_interval))

    final = {"shapecode": sc.detach(), "texturecode": tc.detach(), "pose": pose_obj}
    saved = {k: torch.stack([snaps[k][i] if i < cfg.num_opts else final[k]
                             for i in CODE_SAVE_ITERS], 1) for k in snaps}
    return {
        "shapecodes_saved": saved["shapecode"],      # (B, n_code, latent)
        "texturecodes_saved": saved["texturecode"],
        "poses_saved": saved["pose"],                # (B, n_code, 3, 4)
        "final_pose": pose_obj,
        "final_shapecode": final["shapecode"],
        "final_texturecode": final["texturecode"],
        **{k: torch.stack(v, 1) for k, v in curves.items()},
        "pose_traj": traj,
        "uv_direct": uv_direct,
        "wlh_pred": wlh_pred,
        "wlh_used": wlh_use,
    }

