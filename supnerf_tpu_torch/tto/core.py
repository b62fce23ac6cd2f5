"""Batched test-time optimization (TTO); the port of supnerf_tpu/tto/core.py
(reference optimizer_nuscenes.py: optimize_objs_w_pose_unified :553,
fw_pose_update :451, set_optimizers_w_poses :1762, update_learning_rate
:1771).

For a batch of objects (axis 0): the encoder with per-object batch
statistics, the feed-forward pose refiner, then num_opts AdamW iterations on
(shape code, texture code, rotation, translation), or on the codes alone
with opt_pose False. The pose is an axis-angle or (euler_rot) an XYZ Euler
rotation and a translation, of the object pose or (opt_cam_pose) of the
camera pose (pose_param_fns); the box size is the annotation's, the
encoder's prediction, or that prediction's volume at the nuScenes mean
width and height (pred_wlh 0, 1, 2: effective_wlh). Every iteration renders
the loss rays with the differentiable fused render (in the frustum shell, or
with use_aabb_render inside the box, as the demo does) and the lidar pixels
with its forward only. The baselines (JAX core.py:231-295): AutoRF and
AutoRFMix encode two codes and have no refiner, CodeNeRF starts from the
mean codes; without a refiner the trajectory replays pose_init. The renders
run on the kernels for a kernel-compatible decoder
(ops.render.decoder_kernel_compatible); the original AutoRF's decoder runs
as the plain decoder under autograd (render_decoder). The optional
regularisers (tto/regularizers.py) evaluate the per-point field
(ops.field.field_apply; the plain decoder's ops.render.decoder_field for
the original AutoRF): obj_sz_reg on box-plane samples, sym_loss_coef > 0 on
the loss render's samples and their mirror images, which then go through
the per-point field and volume_render instead of the fused render; sym_aug
flips the loss render's samples laterally at random. Loop semantics kept from the reference:
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

import numpy as np
import torch

from supnerf_tpu_torch.data.common import NUSC_CAR_WLH_MEAN
from supnerf_tpu_torch.geometry.boxes import invert_pose
from supnerf_tpu_torch.geometry.poses import calc_pose_err
from supnerf_tpu_torch.geometry.rotations import (
    axis_angle_to_matrix,
    euler_angles_to_matrix,
    matrix_to_axis_angle,
    matrix_to_euler_angles,
)
from supnerf_tpu_torch.optim import AdamW
from supnerf_tpu_torch.ops.field import field_apply
from supnerf_tpu_torch.ops.render import (
    DecoderWeights,
    decoder_composite,
    decoder_field,
    decoder_kernel_compatible,
    field_composite,
    field_composite_aabb,
    pack_decoder_params,
)
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
    opt_pose: bool = True        # False: the codes alone; the pose stays the refined one
    euler_rot: bool = False      # the rotation as intrinsic XYZ Euler angles (not axis-angle)
    opt_cam_pose: bool = False   # the parameters hold the camera pose (cam2obj)
    pred_wlh_mode: int = 0       # 0: annotated wlh; 1: the encoder's; 2: its volume at mean w, h
    use_aabb_render: bool = False   # loss render inside the box (reference render_rays_v3)
    sym_aug: bool = False        # random lateral flip of the loss render's samples
    obj_sz_reg: bool = False     # box-limit density regulariser (reference :1412)
    loss_obj_sz_coef: float = 1.0
    sym_loss_coef: float = 0.0   # > 0: the density-symmetry loss (reference :1435)
    kitti2nusc: bool = False     # KITTI/Waymo: field queries rotated into the nuScenes frame
    box_fac: float = 1.0         # refiner corner scale (KITTI/Waymo BOX_FAC 1.1)
    emit_code_curves: bool = False  # also return every iteration's codes and pose (vis 2)


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
        """The batch on `device`; to a CUDA device the copies go from pinned
        memory, and the host does not wait for them (the pipelined TTO
        driver uploads a batch while the card runs the one before)."""
        if torch.device(device).type != "cuda":
            return cls(**{f.name: torch.tensor(arrays[f.name], dtype=torch.float32, device=device)
                          for f in dataclasses.fields(cls)})
        return cls(**{f.name: torch.from_numpy(np.asarray(arrays[f.name], np.float32))
                      .pin_memory().to(device, non_blocking=True)
                      for f in dataclasses.fields(cls)})


def pose_param_fns(cfg: TTOConfig):
    """(params_from_obj_pose, obj_pose_from_params) of the configured pose
    parameterisation (JAX tto/core.py pose_param_fns; reference
    optimizer_nuscenes.py:339-366): an axis-angle or (euler_rot) an
    intrinsic XYZ Euler rotation vector and a translation, of the object
    pose or (opt_cam_pose) of its inverse, the camera pose; invert_pose is
    an involution, so that branch maps through it on both sides."""
    if cfg.euler_rot:
        def rot_to_vec(R):
            return matrix_to_euler_angles(R, "XYZ")

        def vec_to_rot(v):
            return euler_angles_to_matrix(v, "XYZ")
    else:
        rot_to_vec, vec_to_rot = matrix_to_axis_angle, axis_angle_to_matrix

    def params_from_obj_pose(pose_obj):
        p = invert_pose(pose_obj) if cfg.opt_cam_pose else pose_obj
        return rot_to_vec(p[..., :3]), p[..., 3]

    def obj_pose_from_params(rot_vec, trans_vec):
        pose = torch.cat([vec_to_rot(rot_vec), trans_vec[..., None]], -1)
        return invert_pose(pose) if cfg.opt_cam_pose else pose

    return params_from_obj_pose, obj_pose_from_params


def effective_wlh(wlh_gt, wlh_pred, mode: int):
    """The box size TTO works with (reference optimizer_nuscenes.py:602-615):
    mode 0 the annotation, mode 1 the encoder's prediction, mode 2 the
    prediction's volume with w and h at the nuScenes car means
    (data.common.NUSC_CAR_WLH_MEAN) and l making up the volume. The order
    is [w, l, h], and the volume divides by the means' w * h, as in JAX."""
    if mode == 0:
        return wlh_gt
    if mode == 1:
        return wlh_pred
    if mode != 2:
        raise ValueError(f"pred_wlh {mode}: 0, 1 or 2")
    w = torch.full_like(wlh_pred[..., 0], float(NUSC_CAR_WLH_MEAN[0]))
    h = torch.full_like(wlh_pred[..., 2], float(NUSC_CAR_WLH_MEAN[2]))
    l = wlh_pred[..., 0] * wlh_pred[..., 1] * wlh_pred[..., 2] / (w * h)
    return torch.stack([w, l, h], -1)


def render_decoder(model):
    """What the renders run (the `wts` of run_tto_batch and tto_loss): the
    kernel operands (ops.render.pack_decoder_params) of a kernel-compatible
    decoder, else the model itself, whose decoder then runs as the plain
    decoder under autograd (the original AutoRF). The decoder's structure
    decides (ops.render.decoder_kernel_compatible), never a failed build or
    launch."""
    return pack_decoder_params(model) if decoder_kernel_compatible(model) else model


def make_composite(wts, shapecode, texturecode):
    """The renderers' composite_fn for these codes: the fused render
    (field_composite: the kernels for CUDA tensors) on kernel operands,
    ops.render.decoder_composite on a model (render_decoder)."""
    if isinstance(wts, DecoderWeights):
        return lambda xyz, vd, z: field_composite(wts, xyz, vd, z, shapecode, texturecode)
    return lambda xyz, vd, z: decoder_composite(wts, xyz, vd, z, shapecode, texturecode)


def make_composite_aabb(wts, shapecode, texturecode):
    """render_rays_aabb's composite_fn: the fused AABB render on kernel
    operands, decoder_composite with the hit mask on a model."""
    if isinstance(wts, DecoderWeights):
        return lambda xyz, vd, z, hit: field_composite_aabb(wts, xyz, vd, z, hit, shapecode,
                                                            texturecode)
    return lambda xyz, vd, z, hit: decoder_composite(wts, xyz, vd, z, shapecode, texturecode,
                                                     hit=hit)


def make_field(wts, shapecode, texturecode):
    """The regularisers' per-point field_fn: ops.field.field_apply on kernel
    operands, ops.render.decoder_field on a model."""
    field = field_apply if isinstance(wts, DecoderWeights) else decoder_field
    return lambda xyz, vd: field(wts, xyz, vd, shapecode, texturecode)


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
    field_fn = make_field(wts, shapecode, texturecode)

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
            make_composite(wts, shapecode, texturecode), invert_pose(pose_obj), batch.K,
            batch.roi_nerf, obj_diag, n_samples=cfg.n_samples,
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


def iteration_draws(cfg: TTOConfig, B: int, generator, device) -> dict:
    """One TTO iteration's uniform draws for B objects, taken from
    `generator` in the order the iteration uses them: the sym_aug flips
    (B,) (None without sym_aug), the loss render's jitter (B, S) or, with
    use_aabb_render, (B, R, S), the object-size draws (B, 3,
    SAMPLES_PER_PLANE) (None without obj_sz_reg), the lidar render's jitter
    (B, S). The one definition of that order: run_tto_batch draws each
    iteration's here, and tto_draws stacks them for a whole run."""
    R, S = cfg.render_im_sz ** 2, cfg.n_samples
    draws = {"sym_flip": (torch.rand(B, generator=generator, device=device) < 0.5
                          if cfg.sym_aug else None)}
    draws["loss_jitter"] = torch.rand((B, R, S) if cfg.use_aabb_render else (B, S),
                                      generator=generator, device=device)
    draws["obj_sz_draws"] = (torch.rand((B, 3, SAMPLES_PER_PLANE), generator=generator,
                                        device=device) if cfg.obj_sz_reg else None)
    draws["depth_jitter"] = torch.rand((B, S), generator=generator, device=device)
    return draws


def tto_draws(cfg: TTOConfig, B: int, generator, device) -> dict:
    """A whole run's draws for B objects (iteration_draws for each of
    num_opts iterations), as run_tto_batch's keyword arguments jitter,
    sym_flips and obj_sz_draws: a run given them is the run that draws them
    itself from the same generator state. The driver takes them for a whole
    batch and hands each rank its objects' rows."""
    its = [iteration_draws(cfg, B, generator, device) for _ in range(cfg.num_opts)]

    def stack(key):
        return None if its[0][key] is None else torch.stack([d[key] for d in its])

    return {"jitter": (stack("loss_jitter"), stack("depth_jitter")),
            "sym_flips": stack("sym_flip"), "obj_sz_draws": stack("obj_sz_draws")}


@torch.no_grad()
def depth_error(wts, shapecode, texturecode, pose_obj, batch: ObjectBatch, obj_diag,
                cfg: TTOConfig, jitter=None, generator=None):
    """Mean absolute lidar-depth error per object (reference log_eval_depth_v2
    :1736), from a forward-only render of the lidar pixels."""
    out = render_rays_at_pixels(
        make_composite(wts, shapecode, texturecode), invert_pose(pose_obj),
        batch.K, batch.lidar_u, batch.lidar_v, obj_diag, n_samples=cfg.n_samples,
        shapenet_obj_cood=cfg.shapenet_obj_cood, kitti2nusc=cfg.kitti2nusc, jitter=jitter,
        generator=generator)
    err = torch.abs(out["depth"] - batch.lidar_depth) * batch.lidar_valid
    return err.sum(1) / (batch.lidar_valid.sum(1) + 1e-8)


@torch.no_grad()
def encode_and_refine(model, batch: ObjectBatch, mean_shape, mean_texture, cfg: TTOConfig,
                      pose_hook=None):
    """Encoder (one object per BatchNorm batch, as the reference encodes one
    image at a time) and the feed-forward refiner on the effective box size
    (effective_wlh; the annotation for a model without a wlh head). A
    two-head encoder (AutoRF, AutoRFMix) gives zero pose code and uv; a
    model without an encoder (CodeNeRF) starts from the mean codes with zero
    uv; a model without a refiner replays pose_init for reg_iters + 1
    entries. pose_hook: optional fn(uv_direct (B, 16)) -> (B, 3, 4), the
    pose the refiner starts from in place of batch.pose_init (the driver's
    PnP bootstrap at opt_pose 2 takes the encoder's corners here, between
    the encoder and the refiner, from the one encoder pass). Returns
    (shapecode0, texturecode0, pose_traj (B, reg_iters + 1, 3, 4),
    uv_direct, wlh_pred, wlh_used)."""
    B = len(batch.img_in)
    uv = batch.wlh.new_zeros((B, 16))
    if hasattr(model, "encode_img"):
        enc = [model.encode_img(batch.img_in[b:b + 1]) for b in range(B)]
        sc, tc = (torch.cat([e[i] for e in enc]) for i in range(2))
    else:
        sc, tc = mean_shape.expand(B, -1), mean_texture.expand(B, -1)
    if getattr(model, "pred_wlh", False):
        wlh_pred = torch.cat([e[4] for e in enc])
        wlh_use = effective_wlh(batch.wlh, wlh_pred, cfg.pred_wlh_mode)
    else:
        wlh_pred, wlh_use = torch.zeros_like(batch.wlh), batch.wlh
    refine = hasattr(model, "pose_update")
    if refine:
        pc, uv = (torch.cat([e[i] for e in enc]) for i in (2, 3))
    pose_init = batch.pose_init if pose_hook is None else pose_hook(uv)
    if refine:
        traj = fw_pose_refine(model.pose_update, pc, pose_init, wlh_use, batch.roi_refine,
                              batch.K, batch.K_inv, iters=cfg.reg_iters, box_fac=cfg.box_fac)
    else:
        traj = pose_init[:, None].expand(B, cfg.reg_iters + 1, 3, 4).clone()
    return ((sc + mean_shape) / 2, (tc + mean_texture) / 2, traj, uv, wlh_pred, wlh_use)


def run_tto_batch(model, wts, batch: ObjectBatch, mean_shape, mean_texture, cfg: TTOConfig,
                  generator=None, jitter=None, sym_flips=None, obj_sz_draws=None, timer=None,
                  pose_hook=None):
    """The full TTO pipeline for a batch of objects.

    wts: render_decoder(model), the kernel operands of a kernel-compatible
    decoder (ops.render.pack_decoder_params), else the model. jitter:
    optional pair (loss_jitter, depth_jitter) of uniform draws for the stratified sampling
    of each iteration's two renders, (num_opts, B, S) each, the loss
    render's (num_opts, B, R, S) with use_aabb_render. sym_flips (num_opts,
    B) bool and obj_sz_draws (num_opts, B, 3, SAMPLES_PER_PLANE): the
    regularisers' draws (tto_loss). Given none, each iteration takes its
    draws from `generator` (iteration_draws); draws left None beside given
    ones come from `generator` where tto_loss and the renders need them.
    timer: optional timing.PhaseTimer, whose device phases encode_refine
    and tto_loop wait for nothing. pose_hook: encode_and_refine's. With
    cfg.opt_pose False only the codes are parameters (the pose is not in
    the optimizer, so weight decay does not touch it either) and every
    iteration after reg_iters renders the refined pose itself.
    Returns a dict of per-object results (leading dim B): codes and poses at
    CODE_SAVE_ITERS, the final codes and pose, and the per-iteration psnr,
    rot_err, trans_err, depth_err and loss curves (B, num_opts), and with
    use_aabb_render the hit_share curve (B, num_opts): the share of the loss
    render's rays that hit the box. With cfg.emit_code_curves also every
    iteration's codes and pose as shapecode_curve, texturecode_curve
    (B, num_opts, latent) and pose_curve (B, num_opts, 3, 4), taken before
    that iteration's update (the vis 2 panels)."""
    if cfg.use_aabb_render and cfg.sym_loss_coef > 0:
        raise ValueError("sym_loss requires the frustum renderer (sample reuse)")
    phase = timer.device if timer is not None else (lambda name: contextlib.nullcontext())
    with phase("encode_refine"):
        sc0, tc0, traj, uv_direct, wlh_pred, wlh_use = encode_and_refine(
            model, batch, mean_shape, mean_texture, cfg, pose_hook)
    obj_diag = torch.linalg.norm(wlh_use, dim=-1)
    params_from_obj_pose, obj_pose_from_params = pose_param_fns(cfg)
    sc, tc = (t.clone().requires_grad_(True) for t in (sc0, tc0))
    params, lrs = [sc, tc], [cfg.lr_shape, cfg.lr_texture]
    if cfg.opt_pose:
        rot, trans = (t.clone().requires_grad_(True) for t in params_from_obj_pose(traj[:, -1]))
        params += [rot, trans]
        lrs += [cfg.lr_pose, cfg.lr_pose]
    opt = AdamW(params, lrs, cfg.weight_decay)

    curves = {k: [] for k in ("psnr", "rot_err", "trans_err", "depth_err", "loss")
              + (("hit_share",) if cfg.use_aabb_render else ())}
    snaps = {"shapecode": {}, "texturecode": {}, "pose": {}}
    pose_obj = traj[:, 0]
    B = len(batch.img_in)
    own_draws = jitter is None and sym_flips is None and obj_sz_draws is None
    with phase("tto_loop"):
        for t in range(cfg.num_opts):
            replay = t <= cfg.reg_iters
            if own_draws:
                d = iteration_draws(cfg, B, generator, sc.device)
                j_loss, j_depth = d["loss_jitter"], d["depth_jitter"]
                reg = {k: d[k] for k in ("sym_flip", "obj_sz_draws")}
            else:
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
                pose_obj = obj_pose_from_params(rot, trans) if cfg.opt_pose else traj[:, -1]
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
            if t in CODE_SAVE_ITERS or cfg.emit_code_curves:
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
        **({f"{k}_curve": torch.stack([snaps[k][t] for t in range(cfg.num_opts)], 1)
            for k in snaps} if cfg.emit_code_curves else {}),
    }

