"""Ray-level rendering over a fused field + compositing callable; the port of
render_rays_frustum, render_rays_at_pixels, render_rays_aabb,
render_full_image, render_virtual_views, prepare_render_target and
apply_obj_coord_transform of supnerf_tpu/render/renderer.py (reference
utils.py:435 render_rays_v2, :504 render_rays_specified, :554
render_full_img, :619 render_virtual_imgs, renderer.py:382
render_rays_v3).

Batched over a leading object axis B. composite_fn is the hook the JAX
package's renderers take: (xyz (B,R,S,3), viewdir (B,R,3), z_vals (B,S)) ->
(rgb (B,R,3), depth (B,R), acc_trans (B,R)), in practice
ops.render.field_composite bound to a decoder and codes; the AABB renderer's
hook also takes per-ray z_vals (B,R,S) and hit (B,R)
(ops.render.field_composite_aabb). The frustum loss render of the symmetry
loss needs the samples' densities, so it takes a per-point field_fn
(xyz, viewdir (B,R,S,3)) -> (sigma (B,R,S,1), rgb (B,R,S,3)) instead
(ops.field.field_apply) and composites with ops.volume_render.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from supnerf_tpu_torch.geometry.rays import (
    aabb_ray_bounds,
    get_rays,
    get_rays_specified,
    sample_from_rays,
    sample_z_stratified,
)
from supnerf_tpu_torch.geometry.roi import resize_linear
from supnerf_tpu_torch.ops.volume_render import volume_render

# The AABB renders (the demo's loss render and scene compositor) sample in
# units of obj_diag/2 while the field was trained on points in units of
# obj_diag; every caller of the JAX package's AABB path scales the points by
# this before the field (its adjust_scale, reference scripts/demo.py:616).
AABB_FIELD_SCALE = 0.5


def apply_obj_coord_transform(xyz, viewdir, shapenet_obj_cood: bool, sym_flip=None,
                              kitti2nusc: bool = False):
    """Frame fix-ups of the sampled points (B,...,3) and directions (B,...,3)
    before the field query, in the reference's order: the symmetry flip
    (sym_flip (B,) bool: negate component 1 of that object's points and
    directions, reference render_rays_v2 sym_aug, utils.py:474-477), then
    with kitti2nusc the KITTI -> nuScenes object-frame rotation (the KITTI
    and Waymo protocols, whose field was trained in the nuScenes frame),
    then the nuScenes object frame -> ShapeNet frame (new_x = -old_y, new_y
    = old_x; utils.py:421-426)."""
    if sym_flip is not None:
        sign = 1.0 - 2.0 * sym_flip.to(xyz.dtype)                    # -1 where flipped

        def flip(v):
            s = sign.reshape(sign.shape + (1,) * (v.dim() - 2))
            return torch.stack([v[..., 0], v[..., 1] * s, v[..., 2]], -1)

        xyz, viewdir = flip(xyz), flip(viewdir)
    if kitti2nusc:            # the rotation (x, y, z) -> (x, z, -y)

        def to_nusc(v):
            return torch.stack([v[..., 0], v[..., 2], -v[..., 1]], -1)

        xyz, viewdir = to_nusc(xyz), to_nusc(viewdir)
    if not shapenet_obj_cood:
        return xyz, viewdir

    def rot(v):
        return torch.stack([-v[..., 1], v[..., 0], v[..., 2]], -1)

    return rot(xyz), rot(viewdir)


def frustum_near_far(cam_pose, obj_diag):
    """near/far = ||t_c2o|| -/+ diag/2 (reference utils.py:467-469), CONSTANT
    with respect to the pose: the reference reads the distance as detached
    python floats, so pose gradients reach the loss only through the ray
    origins and directions. cam_pose (B,3,4), obj_diag (B,) -> (near, far) (B,)."""
    dist = torch.linalg.norm(cam_pose[:, :, 3].detach(), dim=-1)
    return dist - obj_diag / 2, dist + obj_diag / 2


def _render(composite_fn, rays_o, viewdir, cam_pose, obj_diag, n_samples,
            shapenet_obj_cood, jitter, generator, sym_flip=None, field_fn=None,
            kitti2nusc=False):
    near, far = frustum_near_far(cam_pose, obj_diag)
    xyz, z_vals = sample_from_rays(rays_o, viewdir, near, far, n_samples, jitter, generator)
    xyz = xyz / obj_diag[:, None, None, None]
    xyz, vd = apply_obj_coord_transform(xyz, viewdir, shapenet_obj_cood, sym_flip, kitti2nusc)
    if field_fn is None:
        rgb, depth, acc = composite_fn(xyz, vd, z_vals)
        return {"rgb": rgb, "depth": depth, "acc_trans": acc}
    vds = vd[:, :, None, :].expand_as(xyz)
    sigmas, rgbs = field_fn(xyz, vds)
    rgb, depth, acc = volume_render(sigmas, rgbs, z_vals[:, None, :])
    return {"rgb": rgb, "depth": depth, "acc_trans": acc, "xyz": xyz, "viewdir": vds,
            "sigmas": sigmas}


def render_rays_frustum(composite_fn, cam_pose, K, roi, obj_diag, *, n_samples: int,
                        im_sz: int, shapenet_obj_cood: bool, kitti2nusc: bool = False,
                        sym_flip=None, field_fn=None, jitter=None, generator=None):
    """The TTO loss render: an im_sz x im_sz ray grid over each ROI, stratified
    samples in the frustum shell around the object distance, points divided
    by the object diagonal. cam_pose (B,3,4) camera-to-object, K (B,3,3),
    roi (B,4), obj_diag (B,); kitti2nusc and sym_flip (B,) bool or None:
    apply_obj_coord_transform; jitter (B, S) draws or None (then
    `generator`). Returns dict(rgb (B,R,3), depth (B,R), acc_trans (B,R)),
    R = im_sz^2. Given a per-point field_fn (the JAX renderer's
    return_samples), the samples go through it and ops.volume_render
    instead of composite_fn, and the dict also holds the field's inputs xyz
    and viewdir (B,R,S,3) and its sigmas (B,R,S,1), which the symmetry loss
    reuses."""
    rays_o, viewdir = get_rays(K, cam_pose, roi, (im_sz, im_sz))
    return _render(composite_fn, rays_o, viewdir, cam_pose, obj_diag, n_samples,
                   shapenet_obj_cood, jitter, generator, sym_flip, field_fn, kitti2nusc)


def render_rays_at_pixels(composite_fn, cam_pose, K, u, v, obj_diag, *, n_samples: int,
                          shapenet_obj_cood: bool, kitti2nusc: bool = False, jitter=None,
                          generator=None):
    """Render only the full-image pixels u, v (B, N) (the lidar-depth metric,
    reference render_rays_specified); padded entries are masked downstream."""
    rays_o, viewdir = get_rays_specified(K, cam_pose, u, v)
    return _render(composite_fn, rays_o, viewdir, cam_pose, obj_diag, n_samples,
                   shapenet_obj_cood, jitter, generator, kitti2nusc=kitti2nusc)


def render_rays_aabb(composite_fn, cam_pose, K, roi, obj_sz, *, n_samples: int, im_sz: int,
                     shapenet_obj_cood: bool, kitti2nusc: bool = False, sym_flip=None,
                     jitter=None, generator=None):
    """AABB-bounded loss render (reference render_rays_v3): an im_sz x im_sz
    ray grid over each ROI, per-ray near/far from the ray-box intersection in
    units of obj_diag/2, stratified per-ray samples; rays that miss the box
    get bounds (-1, -1) and composite to background. cam_pose (B,3,4), K
    (B,3,3), roi (B,4), obj_sz (B,3) = wlh; jitter (B, R, S) draws or None
    (then `generator`). The points reach the field scaled by
    AABB_FIELD_SCALE. Returns dict(rgb, depth (metric), acc_trans, hit).

    The bounds are constants with respect to the pose, as the reference
    intersects on detached rays (renderer.py:426): the slab test's
    1/viewdir would give 0 * inf = NaN in the backward for grazing rays.
    Pose gradients reach the samples through the ray origins and directions.
    kitti2nusc and sym_flip (B,) bool or None: apply_obj_coord_transform."""
    obj_diag = torch.linalg.norm(obj_sz, dim=-1)
    rays_o, viewdir = get_rays(K, cam_pose, roi, (im_sz, im_sz))
    bounds, hit, rays_o_n = aabb_ray_bounds(rays_o, viewdir, obj_sz)
    bounds = bounds.detach()
    z_coarse = sample_z_stratified(bounds[..., 0], bounds[..., 1], n_samples, jitter, generator)
    xyz = rays_o_n[:, :, None, :] + z_coarse[..., None] * viewdir[:, :, None, :]
    z_vals = z_coarse * (obj_diag[:, None, None] / 2)      # metric distance from the camera
    xyz, vd = apply_obj_coord_transform(xyz * AABB_FIELD_SCALE, viewdir, shapenet_obj_cood,
                                        sym_flip, kitti2nusc)
    rgb, depth, acc = composite_fn(xyz, vd, z_vals, hit)
    return {"rgb": rgb, "depth": depth, "acc_trans": acc, "hit": hit}


def full_image_jitter(n_samples: int, device) -> torch.Tensor:
    """The (S,) stratification jitter of every render_full_image call that
    is given none: one fixed draw of a CPU torch.Generator seeded 0. The
    JAX package draws its own fixed vector from PRNGKey(0) (ROADMAP C.15:
    the two differ; the tests feed JAX's in)."""
    return torch.rand(n_samples, generator=torch.Generator().manual_seed(0)).to(device)


def render_full_image(composite_fn, cam_pose, K, roi, obj_diag, *, n_samples: int, im_hw,
                      shapenet_obj_cood: bool, kitti2nusc: bool = False, jitter=None):
    """Render every pixel of an (H, W) grid over each ROI, the frustum
    sampling of the loss render with one jitter vector shared by all rays
    of all objects (reference render_full_img). cam_pose (B,3,4)
    camera-to-object, K (B,3,3), roi (B,4), obj_diag (B,); im_hw (H, W);
    jitter (S,) or (B, S) draws in [0, 1), None for full_image_jitter.
    The whole grid is one composite_fn call (the JAX package renders it in
    chunks of 4,096 rays to bound its memory). Returns (rgb (B,H,W,3),
    depth (B,H,W), acc_trans (B,H,W))."""
    H, W = int(im_hw[0]), int(im_hw[1])
    B = len(cam_pose)
    if jitter is None:
        jitter = full_image_jitter(n_samples, cam_pose.device)
    if jitter.dim() == 1:
        jitter = jitter.expand(B, -1)
    rays_o, viewdir = get_rays(K, cam_pose, roi, (W, H))
    out = _render(composite_fn, rays_o, viewdir, cam_pose, obj_diag, n_samples,
                  shapenet_obj_cood, jitter, None, kitti2nusc=kitti2nusc)
    return (out["rgb"].reshape(B, H, W, 3), out["depth"].reshape(B, H, W),
            out["acc_trans"].reshape(B, H, W))


def virtual_view_poses(pan_num: int = 8, radius: float = 40.0, tilt: float = math.pi / 6,
                       device=None) -> torch.Tensor:
    """The (pan_num, 3, 4) camera-to-object poses of the ring of virtual
    views (reference render_virtual_imgs, utils.py:619-672): a camera
    radius away on the object's -x axis, tilted by `tilt`, panned about z in
    steps of 2 pi / pan_num."""
    def mat(rows):
        return torch.tensor(rows, dtype=torch.float32, device=device)

    cam_init = mat([[0.0, 0.0, 1.0, -radius], [-1.0, 0.0, 0.0, 0.0],
                    [0.0, -1.0, 0.0, 0.0], [0.0, 0.0, 0.0, 1.0]])
    ct, st = math.cos(tilt), math.sin(tilt)
    cam_tilt = mat([[ct, 0.0, st, 0.0], [0.0, 1.0, 0.0, 0.0],
                    [-st, 0.0, ct, 0.0], [0.0, 0.0, 0.0, 1.0]]) @ cam_init
    poses = []
    for i in range(pan_num):
        pan = 2 * math.pi * i / pan_num
        cp, sp = math.cos(pan), math.sin(pan)
        rot = mat([[cp, -sp, 0.0, 0.0], [sp, cp, 0.0, 0.0],
                   [0.0, 0.0, 1.0, 0.0], [0.0, 0.0, 0.0, 1.0]])
        poses.append((rot @ cam_tilt)[:3])
    return torch.stack(poses)


def render_virtual_views(composite_fn, obj_diag, K, *, n_samples: int,
                         shapenet_obj_cood: bool, radius: float = 40.0,
                         tilt: float = math.pi / 6, pan_num: int = 8, img_sz: int = 128,
                         kitti2nusc: bool = False, jitter=None):
    """Render a ring of pan_num virtual views around each of B objects
    (reference render_virtual_imgs): an img_sz square ROI centred on each
    object's principal point, all B * pan_num views in one render_full_image
    call. composite_fn renders B * pan_num objects, object b's views in rows
    b * pan_num .. (b + 1) * pan_num - 1 (its codes repeat_interleave'd by
    pan_num). obj_diag (B,), K (B,3,3); jitter as render_full_image's.
    Returns (B, pan_num, img_sz, img_sz, 3)."""
    B = len(K)
    K = K.to(torch.float32)
    centre = K[:, :2, 2]
    roi = torch.cat([centre - img_sz / 2, centre + img_sz / 2], -1)
    poses = virtual_view_poses(pan_num, radius, tilt, K.device).repeat(B, 1, 1)
    rgb, _, _ = render_full_image(
        composite_fn, poses, K.repeat_interleave(pan_num, 0), roi.repeat_interleave(pan_num, 0),
        obj_diag.repeat_interleave(pan_num, 0), n_samples=n_samples, im_hw=(img_sz, img_sz),
        shapenet_obj_cood=shapenet_obj_cood, kitti2nusc=kitti2nusc, jitter=jitter)
    return rgb.reshape(B, pan_num, img_sz, img_sz, 3)


def prepare_render_target(img_crop: np.ndarray, mask_crop: np.ndarray, im_sz: int):
    """An ROI crop (h, w, 3) and its occupancy mask (h, w, 1) resized to the
    im_sz render grid: bilinear (jax.image.resize's linear, no antialias),
    the {-1, 0, 1} mask truncated toward zero afterwards. Returns (rgb_tgt
    (im_sz^2, 3), occ_pixels (im_sz^2, 1)) float32."""
    img_r = resize_linear(img_crop, (im_sz, im_sz), antialias=False)
    mask_r = np.trunc(resize_linear(mask_crop, (im_sz, im_sz), antialias=False))
    return img_r.reshape(-1, 3), mask_r.reshape(-1, 1)
