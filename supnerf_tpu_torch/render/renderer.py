"""Ray-level rendering over a fused field + compositing callable; the port of
render_rays_frustum, render_rays_at_pixels, render_rays_aabb and
apply_obj_coord_transform of supnerf_tpu/render/renderer.py (reference
utils.py:435 render_rays_v2, :504 render_rays_specified, renderer.py:382
render_rays_v3).

Batched over a leading object axis B. composite_fn is the hook the JAX
package's renderers take: (xyz (B,R,S,3), viewdir (B,R,3), z_vals (B,S)) ->
(rgb (B,R,3), depth (B,R), acc_trans (B,R)), in practice
ops.render.field_composite bound to a decoder and codes; the AABB renderer's
hook also takes per-ray z_vals (B,R,S) and hit (B,R)
(ops.render.field_composite_aabb).
"""
from __future__ import annotations

import torch

from supnerf_tpu_torch.geometry.rays import (
    aabb_ray_bounds,
    get_rays,
    get_rays_specified,
    sample_from_rays,
    sample_z_stratified,
)

# The AABB renders (the demo's loss render and scene compositor) sample in
# units of obj_diag/2 while the field was trained on points in units of
# obj_diag; every caller of the JAX package's AABB path scales the points by
# this before the field (its adjust_scale, reference scripts/demo.py:616).
AABB_FIELD_SCALE = 0.5


def apply_obj_coord_transform(xyz, viewdir, shapenet_obj_cood: bool):
    """nuScenes object frame -> ShapeNet frame (new_x = -old_y, new_y = old_x;
    reference utils.py:421-426) on points (..., 3) and directions (..., 3)."""
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
            shapenet_obj_cood, jitter, generator):
    near, far = frustum_near_far(cam_pose, obj_diag)
    xyz, z_vals = sample_from_rays(rays_o, viewdir, near, far, n_samples, jitter, generator)
    xyz = xyz / obj_diag[:, None, None, None]
    xyz, vd = apply_obj_coord_transform(xyz, viewdir, shapenet_obj_cood)
    rgb, depth, acc = composite_fn(xyz, vd, z_vals)
    return {"rgb": rgb, "depth": depth, "acc_trans": acc}


def render_rays_frustum(composite_fn, cam_pose, K, roi, obj_diag, *, n_samples: int,
                        im_sz: int, shapenet_obj_cood: bool, jitter=None, generator=None):
    """The TTO loss render: an im_sz x im_sz ray grid over each ROI, stratified
    samples in the frustum shell around the object distance, points divided
    by the object diagonal. cam_pose (B,3,4) camera-to-object, K (B,3,3),
    roi (B,4), obj_diag (B,); jitter (B, S) draws or None (then `generator`).
    Returns dict(rgb (B,R,3), depth (B,R), acc_trans (B,R)), R = im_sz^2."""
    rays_o, viewdir = get_rays(K, cam_pose, roi, (im_sz, im_sz))
    return _render(composite_fn, rays_o, viewdir, cam_pose, obj_diag, n_samples,
                   shapenet_obj_cood, jitter, generator)


def render_rays_at_pixels(composite_fn, cam_pose, K, u, v, obj_diag, *, n_samples: int,
                          shapenet_obj_cood: bool, jitter=None, generator=None):
    """Render only the full-image pixels u, v (B, N) (the lidar-depth metric,
    reference render_rays_specified); padded entries are masked downstream."""
    rays_o, viewdir = get_rays_specified(K, cam_pose, u, v)
    return _render(composite_fn, rays_o, viewdir, cam_pose, obj_diag, n_samples,
                   shapenet_obj_cood, jitter, generator)


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
    The KITTI frame and the symmetry flip are not ported (ROADMAP.md §A.8,
    §A.11) and raise."""
    if kitti2nusc or sym_flip is not None:
        raise NotImplementedError("kitti2nusc and sym_flip are queued in ROADMAP.md (§A.8, "
                                  "§A.11); render_rays_aabb runs the nuScenes frame unflipped")
    obj_diag = torch.linalg.norm(obj_sz, dim=-1)
    rays_o, viewdir = get_rays(K, cam_pose, roi, (im_sz, im_sz))
    bounds, hit, rays_o_n = aabb_ray_bounds(rays_o, viewdir, obj_sz)
    bounds = bounds.detach()
    z_coarse = sample_z_stratified(bounds[..., 0], bounds[..., 1], n_samples, jitter, generator)
    xyz = rays_o_n[:, :, None, :] + z_coarse[..., None] * viewdir[:, :, None, :]
    z_vals = z_coarse * (obj_diag[:, None, None] / 2)      # metric distance from the camera
    xyz, vd = apply_obj_coord_transform(xyz * AABB_FIELD_SCALE, viewdir, shapenet_obj_cood)
    rgb, depth, acc = composite_fn(xyz, vd, z_vals, hit)
    return {"rgb": rgb, "depth": depth, "acc_trans": acc, "hit": hit}
