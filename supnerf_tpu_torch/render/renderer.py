"""Ray-level rendering over a fused field + compositing callable; the port of
render_rays_frustum, render_rays_at_pixels and apply_obj_coord_transform of
supnerf_tpu/render/renderer.py (reference utils.py:435 render_rays_v2,
:504 render_rays_specified).

Batched over a leading object axis B. composite_fn is the hook the JAX
package's renderers take: (xyz (B,R,S,3), viewdir (B,R,3), z_vals (B,S)) ->
(rgb (B,R,3), depth (B,R), acc_trans (B,R)), in practice
ops.render.field_composite bound to a decoder and codes.
"""
from __future__ import annotations

import torch

from supnerf_tpu_torch.geometry.rays import get_rays, get_rays_specified, sample_from_rays


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
