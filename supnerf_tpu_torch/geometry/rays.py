"""Ray generation, stratified sampling and ray-box intersection on torch
tensors; the port of supnerf_tpu/geometry/rays.py (get_rays,
get_rays_specified, sample_from_rays, sample_z_stratified,
ray_box_intersection, aabb_ray_bounds).

Everything is batched over a leading object axis B. Camera convention
(nuScenes): the ray through pixel (u, v) has camera-frame direction
[(u - cx)/fx, (v - cy)/fy, 1]; the (3, 4) camera-to-object pose rotates it
into the object frame.
"""
from __future__ import annotations

import torch


def ray_dirs_from_uv(K, c2w, u, v):
    """Rays through pixels (u, v) of shape (B, N). K (B, 3, 3), c2w (B, 3, 4).
    Returns (rays_o, viewdir), each (B, N, 3); viewdir is unit length."""
    fx, fy = K[:, 0, 0, None], K[:, 1, 1, None]
    cx, cy = K[:, 0, 2, None], K[:, 1, 2, None]
    dirs = torch.stack([(u - cx) / fx, (v - cy) / fy, torch.ones_like(u)], -1)
    rays_d = dirs @ c2w[:, :3, :3].transpose(-1, -2)
    viewdir = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    return c2w[:, None, :3, 3].expand_as(viewdir), viewdir


def get_rays(K, c2w, roi, uv_steps):
    """An nu x nv ray grid over each ROI (B, 4); pixel positions span
    [roi_min, roi_max - 1] inclusive. Returns (rays_o, viewdir), each
    (B, nv * nu, 3), row-major over (v, u)."""
    nu, nv = int(uv_steps[0]), int(uv_steps[1])
    roi = roi.to(torch.float32)
    lin_u = torch.linspace(0.0, 1.0, nu, device=roi.device)
    lin_v = torch.linspace(0.0, 1.0, nv, device=roi.device)
    u_lin = lin_u * (roi[:, 2:3] - 1 - roi[:, 0:1]) + roi[:, 0:1]      # (B, nu)
    v_lin = lin_v * (roi[:, 3:4] - 1 - roi[:, 1:2]) + roi[:, 1:2]      # (B, nv)
    u = u_lin[:, None, :].expand(-1, nv, nu).reshape(len(roi), -1)
    v = v_lin[:, :, None].expand(-1, nv, nu).reshape(len(roi), -1)
    return ray_dirs_from_uv(K, c2w, u, v)


def get_rays_specified(K, c2w, u, v):
    """Rays through explicit full-image pixels u, v (B, N)."""
    return ray_dirs_from_uv(K, c2w, u.to(torch.float32), v.to(torch.float32))


def sample_from_rays(rays_o, viewdir, near, far, n_samples: int, jitter=None,
                     generator=None):
    """Stratified depths shared by all rays of an object (the reference's
    distribution: one (S,) jitter vector per object perturbs every ray alike).

    rays_o/viewdir (B, R, 3); near/far (B,). jitter: (B, S) uniform draws in
    [0, 1), or None to draw them from `generator` — passing the draws in lets
    a test feed this and the JAX package the same numbers.
    Returns (xyz (B, R, S, 3), z_vals (B, S))."""
    near = near[:, None]
    far = far[:, None]
    if jitter is None:
        jitter = torch.rand((len(near), n_samples), generator=generator,
                            device=rays_o.device)
    dist = (far - near) / (2 * n_samples)
    lin = torch.linspace(0.0, 1.0, n_samples, device=rays_o.device)
    base = lin * (far - near - 2 * dist) + near + dist
    z_vals = base + jitter * (far - near) / (2 * n_samples)
    xyz = rays_o[:, :, None, :] + viewdir[:, :, None, :] * z_vals[:, None, :, None]
    return xyz, z_vals


def sample_z_stratified(near, far, n_samples: int, jitter=None, generator=None):
    """Per-ray stratified depths between per-ray bounds (reference
    NeRFRenderer.sample_from_ray, renderer.py:27-41). near/far (..., R);
    jitter: (..., R, S) uniform draws in [0, 1), or None to draw them from
    `generator`. Returns z (..., R, S)."""
    if jitter is None:
        jitter = torch.rand(near.shape + (n_samples,), generator=generator, device=near.device)
    step = 1.0 / n_samples
    z_steps = torch.arange(n_samples, dtype=torch.float32, device=near.device) * step
    z_steps = z_steps + jitter * step
    return near[..., None] * (1 - z_steps) + far[..., None] * z_steps


def ray_box_intersection(rays_o, viewdir, aabb_min, aabb_max):
    """Slab-method ray/box intersection. rays_o, viewdir (..., 3) in the box
    frame; aabb_min/max broadcastable to them. Returns (t_near, t_far, hit),
    each (...,); hit needs t_far > t_near and t_far > 0. The slab test relies
    on inf for axis-parallel rays (1/0), as the JAX package's does, so its
    bounds must not be differentiated: the reverse mode of 1/viewdir gives
    0 * inf = NaN for grazing rays (callers detach them)."""
    inv_d = 1.0 / viewdir
    t_min = (aabb_min - rays_o) * inv_d
    t_max = (aabb_max - rays_o) * inv_d
    t_near = torch.minimum(t_min, t_max).amax(-1)
    t_far = torch.maximum(t_min, t_max).amin(-1)
    return t_near, t_far, (t_far > t_near) & (t_far > 0)


def aabb_ray_bounds(rays_o, viewdir, obj_sz):
    """Per-ray (near, far) from the object's wlh box, in units of obj_diag/2
    (reference NeRFRenderer.prepare_sampled_rays, renderer.py:91-117); rays
    that miss get (-1, -1). rays_o/viewdir (B, R, 3) in the metric object
    frame, obj_sz (B, 3) = (w, l, h). Returns (bounds (B, R, 2), hit (B, R),
    rays_o_n (B, R, 3), the origins divided by obj_diag/2)."""
    obj_diag = torch.linalg.norm(obj_sz, dim=-1)[:, None, None]
    half = torch.stack([obj_sz[:, 1], obj_sz[:, 0], obj_sz[:, 2]], -1)[:, None] / obj_diag
    rays_o_n = rays_o / (obj_diag / 2)
    t_near, t_far, hit = ray_box_intersection(rays_o_n, viewdir, -half, half)
    miss = torch.full_like(t_near, -1.0)
    bounds = torch.stack([torch.where(hit, t_near, miss), torch.where(hit, t_far, miss)], -1)
    return bounds, hit, rays_o_n
