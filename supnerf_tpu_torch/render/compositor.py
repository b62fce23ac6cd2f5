"""Multi-object scene composition: every reconstructed object rendered into
one camera window with cross-object occlusion; the port of
supnerf_tpu/render/compositor.py (reference scripts/demo.py vis_scene
:425-579).

Per object, rays over a static window grid with AABB-bounded samples; the
field of all N objects evaluated in one batch; the N * S samples of each
ray merged along one z-sorted axis and composited on a white background.
Rays that miss an object keep its samples at z = -1 with zero density and
white colour, so they composite to background without boolean gathers.

The field is evaluated per point through a plain decoder (torch.matmul),
as the JAX package evaluates it with model.apply outside any Pallas kernel.
"""
from __future__ import annotations

import numpy as np
import torch

from supnerf_tpu_torch.geometry.boxes import corners_of_box, invert_pose, view_points
from supnerf_tpu_torch.geometry.rays import aabb_ray_bounds, get_rays, sample_z_stratified
from supnerf_tpu_torch.ops.volume_render import volume_render
from supnerf_tpu_torch.render.renderer import AABB_FIELD_SCALE, apply_obj_coord_transform


def scene_rays(obj_poses, obj_wlh, K, window_roi, win_hw):
    """(R, N, 8) scene rays: per object, the origin in units of obj_diag/2 in
    its frame, the unit direction and the AABB (near, far), -1 for misses.
    obj_poses (N,3,4), obj_wlh (N,3), K (3,3), window_roi (4,), win_hw
    (W, H); R = H * W over the window grid, row-major."""
    n = len(obj_poses)
    rays_o, viewdir = get_rays(K.expand(n, 3, 3), invert_pose(obj_poses),
                               window_roi.expand(n, 4), (int(win_hw[0]), int(win_hw[1])))
    bounds, _, rays_o_n = aabb_ray_bounds(rays_o, viewdir, obj_wlh)
    return torch.cat([rays_o_n, viewdir, bounds], -1).transpose(0, 1)


def render_scene_window(field_fn, obj_poses, obj_wlh, shapecodes, texturecodes, K,
                        window_roi, win_hw, *, n_samples: int = 64,
                        shapenet_obj_cood: bool = True, chunk: int = 2048, jitter=None,
                        generator=None):
    """Render a window of a scene of N objects.

    field_fn(xyz (N,C,S,3), viewdir (N,C,3), shapecodes (N,L), texturecodes
    (N,L)) -> (sigma (N,C,S), rgb (N,C,S,3)): the conditioned field of each
    object on its own points, scaled by AABB_FIELD_SCALE. window_roi (4,) in pixels, win_hw (W, H).
    jitter: (n_chunks, chunk, N, S) uniform draws (each chunk's draws, as the
    JAX package splits its key per chunk), or None to draw from `generator`.
    Returns (rgb (H, W, 3), depth (H, W))."""
    win_w, win_h = int(win_hw[0]), int(win_hw[1])
    n_rays = win_w * win_h
    rays = scene_rays(obj_poses, obj_wlh, K, window_roi, win_hw)      # (R, N, 8)
    obj_diag = torch.linalg.norm(obj_wlh, dim=-1)
    rgbs, depths = [], []
    for ci, lo in enumerate(range(0, n_rays, chunk)):
        rb = rays[lo:lo + chunk]
        draws = None if jitter is None else jitter[ci, :len(rb)]
        z_coarse = sample_z_stratified(rb[..., 6], rb[..., 7], n_samples, draws, generator)
        empty = rb[..., 6:7] == -1.0                                   # (C, N, 1)
        xyz = rb[..., None, :3] + z_coarse[..., None] * rb[..., None, 3:6]
        z_vals = torch.where(empty, torch.full_like(z_coarse, -1.0),
                             z_coarse * (obj_diag[:, None] / 2))
        xyz, vd = apply_obj_coord_transform(xyz * AABB_FIELD_SCALE, rb[..., 3:6],
                                            shapenet_obj_cood)
        sig, rgb = field_fn(xyz.transpose(0, 1), vd.transpose(0, 1), shapecodes, texturecodes)
        sig = torch.where(empty, torch.zeros_like(z_coarse), sig.transpose(0, 1))
        rgb = torch.where(empty[..., None], torch.ones_like(xyz), rgb.transpose(0, 1))
        # merge the objects' samples along one z-sorted axis per ray; ties sit
        # at z = -1 (missed objects), whose samples are all alike
        order = torch.argsort(z_vals.reshape(len(rb), -1), dim=-1, stable=True)
        z_sorted = torch.take_along_dim(z_vals.reshape(len(rb), -1), order, -1)
        sig_sorted = torch.take_along_dim(sig.reshape(len(rb), -1), order, -1)
        rgb_sorted = torch.take_along_dim(rgb.reshape(len(rb), -1, 3), order[..., None], -2)
        rgb_out, depth_out, _ = volume_render(sig_sorted, rgb_sorted, z_sorted, white_bkgd=True)
        rgbs.append(rgb_out)
        depths.append(depth_out)
    return (torch.cat(rgbs).reshape(win_h, win_w, 3),
            torch.cat(depths).reshape(win_h, win_w))


def scene_window_from_objects(obj_poses, obj_wlh, K, img_h: int, img_w: int,
                              margin: int = 0) -> np.ndarray:
    """The union 2D bounding window [x0, y0, x1, y1] of the objects' boxes
    (numpy in and out), grown by margin and clipped to the image; taken over
    every manipulated pose, it keeps the render window static across frames."""
    corners = corners_of_box(torch.as_tensor(obj_poses, dtype=torch.float32),
                             torch.as_tensor(obj_wlh, dtype=torch.float32))
    uv = view_points(corners, torch.as_tensor(K, dtype=torch.float32)).numpy()
    x0 = max(int(np.floor(uv[:, 0].min())) - margin, 0)
    y0 = max(int(np.floor(uv[:, 1].min())) - margin, 0)
    x1 = min(int(np.ceil(uv[:, 0].max())) + margin, img_w - 1)
    y1 = min(int(np.ceil(uv[:, 1].max())) + margin, img_h - 1)
    return np.asarray([x0, y0, x1, y1], np.float32)
