"""Volume rendering (alpha compositing) on torch tensors; the port of
supnerf_tpu/ops/volume_render.py, with the same numerical contract
(reference utils.py:187-234, renderer.py:355-379):

  deltas_i  = z_{i+1} - z_i, last delta = 1e10
  alpha_i   = 1 - exp(-relu(sigma_i) * delta_i)
  T_i       = prod_{j<i} (max(1 - alpha_j, 0) + 1e-10)   (exclusive cumprod)
  w_i       = alpha_i * T_i
  rgb       = sum_i w_i rgb_i  (+ 1 - sum_i w_i on a white background)
  depth     = sum_i w_i z_i
  acc_trans = T_{S-1}, the exclusive cumprod's LAST element: the last delta
              is 1e10, so including the last factor would drive acc_trans to
              ~0 for any positive terminal density and kill the occupancy
              loss's silhouette gradient.

The transmittance is a plain cumprod, never exp(cumsum(log(t))): with the
1e10 last delta t saturates at 1e-10 and that form's reverse mode overflows
to inf * 0 = NaN. The fused kernels (ops/render.py) keep the same contract.
"""
from __future__ import annotations

import math

import torch

EPS_TRANS = 1e-10
LAST_DELTA = 1e10


def composite_weights(sigmas, z_vals):
    """sigmas (..., S), z_vals broadcastable to it -> (weights (..., S),
    acc_trans (...,))."""
    z_vals = torch.broadcast_to(z_vals, sigmas.shape)
    deltas = z_vals[..., 1:] - z_vals[..., :-1]
    deltas = torch.cat([deltas, torch.full_like(deltas[..., :1], LAST_DELTA)], -1)
    alphas = 1.0 - torch.exp(-torch.clamp(sigmas, min=0.0) * deltas)
    trans = torch.clamp(1.0 - alphas, min=0.0) + EPS_TRANS
    incl = torch.cumprod(trans, -1)
    excl = torch.cat([torch.ones_like(incl[..., :1]), incl[..., :-1]], -1)
    return alphas * excl, excl[..., -1]


def volume_render(sigmas, rgbs, z_vals, white_bkgd: bool = False):
    """sigmas (..., S) or (..., S, 1), rgbs (..., S, 3), z_vals broadcastable
    to sigmas -> (rgb (..., 3), depth (...,), acc_trans (...,))."""
    if sigmas.shape[-1] == 1 and sigmas.dim() == rgbs.dim():
        sigmas = sigmas[..., 0]
    z_vals = torch.broadcast_to(z_vals, sigmas.shape)
    weights, acc_trans = composite_weights(sigmas, z_vals)
    rgb = torch.sum(weights[..., None] * rgbs, -2)
    depth = torch.sum(weights * z_vals, -1)
    if white_bkgd:
        rgb = rgb + (1.0 - weights.sum(-1))[..., None]
    return rgb, depth, acc_trans


def rgb_loss_masked(rgb_rays, rgb_tgt, occ_pixels, dim=None):
    """Occupancy-weighted RGB loss (reference optimizer_nuscenes.py:729);
    occ_pixels (..., 1) in {-1, 0, 1}; dim: axes to reduce (None = all)."""
    w = torch.abs(occ_pixels)
    num = torch.sum((rgb_rays - rgb_tgt) ** 2 * w, dim=dim)
    return num / (torch.sum(w, dim=dim) + 1e-9)


def occupancy_loss(acc_trans, occ_pixels, dim=None):
    """Silhouette loss pushing transmittance to 0 on the object and 1 off it
    (reference trainer_unified_nuscenes.py:138-140)."""
    w = torch.abs(occ_pixels)
    per = torch.exp(-occ_pixels * (0.5 - acc_trans[..., None])) * w
    return torch.sum(per, dim=dim) / (torch.sum(w, dim=dim) + 1e-9)


def masked_psnr(rgb_rays, rgb_tgt, occ_pixels, dim=None):
    """PSNR over the foreground pixels (occ > 0), the reference's metric
    (optimizer_nuscenes.py:740-744)."""
    mask = torch.clamp(occ_pixels, min=0.0)
    mse = torch.sum((rgb_rays - rgb_tgt) ** 2 * mask, dim=dim) / (torch.sum(mask, dim=dim) + 1e-9)
    return -10.0 * torch.log(mse) / math.log(10.0)
