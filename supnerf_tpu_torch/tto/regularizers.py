"""The optional TTO regularisers; the port of supnerf_tpu/tto/regularizers.py
(reference optimizer_nuscenes.py: loss_obj_sz :1412-1433 with
generate_obj_sz_reg_samples utils.py:725-758, loss_sym :1435-1448), batched
over a leading object axis B.

field_fn is the field bound to the objects' codes: (xyz (B,...,3), viewdir
(B,...,3)) -> (sigma (B,...,1), rgb (B,...,3)), in practice
ops.field.field_apply. The uniform draws of the box-plane samples come from
outside, so that a test can replay the JAX package's."""
from __future__ import annotations

import torch

SAMPLES_PER_PLANE = 100


def obj_sz_reg_samples(draws, obj_sz, obj_diag, shapenet_obj_cood: bool = True,
                       tau: float = 0.05):
    """Samples just outside and just inside the six box-limit planes in the
    normalised object frame. draws (B, 3, P) uniform in [0, 1): the X, Y and Z
    coordinates of the P samples per plane, mapped to [-lim, lim] as
    jax.random.uniform maps its bits; obj_sz (B, 3) = wlh, obj_diag (B,).
    Returns (samples_out, samples_in), each (B, 3, 2P, 3): per axis, the
    plane at -lim and the plane at +lim, pushed out (in) by tau."""
    lim = obj_sz / obj_diag[:, None]
    if shapenet_obj_cood:
        lim = lim[:, [1, 0, 2]]
    lo, hi = -lim[..., None], lim[..., None]                     # (B, 3, 1)
    coords = torch.maximum(lo, draws * (hi - lo) + lo)            # (B, 3, P)

    def planes(delta):
        per_axis = []
        for a in range(3):
            at = []
            for side in (-lim[:, a:a + 1] + delta, lim[:, a:a + 1] - delta):
                cols = [coords[:, k] if k != a else side.expand_as(coords[:, k]) for k in range(3)]
                at.append(torch.stack(cols, -1))
            per_axis.append(torch.cat(at, 1))                     # (B, 2P, 3)
        return torch.stack(per_axis, 1)

    return planes(-tau), planes(tau)


def obj_sz_loss(field_fn, draws, obj_sz, obj_diag, shapenet_obj_cood: bool = True,
                tau: float = 0.05):
    """Penalise density just outside the box limits and reward density just
    inside: (sum of max_sigma_out^2 + sum of (max_sigma_in - 1)^2) / 6 per
    object (B,). torch.amax splits the gradient among tied maxima, as
    jnp.max does."""
    s_out, s_in = obj_sz_reg_samples(draws, obj_sz, obj_diag, shapenet_obj_cood, tau)
    sig_out, _ = field_fn(s_out, torch.ones_like(s_out))
    sig_in, _ = field_fn(s_in, torch.ones_like(s_in))
    so = torch.amax(sig_out[..., 0], dim=2)
    si = torch.amax(sig_in[..., 0], dim=2)
    return ((so ** 2).sum(1) + ((si - 1.0) ** 2).sum(1)) / 6.0


def sym_loss(field_fn, xyz, viewdir, sigmas, shapenet_obj_cood: bool = True):
    """Density symmetry across the object's lateral axis (axis 0 of the
    ShapeNet frame, axis 1 without it): per object (B,), the mean squared
    difference between sigma at the sampled points and at their mirror
    images. xyz, viewdir (B,...,3), sigmas (B,...,1)."""
    flip = torch.ones(3, dtype=xyz.dtype, device=xyz.device)
    flip[0 if shapenet_obj_cood else 1] = -1.0
    sig_sym, _ = field_fn(xyz * flip, viewdir * flip)
    return ((sigmas - sig_sym) ** 2).mean(dim=tuple(range(1, sigmas.dim())))
