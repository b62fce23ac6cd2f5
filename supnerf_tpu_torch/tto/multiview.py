"""Multiview test-time optimization: one instance's shape and texture codes
optimized against all of its views at once; the port of
supnerf_tpu/tto/multiview.py (reference optimizer_nuscenes.py:
optimize_objs_multi_anns :796 and its _w_pose variant: shared codes per
instance, the views' losses averaged each iteration, optionally per-view
poses).

The views of an instance are the batch axis of one render: each iteration
is one fused-render launch pair over the V views (K1 forward, K2 backward on
the card), the shared codes expanded to V rows, so autograd sums their
gradient over the views. JAX pads the views to v_max with weight-0 views
for its compiled shape; the port renders the real views only, which gives
JAX's loss and PSNR (a padded view carries weight 0). With opt_model the
decoder is optimized too: a copy per instance (decoder_copy), so the model
given stays as it was. A kernel-compatible decoder in the float32 mode is
rendered by ops.render.field_composite_train (K1, then K3's data mode and
K4); the original AutoRF's, which no kernel takes, and one in the
bfloat16 mode by ops.render.decoder_composite under autograd, as the JAX
package's opt_model runs every decoder on its flax path: the copy's
forward is then models.nerf_mlp.decode_bf16, flax TorchDense's bfloat16
contract, which the training kernels' bfloat16 mode (the Pallas kernels'
rounding) is not.
"""
from __future__ import annotations

import dataclasses

import torch

from supnerf_tpu_torch.geometry.boxes import invert_pose
from supnerf_tpu_torch.models.nerf_mlp import AutoRFDecoder, CodeNeRFDecoder
from supnerf_tpu_torch.ops.render import (
    decoder_composite,
    decoder_kernel_compatible,
    field_composite_train,
)
from supnerf_tpu_torch.ops.volume_render import masked_psnr, occupancy_loss, rgb_loss_masked
from supnerf_tpu_torch.optim import AdamW
from supnerf_tpu_torch.render.renderer import render_rays_frustum
from supnerf_tpu_torch.tto.core import CODE_SAVE_ITERS, TTOConfig, make_composite, pose_param_fns

# the decoder's learning rate with opt_model (reference optimizer_nuscenes.py:869)
LR_MODEL = 1e-3


@dataclasses.dataclass
class MultiviewBatch:
    """One instance's views, along axis 0 (V)."""

    img_in: torch.Tensor       # (V, in_img_sz, in_img_sz, 3)
    rgb_tgt: torch.Tensor      # (V, R, 3)
    occ_tgt: torch.Tensor      # (V, R, 1)
    K: torch.Tensor            # (V, 3, 3)
    roi_nerf: torch.Tensor     # (V, 4)
    pose_init: torch.Tensor    # (V, 3, 4) per-view object pose
    wlh: torch.Tensor          # (V, 3)
    obj_pose_gt: torch.Tensor  # (V, 3, 4)

    @classmethod
    def from_object_batch(cls, batch):
        """The views' fields of a tto.core.ObjectBatch of one instance."""
        return cls(**{f.name: getattr(batch, f.name) for f in dataclasses.fields(cls)})

    @classmethod
    def from_numpy(cls, arrays: dict, device):
        return cls(**{f.name: torch.tensor(arrays[f.name], dtype=torch.float32, device=device)
                      for f in dataclasses.fields(cls)})


def decoder_copy(model):
    """opt_model's per-instance decoder, on `model`'s device: a
    CodeNeRFDecoder holding copies of a kernel-compatible model's decoder
    layers, in the model's field_dtype, or an AutoRFDecoder holding the
    original AutoRF's (both models keep them at the top level under the
    reference names). Any other decoder raises ValueError."""
    if decoder_kernel_compatible(model):
        W = model.encoding_shape.weight.shape[0]
        latent = model.get_submodule("shape_latent_layer_1.0").weight.shape[1]
        dec = CodeNeRFDecoder(model.shape_blocks, model.texture_blocks, W, latent,
                              model.num_xyz_freq, model.num_dir_freq, model.field_dtype)
    elif isinstance(model, AutoRFDecoder):
        dec = AutoRFDecoder(model.shape_blocks, model.texture_blocks,
                            model.encoding_xyz[0].weight.shape[0], model.num_xyz_freq,
                            model.num_dir_freq)
    else:
        raise ValueError(f"opt_model: {type(model).__name__} with {model.shape_blocks} shape "
                         f"and {model.texture_blocks} texture blocks is neither a decoder the "
                         "kernels take (ops.render.decoder_kernel_compatible) nor the "
                         "original AutoRF's")
    own = model.state_dict()
    dec.load_state_dict({k: own[k].detach().clone() for k in dec.state_dict()}, strict=True)
    return dec.to(model.encoding_xyz[0].weight.device)


def multiview_loss(wts, sc, tc, pose, batch: MultiviewBatch, cfg: TTOConfig, *, dec=None,
                   jitter=None, generator=None):
    """One render of all V views, one fused launch pair, and its loss: the
    mean over the views of the masked RGB loss plus loss_occ_coef times the
    occupancy loss, and the mean PSNR. sc (latent,); tc (latent,), or with
    slack_tex's residuals added (V, latent); pose (V, 3, 4) object poses.
    wts: tto.core.render_decoder(model); with dec (opt_model's
    decoder_copy) the render runs through field_composite_train instead
    (K1, then K3's data mode and K4), or for a decoder no kernel takes or
    one in the bfloat16 mode through decoder_composite, either of which
    gives dec's weights their gradient. jitter: optional (V, S) uniform
    draws, else from `generator`."""
    V = len(batch.img_in)
    sc_v, tc_v = sc.expand(V, -1), tc.expand(V, -1)
    if (dec is not None and decoder_kernel_compatible(dec)
            and dec.field_dtype == "float32"):
        def composite(xyz, vd, z):
            return field_composite_train(dec, xyz, vd, z, sc_v, tc_v, data_grads=True)
    elif dec is not None:
        sc_r, tc_r = sc_v, tc_v
        if getattr(dec, "field_dtype", "float32") == "bfloat16":
            # a code the views share as one row: JAX's vmap over the views
            # computes its latent projections once (DenseBf16's rounding)
            sc_r, tc_r = sc[None], tc if tc.dim() == 2 else tc[None]

        def composite(xyz, vd, z):
            return decoder_composite(dec, xyz, vd, z, sc_r, tc_r)
    else:
        composite = make_composite(wts, sc_v, tc_v)
    out = render_rays_frustum(
        composite, invert_pose(pose), batch.K, batch.roi_nerf,
        torch.linalg.norm(batch.wlh, dim=-1), n_samples=cfg.n_samples, im_sz=cfg.render_im_sz,
        shapenet_obj_cood=cfg.shapenet_obj_cood, kitti2nusc=cfg.kitti2nusc, jitter=jitter,
        generator=generator)
    loss = (rgb_loss_masked(out["rgb"], batch.rgb_tgt, batch.occ_tgt, dim=(1, 2))
            + cfg.loss_occ_coef * occupancy_loss(out["acc_trans"], batch.occ_tgt, dim=(1, 2)))
    psnr = masked_psnr(out["rgb"], batch.rgb_tgt, batch.occ_tgt, dim=(1, 2))
    return loss.mean(), psnr.mean()


def run_multiview_tto(model, wts, batch: MultiviewBatch, mean_shape, mean_texture,
                      cfg: TTOConfig, *, opt_pose: bool = False, opt_model: bool = False,
                      slack_tex: bool = False, jitter=None, generator=None):
    """Optimize one shared shape and texture code (and with opt_pose the
    per-view poses) of an instance against its V views, num_opts AdamW
    iterations at cfg's learning rates, halved every lr_half_interval
    iterations (no moment reset and no replay iterations, as in JAX).

    wts: tto.core.render_decoder(model). The codes start from the mean of
    the views' encodings (one image per BatchNorm batch; the mean codes for
    a model without an encoder) averaged with the mean codes; the poses
    from batch.pose_init, through pose_param_fns(cfg). The poses take part
    in the graph at every opt_pose, as in JAX, whose pose gradients are
    zeroed; without opt_pose they are not in the optimizer and keep their
    values. slack_tex: per-view texture residuals, zero at the start, added
    to the shared texture code (reference :874-880). opt_model: also a copy
    of the decoder (decoder_copy) at AdamW lr LR_MODEL (reference :869),
    in the model's field_dtype (multiview_loss's routes).
    jitter: optional (num_opts, V, S)
    uniform draws of the loss renders' stratified samples, else drawn from
    `generator`. Returns codes at CODE_SAVE_ITERS (n_code, latent), the
    final codes, the final per-view poses (V, 3, 4) and the per-iteration
    loss and PSNR (num_opts,), both means over the views."""
    V, dev = len(batch.img_in), batch.img_in.device
    with torch.no_grad():
        if hasattr(model, "encode_img"):
            enc = [model.encode_img(batch.img_in[v:v + 1]) for v in range(V)]
            sc_enc, tc_enc = (torch.cat([e[i] for e in enc]) for i in range(2))
        else:
            sc_enc, tc_enc = mean_shape.expand(V, -1), mean_texture.expand(V, -1)
    params_from_obj_pose, obj_pose_from_params = pose_param_fns(cfg)
    sc = ((sc_enc.mean(0) + mean_shape) / 2).clone().requires_grad_(True)
    tc = ((tc_enc.mean(0) + mean_texture) / 2).clone().requires_grad_(True)
    rot, trans = (t.clone().requires_grad_(True) for t in params_from_obj_pose(batch.pose_init))
    params, lrs = [sc, tc], [cfg.lr_shape, cfg.lr_texture]
    if opt_pose:
        params += [rot, trans]
        lrs += [cfg.lr_pose, cfg.lr_pose]
    tex_res = None
    if slack_tex:
        tex_res = torch.zeros((V,) + tc.shape, device=dev, requires_grad=True)
        params.append(tex_res)
        lrs.append(cfg.lr_texture)
    dec = None
    if opt_model:
        dec = decoder_copy(model)
        dec_params = list(dec.parameters())
        params += dec_params
        lrs += [LR_MODEL] * len(dec_params)
    opt = AdamW(params, lrs, cfg.weight_decay)

    curves = {"loss": [], "psnr": []}
    snaps = {"shapecode": {}, "texturecode": {}}
    for t in range(cfg.num_opts):
        loss, psnr = multiview_loss(wts, sc, tc + tex_res if slack_tex else tc,
                                    obj_pose_from_params(rot, trans), batch, cfg,
                                    dec=dec,
                                    jitter=None if jitter is None else jitter[t],
                                    generator=generator)
        grads = torch.autograd.grad(loss, params)
        curves["loss"].append(loss.detach())
        curves["psnr"].append(psnr.detach())
        if t in CODE_SAVE_ITERS:
            snaps["shapecode"][t] = sc.detach().clone()
            snaps["texturecode"][t] = tc.detach().clone()
        opt.step(grads, 2.0 ** -(t // cfg.lr_half_interval))

    final = {"shapecode": sc.detach(), "texturecode": tc.detach()}
    saved = {k: torch.stack([snaps[k][i] if i < cfg.num_opts else final[k]
                             for i in CODE_SAVE_ITERS]) for k in snaps}
    return {
        "shapecodes_saved": saved["shapecode"],      # (n_code, latent)
        "texturecodes_saved": saved["texturecode"],
        "final_shapecode": final["shapecode"],
        "final_texturecode": final["texturecode"],
        "final_poses": obj_pose_from_params(rot, trans).detach(),   # (V, 3, 4)
        "loss": torch.stack(curves["loss"]),
        "psnr": torch.stack(curves["psnr"]),
    }
