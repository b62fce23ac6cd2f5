"""Training checkpoints in the reference's .pth schema; the port's
counterpart of supnerf_tpu/training/checkpoints.py (reference
trainer_unified_nuscenes.py save_models :476-490, resume_from_epoch
:492-513).

epoch_{n}.pth, and models.pth as a copy of the newest, hold exactly the keys
supnerf_tpu.models.torch_import.save_reference_checkpoint writes:
model_params (the model's state_dict, BatchNorm buffers included),
shape_code_params / texture_code_params {"weight"}, niter, nepoch,
instoken2idx and optimized_idx, so that cli/common.load_model_and_codes and
the reference's loaders read them. The two optimizer states, which the
reference schema has no key for, go beside it into epoch_{n}_optim.pth for
an exact resume; instoken2idx.json repeats the instance map. The mean
codes of a checkpoint (the JAX module's mean_codes) are cli/common.py's
mean_codes, which test-time optimization uses without the training stack.

A checkpoint without epoch_{n}_optim.pth (one from the reference trainer, or
from the JAX package's export_reference_checkpoint) resumes with both
AdamWs started fresh: zero moments and count 0, so Adam's bias correction
starts over, and a line printed to say so. The learning-rate schedule reads
the step count (state.niter, restored from the checkpoint), not the
optimizers' counts, so its decay goes on where the checkpoint left it.
"""
from __future__ import annotations

import json
import os
import shutil

import torch

from supnerf_tpu_torch.training.train_step import TrainState


def _cpu(t):
    return t.detach().cpu().clone()


def save_checkpoint(save_dir: str, state: TrainState, nepoch: int, instoken2idx: dict) -> str:
    """Write epoch_{nepoch}.pth, its optimizer file, models.pth and
    instoken2idx.json; returns the epoch file's path."""
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, f"epoch_{nepoch}.pth")
    torch.save({
        "model_params": {k: _cpu(v) for k, v in state.model.state_dict().items()},
        "shape_code_params": {"weight": _cpu(state.shape_codes)},
        "texture_code_params": {"weight": _cpu(state.texture_codes)},
        "niter": int(state.niter),
        "nepoch": int(nepoch),
        "instoken2idx": dict(instoken2idx),
        "optimized_idx": _cpu(state.optimized_idx),
    }, path)
    torch.save({"model": state.opt_model.state_dict(), "codes": state.opt_codes.state_dict()},
               os.path.join(save_dir, f"epoch_{nepoch}_optim.pth"))
    shutil.copyfile(path, os.path.join(save_dir, "models.pth"))
    with open(os.path.join(save_dir, "instoken2idx.json"), "w") as f:
        json.dump(instoken2idx, f)
    return path


def restore_checkpoint(save_dir: str, state: TrainState, nepoch: int | None = None):
    """Load epoch_{nepoch} (models.pth's epoch when None) into `state` in
    place: weights and buffers strictly, code tables, optimized_idx, niter
    and both optimizer states, or fresh optimizers where the checkpoint has
    no optimizer file. Returns (nepoch, instoken2idx)."""
    if nepoch is None:
        nepoch = int(torch.load(os.path.join(save_dir, "models.pth"), map_location="cpu",
                                weights_only=False)["nepoch"])
    saved = torch.load(os.path.join(save_dir, f"epoch_{nepoch}.pth"), map_location="cpu",
                       weights_only=False)
    optim_path = os.path.join(save_dir, f"epoch_{nepoch}_optim.pth")
    state.model.load_state_dict(saved["model_params"], strict=True)
    with torch.no_grad():
        for dst, src in ((state.shape_codes, saved["shape_code_params"]["weight"]),
                         (state.texture_codes, saved["texture_code_params"]["weight"]),
                         (state.optimized_idx, saved["optimized_idx"])):
            if dst.shape != src.shape:
                raise ValueError(f"checkpoint table of shape {tuple(src.shape)} for a state "
                                 f"of shape {tuple(dst.shape)}")
            dst.copy_(src)
    if os.path.exists(optim_path):
        optim = torch.load(optim_path, map_location="cpu", weights_only=False)
        state.opt_model.load_state_dict(optim["model"])
        state.opt_codes.load_state_dict(optim["codes"])
    else:
        state.opt_model.reset()
        state.opt_codes.reset()
        print(f"{optim_path} not found: both optimizers start fresh (zero moments, count 0); "
              f"the learning-rate schedule goes on from step {int(saved['niter'])}")
    state.niter = int(saved["niter"])
    return int(saved["nepoch"]), dict(saved["instoken2idx"])

