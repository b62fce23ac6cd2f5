"""optax.adamw written out for the port's two optimizing loops, test-time
optimization (tto/core.py) and training (training/train_step.py), and
optax.clip_by_global_norm for training's gradient clipping."""
from __future__ import annotations

import torch

_ADAM_B1, _ADAM_B2, _ADAM_EPS = 0.9, 0.999, 1e-8


class AdamW:
    """optax.adamw per parameter, written out: b1 0.9, b2 0.999, eps 1e-8
    outside the square root, bias-corrected moments, decoupled weight decay
    multiplied by the learning rate. `scale` multiplies the whole update
    (the lr halving); reset() re-creates the state (zero moments, count 0).
    The parameters are updated in place; every one of them, with a zero
    gradient too, decays on every step, as optax does for dense arrays."""

    def __init__(self, params, lrs, weight_decay: float):
        self.params, self.lrs, self.wd = list(params), list(lrs), weight_decay
        self.reset()

    def reset(self):
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads, scale: float):
        self.count += 1
        c1 = 1.0 - _ADAM_B1 ** self.count
        c2 = 1.0 - _ADAM_B2 ** self.count
        grads = list(grads)
        # multi-tensor ops: the model's optimizer holds a few hundred tensors
        torch._foreach_mul_(self.m, _ADAM_B1)
        torch._foreach_add_(self.m, grads, alpha=1 - _ADAM_B1)
        torch._foreach_mul_(self.v, _ADAM_B2)
        torch._foreach_addcmul_(self.v, grads, grads, value=1 - _ADAM_B2)
        denom = torch._foreach_div(self.v, c2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, _ADAM_EPS)
        u = torch._foreach_div(self.m, c1)
        torch._foreach_div_(u, denom)
        torch._foreach_add_(u, self.params, alpha=self.wd)
        torch._foreach_mul_(u, [lr * scale for lr in self.lrs])
        torch._foreach_sub_(self.params, u)

    def state_dict(self) -> dict:
        return {"m": [t.detach().cpu() for t in self.m], "v": [t.detach().cpu() for t in self.v],
                "count": self.count}

    @torch.no_grad()
    def load_state_dict(self, state: dict):
        if len(state["m"]) != len(self.params) or len(state["v"]) != len(self.params):
            raise ValueError("optimizer state does not match the parameters")
        for dst, src in zip(self.m + self.v, list(state["m"]) + list(state["v"])):
            if tuple(dst.shape) != tuple(src.shape):
                raise ValueError(f"optimizer moment of shape {tuple(src.shape)} for a "
                                 f"parameter of shape {tuple(dst.shape)}")
            dst.copy_(torch.as_tensor(src))
        self.count = int(state["count"])


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float) -> list:
    """optax.clip_by_global_norm(max_norm) on one set of gradients: each
    unchanged where their global norm sqrt(sum of squares) is below
    max_norm, else t / norm * max_norm. On the device, without a host
    round trip."""
    grads = list(grads)
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    return [torch.where(keep, g, g / norm * max_norm) for g in grads]
