"""Initialisation and normalisation shared by the port's modules; the port
of supnerf_tpu/models/layers.py.

Linear layers are plain torch.nn.Linear: the JAX package's TorchDense
reproduces exactly torch's default Linear init (weight and bias uniform in
+-1/sqrt(fan_in)). init_parameters redraws every parameter from an explicit
generator with the reference's distributions, so a fresh model is the same
on every device for one seed.
"""
from __future__ import annotations

import contextlib
import math

import torch
from torch import nn


class BatchStatNorm2d(nn.BatchNorm2d):
    """BatchNorm2d that always normalises with the current batch's statistics:
    the reference never calls .eval(), and test-time optimization encodes
    each object as a batch of one. The statistics are computed here rather
    than by F.batch_norm, which refuses a single value per channel (a 1 x 1
    feature map of one image) where the JAX package's BatchNorm returns the
    bias.

    The running buffers move only while update_stats is set (the training
    step sets it through batch_stat_updates; test-time optimization never
    does), and then by flax's rule (supnerf_tpu/models/layers.py:batch_norm,
    momentum 0.9): mean <- 0.9 mean + 0.1 batch_mean and var <- 0.9 var +
    0.1 batch_var with the BIASED batch variance. torch's own BatchNorm2d
    would use the unbiased one, n/(n-1) larger: a factor of 4/3 on the 1 x 1
    maps of the last stage at batch 4."""

    update_stats = False

    def forward(self, x):
        var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False, keepdim=True)
        if self.update_stats:
            with torch.no_grad():
                self.running_mean.mul_(0.9).add_(mean.flatten(), alpha=0.1)
                self.running_var.mul_(0.9).add_(var.flatten(), alpha=0.1)
                self.num_batches_tracked += 1
        scale = self.weight[:, None, None] * torch.rsqrt(var + self.eps)
        return (x - mean) * scale + self.bias[:, None, None]


@contextlib.contextmanager
def batch_stat_updates(module: nn.Module):
    """Within the block, every BatchStatNorm2d of `module` updates its
    running buffers on each forward (the JAX train step's
    mutable=["batch_stats"])."""
    norms = [m for m in module.modules() if isinstance(m, BatchStatNorm2d)]
    for m in norms:
        m.update_stats = True
    try:
        yield
    finally:
        for m in norms:
            m.update_stats = False


@torch.no_grad()
def init_parameters(module: nn.Module, generator: torch.Generator):
    """Re-draw all parameters in place: Linear weight and bias U(+-1/sqrt(fan_in));
    Conv2d weight kaiming-normal (fan_out, ReLU gain); BatchNorm scale 1, bias 0."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            bound = 1.0 / math.sqrt(m.in_features)
            m.weight.uniform_(-bound, bound, generator=generator)
            m.bias.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, nn.Conv2d):
            nn.init.kaiming_normal_(m.weight, mode="fan_out", nonlinearity="relu",
                                    generator=generator)
        elif isinstance(m, nn.BatchNorm2d):
            m.weight.fill_(1.0)
            m.bias.zero_()
