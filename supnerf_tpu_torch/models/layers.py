"""Initialisation and normalisation shared by the port's modules; the port
of supnerf_tpu/models/layers.py.

Linear layers are plain torch.nn.Linear: the JAX package's TorchDense
reproduces exactly torch's default Linear init (weight and bias uniform in
+-1/sqrt(fan_in)). init_parameters redraws every parameter from an explicit
generator with the reference's distributions, so a fresh model is the same
on every device for one seed.
"""
from __future__ import annotations

import math

import torch
from torch import nn


class BatchStatNorm2d(nn.BatchNorm2d):
    """BatchNorm2d that always normalises with the current batch's statistics
    and never updates its running buffers: the reference never calls .eval(),
    and test-time optimization encodes each object as a batch of one. The
    running buffers stay only so that reference checkpoints load strictly.
    The statistics are computed here rather than by F.batch_norm, which
    refuses a single value per channel (a 1 x 1 feature map of one image)
    where the JAX package's BatchNorm returns the bias."""

    def forward(self, x):
        var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False, keepdim=True)
        scale = self.weight[:, None, None] * torch.rsqrt(var + self.eps)
        return (x - mean) * scale + self.bias[:, None, None]


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
