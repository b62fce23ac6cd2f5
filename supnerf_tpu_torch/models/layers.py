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
    maps of the last stage at batch 4.

    Under global_batch_stats (data-parallel training) the statistics are
    those of the global batch, every rank's rows (JAX
    training/train_step.py:1-15 psums them over the mesh; the reference's
    DataParallel kept each replica's): two passes, each one reduction of
    per-channel sums over the ranks by the function global_batch_stats
    hands in (stat_reduce; the training step's is parallel.all_reduce_sum,
    whose backward all-reduces too, so the statistics' gradient is
    global), the mean first and then
    the centred second moment, where E[x^2] - mean^2 would lose float32
    digits against var_mean. The running buffers then move by the global
    values, equal on every rank."""

    update_stats = False
    stat_reduce = None

    def forward(self, x):
        if self.stat_reduce is not None:
            mean, var = global_moments(x, self.stat_reduce)
        else:
            var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False, keepdim=True)
        if self.update_stats:
            with torch.no_grad():
                self.running_mean.mul_(0.9).add_(mean.flatten(), alpha=0.1)
                self.running_var.mul_(0.9).add_(var.flatten(), alpha=0.1)
                self.num_batches_tracked += 1
        scale = self.weight[:, None, None] * torch.rsqrt(var + self.eps)
        return (x - mean) * scale + self.bias[:, None, None]


def global_moments(x, reduce):
    """(mean, biased variance) per channel, (1, C, 1, 1) each, of x (n, C,
    H, W) over the rows of every rank: the count and sums summed over the
    ranks by reduce (a differentiable sum, as parallel.all_reduce_sum),
    then the centred squares'."""
    sums = torch.cat([x.sum(dim=(0, 2, 3)), x.new_full((1,), x.numel() / x.shape[1])])
    sums = reduce(sums)
    count = sums[-1]
    mean = (sums[:-1] / count)[None, :, None, None]
    var = reduce(((x - mean) ** 2).sum(dim=(0, 2, 3))) / count
    return mean, var[None, :, None, None]


class InstanceNorm2d(nn.InstanceNorm2d):
    """InstanceNorm2d (affine=False, eps 1e-5, no running statistics): each
    sample's channels normalised over H, W with the biased variance, as the
    JAX package's InstanceNorm (supnerf_tpu/models/layers.py:70-81). The
    statistics are computed here, because F.instance_norm refuses a 1 x 1
    map in training mode where JAX gives zeros; it has no state_dict entry,
    as torch's and the reference's."""

    def forward(self, x):
        var, mean = torch.var_mean(x, dim=(2, 3), unbiased=False, keepdim=True)
        return (x - mean) * torch.rsqrt(var + self.eps)


NORMS = {"BatchNorm2d": BatchStatNorm2d, "InstanceNorm2d": InstanceNorm2d}


def norm_layer(norm_layer_type: str):
    """The encoder's normalisation class of a config's norm_layer_type (JAX
    encoder.make_norm)."""
    if norm_layer_type not in NORMS:
        raise ValueError(f"norm_layer_type {norm_layer_type!r}: one of {sorted(NORMS)}")
    return NORMS[norm_layer_type]


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


@contextlib.contextmanager
def global_batch_stats(module: nn.Module, reduce):
    """Within the block, every BatchStatNorm2d of `module` normalises with
    the statistics of all ranks' rows (global_moments), summed over the
    ranks by reduce: the data-parallel training step runs its loss under
    it with parallel.all_reduce_sum."""
    norms = [m for m in module.modules() if isinstance(m, BatchStatNorm2d)]
    for m in norms:
        m.stat_reduce = reduce
    try:
        yield
    finally:
        for m in norms:
            m.stat_reduce = None


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
