"""Shared dense building blocks — the port of `second_tpu/models/layers.py`
(`ConvBlock`, `DeconvBlock` in NCHW, and `DenseBNReLU`).

`dtype` is the compute dtype of the convolutions (bf16 under mixed
precision); parameters and normalization stay fp32, and normalization
outputs fp32, as flax's BatchNorm does after a bf16 conv. BatchNorm uses
eps 1e-3 and torch momentum 0.01 (flax momentum 0.99), with flax's
training statistics (`FlaxBatchNorm2d`, `FlaxBatchNorm1d`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..device import at_least_fp32
from ..parallel.mesh import global_moments


def _flax_batch_norm(bn, x, dims):
    """flax's `BatchNorm` in training over the axes `dims` of x, the
    channels on the remaining one: the batch statistics in fp32 as flax's
    fast variance, mean(x²) − mean(x)² clamped at 0 (biased), the output
    (x − mean) · (rsqrt(var + eps) · scale) + bias, and the running update
    ra = 0.99 · ra + 0.01 · stat with the biased variance. torch's own
    training step updates `running_var` with the unbiased variance, n/(n−1)
    away from flax's. In a data-parallel step (`parallel.mesh.sync_norms`)
    the statistics are the whole batch's over the ranks (`global_moments`,
    differentiably), as XLA's SPMD step computes flax's norm over the
    global batch."""
    x = at_least_fp32(x)
    mean, var = global_moments(x, dims)
    with torch.no_grad():
        m = bn.momentum
        bn.running_mean.mul_(1 - m).add_(m * mean)
        bn.running_var.mul_(1 - m).add_(m * var)
        bn.num_batches_tracked.add_(1)
    shape = [-1 if d == 1 else 1 for d in range(x.dim())]
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    return (x - mean.view(shape)) * mul.view(shape) + bn.bias.view(shape)


class FlaxBatchNorm2d(nn.BatchNorm2d):
    """`nn.BatchNorm2d` (the same parameters, buffers and eval forward) with
    flax's `BatchNorm` in training (`_flax_batch_norm`) over N, H and W."""

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        return _flax_batch_norm(self, x, (0, 2, 3))


class FlaxBatchNorm1d(nn.BatchNorm1d):
    """`nn.BatchNorm1d` on [N, C] with flax's `BatchNorm` in training
    (`_flax_batch_norm`) over all N rows."""

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        return _flax_batch_norm(self, x, (0,))


def same_padding(size: int, kernel: int, stride: int):
    """(before, after) padding of one axis under flax/XLA "SAME": the output
    is ceil(size / stride) and an odd total pads one more after (so a 3x3
    stride-2 conv on an even size pads 0 before, 1 after)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _norm(channels, use_groupnorm, num_groups):
    if use_groupnorm:
        return nn.GroupNorm(num_groups, channels, eps=1e-3)
    return FlaxBatchNorm2d(channels, eps=1e-3, momentum=0.01)


class ConvBlock(nn.Module):
    """Conv2d (SAME padding, no bias) → BatchNorm | GroupNorm → ReLU."""

    def __init__(self, in_channels, features, kernel_size=3, stride=1,
                 use_groupnorm=False, num_groups=32, dtype=None):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.dtype = dtype
        self.conv = nn.Conv2d(in_channels, features, kernel_size, stride,
                              padding=0, bias=False)
        self.norm = _norm(features, use_groupnorm, num_groups)

    def forward(self, x, pad_h=None):
        """x [B, C, H, W]; `pad_h` (before, after) rows of zeros in place of
        H's SAME padding (the row-sharded forward, `parallel/spatial.py`,
        brings its halo rows and pads none)."""
        H, W = x.shape[-2:]
        ph = same_padding(H, self.kernel_size, self.stride) \
            if pad_h is None else pad_h
        pw = same_padding(W, self.kernel_size, self.stride)
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
        dtype = self.dtype or x.dtype
        x = F.conv2d(x.to(dtype), self.conv.weight.to(dtype),
                     stride=self.stride)
        return F.relu(self.norm(at_least_fp32(x)))


class DeconvBlock(nn.Module):
    """ConvTranspose2d (kernel = stride, no bias) → norm → ReLU."""

    def __init__(self, in_channels, features, stride=1, use_groupnorm=False,
                 num_groups=32, dtype=None):
        super().__init__()
        self.stride = stride
        self.dtype = dtype
        self.conv = nn.ConvTranspose2d(in_channels, features, stride, stride,
                                       bias=False)
        self.norm = _norm(features, use_groupnorm, num_groups)

    def forward(self, x):
        dtype = self.dtype or x.dtype
        x = F.conv_transpose2d(x.to(dtype), self.conv.weight.to(dtype),
                               stride=self.stride)
        return F.relu(self.norm(at_least_fp32(x)))


class DenseBNReLU(nn.Module):
    """Linear (no bias) → BatchNorm → ReLU over the last axis, fp32 (the
    pillar encoder's layer). The norm sees x.reshape(-1, C), every row of
    it: in JAX's too, padded points and padded pillars count in the batch
    statistics (this is not the sparse middle's masked norm)."""

    def __init__(self, in_features, features):
        super().__init__()
        self.linear = nn.Linear(in_features, features, bias=False)
        self.norm = FlaxBatchNorm1d(features, eps=1e-3, momentum=0.01)

    def forward(self, x):
        c = self.linear.out_features
        y = self.norm(self.linear(x).reshape(-1, c))
        return F.relu(y).reshape(*x.shape[:-1], c)
