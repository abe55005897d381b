"""Shared dense building blocks — the port of `second_tpu/models/layers.py`
(`ConvBlock`, `DeconvBlock`), in NCHW.

`dtype` is the compute dtype of the convolutions (bf16 under mixed
precision); parameters and normalization stay fp32, and normalization
outputs fp32, as flax's BatchNorm does after a bf16 conv. BatchNorm uses
eps 1e-3 and torch momentum 0.01 (flax momentum 0.99), with flax's
training statistics (`FlaxBatchNorm2d`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class FlaxBatchNorm2d(nn.BatchNorm2d):
    """`nn.BatchNorm2d` (the same parameters, buffers and eval forward) with
    flax's `BatchNorm` in training: the batch statistics in fp32 as flax's
    fast variance, mean(x²) − mean(x)² clamped at 0 (biased), the output
    (x − mean) · (rsqrt(var + eps) · scale) + bias, and the running update
    ra = 0.99 · ra + 0.01 · stat with the biased variance. torch's own
    training step updates `running_var` with the unbiased variance, n/(n−1)
    away from flax's."""

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        x = x.float()
        mean = x.mean((0, 2, 3))
        var = torch.clamp((x * x).mean((0, 2, 3)) - mean * mean, min=0.0)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1 - m).add_(m * mean)
            self.running_var.mul_(1 - m).add_(m * var)
            self.num_batches_tracked.add_(1)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean[:, None, None]) * mul[:, None, None] + \
            self.bias[:, None, None]


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

    def forward(self, x):
        H, W = x.shape[-2:]
        ph = same_padding(H, self.kernel_size, self.stride)
        pw = same_padding(W, self.kernel_size, self.stride)
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
        dtype = self.dtype or x.dtype
        x = F.conv2d(x.to(dtype), self.conv.weight.to(dtype),
                     stride=self.stride)
        return F.relu(self.norm(x.float()))


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
        return F.relu(self.norm(x.float()))
