"""Sparse middle extractor — the port of `second_tpu/models/sparse_middle.py`
(`MaskedBatchNorm`, `SubMBlock`, `DownBlock`, `SparseMiddleFHD`).

Activations are batched active sets (coords, features, valid, keys) of
static capacity; every sparse conv applies through the gather-GEMM kernel.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from ..device import at_least_fp32
from ..ops import sparse_conv as sp
from .middle import register_middle


class MaskedBatchNorm(nn.Module):
    """BatchNorm over the valid rows of [B, N, C] active-set features, in
    fp32 whatever the input dtype (fp64 stays fp64, as `at_least_fp32`);
    invalid rows come out zero. Training
    normalises with the masked batch statistics (the valid-row count
    clamped to 1, the biased variance) and updates the running statistics
    as ra = 0.99 · ra + 0.01 · stat, as JAX's does
    (`second_tpu/models/sparse_middle.py:42-50`); eval uses the running
    statistics."""

    MOMENTUM = 0.99                     # flax's: the running share kept

    def __init__(self, channels, eps=1e-3):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x, mask):
        out_dtype = x.dtype
        x = at_least_fp32(x)
        m = mask[..., None].to(x.dtype)
        if self.training:
            count = torch.clamp(m.sum(), min=1.0)
            mean = (x * m).sum((0, 1)) / count
            var = (torch.square(x - mean) * m).sum((0, 1)) / count
            with torch.no_grad():
                keep = self.MOMENTUM
                self.running_mean.mul_(keep).add_((1 - keep) * mean)
                self.running_var.mul_(keep).add_((1 - keep) * var)
        else:
            mean, var = self.running_mean, self.running_var
        y = (x - mean) * torch.rsqrt(var + self.eps)
        y = (y * self.weight + self.bias) * m
        return y.to(out_dtype)


class SubMBlock(nn.Module):
    """SubMConv3d(k=3) → masked BN → ReLU."""

    def __init__(self, in_channels, features):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(27, in_channels, features))
        self.bn = MaskedBatchNorm(features)

    def forward(self, feats, coords, keys, valid, grid_dhw, rulebook):
        out = sp.subm_conv3d_b(feats, coords, keys, valid, grid_dhw,
                               self.weight, rulebook=rulebook)
        out = self.bn(out, valid)
        return (torch.relu(out) * valid[..., None]).to(feats.dtype)


class DownBlock(nn.Module):
    """SparseConv3d(stride) → masked BN → ReLU; emits a new active set and
    the number of active output sites cut by the capacity."""

    def __init__(self, in_channels, features, kernel_size=(3, 3, 3),
                 stride=(2, 2, 2), padding=(1, 1, 1)):
        super().__init__()
        self.kernel_size = tuple(kernel_size)
        self.stride = tuple(stride)
        self.padding = tuple(padding)
        K = int(np.prod(self.kernel_size))
        self.weight = nn.Parameter(torch.empty(K, in_channels, features))
        self.bn = MaskedBatchNorm(features)

    def forward(self, feats, coords, keys, valid, grid_dhw, out_cap):
        out, oc, ok, ov, out_grid, nu = sp.sparse_conv3d_b(
            feats, coords, keys, valid, grid_dhw, self.weight,
            self.kernel_size, self.stride, self.padding, out_cap)
        overflow = torch.clamp(nu - out_cap, min=0).sum()
        out = self.bn(out, ov)
        out = (torch.relu(out) * ov[..., None]).to(feats.dtype)
        return out, oc, ok, ov, out_grid, overflow


def _round_cap(n: float, multiple: int = 1024) -> int:
    """Round a stage capacity up to a multiple of 1024."""
    return max(multiple, int(-(-n // multiple)) * multiple)


# Per-stage active-site capacity as a fraction of the input voxel capacity:
# the strided convs shrink LiDAR-scan active sets (1.0 → 0.84 → 0.40 → 0.17
# → 0.17 of N at fhd resolution), so the stages are sized to that profile
# with headroom. Truncation shows in each DownBlock's overflow count.
FHD_CAP_FACTORS = (1.0, 0.75, 0.375, 0.25)


class SparseMiddleFHD(nn.Module):
    """SpMiddleFHD: SubM×2(16) → down(32) → SubM×2(32) → down(64) →
    SubM×3(64) → down(64, pad (0,1,1)) → SubM×3(64) → down (3,1,1)/(2,1,1)
    → dense BEV map [B, D*C, H, W] (channel index d*C + c).

    output_shape: dense zyx grid (D, H, W) = voxel grid + (1, 0, 0)."""

    def __init__(self, output_shape: Sequence[int], num_input_features=4,
                 channels: Sequence[int] = (16, 32, 64, 64, 64),
                 cap_factors: Sequence[float] = FHD_CAP_FACTORS,
                 dtype=None):
        super().__init__()
        self.grid0 = tuple(int(v) for v in output_shape)
        self.cap_factors = tuple(cap_factors)
        self.dtype = dtype
        c16, c32, c64, c64b, c64c = channels
        subm = [(num_input_features, c16), (c16, c16), (c32, c32),
                (c32, c32), (c64, c64), (c64, c64), (c64, c64),
                (c64b, c64b), (c64b, c64b), (c64b, c64b)]
        self.subm = nn.ModuleList(SubMBlock(i, o) for i, o in subm)
        self.down = nn.ModuleList([
            DownBlock(c16, c32),
            DownBlock(c32, c64),
            DownBlock(c64, c64b, padding=(0, 1, 1)),
            DownBlock(c64b, c64c, kernel_size=(3, 1, 1), stride=(2, 1, 1),
                      padding=(0, 0, 0)),
        ])
        self.stage_subm = (2, 2, 3, 3)
        grid = self.grid0
        for d in self.down:
            grid = sp.out_grid(grid, d.kernel_size, d.stride, d.padding)
        self.out_channels = grid[0] * c64c     # BEV channels D*C

    def forward(self, voxel_features, coords, valid):
        """voxel_features [B, N, C], coords [B, N, 3] zyx, valid [B, N] →
        (bev [B, D*C, H, W], stage_overflow scalar tensor)."""
        N = voxel_features.shape[1]
        caps = [_round_cap(N * f) for f in self.cap_factors]
        if self.dtype is not None:
            voxel_features = voxel_features.to(self.dtype)
        grid = self.grid0
        coords, feats, valid, keys = sp.sort_active(coords, voxel_features,
                                                    valid, grid)
        overflow = torch.zeros((), dtype=torch.int64, device=feats.device)
        j = 0
        for stage, n_subm in enumerate(self.stage_subm):
            rb = sp.subm_rulebook_b(coords, keys, valid, grid)
            for _ in range(n_subm):
                feats = self.subm[j](feats, coords, keys, valid, grid, rb)
                j += 1
            feats, coords, keys, valid, grid, ovf = self.down[stage](
                feats, coords, keys, valid, grid, caps[stage])
            overflow = overflow + ovf
        dense = sp.densify(feats, coords, valid, grid)    # [B, D, H, W, C]
        B, D, H, W, C = dense.shape
        return (dense.permute(0, 1, 4, 2, 3).reshape(B, D * C, H, W),
                overflow)


register_middle("SpMiddleFHD", SparseMiddleFHD)
