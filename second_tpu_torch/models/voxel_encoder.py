"""Voxel feature encoders — the port of `second_tpu/models/voxel_encoder.py`
(`VoxelFeatureExtractorV3`, the fhd configs' encoder, and
`PillarFeatureNet`, PointPillars' pillar encoder).

Every encoder maps (voxels [B, V, T, C], num_points [B, V], coords
[B, V, 3] zyx) → per-voxel features [B, V, C_out]. The pillar encoder stays
fp32 under mixed precision, as JAX's (`build_voxelnet` gives it no dtype).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .layers import DenseBNReLU


def _points_mask(voxels, num_points):
    """[B, V, T, 1] in the voxels' dtype: 1 for the first num_points slots
    of each voxel."""
    T = voxels.shape[-2]
    idx = torch.arange(T, device=voxels.device)
    return (idx < num_points[..., None]).to(voxels.dtype)[..., None]


def _cluster_center_offset(voxels, num_points):
    """JAX's "offset from the cluster centre", as JAX computes it: the sum
    runs over axis -3, the voxels of the example, not over axis -2, the
    points of the voxel, so `mean[b, v, t]` is the sum of slot t's xyz over
    all voxels divided by voxel v's point count (the reference's torch code
    sums over the points). The port keeps JAX's semantics: the JAX package
    is the reference it is held to (ROADMAP §3)."""
    denom = torch.clamp(num_points, min=1).to(voxels.dtype)[..., None, None]
    mean = voxels[..., :3].sum(-3, keepdim=True) / denom
    return voxels[..., :3] - mean


class VoxelFeatureExtractorV3(nn.Module):
    """Per-voxel mean of the raw point features; no parameters.
    voxels [B, V, T, C], num_points [B, V] → [B, V, C]."""

    def __init__(self, num_filters=(16,), use_norm=True, with_distance=False):
        super().__init__()

    def forward(self, voxels, num_points, coords=None):
        denom = torch.clamp(num_points, min=1).to(voxels.dtype)[..., None]
        return voxels.sum(dim=-2) / denom


class PillarFeatureNet(nn.Module):
    """PointPillars pillar encoder: each point decorated to [p, p − cluster
    mean, p_xy − pillar centre] (9 features for 4-feature points, the pillar
    centre from the zyx coords), masked, then per filter Linear + BatchNorm
    + ReLU and the mask again, then the max over the pillar's points.

    The max is `amax`: where entries tie, its gradient is shared evenly
    among them, as JAX's is (`torch.max(dim)` gives it all to one)."""

    def __init__(self, num_filters: Sequence[int] = (64,),
                 with_distance=False, voxel_size=(0.16, 0.16, 4.0),
                 pc_range=(0.0, -39.68, -3.0, 69.12, 39.68, 1.0),
                 num_input_features=4):
        super().__init__()
        self.with_distance = with_distance
        self.voxel_size = tuple(float(v) for v in voxel_size)
        self.pc_range = tuple(float(v) for v in pc_range)
        cin = num_input_features + 5 + int(with_distance)
        self.layers = nn.ModuleList()
        for f in num_filters:
            self.layers.append(DenseBNReLU(cin, f))
            cin = f

    def forward(self, voxels, num_points, coords):
        mask = _points_mask(voxels, num_points)
        vx, vy = self.voxel_size[:2]
        x0, y0 = self.pc_range[:2]
        # Python floats: a tensor of them would copy to the card at each call
        cx = (coords[..., 2:3].to(voxels.dtype) + 0.5) * vx + x0
        cy = (coords[..., 1:2].to(voxels.dtype) + 0.5) * vy + y0
        center = torch.cat([cx, cy], -1)[..., None, :]
        feats = [voxels, _cluster_center_offset(voxels, num_points),
                 voxels[..., :2] - center]
        if self.with_distance:
            feats.append(torch.linalg.norm(voxels[..., :3], dim=-1,
                                           keepdim=True))
        x = torch.cat(feats, -1) * mask
        for layer in self.layers:
            x = layer(x) * mask
        return x.amax(dim=-2)


VFE_REGISTRY = {
    "VoxelFeatureExtractorV3": VoxelFeatureExtractorV3,
    "PillarFeatureNet": PillarFeatureNet,
}
