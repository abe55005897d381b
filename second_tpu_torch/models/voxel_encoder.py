"""Voxel feature encoders — the port of `second_tpu/models/voxel_encoder.py`:
`VFELayer`, `VoxelFeatureExtractor`, `VoxelFeatureExtractorV2`,
`VoxelFeatureExtractorV3` (the fhd configs' encoder), `SimpleVoxel` and
`PillarFeatureNet` (PointPillars' pillar encoder).

Every encoder maps (voxels [B, V, T, C], num_points [B, V], coords
[B, V, 3] zyx) → per-voxel features [B, V, W], W = `out_width(num_filters,
num_input_features)`, a static rule of each class that sizes the middle's
first conv. The encoders with layers (`takes_point_width`) size their
first from the points' width `num_input_features`; the parameter-free
ones take no such argument. The encoders stay fp32 under mixed
precision, as JAX's (`build_voxelnet` gives them no dtype). Every max over
a voxel's points is an `amax`: where entries tie, its gradient is shared
evenly among them, as JAX's is (`torch.max(dim)` gives it all to one).
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


def _decorated(voxels, num_points, with_distance):
    """[p, p_xyz − cluster mean (`_cluster_center_offset`), |p_xyz|
    where asked]: the point features the VFE layers take."""
    feats = [voxels, _cluster_center_offset(voxels, num_points)]
    if with_distance:
        feats.append(torch.linalg.norm(voxels[..., :3], dim=-1,
                                       keepdim=True))
    return torch.cat(feats, -1)


class VFELayer(nn.Module):
    """Pointwise Linear + BatchNorm + ReLU to features // 2, masked, then
    the max over the voxel's points concatenated back to each point: out
    2 · (features // 2) wide."""

    def __init__(self, in_features, features):
        super().__init__()
        self.dense = DenseBNReLU(in_features, features // 2)
        self.out_channels = 2 * (features // 2)

    def forward(self, x, mask):
        pw = self.dense(x) * mask
        agg = pw.amax(dim=-2, keepdim=True).expand_as(pw)
        return torch.cat([pw, agg], -1)


class VoxelFeatureExtractorV2(nn.Module):
    """A `VFELayer` for each of num_filters[:-1], then a Linear + BatchNorm
    + ReLU to num_filters[-1], masked, then the max over the points. The
    decorated input is not masked (JAX's is not); the norms see every
    row."""

    takes_point_width = True

    @staticmethod
    def out_width(num_filters, num_input_features):
        return num_filters[-1]

    def __init__(self, num_filters: Sequence[int] = (32, 128),
                 with_distance=False, num_input_features=4):
        super().__init__()
        self.with_distance = with_distance
        cin = num_input_features + 3 + int(with_distance)
        self.vfe_layers = nn.ModuleList()
        for f in num_filters[:-1]:
            self.vfe_layers.append(VFELayer(cin, f))
            cin = self.vfe_layers[-1].out_channels
        self.layers = nn.ModuleList([DenseBNReLU(cin, num_filters[-1])])
        self.out_channels = num_filters[-1]

    def forward(self, voxels, num_points, coords=None):
        mask = _points_mask(voxels, num_points)
        x = _decorated(voxels, num_points, self.with_distance)
        for layer in self.vfe_layers:
            x = layer(x, mask)
        return (self.layers[0](x) * mask).amax(dim=-2)


class VoxelFeatureExtractor(VoxelFeatureExtractorV2):
    """Two `VFELayer`s (num_filters[0], num_filters[1]) and a final Linear +
    BatchNorm + ReLU to num_filters[1]: V2 with the filters (f0, f1, f1)."""

    @staticmethod
    def out_width(num_filters, num_input_features):
        return num_filters[1]

    def __init__(self, num_filters: Sequence[int] = (32, 128),
                 with_distance=False, num_input_features=4):
        f0, f1 = num_filters[:2]
        super().__init__((f0, f1, f1), with_distance, num_input_features)


class VoxelFeatureExtractorV3(nn.Module):
    """Per-voxel mean of the raw point features; no parameters.
    voxels [B, V, T, C], num_points [B, V] → [B, V, C]."""

    takes_point_width = False

    @staticmethod
    def out_width(num_filters, num_input_features):
        return num_input_features

    def __init__(self, num_filters=(16,), with_distance=False):
        super().__init__()

    def forward(self, voxels, num_points, coords=None):
        denom = torch.clamp(num_points, min=1).to(voxels.dtype)[..., None]
        return voxels.sum(dim=-2) / denom


class SimpleVoxel(nn.Module):
    """The mean xyz of the voxel's points and the max of the rest of their
    features (reflectance); no parameters. The max is not masked, as JAX's
    is not: the padded zero slots take part in it."""

    takes_point_width = False

    @staticmethod
    def out_width(num_filters, num_input_features):
        return num_input_features

    def __init__(self, num_filters=(16,), with_distance=False):
        super().__init__()

    def forward(self, voxels, num_points, coords=None):
        denom = torch.clamp(num_points, min=1).to(voxels.dtype)[..., None]
        mean = voxels[..., :3].sum(dim=-2) / denom
        if voxels.shape[-1] <= 3:
            return mean
        return torch.cat([mean, voxels[..., 3:].amax(dim=-2)], -1)


class PillarFeatureNet(nn.Module):
    """PointPillars pillar encoder: each point decorated to [p, p − cluster
    mean, p_xy − pillar centre] (9 features for 4-feature points, the pillar
    centre from the zyx coords), masked, then per filter Linear + BatchNorm
    + ReLU and the mask again, then the max over the pillar's points."""

    takes_point_width = True

    @staticmethod
    def out_width(num_filters, num_input_features):
        return num_filters[-1]

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
        self.out_channels = cin

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
    "VoxelFeatureExtractor": VoxelFeatureExtractor,
    "VoxelFeatureExtractorV2": VoxelFeatureExtractorV2,
    "VoxelFeatureExtractorV3": VoxelFeatureExtractorV3,
    "SimpleVoxel": SimpleVoxel,
    "PillarFeatureNet": PillarFeatureNet,
}
