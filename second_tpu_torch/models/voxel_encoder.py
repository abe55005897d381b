"""Voxel feature encoders — the port of `second_tpu/models/voxel_encoder.py`
(`VoxelFeatureExtractorV3`, the fhd configs' encoder)."""

from __future__ import annotations

import torch
from torch import nn


class VoxelFeatureExtractorV3(nn.Module):
    """Per-voxel mean of the raw point features; no parameters.
    voxels [B, V, T, C], num_points [B, V] → [B, V, C]."""

    def __init__(self, num_filters=(16,), use_norm=True, with_distance=False):
        super().__init__()

    def forward(self, voxels, num_points, coords=None):
        denom = torch.clamp(num_points, min=1).to(voxels.dtype)[..., None]
        return voxels.sum(dim=-2) / denom


VFE_REGISTRY = {
    "VoxelFeatureExtractorV3": VoxelFeatureExtractorV3,
}
