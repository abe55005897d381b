"""Middle feature extractors: voxel features → dense BEV maps — the port of
`second_tpu/models/middle.py` (`PointPillarsScatter` and the registry), in
NCHW. The sparse middles register themselves from `sparse_middle.py`."""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

MIDDLE_REGISTRY = {}


def register_middle(name, cls):
    MIDDLE_REGISTRY[name] = cls
    return cls


class PointPillarsScatter(nn.Module):
    """Scatter per-pillar features onto the BEV canvas [B, C, ny, nx].

    Each valid pillar writes its features at (y, x) of its zyx coords;
    invalid rows go to one spare slot past the canvas, which is dropped (JAX
    sends them to index ny·nx with mode="drop"). The voxelizer makes each
    valid pillar's (y, x) unique in its example, so the canvas is the same
    on every run, and the gradient of the scatter is a gather."""

    def __init__(self, output_shape: Sequence[int], num_input_features=64):
        super().__init__()
        self.ny, self.nx = (int(s) for s in output_shape)
        self.out_channels = num_input_features

    def forward(self, voxel_features, coords, valid):
        """voxel_features [B, V, C], coords [B, V, 3] zyx, valid [B, V] →
        (bev [B, C, ny, nx], stage_overflow 0: nothing is cut here)."""
        B, V, C = voxel_features.shape
        hw = self.ny * self.nx
        dev = voxel_features.device
        lin = coords[..., 1].long() * self.nx + coords[..., 2].long()
        # flat index b·C·hw + c·hw + lin into a [B, C, hw] canvas, plus one
        # slot at the end for the invalid rows
        base = (torch.arange(B, device=dev) * (C * hw))[:, None, None] + \
            (torch.arange(C, device=dev) * hw)[None, None, :]
        idx = torch.where(valid[..., None], base + lin[..., None], B * C * hw)
        feats = torch.where(valid[..., None], voxel_features, 0.0)
        canvas = voxel_features.new_zeros(B * C * hw + 1).scatter(
            0, idx.reshape(-1), feats.reshape(-1))
        overflow = torch.zeros((), dtype=torch.int64, device=dev)
        return canvas[:B * C * hw].view(B, C, self.ny, self.nx), overflow


register_middle("PointPillarsScatter", PointPillarsScatter)
