"""The occupancy anchors mask (a summed-area table, SAT) from the
voxelizer's coords, on the device — the port of
`second_tpu/ops/anchors_mask.py`.

The host computes the same mask per frame (`data/pipeline.py`
`_compute_anchors_mask`: `sparse_sum_for_anchors_mask` → two cumsums →
`fused_get_anchors_area`); the eval step computes it here from the coords
already on the card, for the whole batch: an occupancy scatter-add, two
cumsums and a four-corner gather. The four SAT corners of each anchor
depend only on the config, and are computed once on the host
(`sat_corner_indices`). The two masks are equal whenever `voxel_overflow`
is 0 (the host voxelizes the raw cloud at a 200 000-voxel cap).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import constant


def sat_corner_indices(anchors_bv, voxel_size, point_cloud_range,
                       grid_size) -> np.ndarray:
    """Per-anchor SAT corner indices [A, 4] int32 (y0, x0, y1, x1), with
    `core/box_np.fused_get_anchors_area`'s index arithmetic (floor, then
    clamp), so the device mask equals the host one. anchors_bv [A, 4] xyxy
    metric BEV boxes; grid_size (gx, gy)."""
    bv = np.asarray(anchors_bv, np.float64)
    sx, sy = float(voxel_size[0]), float(voxel_size[1])
    ox, oy = float(point_cloud_range[0]), float(point_cloud_range[1])
    gx, gy = int(grid_size[0]), int(grid_size[1])
    x0 = np.clip(np.floor((bv[:, 0] - ox) / sx), 0, gx - 1).astype(np.int32)
    y0 = np.clip(np.floor((bv[:, 1] - oy) / sy), 0, gy - 1).astype(np.int32)
    x1 = np.clip(np.floor((bv[:, 2] - ox) / sx), 0, gx - 1).astype(np.int32)
    y1 = np.clip(np.floor((bv[:, 3] - oy) / sy), 0, gy - 1).astype(np.int32)
    return np.stack([y0, x0, y1, x1], axis=1)


def anchors_mask_from_coords(coords, voxel_valid, corners, grid_hw,
                             threshold: float) -> torch.Tensor:
    """[B, A] bool: the anchors whose BEV footprint holds more than
    `threshold` occupied voxels.

    coords [B, V, 3] zyx (invalid rows zeroed), voxel_valid [B, V]; corners
    [A, 4] from `sat_corner_indices`, an integer tensor on the coords'
    device (the eval step uploads it once) or the numpy array itself (then
    a `device.constant`, looked up by value at each call); grid_hw (H, W).
    Occupancy counts each valid voxel once in its (y, x) column, as the
    host scatter does; the area of an anchor is
    sat[y1, x1] − sat[y1, x0] − sat[y0, x1] + sat[y0, x0]. Nothing here
    reads a tensor on the host: the threshold is compared as a Python
    float."""
    B = coords.shape[0]
    H, W = int(grid_hw[0]), int(grid_hw[1])
    dev = coords.device
    lin = (coords[..., 1].long() * W + coords[..., 2].long()) + \
        (torch.arange(B, device=dev) * (H * W))[:, None]
    occ = torch.zeros(B * H * W, dtype=torch.float32, device=dev)
    occ.index_add_(0, lin.reshape(-1), voxel_valid.reshape(-1).float())
    sat = occ.view(B, H, W).cumsum(1).cumsum(2).view(B, H * W)
    if not isinstance(corners, torch.Tensor):
        corners = constant(np.asarray(corners, np.int64), dev)
    y0, x0, y1, x1 = corners.long().unbind(1)
    # the flat SAT index of the corners (y1, x1), (y1, x0), (y0, x1),
    # (y0, x0), in that order: one gather of [B, 4 · A]
    flat = torch.cat([y1 * W + x1, y1 * W + x0, y0 * W + x1, y0 * W + x0])
    d, b, c, a = sat[:, flat].view(B, 4, -1).unbind(1)
    return d - b - c + a > float(threshold)
