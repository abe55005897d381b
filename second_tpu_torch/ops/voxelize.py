"""Static-shape voxelizer — the port of `second_tpu/ops/voxelize.py`
`voxelize` / `voxelize_batch` (batched, as `voxelize_batch`) and
`second_tpu/train/state.py` `VoxelizeSpec` / `device_voxelize`.

Sort-based, on whatever device the points lie on: points are keyed by
voxel id, stably sorted (invalid rows last), segmented and scattered into
fixed-capacity buffers. Voxels come out in ascending key order; each
voxel's points keep their arrival order; over capacity the smallest keys
win (or, with `shuffle_overflow`, the smallest Knuth-hashed keys, a
pseudorandom spatially uniform subset).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..device import constant, resolve_device
from .cuda.gather import gather_rows


def voxelize(points, points_mask, *, voxel_size, point_cloud_range,
             max_points, max_voxels, shuffle_overflow=False):
    """Bin a batch of padded point clouds into fixed-capacity voxels.

    points [B, P, C] float (xyz leading), points_mask [B, P] bool. Returns a
    dict of voxels [B, V, T, C], coords [B, V, 3] int32 zyx (-1 for empty
    slots), num_points [B, V] int32, num_voxels [B] int32, point_voxel
    [B, P] int32 (-1 for dropped points) and voxel_overflow [B] int32
    (occupied voxels beyond capacity)."""
    dev = points.device
    B, P, C = points.shape
    V, T = int(max_voxels), int(max_points)
    vsize = np.asarray(voxel_size, np.float32)
    pc_range = np.asarray(point_cloud_range, np.float32)
    grid = np.round((pc_range[3:] - pc_range[:3]) / vsize).astype(np.int64)

    coords = torch.floor(
        (points[..., :3] - constant(pc_range[:3], dev)) /
        constant(vsize, dev)).to(torch.int32)                    # xyz
    in_range = ((coords >= 0) & (coords < constant(grid, dev))).all(-1)
    valid = in_range & points_mask
    c64 = coords.long()
    lin = (c64[..., 2] * int(grid[1]) + c64[..., 1]) * int(grid[0]) + \
        c64[..., 0]
    if shuffle_overflow:
        # Knuth multiplicative hash: an odd multiplier mod 2^32 is a
        # bijection, so equal keys still mean equal voxels
        skey = (lin * 2654435761) & 0xFFFFFFFF
    else:
        skey = lin & 0xFFFFFFFF
    # one int64 key: invalid rows after every valid one, then the voxel key
    key = torch.where(valid, skey, 0) + ((~valid).long() << 32)
    key_s, order = torch.sort(key, dim=1, stable=True)
    flat_order = (order + (torch.arange(B, device=dev) * P)[:, None]
                  ).reshape(-1)
    pts_s = gather_rows(points.reshape(B * P, C), flat_order)
    coords_s = gather_rows(coords.reshape(B * P, 3), flat_order)
    valid_s = (key_s >> 32) == 0

    is_first = torch.cat(
        [valid_s[:, :1], (key_s[:, 1:] != key_s[:, :-1]) & valid_s[:, 1:]],
        dim=1)
    voxel_idx = torch.cumsum(is_first, dim=1) - 1                # [B, P]
    num_unique = torch.where(valid_s.any(1), voxel_idx[:, -1] + 1, 0)
    num_voxels = torch.clamp(num_unique, max=V).to(torch.int32)

    # slot of each point within its voxel (the stable sort kept arrival order)
    idx = torch.arange(P, device=dev).expand(B, P)
    seg_start = torch.cummax(torch.where(is_first, idx, 0), dim=1).values
    slot = idx - seg_start

    keep = valid_s & (slot < T) & (voxel_idx < V)
    boff = (torch.arange(B, device=dev) * V)[:, None]
    vflat = torch.where(keep, boff + voxel_idx, B * V).reshape(-1)
    voxels = torch.zeros((B * V * T + 1, C), dtype=points.dtype, device=dev)
    voxels[torch.where(keep.reshape(-1), vflat * T + slot.reshape(-1),
                       B * V * T)] = pts_s
    voxels = voxels[:B * V * T].reshape(B, V, T, C)

    num_points = torch.zeros((B * V + 1,), dtype=torch.int32, device=dev)
    num_points.index_add_(0, vflat, torch.ones_like(vflat, dtype=torch.int32))
    num_points = num_points[:B * V].reshape(B, V)

    first = (is_first & (voxel_idx < V)).reshape(-1)
    coords_zyx = torch.full((B * V + 1, 3), -1, dtype=torch.int32, device=dev)
    coords_zyx[torch.where(first, (boff + voxel_idx).reshape(-1), B * V)] = \
        coords_s.flip(-1)
    coords_zyx = coords_zyx[:B * V].reshape(B, V, 3)

    point_voxel = torch.full((B, P), -1, dtype=torch.int32, device=dev)
    point_voxel.scatter_(1, order,
                         torch.where(keep, voxel_idx, -1).to(torch.int32))

    return {
        "voxels": voxels,
        "coords": coords_zyx,
        "num_points": num_points,
        "num_voxels": num_voxels,
        "point_voxel": point_voxel,
        "voxel_overflow": torch.clamp(num_unique - V, min=0).to(torch.int32),
    }


def voxelize_batch(points, points_mask, **kw):
    """JAX's `voxelize_batch` (its `voxelize` mapped over a leading batch
    axis): this module's `voxelize`, which takes the batch itself."""
    return voxelize(points, points_mask, **kw)


@dataclasses.dataclass(frozen=True)
class VoxelizeSpec:
    """Static voxelizer parameters (from VoxelGeneratorConfig)."""
    voxel_size: Tuple[float, float, float]
    point_cloud_range: Tuple[float, ...]
    max_points: int
    max_voxels: int
    shuffle_overflow: bool = False

    @classmethod
    def from_config(cls, vg_cfg, max_voxels, shuffle_overflow=False):
        return cls(voxel_size=tuple(vg_cfg.voxel_size),
                   point_cloud_range=tuple(vg_cfg.point_cloud_range),
                   max_points=vg_cfg.max_number_of_points_per_voxel,
                   max_voxels=max_voxels,
                   shuffle_overflow=shuffle_overflow)


def device_voxelize(vspec: VoxelizeSpec, points, points_mask,
                    device="cuda"):
    """Batched voxelization → model-ready tensors on `device`.

    points [B, P, C] and points_mask [B, P] (numpy arrays or tensors) are
    moved to `device` first: the CUDA card unless the caller asks for the
    CPU."""
    dev = resolve_device(device)
    points = torch.as_tensor(points, device=dev)
    points_mask = torch.as_tensor(points_mask, device=dev)
    out = voxelize(points, points_mask, voxel_size=vspec.voxel_size,
                   point_cloud_range=vspec.point_cloud_range,
                   max_points=vspec.max_points, max_voxels=vspec.max_voxels,
                   shuffle_overflow=vspec.shuffle_overflow)
    V = vspec.max_voxels
    voxel_valid = torch.arange(V, device=dev)[None, :] < \
        out["num_voxels"][:, None]
    return {
        "voxels": out["voxels"],
        "num_points": out["num_points"],
        "coordinates": torch.where(voxel_valid[..., None], out["coords"], 0),
        "voxel_valid": voxel_valid,
        "voxel_overflow": out["voxel_overflow"].sum(),
    }
