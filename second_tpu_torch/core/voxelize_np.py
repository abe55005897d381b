"""Host-side (numpy) point-cloud voxelizer.

Behavioral equivalent of the reference's `spconv.utils.VoxelGenerator` (built in
`second/builder/voxel_builder.py:23-27`; `generate(points)` → voxels [V, T, C],
coords [V, 3] in zyx, num_points [V]): points are binned in arrival order,
each voxel keeps its first `max_num_points` points, and at most `max_voxels`
voxels (in first-occurrence order) are produced. The on-device JAX twin lives in
`second_tpu/ops/voxelize.py`.
"""

from __future__ import annotations

import numpy as np


class VoxelGenerator:
    def __init__(self, voxel_size, point_cloud_range, max_num_points,
                 max_voxels=20000):
        point_cloud_range = np.array(point_cloud_range, dtype=np.float32)
        voxel_size = np.array(voxel_size, dtype=np.float32)
        grid_size = np.round(
            (point_cloud_range[3:] - point_cloud_range[:3]) / voxel_size
        ).astype(np.int64)
        self._voxel_size = voxel_size
        self._point_cloud_range = point_cloud_range
        self._max_num_points = max_num_points
        self._max_voxels = max_voxels
        self._grid_size = grid_size  # xyz

    @property
    def voxel_size(self):
        return self._voxel_size

    @property
    def max_num_points_per_voxel(self):
        return self._max_num_points

    @property
    def point_cloud_range(self):
        return self._point_cloud_range

    @property
    def grid_size(self):
        return self._grid_size

    def generate(self, points, max_voxels=None):
        return points_to_voxel(points, self._voxel_size,
                               self._point_cloud_range, self._max_num_points,
                               max_voxels or self._max_voxels)


def points_to_voxel(points, voxel_size, point_cloud_range, max_points=35,
                    max_voxels=20000):
    """Bin points into voxels, first-come order.

    Args:
        points: [P, C>=3] float array, xyz in the leading columns.
    Returns:
        voxels [V, max_points, C], coords [V, 3] int32 **zyx**, num_points [V].
    """
    points = np.asarray(points)
    voxel_size = np.asarray(voxel_size, dtype=points.dtype)
    pc_range = np.asarray(point_cloud_range, dtype=points.dtype)
    grid_size = np.round((pc_range[3:] - pc_range[:3]) / voxel_size).astype(np.int64)

    coords = np.floor((points[:, :3] - pc_range[:3]) / voxel_size).astype(np.int64)
    in_range = ((coords >= 0) & (coords < grid_size)).all(axis=1)
    pt_idx = np.flatnonzero(in_range)
    coords = coords[pt_idx]

    # linear voxel id (x-major is irrelevant as long as it's a bijection)
    lin = (coords[:, 2] * grid_size[1] + coords[:, 1]) * grid_size[0] + coords[:, 0]
    uniq, first_idx, inverse = np.unique(lin, return_index=True,
                                         return_inverse=True)
    # voxels ordered by first occurrence in the original point stream
    order = np.argsort(first_idx, kind="stable")
    voxel_rank = np.empty_like(order)
    voxel_rank[order] = np.arange(len(order))
    point_voxel = voxel_rank[inverse]            # per-point voxel index

    num_voxels = min(len(uniq), max_voxels)
    keep_voxel = point_voxel < num_voxels

    # slot of each point within its voxel, in original order
    sort_key = np.argsort(point_voxel, kind="stable")
    sorted_voxel = point_voxel[sort_key]
    group_start = np.searchsorted(sorted_voxel, np.arange(len(uniq)))
    slot_sorted = np.arange(len(sorted_voxel)) - group_start[sorted_voxel]
    slot = np.empty_like(slot_sorted)
    slot[sort_key] = slot_sorted

    keep = keep_voxel & (slot < max_points)
    C = points.shape[1]
    voxels = np.zeros((num_voxels, max_points, C), dtype=points.dtype)
    voxels[point_voxel[keep], slot[keep]] = points[pt_idx[keep]]
    num_points = np.bincount(point_voxel[keep], minlength=num_voxels).astype(np.int32)

    coords_zyx = coords[:, ::-1][first_idx[order[:num_voxels]]].astype(np.int32)
    return voxels, coords_zyx, num_points
