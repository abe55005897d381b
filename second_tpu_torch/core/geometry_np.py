"""Host-side convex-polygon / surface geometry (vectorized numpy).

Equivalent of the reference's numba kernels in `second/core/geometry.py`
(`points_in_convex_polygon_3d_jit :96-143`, surface equations `:84-93`, 2D polygon
test `:146-202`) — the hot predicates behind frustum culling and points-in-box.
"""

from __future__ import annotations

import numpy as np


def corner_to_surfaces_3d(corners):
    """3D box corners [N, 8, 3] → 6 quad surfaces [N, 6, 4, 3] whose normals all
    point inward (reference `box_np_ops.py:705-723`)."""
    idx = np.array([
        [0, 1, 2, 3],
        [7, 6, 5, 4],
        [0, 3, 7, 4],
        [1, 5, 6, 2],
        [0, 4, 5, 1],
        [3, 2, 6, 7],
    ])
    return corners[:, idx, :]


def surface_equ_3d(polygon_surfaces):
    """Plane normal + offset for each surface from its first three vertices.

    polygon_surfaces: [N, S, 4(or more), 3]. Returns (normals [N, S, 3],
    d [N, S]) with the plane written n·x + d = 0... matching the reference's
    sign convention (`geometry.py:84-93`): d = -n·p0.
    """
    sv0 = polygon_surfaces[:, :, 0, :] - polygon_surfaces[:, :, 1, :]
    sv1 = polygon_surfaces[:, :, 1, :] - polygon_surfaces[:, :, 2, :]
    normal = np.cross(sv0, sv1)
    d = -np.einsum("nsk,nsk->ns", normal, polygon_surfaces[:, :, 0, :])
    return normal, d


def points_in_convex_polygon_3d(points, polygon_surfaces, num_surfaces=None):
    """Boolean [num_points, num_polygons] test: inside iff n·x + d <= 0 for all
    surfaces (inward normals). Vectorized form of `geometry.py:96-143`."""
    normals, d = surface_equ_3d(polygon_surfaces[:, :, :3, :])
    # sign[p, n, s] = points[p]·normals[n, s] + d[n, s]
    sign = np.einsum("pk,nsk->pns", points, normals) + d[None, :, :]
    if num_surfaces is not None:
        max_s = polygon_surfaces.shape[1]
        valid = np.arange(max_s)[None, :] < np.asarray(num_surfaces)[:, None]
        sign = np.where(valid[None, :, :], sign, -1.0)
    return (sign < 0).all(axis=-1)


def points_in_convex_polygon_2d(points, polygon, clockwise=True):
    """Boolean [num_points, num_polygons] test for 2D convex polygons
    [N, V, 2] (vectorized form of `geometry.py:146-202`)."""
    polygon = np.asarray(polygon)
    num_points_of_polygon = polygon.shape[1]
    if clockwise:
        vec1 = polygon - polygon[:, np.concatenate(
            [[num_points_of_polygon - 1], np.arange(num_points_of_polygon - 1)])]
    else:
        vec1 = polygon[:, np.concatenate(
            [[num_points_of_polygon - 1], np.arange(num_points_of_polygon - 1)])] - polygon
    # cross[p, n, v] = vec1[n, v] x (points[p] - polygon[n, v])
    rel = points[:, None, None, :2] - polygon[None, :, :, :]
    cross = vec1[None, :, :, 0] * rel[..., 1] - vec1[None, :, :, 1] * rel[..., 0]
    return (cross <= 0).all(axis=-1)
