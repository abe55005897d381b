"""Pairwise rotated-box intersection / IoU (vectorized numpy).

Equivalent of the reference's numba-CUDA rotated-IoU device math
(`second/core/non_max_suppression/nms_gpu.py:196-431`: corner generation,
quadrilateral intersection via corner-containment + edge-pair crossings, angular
vertex sort, fan-area) re-expressed as a fully vectorized pairwise computation.
Used by the host oracle for target assignment (RotateIouSimilarity), KITTI eval
BEV/3D overlaps, and as the reference for the JAX device kernel
(`second_tpu/ops/rotated_iou.py`).

Boxes are BEV rotated boxes [x, y, w, l, yaw] with the framework's corner
convention (`core/box_np.center_to_corner_box2d`).
"""

from __future__ import annotations

import numpy as np

from .box_np import center_to_corner_box2d


def rbbox_to_corners(rbboxes):
    """[N, 5(x, y, w, l, yaw)] → [N, 4, 2] corners."""
    return center_to_corner_box2d(
        rbboxes[:, :2], rbboxes[:, 2:4], rbboxes[:, 4])


def _cross2(o, a, b):
    """2D cross product (a - o) x (b - o), broadcasting."""
    return ((a[..., 0] - o[..., 0]) * (b[..., 1] - o[..., 1]) -
            (a[..., 1] - o[..., 1]) * (b[..., 0] - o[..., 0]))


def _points_in_quad(points, quad):
    """points [..., P, 2] inside convex quads [..., 4, 2] (any winding).

    Inside iff the cross products against all four directed edges share a sign.
    """
    p = points[..., :, None, :]          # [..., P, 1, 2]
    v0 = quad[..., None, :, :]           # [..., 1, 4, 2]
    v1 = np.roll(quad, -1, axis=-2)[..., None, :, :]
    cross = ((v1[..., 0] - v0[..., 0]) * (p[..., 1] - v0[..., 1]) -
             (v1[..., 1] - v0[..., 1]) * (p[..., 0] - v0[..., 0]))
    eps = 1e-8
    return np.logical_or((cross >= -eps).all(axis=-1), (cross <= eps).all(axis=-1))


def _segment_intersections(quad1, quad2):
    """All 16 edge-pair intersection points of two quads.

    quad1, quad2: [..., 4, 2]. Returns (points [..., 16, 2], valid [..., 16]).
    """
    a = quad1[..., :, None, :]                       # edge i start  [...,4,1,2]
    b = np.roll(quad1, -1, axis=-2)[..., :, None, :]  # edge i end
    c = quad2[..., None, :, :]                       # edge j start  [...,1,4,2]
    d = np.roll(quad2, -1, axis=-2)[..., None, :, :]
    r = b - a
    s = d - c
    denom = r[..., 0] * s[..., 1] - r[..., 1] * s[..., 0]
    cma = c - a
    t_num = cma[..., 0] * s[..., 1] - cma[..., 1] * s[..., 0]
    u_num = cma[..., 0] * r[..., 1] - cma[..., 1] * r[..., 0]
    safe = np.where(np.abs(denom) < 1e-12, 1.0, denom)
    t = t_num / safe
    u = u_num / safe
    valid = (np.abs(denom) >= 1e-12) & (t >= 0) & (t <= 1) & (u >= 0) & (u <= 1)
    pts = a + t[..., None] * r
    new_shape = pts.shape[:-3] + (16, 2)
    return pts.reshape(new_shape), valid.reshape(new_shape[:-1])


def _convex_area_from_candidates(pts, valid):
    """Area of the convex region given candidate vertices + validity masks.

    pts: [..., M, 2]; valid: [..., M]. Sorts valid vertices by angle around the
    centroid of the valid set and sums the triangle fan — the same construction
    as the reference's `sort_vertex_in_convex_polygon`/`area` device functions.
    """
    cnt = valid.sum(axis=-1)                                    # [...]
    w = valid.astype(pts.dtype)
    denom = np.maximum(cnt, 1)[..., None]
    centroid = (pts * w[..., None]).sum(axis=-2) / denom        # [..., 2]
    rel = pts - centroid[..., None, :]
    ang = np.arctan2(rel[..., 1], rel[..., 0])
    ang = np.where(valid, ang, np.inf)                          # invalid last
    order = np.argsort(ang, axis=-1)
    sorted_pts = np.take_along_axis(pts, order[..., None], axis=-2)
    sorted_valid = np.take_along_axis(valid, order, axis=-1)
    # Next valid vertex is cyclic within the first `cnt` sorted entries.
    M = pts.shape[-2]
    idx = np.arange(M)
    nxt = idx + 1
    nxt = np.where(nxt[None, ...] >= np.maximum(cnt, 1)[..., None], 0, nxt)
    nxt = np.broadcast_to(nxt, sorted_valid.shape)
    nxt_pts = np.take_along_axis(sorted_pts, nxt[..., None], axis=-2)
    rel_a = sorted_pts - centroid[..., None, :]
    rel_b = nxt_pts - centroid[..., None, :]
    tri = rel_a[..., 0] * rel_b[..., 1] - rel_a[..., 1] * rel_b[..., 0]
    tri = np.where(sorted_valid, tri, 0.0)
    return np.abs(tri.sum(axis=-1)) * 0.5


def rotated_intersection_area(corners1, corners2):
    """Pairwise intersection areas of [N, 4, 2] and [K, 4, 2] convex quads →
    [N, K]."""
    N, K = corners1.shape[0], corners2.shape[0]
    q1 = np.broadcast_to(corners1[:, None], (N, K, 4, 2))
    q2 = np.broadcast_to(corners2[None, :], (N, K, 4, 2))
    in12 = _points_in_quad(q1, q2)                  # [N, K, 4]
    in21 = _points_in_quad(q2, q1)
    inter_pts, inter_valid = _segment_intersections(q1, q2)
    pts = np.concatenate([q1, q2, inter_pts], axis=-2)          # [N, K, 24, 2]
    valid = np.concatenate([in12, in21, inter_valid], axis=-1)  # [N, K, 24]
    return _convex_area_from_candidates(pts, valid)


def rotated_iou(rbboxes1, rbboxes2, criterion=-1):
    """Pairwise rotated IoU of [N, 5] and [K, 5] BEV boxes → [N, K].

    criterion: -1 = IoU (area union), 0 = intersection / area1,
    1 = intersection / area2 (matching `rotate_iou_gpu_eval`'s criterion arg,
    reference `nms_gpu.py:606-671`).
    """
    rbboxes1 = np.asarray(rbboxes1, np.float64)
    rbboxes2 = np.asarray(rbboxes2, np.float64)
    if rbboxes1.shape[0] == 0 or rbboxes2.shape[0] == 0:
        return np.zeros((rbboxes1.shape[0], rbboxes2.shape[0]), np.float32)
    c1 = rbbox_to_corners(rbboxes1)
    c2 = rbbox_to_corners(rbboxes2)
    inter = rotated_intersection_area(c1, c2)
    area1 = (rbboxes1[:, 2] * rbboxes1[:, 3])[:, None]
    area2 = (rbboxes2[:, 2] * rbboxes2[:, 3])[None, :]
    if criterion == -1:
        denom = area1 + area2 - inter
    elif criterion == 0:
        denom = area1
    elif criterion == 1:
        denom = area2
    else:
        raise ValueError("criterion must be -1, 0, or 1")
    return (inter / np.maximum(denom, 1e-12)).astype(np.float32)


def d3_box_overlap(boxes, qboxes, criterion=-1, z_axis=1, z_center=1.0):
    """Rotated-3D overlap: BEV rotated intersection x vertical overlap.

    Matches the reference eval's `d3_box_overlap` + `d3_box_overlap_kernel`
    (`second/utils/eval.py:130-163`) operating on camera-frame boxes
    [x, y, z, l, h, w, ry] (z_axis=1, box bottom at y). For lidar boxes
    [x, y, z, w, l, h, yaw] use z_axis=2, z_center=0.
    """
    boxes = np.asarray(boxes, np.float64)
    qboxes = np.asarray(qboxes, np.float64)
    bev_axes = [i for i in range(3) if i != z_axis]
    bev1 = boxes[:, [bev_axes[0], bev_axes[1], bev_axes[0] + 3, bev_axes[1] + 3, 6]]
    bev2 = qboxes[:, [bev_axes[0], bev_axes[1], bev_axes[0] + 3, bev_axes[1] + 3, 6]]
    c1 = rbbox_to_corners(bev1)
    c2 = rbbox_to_corners(bev2)
    inter_bev = rotated_intersection_area(c1, c2)

    h1 = boxes[:, z_axis + 3]
    h2 = qboxes[:, z_axis + 3]
    # box extent along the vertical axis: center-coordinate minus h*z_center is
    # the bottom (camera: y is bottom → z_center=1; lidar: z is bottom → 0)
    top1 = boxes[:, z_axis] + h1 * (1.0 - z_center)
    bot1 = boxes[:, z_axis] - h1 * z_center
    top2 = qboxes[:, z_axis] + h2 * (1.0 - z_center)
    bot2 = qboxes[:, z_axis] - h2 * z_center
    zo = (np.minimum(top1[:, None], top2[None, :]) -
          np.maximum(bot1[:, None], bot2[None, :]))
    inter3d = inter_bev * np.maximum(zo, 0.0)
    vol1 = (boxes[:, 3] * boxes[:, 4] * boxes[:, 5])[:, None]
    vol2 = (qboxes[:, 3] * qboxes[:, 4] * qboxes[:, 5])[None, :]
    if criterion == -1:
        denom = vol1 + vol2 - inter3d
    elif criterion == 0:
        denom = vol1
    else:
        denom = vol2
    return (inter3d / np.maximum(denom, 1e-12)).astype(np.float32)
