"""Point-cloud / box augmentation (host-side numpy).

Equivalents of the reference's `second/core/preprocess.py`: per-object
collision-checked pose perturbation (`noise_per_object_v3_ :592-685`,
`noise_per_box :250-456`, `points_transform_ :459-475`), global rotation /
scaling / flip (`:756-802`), `random_crop_frustum :103`, gt filters
(`:131-185`), and the BEV collision test (`box_collision_test :806-886`,
realized here via exact rotated-polygon overlap).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from . import box_np
from .rotated_iou_np import rbbox_to_corners, rotated_intersection_area


def box_collision_test(boxes, qboxes):
    """Boolean [N, K] BEV collision matrix for [*, 5(x, y, w, l, yaw)] boxes."""
    if len(boxes) == 0 or len(qboxes) == 0:
        return np.zeros((len(boxes), len(qboxes)), bool)
    inter = rotated_intersection_area(
        rbbox_to_corners(np.asarray(boxes, np.float64)),
        rbbox_to_corners(np.asarray(qboxes, np.float64)))
    return inter > 1e-8


def noise_per_object(gt_boxes, points=None, valid_mask=None,
                     rotation_perturb=(-np.pi / 4, np.pi / 4),
                     center_noise_std=(1.0, 1.0, 0.5),
                     num_try=100, rng: Optional[np.random.Generator] = None,
                     group_ids=None):
    """Perturb each gt box (and its interior points) independently, rejecting
    poses that collide with any other box (current positions).

    With `group_ids` [N], boxes sharing an id move RIGIDLY: they draw the
    same loc/rot noise, each member's translation additionally carries the
    rigid rotation about the group's BEV center, and a noise candidate is
    accepted for the whole group only if no member collides (the reference's
    group-noise variant: `preprocess.py:496-588` `group_transform_` /
    `set_group_noise_same_` / `noise_per_box_group`).

    Mutates `gt_boxes` / `points` in place, like the reference.
    """
    rng = rng or np.random.default_rng()
    num_boxes = gt_boxes.shape[0]
    if num_boxes == 0:
        return
    if valid_mask is None:
        valid_mask = np.ones(num_boxes, bool)
    if not hasattr(rotation_perturb, "__len__"):
        rotation_perturb = (-rotation_perturb, rotation_perturb)
    center_noise_std = np.asarray(center_noise_std, np.float64)

    loc_noises = rng.normal(0, center_noise_std,
                            (num_boxes, num_try, 3))
    rot_noises = rng.uniform(rotation_perturb[0], rotation_perturb[1],
                             (num_boxes, num_try))

    groups = [[i] for i in range(num_boxes)]
    if group_ids is not None:
        group_ids = np.asarray(group_ids)
        # same noise draw for every member of a group (first member's)
        first = {}
        order = []
        for i, gid in enumerate(group_ids):
            if gid not in first:
                first[gid] = i
                order.append([i])
            else:
                order[[g[0] for g in order].index(first[gid])].append(i)
            loc_noises[i] = loc_noises[first[gid]]
            rot_noises[i] = rot_noises[first[gid]]
        groups = order
        # rigid rotation about the group BEV center: member translation
        # = r·(sin/cos(rot_center + θ) − sin/cos(rot_center))
        for members in groups:
            if len(members) < 2:
                continue
            center = gt_boxes[members, :3].mean(axis=0)
            for i in members:
                x = gt_boxes[i, 0] - center[0]
                y = gt_boxes[i, 1] - center[1]
                r = np.sqrt(x * x + y * y)
                rot_center = np.arctan2(x, y)
                loc_noises[i, :, 0] += r * (
                    np.sin(rot_center + rot_noises[i]) - np.sin(rot_center))
                loc_noises[i, :, 1] += r * (
                    np.cos(rot_center + rot_noises[i]) - np.cos(rot_center))

    point_masks = None
    if points is not None:
        point_masks = box_np.points_in_rbbox(points, gt_boxes)

    bev = gt_boxes[:, [0, 1, 3, 4, 6]].copy()
    chosen_loc = np.zeros((num_boxes, 3))
    chosen_rot = np.zeros(num_boxes)
    for members in groups:
        members = [i for i in members if valid_mask[i]]
        if not members:
            continue
        # candidate BEV boxes for every member under each perturbation
        cand = np.stack([np.tile(bev[i], (num_try, 1)) for i in members])
        for mi, i in enumerate(members):
            cand[mi, :, 0] += loc_noises[i, :, 0]
            cand[mi, :, 1] += loc_noises[i, :, 1]
            cand[mi, :, 4] += rot_noises[i]
        others = np.delete(bev, members, axis=0)
        if len(others):
            coll = box_collision_test(
                cand.reshape(-1, 5), others).any(axis=1)
            coll = coll.reshape(len(members), num_try).any(axis=0)
        else:
            coll = np.zeros(num_try, bool)
        ok = np.flatnonzero(~coll)
        if len(ok) == 0:
            continue
        t = ok[0]
        for i in members:
            chosen_loc[i] = loc_noises[i, t]
            chosen_rot[i] = rot_noises[i, t]
            bev[i, :2] += chosen_loc[i, :2]
            bev[i, 4] += chosen_rot[i]

    # apply to points first (needs original box centers)
    if points is not None:
        for i in range(num_boxes):
            if not valid_mask[i] or (chosen_loc[i] == 0).all() and \
                    chosen_rot[i] == 0:
                continue
            mask = point_masks[:, i]
            if not mask.any():
                continue
            center = gt_boxes[i, :3].copy()
            center[2] += gt_boxes[i, 5] / 2
            pts = points[mask, :3] - center
            pts = box_np.rotation_points_single_angle(
                pts, chosen_rot[i], axis=2)
            points[mask, :3] = pts + center + chosen_loc[i]
    gt_boxes[:, :3] += chosen_loc
    gt_boxes[:, 6] += chosen_rot


def global_rotation(gt_boxes, points, rotation=(-np.pi / 4, np.pi / 4),
                    rng: Optional[np.random.Generator] = None):
    rng = rng or np.random.default_rng()
    if not hasattr(rotation, "__len__"):
        rotation = (-rotation, rotation)
    noise = rng.uniform(rotation[0], rotation[1])
    points[:, :3] = box_np.rotation_points_single_angle(
        points[:, :3], noise, axis=2)
    gt_boxes[:, :3] = box_np.rotation_points_single_angle(
        gt_boxes[:, :3], noise, axis=2)
    gt_boxes[:, 6] += noise
    return gt_boxes, points


def global_scaling(gt_boxes, points, scale_range=(0.95, 1.05),
                   rng: Optional[np.random.Generator] = None):
    rng = rng or np.random.default_rng()
    scale = rng.uniform(*scale_range)
    points[:, :3] *= scale
    gt_boxes[:, :6] *= scale
    return gt_boxes, points


def random_flip(gt_boxes, points, probability=0.5,
                rng: Optional[np.random.Generator] = None):
    """Flip across the x axis (y → −y), like the reference (`:756-767`)."""
    rng = rng or np.random.default_rng()
    if rng.uniform() < probability:
        gt_boxes[:, 1] = -gt_boxes[:, 1]
        gt_boxes[:, 6] = -gt_boxes[:, 6] + np.pi
        points[:, 1] = -points[:, 1]
    return gt_boxes, points


def global_translate(gt_boxes, points, noise_std=(0.0, 0.0, 0.0),
                     rng: Optional[np.random.Generator] = None):
    rng = rng or np.random.default_rng()
    noise = rng.normal(0, np.asarray(noise_std))
    points[:, :3] += noise
    gt_boxes[:, :3] += noise
    return gt_boxes, points


def filter_gt_box_outside_range(gt_boxes, limit_range):
    """Keep boxes whose BEV corners touch the range (reference :131-146)."""
    corners = box_np.center_to_corner_box2d(
        gt_boxes[:, :2], gt_boxes[:, 3:5], gt_boxes[:, 6])
    mask = ((corners >= np.asarray(limit_range[:2])) &
            (corners <= np.asarray(limit_range[2:]))).all(-1).any(-1)
    return mask


def filter_gt_low_points(gt_boxes, points, min_points=5):
    """Drop boxes with fewer than `min_points` interior points."""
    if len(gt_boxes) == 0:
        return np.zeros((0,), bool)
    inside = box_np.points_in_rbbox(points, gt_boxes)
    return inside.sum(0) >= min_points


def remove_points_in_boxes(points, boxes):
    if len(boxes) == 0:
        return points
    inside = box_np.points_in_rbbox(points, boxes)
    return points[~inside.any(axis=1)]


def random_crop_frustum(bboxes, rect, Trv2c, P2,
                        max_crop_height=1.0, max_crop_width=0.9,
                        rng: Optional[np.random.Generator] = None):
    """Random image-subwindow frustums for point dropout (reference :103-128)."""
    rng = rng or np.random.default_rng()
    num_gt = bboxes.shape[0]
    crop_minxy = rng.uniform([1 - max_crop_width, 1 - max_crop_height],
                             [0.3, 0.3], size=[num_gt, 2])
    crop_maxxy = np.ones([num_gt, 2])
    crop_bboxes = np.concatenate([crop_minxy, crop_maxxy], axis=1)
    left = rng.uniform(size=num_gt) < 0.5
    crop_bboxes[left, 0::2] = 1 - crop_bboxes[left, 2::-2]
    # to absolute pixels within each gt bbox
    wh = bboxes[:, 2:] - bboxes[:, :2]
    crop_bboxes = crop_bboxes * np.tile(wh, (1, 2)) + np.tile(bboxes[:, :2],
                                                              (1, 2))
    C, R, T = box_np.projection_matrix_to_CRT_kitti(P2)
    frustums = np.stack(
        [box_np.get_frustum(b, C) for b in crop_bboxes])   # [N, 8, 3]
    frustums -= T
    frustums = np.einsum("ij,akj->aki", np.linalg.inv(R), frustums)
    frustums = box_np.camera_to_lidar(frustums, rect, Trv2c)
    return frustums
