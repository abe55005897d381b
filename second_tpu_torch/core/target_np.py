"""Detectron-style anchor→gt target assignment (host-side oracle).

Behavioral equivalent of the reference's `second/core/target_ops.py:31-214`
(`create_target_np`): bidirectional argmax matching with force-matching of each
gt's best anchor (including ties), pos/neg IoU thresholds, optional
positive-fraction subsampling, box encoding of foreground anchors, and unmapping
back to the full (pruned) anchor set.
"""

from __future__ import annotations

import numpy as np


def unmap(data, count, inds, fill=0):
    """Scatter `data` rows back to a `count`-row array at `inds` (reference :12-26)."""
    if count == len(inds):
        return data
    shape = (count,) + data.shape[1:]
    ret = np.full(shape, fill, dtype=data.dtype)
    ret[inds] = data
    return ret


def create_target(all_anchors,
                  gt_boxes,
                  similarity_fn,
                  box_encoding_fn,
                  prune_anchor_fn=None,
                  gt_classes=None,
                  matched_threshold=0.6,
                  unmatched_threshold=0.45,
                  positive_fraction=None,
                  rpn_batch_size=300,
                  norm_by_num_examples=False,
                  box_code_size=7,
                  rng: np.random.Generator | None = None):
    """Assign classification labels and regression targets to anchors.

    Returns a dict with `labels` (-1 ignore / 0 bg / >0 class id),
    `bbox_targets`, `bbox_outside_weights`, `assigned_anchors_overlap`,
    `positive_gt_id`, `assigned_anchors_inds` — the contract consumed by
    `TargetAssigner.assign_v2` in the reference (`target_assigner.py:61-112`).
    """
    total_anchors = all_anchors.shape[0]
    if prune_anchor_fn is not None:
        inds_inside = prune_anchor_fn(all_anchors)
        anchors = all_anchors[inds_inside, :]
        if not isinstance(matched_threshold, float):
            matched_threshold = matched_threshold[inds_inside]
        if not isinstance(unmatched_threshold, float):
            unmatched_threshold = unmatched_threshold[inds_inside]
    else:
        anchors = all_anchors
        inds_inside = None
    num_inside = len(inds_inside) if inds_inside is not None else total_anchors

    if gt_classes is None:
        gt_classes = np.ones([gt_boxes.shape[0]], dtype=np.int32)

    labels = np.full((num_inside,), -1, dtype=np.int32)
    gt_ids = np.full((num_inside,), -1, dtype=np.int32)

    have_boxes = len(gt_boxes) > 0 and anchors.shape[0] > 0
    if have_boxes:
        overlap = similarity_fn(anchors, gt_boxes)              # [A, G]
        anchor_to_gt_argmax = overlap.argmax(axis=1)
        anchor_to_gt_max = overlap[np.arange(num_inside), anchor_to_gt_argmax]
        gt_to_anchor_argmax = overlap.argmax(axis=0)
        gt_to_anchor_max = overlap[gt_to_anchor_argmax,
                                   np.arange(overlap.shape[1])]
        # A gt with zero best-overlap matches nothing.
        gt_to_anchor_max = np.where(gt_to_anchor_max == 0, -1.0, gt_to_anchor_max)
        # Force-match: every anchor tied at a gt's max overlap becomes fg.
        anchors_with_max_overlap = np.where(overlap == gt_to_anchor_max)[0]
        gt_inds_force = anchor_to_gt_argmax[anchors_with_max_overlap]
        labels[anchors_with_max_overlap] = gt_classes[gt_inds_force]
        gt_ids[anchors_with_max_overlap] = gt_inds_force
        # Threshold matches.
        pos_inds = anchor_to_gt_max >= matched_threshold
        gt_inds = anchor_to_gt_argmax[pos_inds]
        labels[pos_inds] = gt_classes[gt_inds]
        gt_ids[pos_inds] = gt_inds
        bg_inds = np.where(anchor_to_gt_max < unmatched_threshold)[0]
    else:
        bg_inds = np.arange(num_inside)

    fg_inds = np.where(labels > 0)[0]
    fg_max_overlap = anchor_to_gt_max[fg_inds] if have_boxes else None
    gt_pos_ids = gt_ids[fg_inds]

    if positive_fraction is not None:
        rng = rng or np.random.default_rng()
        num_fg = int(positive_fraction * rpn_batch_size)
        if len(fg_inds) > num_fg:
            disable = rng.choice(fg_inds, size=len(fg_inds) - num_fg,
                                 replace=False)
            labels[disable] = -1
            fg_inds = np.where(labels > 0)[0]
        num_bg = rpn_batch_size - np.sum(labels > 0)
        if len(bg_inds) > num_bg:
            enable = bg_inds[rng.integers(len(bg_inds), size=num_bg)]
            labels[enable] = 0
    else:
        if not have_boxes:
            labels[:] = 0
        else:
            labels[bg_inds] = 0
            # force-matched anchors stay positive even below unmatched_threshold
            labels[anchors_with_max_overlap] = gt_classes[gt_inds_force]

    bbox_targets = np.zeros((num_inside, box_code_size), dtype=all_anchors.dtype)
    if have_boxes and len(fg_inds) > 0:
        bbox_targets[fg_inds, :] = box_encoding_fn(
            gt_boxes[anchor_to_gt_argmax[fg_inds], :], anchors[fg_inds, :])

    bbox_outside_weights = np.zeros((num_inside,), dtype=all_anchors.dtype)
    if norm_by_num_examples:
        num_examples = max(1.0, float(np.sum(labels >= 0)))
        bbox_outside_weights[labels > 0] = 1.0 / num_examples
    else:
        bbox_outside_weights[labels > 0] = 1.0

    if inds_inside is not None:
        labels = unmap(labels, total_anchors, inds_inside, fill=-1)
        bbox_targets = unmap(bbox_targets, total_anchors, inds_inside, fill=0)
        bbox_outside_weights = unmap(bbox_outside_weights, total_anchors,
                                     inds_inside, fill=0)
        assigned_inds = inds_inside[fg_inds]
    else:
        assigned_inds = fg_inds
    return {
        "labels": labels,
        "bbox_targets": bbox_targets,
        "bbox_outside_weights": bbox_outside_weights,
        "assigned_anchors_overlap": fg_max_overlap,
        "positive_gt_id": gt_pos_ids,
        "assigned_anchors_inds": assigned_inds,
    }
