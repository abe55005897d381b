"""Masked, fixed-size non-maximum suppression — the port of
`second_tpu/ops/nms.py` (`nms`, `nearest_nms`, `multiclass_nms` and their
helpers).

Selection returns fixed-size [post_max_size] indices plus a keep mask, as
the JAX package does. Both entry points take one example ([N, ...]) or a
batch ([B, N, ...], what `jax.vmap` of the JAX function computes). Top-k
is a stable descending sort, so ties (the many -inf entries included)
resolve lowest index first, like `lax.top_k`.

On the card the batch runs without a host sync: a batched top-k, one row
gather of the candidates, the overlap bitmask (`nms_overlap`, rotated;
`standup_overlap`, the standup IoU thresholded, nearest) and the
suppression kernel (`nms_suppress`), then a batched top-k of the kept
scores. Multi-class NMS runs every class of every example as one such
batch of B·C rows.
"""

from __future__ import annotations

import torch

from .box_ops import rbbox2d_to_near_bbox
from .cuda.gather import flat_rows
from .cuda.riou import nms_overlap, nms_suppress, standup_overlap


def top_k(values, k):
    """(values, indices) of the k largest along the last axis; equal values
    keep ascending index order (`lax.top_k`'s tie rule)."""
    vals, idx = torch.sort(values, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def nms(boxes, scores, valid, *, pre_max_size, post_max_size, iou_threshold,
        rotated=True, max_pairs=8192):
    """Single-class NMS.

    boxes: [N, 5] BEV rotated boxes (x, y, w, l, yaw) if `rotated`, else
    standup [N, 4] xyxy; scores [N]; valid [N] bool; or each with a leading
    batch axis B. Returns indices [min(post_max_size, k)] (or [B, ...]) into
    the inputs and their keep mask. Rotated overlap is exact on the first
    `max_pairs` (row-major) candidate pairs whose standup bound exceeds the
    threshold; pairs past that cap count as non-overlapping."""
    if boxes.dim() == 2:
        idx, keep = nms(boxes[None], scores[None], valid[None],
                        pre_max_size=pre_max_size,
                        post_max_size=post_max_size,
                        iou_threshold=iou_threshold, rotated=rotated,
                        max_pairs=max_pairs)
        return idx[0], keep[0]
    masked = torch.where(valid, scores, float("-inf"))
    k = min(pre_max_size, boxes.shape[1])
    top_scores, top_idx = top_k(masked, k)
    sel, keep = nms_sorted(flat_rows(boxes, top_idx), top_scores,
                           post_max_size=post_max_size,
                           iou_threshold=iou_threshold, rotated=rotated,
                           max_pairs=max_pairs)
    return top_idx.gather(-1, sel), keep


def nms_sorted(cand, cand_scores, *, post_max_size, iou_threshold,
               rotated=True, max_pairs=8192):
    """NMS over candidates already sorted by descending score, one row of a
    batch each: cand [R, K, 5] (or standup [R, K, 4]), cand_scores [R, K]
    with -inf for an invalid candidate. One overlap and one suppression
    launch for all R rows, the pair cap `min(max_pairs, K * K)` a row.
    Returns the kept candidates' positions [R, min(post_max_size, K)] in
    descending score order and their keep mask."""
    k = cand.shape[1]
    valid = torch.isfinite(cand_scores)
    if rotated:
        over_bits, _ = nms_overlap(cand, valid, iou_threshold,
                                   min(max_pairs, k * k))
    else:
        over_bits = standup_overlap(cand, valid, iou_threshold)
    keep = nms_suppress(over_bits, valid)
    keep_scores = torch.where(keep, cand_scores, float("-inf"))
    out_scores, sel = top_k(keep_scores, min(post_max_size, k))
    return sel, torch.isfinite(out_scores)


def multiclass_nms(boxes, scores, valid, *, num_classes, pre_max_size,
                   post_max_size, iou_threshold, score_threshold=0.0,
                   max_pairs=8192):
    """Per-class rotated NMS (JAX `multiclass_nms`, batched as `jax.vmap`
    of it computes). scores [B, N, num_classes], valid [B, N]; boxes the
    BEV boxes [B, N, 5], or a function giving the BEV boxes [B, m, 5] of
    the rows idx [B, m] (`predict` decodes only the candidates). Each
    class row takes its top min(pre_max_size, N) of `valid & (score >=
    score_threshold)`; every class of every example then runs as one
    `nms_sorted` batch of B·C rows (one overlap and one suppression launch,
    no host sync). Returns indices [B, C, P] into N, keep [B, C, P] and
    the per-class scores [B, C, P]."""
    B, N, C = scores.shape
    if C != num_classes:
        raise ValueError(f"multiclass_nms: scores have {C} classes, "
                         f"num_classes is {num_classes}")
    s = scores.transpose(1, 2)                                  # [B, C, N]
    ok = valid[:, None, :] & (s >= score_threshold)
    cand_scores, cand_idx = top_k(torch.where(ok, s, float("-inf")),
                                  min(pre_max_size, N))         # [B, C, k]
    k = cand_idx.shape[-1]
    flat = cand_idx.reshape(B, C * k)
    cand = boxes(flat) if callable(boxes) else flat_rows(boxes, flat)
    sel, keep = nms_sorted(cand.reshape(B * C, k, 5),
                           cand_scores.reshape(B * C, k),
                           post_max_size=post_max_size,
                           iou_threshold=iou_threshold, max_pairs=max_pairs)
    idx = cand_idx.gather(-1, sel.view(B, C, -1))
    return idx, keep.view(B, C, -1), s.gather(-1, idx)


def nearest_nms(boxes_rbv, scores, valid, *, pre_max_size, post_max_size,
                iou_threshold):
    """Standup NMS over the nearest axis-aligned boxes of rotated inputs."""
    return nms(rbbox2d_to_near_bbox(boxes_rbv), scores, valid,
               pre_max_size=pre_max_size, post_max_size=post_max_size,
               iou_threshold=iou_threshold, rotated=False)
