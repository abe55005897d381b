"""Masked, fixed-size non-maximum suppression — the port of
`second_tpu/ops/nms.py` (`nms`, `nearest_nms` and their helpers).

Selection returns fixed-size [post_max_size] indices plus a keep mask, as
the JAX package does. Top-k is a stable descending sort, so ties (the many
-inf entries included) resolve lowest index first, like `lax.top_k`.
"""

from __future__ import annotations

import torch

from .box_ops import rbbox2d_to_near_bbox
from .cuda.gather import gather_rows
from .cuda.riou import riou_pairs
from .rotated_iou import rbbox_to_corners, standup_iou_matrix


def top_k(values, k):
    """(values, indices) of the k largest along the last axis; equal values
    keep ascending index order (`lax.top_k`'s tie rule)."""
    vals, idx = torch.sort(values, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _greedy_suppress(iou, valid, iou_threshold):
    """Exact greedy NMS over boxes sorted by descending score: iou [K, K]
    pairwise overlap, valid [K] → keep [K]."""
    K = iou.shape[0]
    upper = torch.triu(torch.ones((K, K), dtype=torch.bool,
                                  device=iou.device), diagonal=1)
    over = (iou > iou_threshold) & upper & valid[:, None] & valid[None, :]
    return _greedy_suppress_over(over.float(), valid)


def _greedy_suppress_over(over_f, valid):
    """Greedy suppression by frontier rounds from a strictly-upper float
    overlap matrix: each round decides every box whose higher-ranked
    overlapping boxes are all decided (kept if none of those was kept). The
    rounds run as a host loop; each is two [K] x [K, K] products."""
    undecided = valid.clone()
    kept = torch.zeros_like(valid)
    while bool(undecided.any()):
        blocked = (undecided.float() @ over_f) > 0.5
        suppressed = (kept.float() @ over_f) > 0.5
        newly_kept = undecided & ~blocked & ~suppressed
        newly_removed = undecided & suppressed
        kept = kept | newly_kept
        undecided = undecided & ~newly_kept & ~newly_removed
    return kept


def _sparse_rotated_over(cand, top_valid, iou_threshold, max_pairs):
    """Exact `rotated_iou > threshold` upper-triangle matrix [K, K] (float),
    computed sparsely: the standup envelope bounds the rotated IoU from
    above, so polygon clipping runs only on the first `max_pairs` (row-major)
    candidate pairs whose bound exceeds the threshold. Pairs beyond the cap
    count as non-overlapping."""
    K = cand.shape[0]
    corners = rbbox_to_corners(cand)                         # [K, 4, 2]
    standup = torch.cat([corners.amin(-2), corners.amax(-2)], -1)
    lt = torch.maximum(standup[:, None, :2], standup[None, :, :2])
    rb = torch.minimum(standup[:, None, 2:], standup[None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter_st = wh[..., 0] * wh[..., 1]
    areas = cand[:, 2] * cand[:, 3]
    asum = areas[:, None] + areas[None, :]
    bound = inter_st / torch.clamp(asum - inter_st, min=1e-12)

    upper = torch.triu(torch.ones((K, K), dtype=torch.bool,
                                  device=cand.device), diagonal=1)
    maybe = (bound > iou_threshold) & upper & \
        top_valid[:, None] & top_valid[None, :]
    plist = torch.nonzero(maybe.reshape(-1))[:max_pairs, 0]
    pi, pj = plist // K, plist % K
    iou = riou_pairs(cand, cand, pi, pj)
    over = torch.zeros((K * K,), dtype=torch.float32, device=cand.device)
    over[plist] = (iou > iou_threshold).float()
    return over.reshape(K, K)


def nms(boxes, scores, valid, *, pre_max_size, post_max_size, iou_threshold,
        rotated=True, max_pairs=8192):
    """Single-class NMS.

    boxes: [N, 5] BEV rotated boxes (x, y, w, l, yaw) if `rotated`, else
    standup [N, 4] xyxy; scores [N]; valid [N] bool. Returns indices
    [min(post_max_size, k)] into the inputs and their keep mask."""
    neg_inf = torch.tensor(float("-inf"), dtype=scores.dtype,
                           device=scores.device)
    masked = torch.where(valid, scores, neg_inf)
    k = min(pre_max_size, boxes.shape[0])
    top_scores, top_idx = top_k(masked, k)
    top_valid = torch.isfinite(top_scores)
    cand = gather_rows(boxes, top_idx)
    if rotated:
        over_f = _sparse_rotated_over(cand, top_valid, iou_threshold,
                                      min(max_pairs, k * k))
        keep = _greedy_suppress_over(over_f, top_valid)
    else:
        keep = _greedy_suppress(standup_iou_matrix(cand, cand), top_valid,
                                iou_threshold)
    keep_scores = torch.where(keep, top_scores, neg_inf)
    out_scores, sel = top_k(keep_scores, min(post_max_size, k))
    return top_idx[sel], torch.isfinite(out_scores)


def nearest_nms(boxes_rbv, scores, valid, *, pre_max_size, post_max_size,
                iou_threshold):
    """Standup NMS over the nearest axis-aligned boxes of rotated inputs."""
    return nms(rbbox2d_to_near_bbox(boxes_rbv), scores, valid,
               pre_max_size=pre_max_size, post_max_size=post_max_size,
               iou_threshold=iou_threshold, rotated=False)
