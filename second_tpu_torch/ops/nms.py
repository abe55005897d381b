"""Masked, fixed-size non-maximum suppression — the port of
`second_tpu/ops/nms.py` (`nms`, `nearest_nms` and their helpers).

Selection returns fixed-size [post_max_size] indices plus a keep mask, as
the JAX package does. Both entry points take one example ([N, ...]) or a
batch ([B, N, ...], what `jax.vmap` of the JAX function computes). Top-k
is a stable descending sort, so ties (the many -inf entries included)
resolve lowest index first, like `lax.top_k`.

On the card the batch runs without a host sync: a batched top-k, one row
gather of the candidates, the overlap bitmask (`nms_overlap`, rotated; the
standup IoU packed by `pack_bits`, nearest) and the suppression kernel
(`nms_suppress`), then a batched top-k of the kept scores.
"""

from __future__ import annotations

import torch

from .box_ops import rbbox2d_to_near_bbox
from .cuda.gather import flat_rows
from .cuda.riou import nms_overlap, nms_suppress, pack_bits
from .rotated_iou import standup_iou_matrix


def top_k(values, k):
    """(values, indices) of the k largest along the last axis; equal values
    keep ascending index order (`lax.top_k`'s tie rule)."""
    vals, idx = torch.sort(values, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _standup_over_bits(cand, valid, iou_threshold):
    """The strictly-upper `standup IoU > threshold` matrix of valid pairs,
    packed: cand [B, K, 4] xyxy → [B, K, ceil(K / 32)] int32."""
    K = cand.shape[1]
    upper = torch.ones((K, K), dtype=torch.bool, device=cand.device).triu(1)
    over = (standup_iou_matrix(cand, cand) > iou_threshold) & upper & \
        valid[:, :, None] & valid[:, None, :]
    return pack_bits(over)


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
    top_valid = torch.isfinite(top_scores)
    cand = flat_rows(boxes, top_idx)
    if rotated:
        over_bits, _ = nms_overlap(cand, top_valid, iou_threshold,
                                   min(max_pairs, k * k))
    else:
        over_bits = _standup_over_bits(cand, top_valid, iou_threshold)
    keep = nms_suppress(over_bits, top_valid)
    keep_scores = torch.where(keep, top_scores, float("-inf"))
    out_scores, sel = top_k(keep_scores, min(post_max_size, k))
    return top_idx.gather(-1, sel), torch.isfinite(out_scores)


def nearest_nms(boxes_rbv, scores, valid, *, pre_max_size, post_max_size,
                iou_threshold):
    """Standup NMS over the nearest axis-aligned boxes of rotated inputs."""
    return nms(rbbox2d_to_near_bbox(boxes_rbv), scores, valid,
               pre_max_size=pre_max_size, post_max_size=post_max_size,
               iou_threshold=iou_threshold, rotated=False)
