"""Masked, fixed-size non-maximum suppression — the port of
`second_tpu/ops/nms.py` (`nms`, `nearest_nms`, `multiclass_nms`,
`soft_nms` and their helpers).

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

Soft-NMS decays the scores of overlapping boxes instead of removing them.
Rotated, it clips the capped pair list (`soft_nms_pairs`, `pair_iou`) and
runs the `m` decay steps of every row over that list in one launch
(`soft_nms_decay_pairs`): no [B, K, K] matrix is built. Standup, the steps
run over the candidates' boxes (`soft_nms_decay_standup`: each step
computes the pick's row of their standup IoU matrix), none built either.
"""

from __future__ import annotations

import torch

from .box_ops import rbbox2d_to_near_bbox
from .cuda.gather import flat_rows
from .cuda.riou import (check_rotated_k, nms_overlap, nms_suppress,
                        pair_matrix, riou_pairs, soft_nms_decay_pairs,
                        soft_nms_decay_standup, standup_maybe,
                        standup_overlap)


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


def soft_nms_pairs(cand, valid, max_pairs, min_bound=0.0):
    """The pairs soft-NMS clips, at a fixed size: cand [B, K, 5], valid
    [B, K] → (plist [B, max_pairs] int64 of i * K + j, ok [B, max_pairs]
    bool). The pairs are `standup_maybe`'s at `min_bound` (i < j, both
    valid, the standup-envelope bound on their IoU above it) in row-major
    order, the first `max_pairs` of them; a slot past an example's pairs
    holds 0 and is not ok (JAX `_sparse_rotated_iou_matrix`'s `plist` and
    `pair_ok`). Found by a search in the running count, so nothing is read
    on the host."""
    B, K = valid.shape
    maybe = standup_maybe(cand, valid, min_bound).reshape(B, K * K)
    count = torch.cumsum(maybe, 1)
    want = torch.arange(1, max_pairs + 1, device=cand.device,
                        dtype=count.dtype).expand(B, -1).contiguous()
    plist = torch.searchsorted(count, want)
    ok = plist < K * K
    return torch.where(ok, plist, 0), ok


def sparse_rotated_iou_matrix(cand, top_valid, max_pairs, min_bound=0.0):
    """The symmetric rotated-IoU matrix [K, K] (or [B, K, K]) of candidates
    [K, 5] (or [B, K, 5]), computed sparsely (JAX
    `_sparse_rotated_iou_matrix`): only `soft_nms_pairs`' pairs are clipped
    (`riou_pairs`), every other entry is 0, the pairs past the cap
    included, and each IoU is written into both triangles.

    `riou_pairs`' criterion -1 is JAX's IoU here: inter / max(a_i + a_j -
    inter, 1e-12) with a = w · l of each box, in JAX's order
    (`inter / jnp.maximum(areas[pi] + areas[pj] - inter, 1e-12)`). On the
    same intersections and boxes the plain version's value is that
    expression's, run op by op, bit for bit (`tests/test_torch_soft_nms.py`;
    XLA's jit of it rounds some values an ulp or two apart), and the
    kernel's `pair_iou` runs the same operations, built without fused
    multiply-adds; the intersections themselves differ by the corners' sin
    and cos (an ulp)."""
    if cand.dim() == 2:
        return sparse_rotated_iou_matrix(cand[None], top_valid[None],
                                         max_pairs, min_bound)[0]
    plist, ok = soft_nms_pairs(cand, top_valid, max_pairs, min_bound)
    return pair_matrix(plist, ok, pair_iou(cand, plist), top_valid.shape[1])


def pair_iou(cand, plist):
    """The rotated IoU [B, P] of each listed pair of candidates cand
    [B, K, 5], plist [B, P] of i * K + j (`riou_pairs`, criterion -1, one
    launch for the batch); a slot that is not ok clips the pair (0, 0)."""
    B, K = cand.shape[:2]
    off = (torch.arange(B, device=cand.device) * K)[:, None]
    flat = cand.reshape(B * K, 5)
    return riou_pairs(flat, flat, (off + plist // K).reshape(-1),
                      (off + plist % K).reshape(-1)).view(B, -1)


def soft_nms(boxes, scores, valid, *, pre_max_size, post_max_size,
             sigma=0.5, iou_threshold=0.3, score_threshold=1e-3,
             method="gaussian", rotated=True, max_pairs=8192):
    """Soft-NMS (Bodla et al.; JAX `soft_nms`): instead of removing the
    boxes that overlap a pick, their scores decay by exp(-iou² / sigma)
    ("gaussian") or by 1 - iou above `iou_threshold` (any other method).

    boxes [N, 5] rotated BEV boxes (or standup [N, 4] with rotated=False),
    scores [N], valid [N] bool; or each with a leading batch axis B. The
    top min(pre_max_size, N) valid candidates (stable top-k); their IoU
    matrix, the rotated one sparsely over the first min(max_pairs, k²)
    pairs that can overlap (pairs past that cap count as IoU 0), the
    standup one whole; then min(post_max_size, k) decay steps, every row
    in one launch, with no [B, k, k] matrix built (rotated: over the pair
    list itself; standup: a step computes the pick's row of the matrix
    from the boxes). Returns (indices [m] into the inputs, in pick order,
    the rescored scores where kept and 0 elsewhere, keep [m]: finite and
    at least `score_threshold`)."""
    if boxes.dim() == 2:
        idx, out, keep = soft_nms(
            boxes[None], scores[None], valid[None],
            pre_max_size=pre_max_size, post_max_size=post_max_size,
            sigma=sigma, iou_threshold=iou_threshold,
            score_threshold=score_threshold, method=method, rotated=rotated,
            max_pairs=max_pairs)
        return idx[0], out[0], keep[0]
    masked = torch.where(valid, scores, float("-inf"))
    k = min(pre_max_size, boxes.shape[1])
    top_scores, top_idx = top_k(masked, k)
    cand = flat_rows(boxes, top_idx)
    m = min(post_max_size, k)
    if rotated:
        if cand.device.type == "cuda":      # before the [B, k, k] pair search
            check_rotated_k("soft_nms", k)
        plist, ok = soft_nms_pairs(cand, torch.isfinite(top_scores),
                                   min(max_pairs, k * k))
        picks, picked = soft_nms_decay_pairs(
            plist, ok, pair_iou(cand, plist), top_scores, m, method, sigma,
            iou_threshold)
    else:
        picks, picked = soft_nms_decay_standup(cand, top_scores, m, method,
                                               sigma, iou_threshold)
    keep = torch.isfinite(picked) & (picked >= score_threshold)
    return (top_idx.gather(-1, picks), torch.where(keep, picked, 0.0),
            keep)
