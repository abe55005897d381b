"""Host-side NMS oracles: greedy and soft-NMS.

Equivalents of the reference's `second/core/non_max_suppression/nms_cpu.py`
(`nms_jit :33-63`, `soft_nms_jit :66-156`) as plain numpy, used for oracle
tests and CPU-side postprocessing.
"""

from __future__ import annotations

import numpy as np

from .box_np import iou_matrix
from .rotated_iou_np import rotated_iou


def greedy_nms(boxes_bev, scores, iou_threshold=0.5, rotated=True,
               max_out=None):
    """Greedy NMS on [N, 5] rotated BEV boxes (or [N, 4] xyxy if not rotated).
    Returns kept indices in score order."""
    order = np.argsort(-scores)
    if rotated:
        iou = rotated_iou(boxes_bev[order], boxes_bev[order])
    else:
        iou = iou_matrix(boxes_bev[order], boxes_bev[order])
    n = len(order)
    suppressed = np.zeros(n, bool)
    keep = []
    for i in range(n):
        if suppressed[i]:
            continue
        keep.append(order[i])
        if max_out and len(keep) >= max_out:
            break
        suppressed |= iou[i] > iou_threshold
    return np.array(keep, np.int64)


def soft_nms(boxes_xyxy, scores, iou_threshold=0.3, sigma=0.5,
             score_threshold=0.001, method="gaussian"):
    """Soft-NMS (Bodla et al.): decay overlapping scores instead of removing.

    method: "gaussian" (exp(-iou^2/sigma)) or "linear" (1-iou above thr).
    Returns (kept indices, rescored values).
    """
    boxes = np.asarray(boxes_xyxy, np.float64).copy()
    scores = np.asarray(scores, np.float64).copy()
    idx = np.arange(len(scores))
    keep, keep_scores = [], []
    while len(idx):
        best = np.argmax(scores[idx])
        cur = idx[best]
        keep.append(cur)
        keep_scores.append(scores[cur])
        idx = np.delete(idx, best)
        if not len(idx):
            break
        iou = iou_matrix(boxes[cur][None], boxes[idx])[0]
        if method == "gaussian":
            decay = np.exp(-(iou ** 2) / sigma)
        else:
            decay = np.where(iou > iou_threshold, 1.0 - iou, 1.0)
        scores[idx] *= decay
        idx = idx[scores[idx] >= score_threshold]
    return np.array(keep, np.int64), np.array(keep_scores)
