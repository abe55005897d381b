"""CLEAR-MOT tracking metrics (MOTA / MOTP / id switches).

Equivalent of the reference's tracking evaluation via `motmetrics`
(`mm.distances.iou_matrix`, spatio `:1754-1764`) and the KITTI devkit
`evaluate_tracking` entry (`train_2st_spatio.py:39-63`): per-frame gt↔det
matching at an IoU threshold, accumulated FP / FN / id-switch counts.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
from scipy.optimize import linear_sum_assignment

from ..core.box_np import iou_matrix


def iou_distance(gt_boxes, dt_boxes, max_iou: float = 0.5):
    """motmetrics-style distance: 1 − IoU, NaN where IoU < 1 − max_iou...
    here: entries above the distance cutoff are invalid (NaN)."""
    if len(gt_boxes) == 0 or len(dt_boxes) == 0:
        return np.full((len(gt_boxes), len(dt_boxes)), np.nan)
    iou = iou_matrix(np.asarray(gt_boxes), np.asarray(dt_boxes))
    dist = 1.0 - iou
    dist[dist > max_iou] = np.nan
    return dist


class MOTAccumulator:
    """Accumulate CLEAR-MOT statistics over a sequence."""

    def __init__(self, iou_threshold: float = 0.5):
        self._max_dist = iou_threshold
        self.num_gt = 0
        self.fp = 0
        self.fn = 0
        self.idsw = 0
        self.dist_sum = 0.0
        self.num_matches = 0
        self._last_match: Dict[int, int] = {}   # gt id → track id

    def update(self, gt_ids: Sequence[int], gt_boxes, dt_ids: Sequence[int],
               dt_boxes):
        gt_ids = list(gt_ids)
        dt_ids = list(dt_ids)
        self.num_gt += len(gt_ids)
        dist = iou_distance(gt_boxes, dt_boxes, self._max_dist)
        matches = []
        # CLEAR-MOT correspondence continuity (Bernardin & Stiefelhagen
        # 2008 §III.B, and py-motmetrics MOTAccumulator): a (gt, track)
        # correspondence from the previous frame is KEPT if still within
        # the distance threshold, even when a fresh global assignment would
        # prefer a closer pair — only the remainder goes to the Hungarian.
        used_r, used_c = set(), set()
        if dist.size:
            row_of = {g: i for i, g in enumerate(gt_ids)}
            col_of = {d: j for j, d in enumerate(dt_ids)}
            for gid in sorted(self._last_match):
                r, c = row_of.get(gid), col_of.get(self._last_match[gid])
                if (r is None or c is None or r in used_r or c in used_c
                        or np.isnan(dist[r, c])):
                    continue
                matches.append((r, c, dist[r, c]))
                used_r.add(r)
                used_c.add(c)
            rows_left = [r for r in range(len(gt_ids)) if r not in used_r]
            cols_left = [c for c in range(len(dt_ids)) if c not in used_c]
            if rows_left and cols_left:
                cost = np.where(np.isnan(dist), 1e6, dist)
                sub = cost[np.ix_(rows_left, cols_left)]
                rr, cc = linear_sum_assignment(sub)
                for r, c in zip(rr, cc):
                    gr, gc = rows_left[r], cols_left[c]
                    if not np.isnan(dist[gr, gc]):
                        matches.append((gr, gc, dist[gr, gc]))
        matched_gt = {r for r, _, _ in matches}
        matched_dt = {c for _, c, _ in matches}
        self.fn += len(gt_ids) - len(matched_gt)
        self.fp += len(dt_ids) - len(matched_dt)
        for r, c, d in matches:
            gid, tid = gt_ids[r], dt_ids[c]
            if gid in self._last_match and self._last_match[gid] != tid:
                self.idsw += 1
            self._last_match[gid] = tid
            self.dist_sum += d
            self.num_matches += 1

    @property
    def mota(self) -> float:
        if self.num_gt == 0:
            return 0.0
        return 1.0 - (self.fp + self.fn + self.idsw) / self.num_gt

    @property
    def motp(self) -> float:
        if self.num_matches == 0:
            return 0.0
        return self.dist_sum / self.num_matches

    def summary(self) -> Dict[str, float]:
        return {"mota": self.mota, "motp": self.motp, "fp": self.fp,
                "fn": self.fn, "id_switches": self.idsw,
                "num_gt": self.num_gt, "num_matches": self.num_matches}
