"""Anchor↔gt similarity calculators (host oracle).

Equivalents of the reference's `second/core/region_similarity.py`:
RotateIouSimilarity (:53-76), NearestIouSimilarity (:79-99 — the one the shipped
configs use), DistanceSimilarity (:102-128). All operate on BEV rotated boxes
[x, y, w, l, yaw].
"""

from __future__ import annotations

import numpy as np

from . import box_np
from .rotated_iou_np import rotated_iou


class RegionSimilarityCalculator:
    def compare(self, boxes1, boxes2):
        raise NotImplementedError


class RotateIouSimilarity(RegionSimilarityCalculator):
    """Exact rotated IoU."""

    def compare(self, boxes1, boxes2):
        return rotated_iou(boxes1, boxes2)


class NearestIouSimilarity(RegionSimilarityCalculator):
    """IoU of the nearest axis-aligned ("standup") boxes: yaw is snapped to the
    nearest multiple of π/2 before computing plain IoU."""

    def compare(self, boxes1, boxes2):
        boxes1_bv = box_np.rbbox2d_to_near_bbox(boxes1)
        boxes2_bv = box_np.rbbox2d_to_near_bbox(boxes2)
        from .. import runtime   # native loop; numpy-oracle fallback
        return runtime.iou_matrix(boxes1_bv, boxes2_bv)


class DistanceSimilarity(RegionSimilarityCalculator):
    """Negative-normalized center distance with optional rotation penalty."""

    def __init__(self, distance_norm, with_rotation=False, rotation_alpha=0.5):
        self._distance_norm = distance_norm
        self._with_rotation = with_rotation
        self._rotation_alpha = rotation_alpha

    def compare(self, boxes1, boxes2):
        p = boxes1[:, [0, 1, -1]]
        q = boxes2[:, [0, 1, -1]]
        norm = self._distance_norm
        close = (np.abs(p[:, None, 0] - q[None, :, 0]) <= norm) & \
                (np.abs(p[:, None, 1] - q[None, :, 1]) <= norm)
        dist = ((p[:, None, :2] - q[None, :, :2]) ** 2).sum(-1)
        dist_normed = np.minimum(dist / norm, norm)
        if self._with_rotation:
            a = self._rotation_alpha
            dist_rot = np.abs(np.sin(p[:, None, -1] - q[None, :, -1]))
            sim = 1 - (1 - a) * dist_normed - a * dist_rot
        else:
            sim = 1 - dist_normed
        return np.where(close, sim, 0.0).astype(boxes1.dtype)


def build_similarity(cfg) -> RegionSimilarityCalculator:
    """From schema.SimilarityConfig (reference `similarity_calculator_builder`)."""
    if cfg.kind == "rotate_iou_similarity":
        return RotateIouSimilarity()
    if cfg.kind == "nearest_iou_similarity":
        return NearestIouSimilarity()
    if cfg.kind == "distance_similarity":
        return DistanceSimilarity(cfg.distance_norm, cfg.with_rotation,
                                  cfg.rotation_alpha)
    raise ValueError(f"unknown similarity kind {cfg.kind}")
