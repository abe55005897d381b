"""Anchor generators, box coders, and the per-class target assigner (host side).

Equivalents of the reference's `second/core/anchor_generator.py`,
`second/core/box_coders.py`, and `second/core/target_assigner.py`
(`assign_v2 :61-112`, anchor caching `:115-169`).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from . import box_np
from .target_np import create_target


# ---------------------------------------------------------------------------
# Box coders
# ---------------------------------------------------------------------------

class GroundBox3dCoder:
    """7-dof SECOND coder (reference `box_coders.py:30-44`)."""

    def __init__(self, linear_dim=False, vec_encode=False):
        self.linear_dim = linear_dim
        self.vec_encode = vec_encode

    @property
    def code_size(self):
        return 8 if self.vec_encode else 7

    def encode(self, boxes, anchors):
        return box_np.second_box_encode(boxes, anchors, self.vec_encode,
                                        self.linear_dim)

    def decode(self, encodings, anchors):
        return box_np.second_box_decode(encodings, anchors, self.vec_encode,
                                        self.linear_dim)


class BevBoxCoder:
    """5-dof BEV coder with fixed z/h (reference `box_coders.py:47-72`)."""

    def __init__(self, linear_dim=False, vec_encode=False, z_fixed=-1.0,
                 h_fixed=2.0):
        self.linear_dim = linear_dim
        self.vec_encode = vec_encode
        self.z_fixed = z_fixed
        self.h_fixed = h_fixed

    @property
    def code_size(self):
        return 6 if self.vec_encode else 5

    def encode(self, boxes, anchors):
        anchors = anchors[..., [0, 1, 3, 4, 6]]
        boxes = boxes[..., [0, 1, 3, 4, 6]]
        return box_np.bev_box_encode(boxes, anchors, self.vec_encode,
                                     self.linear_dim)

    def decode(self, encodings, anchors):
        anchors = anchors[..., [0, 1, 3, 4, 6]]
        ret = box_np.bev_box_decode(encodings, anchors, self.vec_encode,
                                    self.linear_dim)
        z_fixed = np.full([*ret.shape[:-1], 1], self.z_fixed, dtype=ret.dtype)
        h_fixed = np.full([*ret.shape[:-1], 1], self.h_fixed, dtype=ret.dtype)
        return np.concatenate(
            [ret[..., :2], z_fixed, ret[..., 2:4], h_fixed, ret[..., 4:]], axis=-1)


def build_box_coder(cfg):
    """From schema.BoxCoderConfig (reference `box_coder_builder.py`)."""
    if cfg.kind == "ground_box3d_coder":
        return GroundBox3dCoder(cfg.linear_dim, cfg.encode_angle_vector)
    if cfg.kind == "bev_box_coder":
        return BevBoxCoder(cfg.linear_dim, cfg.encode_angle_vector, cfg.z_fixed,
                           cfg.h_fixed)
    raise ValueError(f"unknown box coder {cfg.kind}")


# ---------------------------------------------------------------------------
# Anchor generators
# ---------------------------------------------------------------------------

class AnchorGeneratorStride:
    def __init__(self, sizes, anchor_strides, anchor_offsets,
                 rotations=(0, np.pi / 2), match_threshold=-1,
                 unmatch_threshold=-1, class_name=None, dtype=np.float32):
        self._sizes = sizes
        self._anchor_strides = anchor_strides
        self._anchor_offsets = anchor_offsets
        self._rotations = rotations
        self._dtype = dtype
        self.match_threshold = match_threshold
        self.unmatch_threshold = unmatch_threshold
        self.class_name = class_name

    @property
    def num_anchors_per_localization(self):
        return len(self._rotations) * (len(np.reshape(self._sizes, [-1])) // 3)

    def generate(self, feature_map_size):
        return box_np.create_anchors_3d_stride(
            feature_map_size, self._sizes, self._anchor_strides,
            self._anchor_offsets, self._rotations, self._dtype)


class AnchorGeneratorRange:
    def __init__(self, anchor_ranges, sizes=(1.6, 3.9, 1.56),
                 rotations=(0, np.pi / 2), match_threshold=-1,
                 unmatch_threshold=-1, class_name=None, dtype=np.float32):
        self._anchor_ranges = anchor_ranges
        self._sizes = sizes
        self._rotations = rotations
        self._dtype = dtype
        self.match_threshold = match_threshold
        self.unmatch_threshold = unmatch_threshold
        self.class_name = class_name

    @property
    def num_anchors_per_localization(self):
        return len(self._rotations) * (len(np.reshape(self._sizes, [-1])) // 3)

    def generate(self, feature_map_size):
        return box_np.create_anchors_3d_range(
            feature_map_size, self._anchor_ranges, self._sizes,
            self._rotations, self._dtype)


def build_anchor_generators(cfgs: Sequence) -> List:
    """From a list of schema.AnchorGeneratorConfig."""
    out = []
    for c in cfgs:
        if c.kind == "anchor_generator_range":
            out.append(AnchorGeneratorRange(
                anchor_ranges=list(c.anchor_ranges), sizes=list(c.sizes),
                rotations=list(c.rotations), match_threshold=c.matched_threshold,
                unmatch_threshold=c.unmatched_threshold, class_name=c.class_name))
        elif c.kind == "anchor_generator_stride":
            out.append(AnchorGeneratorStride(
                sizes=list(c.sizes), anchor_strides=list(c.strides),
                anchor_offsets=list(c.offsets), rotations=list(c.rotations),
                match_threshold=c.matched_threshold,
                unmatch_threshold=c.unmatched_threshold, class_name=c.class_name))
        else:
            raise ValueError(f"unknown anchor generator {c.kind}")
    return out


# ---------------------------------------------------------------------------
# Target assigner
# ---------------------------------------------------------------------------

class TargetAssigner:
    """Per-class anchor→gt assignment concatenated on the feature map
    (reference `target_assigner.py`)."""

    def __init__(self, box_coder, anchor_generators, region_similarity,
                 positive_fraction=None, sample_size=512):
        self._region_similarity = region_similarity
        self.box_coder = box_coder
        self._anchor_generators = anchor_generators
        self._positive_fraction = positive_fraction
        self._sample_size = sample_size

    @property
    def classes(self):
        return [a.class_name for a in self._anchor_generators]

    @property
    def num_anchors_per_location(self):
        return sum(a.num_anchors_per_localization
                   for a in self._anchor_generators)

    def _similarity_fn(self, anchors, gt_boxes):
        anchors_rbv = anchors[:, [0, 1, 3, 4, 6]]
        gt_rbv = gt_boxes[:, [0, 1, 3, 4, 6]]
        return self._region_similarity.compare(anchors_rbv, gt_rbv)

    def assign(self, anchors_dict: Dict[str, dict], gt_boxes, anchors_mask=None,
               gt_classes=None, gt_names=None, rng=None):
        """assign_v2: loop classes over anchors_dict, concat per-class targets
        along the per-location anchor axis (reference `target_assigner.py:61-112`).
        """
        prune_fn = None
        if anchors_mask is not None:
            prune_fn = lambda _: np.where(anchors_mask)[0]
        if gt_classes is None:     # reference target_ops.py:31 defaults to 1s
            gt_classes = np.ones(len(gt_boxes), dtype=np.int32)

        targets_list = []
        feature_map_size = None
        for class_name, anchor_dict in anchors_dict.items():
            mask = np.array([c == class_name for c in gt_names], dtype=bool)
            targets = create_target(
                anchor_dict["anchors"].reshape(-1, self.box_coder.code_size),
                gt_boxes[mask],
                self._similarity_fn,
                self.box_coder.encode,
                prune_anchor_fn=prune_fn,
                gt_classes=gt_classes[mask],
                matched_threshold=anchor_dict["matched_thresholds"],
                unmatched_threshold=anchor_dict["unmatched_thresholds"],
                positive_fraction=self._positive_fraction,
                rpn_batch_size=self._sample_size,
                box_code_size=self.box_coder.code_size,
                rng=rng)
            targets_list.append(targets)
            feature_map_size = anchor_dict["anchors"].shape[:3]

        code = self.box_coder.code_size
        bbox_targets = np.concatenate(
            [t["bbox_targets"].reshape(*feature_map_size, -1, code)
             for t in targets_list], axis=-2).reshape(-1, code)
        labels = np.concatenate(
            [t["labels"].reshape(*feature_map_size, -1)
             for t in targets_list], axis=-1).reshape(-1)
        bbox_outside_weights = np.concatenate(
            [t["bbox_outside_weights"].reshape(*feature_map_size, -1)
             for t in targets_list], axis=-1).reshape(-1)
        return {
            "labels": labels,
            "bbox_targets": bbox_targets,
            "bbox_outside_weights": bbox_outside_weights,
        }

    def generate_anchors(self, feature_map_size):
        """Concatenated anchors + thresholds (reference :115-142)."""
        anchors_list, match_list, unmatch_list = [], [], []
        for gen in self._anchor_generators:
            anchors = gen.generate(feature_map_size)
            anchors = anchors.reshape([*anchors.shape[:3], -1, 7])
            anchors_list.append(anchors)
            num = int(np.prod(anchors.shape[:-1]))
            match_list.append(np.full([num], gen.match_threshold, anchors.dtype))
            unmatch_list.append(
                np.full([num], gen.unmatch_threshold, anchors.dtype))
        return {
            "anchors": np.concatenate(anchors_list, axis=-2),
            "matched_thresholds": np.concatenate(match_list, axis=0),
            "unmatched_thresholds": np.concatenate(unmatch_list, axis=0),
        }

    def generate_anchors_dict(self, feature_map_size):
        """Per-class anchors dict (reference :144-169)."""
        anchors_dict = {}
        for gen in self._anchor_generators:
            anchors = gen.generate(feature_map_size)
            anchors = anchors.reshape([*anchors.shape[:3], -1, 7])
            num = int(np.prod(anchors.shape[:-1]))
            anchors_dict[gen.class_name] = {
                "anchors": anchors,
                "matched_thresholds": np.full([num], gen.match_threshold,
                                              anchors.dtype),
                "unmatched_thresholds": np.full([num], gen.unmatch_threshold,
                                                anchors.dtype),
            }
        return anchors_dict


def build_target_assigner(cfg, box_coder):
    """From schema.TargetAssignerConfig (reference `target_assigner_builder`)."""
    from .region_similarity import build_similarity
    generators = build_anchor_generators(cfg.anchor_generators)
    similarity = build_similarity(cfg.region_similarity_calculator)
    pos_fraction = cfg.sample_positive_fraction
    if pos_fraction is not None and pos_fraction < 0:
        pos_fraction = None
    return TargetAssigner(
        box_coder=box_coder,
        anchor_generators=generators,
        region_similarity=similarity,
        positive_fraction=pos_fraction,
        sample_size=cfg.sample_size)
