"""Host-side example preparation + batching.

Equivalent of the reference's absent `second/data/preprocess.py`
(`prep_pointcloud`, reconstructed from call sites — SURVEY.md §2.4 /
`second/builder/dataset_builder.py:51-87`) and the `merge_second_batch`
collate (`train.py:68-88`) — redesigned for the on-device voxelizer: the host
pads raw points and computes anchor targets; voxelization happens inside the
jitted step (`train/state.py`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from ..core import box_np
from ..core.anchors import TargetAssigner


@dataclasses.dataclass
class PrepConfig:
    max_points: int = 25000          # padded point capacity per frame
    max_gt: int = 64                 # padded gt-box capacity per frame
    shuffle_points: bool = False
    training: bool = True
    # anchors_mask via summed-area-table occupancy (reference
    # box_np_ops.sparse_sum_for_anchors_mask / fused_get_anchors_area,
    # prep_pointcloud contract); <= 0 disables
    anchor_area_threshold: float = -1.0
    # eval-only: skip the host SAT mask (the jitted eval step computes it
    # in-graph from the voxelizer's coords — ops/anchors_mask.py); training
    # always computes it on host (the target assigner prunes with it)
    device_anchors_mask: bool = False
    voxel_size: tuple = (0.05, 0.05, 0.1)
    pc_range: tuple = (0.0, -40.0, -3.0, 70.4, 40.0, 1.0)
    # camera-fusion inputs (reference `--use_fusion` example keys: the
    # image plus per-point P3-pixel / BEV-cell projections the fused RPN
    # scatters with, `rpn.py:753-1023` / `models/fusion.py`)
    use_fusion: bool = False
    image_shape: tuple = (384, 1248)     # fixed (H, W) canvas, padded
    image_stride: int = 8                # P3 feature stride
    out_stride: int = 8                  # BEV feature-map stride
    # per-z-slice BEV→P3 projection grids (`idxs_norm`, the
    # RPN_SECOND_FUSION / temporal-fusion contract, reference rpn.py:593,616)
    use_zslice: bool = False
    num_z_slices: int = 4


class ExamplePrep:
    """Prepares fixed-shape examples: pad points, assign anchor targets."""

    def __init__(self, assigner: TargetAssigner, feature_map_size,
                 prep_cfg: PrepConfig):
        self._assigner = assigner
        self._prep = prep_cfg
        self._bev_hw = tuple(feature_map_size[-2:])
        # anchor cache, like the reference's anchor_cache
        # (`second/core/inference.py:21,57`)
        self._anchors_dict = assigner.generate_anchors_dict(feature_map_size)
        anchors_all = assigner.generate_anchors(feature_map_size)
        self._anchors = anchors_all["anchors"].reshape(
            -1, assigner.box_coder.code_size).astype(np.float32)
        # standup BEV footprint of every anchor, cached for the SAT mask
        if prep_cfg.anchor_area_threshold > 0:
            bev = self._anchors[:, [0, 1, 3, 4, 6]]
            self._anchors_bv = box_np.rbbox2d_to_near_bbox(bev)
        else:
            self._anchors_bv = None

    @property
    def anchors(self) -> np.ndarray:
        return self._anchors

    @property
    def num_anchors(self) -> int:
        return self._anchors.shape[0]

    def pad_points(self, points, rng: Optional[np.random.Generator] = None):
        """Pad/subsample raw points to the fixed capacity."""
        rng = rng or np.random.default_rng()
        P = self._prep.max_points
        if self._prep.shuffle_points or len(points) > P:
            sel = rng.permutation(len(points))[:P]
            points = points[sel]
        n = len(points)
        padded = np.zeros((P, points.shape[1]), np.float32)
        padded[:n] = points
        mask = np.zeros((P,), bool)
        mask[:n] = True
        return padded, mask

    def __call__(self, scene: Dict, rng: Optional[np.random.Generator] = None
                 ) -> Dict:
        rng = rng or np.random.default_rng()
        padded, mask = self.pad_points(scene["points"], rng)
        example = {
            "points": padded,
            "points_mask": mask,
            "image_idx": scene.get("image_idx", -1),
        }
        anchors_mask = None
        if self._anchors_bv is not None and (
                self._prep.training or not self._prep.device_anchors_mask):
            anchors_mask = self._compute_anchors_mask(scene["points"])
            example["anchors_mask"] = anchors_mask
        if self._prep.use_fusion:
            example.update(self._fusion_inputs(scene, padded, mask))
        if "p_points" in scene:   # temporal pairs (reference p_* keys)
            p_padded, p_mask = self.pad_points(scene["p_points"], rng)
            example["p_points"] = p_padded
            example["p_points_mask"] = p_mask
        if self._prep.training:
            gt_boxes = scene["gt_boxes"].astype(np.float64)
            gt_names = scene["gt_names"]
            gt_classes = np.array(
                [self._assigner.classes.index(n) + 1 if n in
                 self._assigner.classes else -1 for n in gt_names],
                np.int32)
            keep = gt_classes > 0
            targets = self._assigner.assign(
                self._anchors_dict, gt_boxes[keep],
                anchors_mask=anchors_mask,
                gt_classes=gt_classes[keep], gt_names=gt_names[keep],
                rng=rng)
            example["labels"] = targets["labels"].astype(np.int32)
            example["reg_targets"] = targets["bbox_targets"].astype(np.float32)
            example["gt_boxes"] = scene["gt_boxes"]
            G = self._prep.max_gt
            padded_gt = np.zeros((G, 7), np.float32)
            kept = gt_boxes[keep][:G]
            padded_gt[:len(kept)] = kept
            gt_valid = np.zeros((G,), bool)
            gt_valid[:len(kept)] = True
            example["gt_boxes_padded"] = padded_gt
            example["gt_valid"] = gt_valid
        return example

    def _fusion_inputs(self, scene: Dict, padded, mask) -> Dict:
        """Fixed-shape camera inputs: padded image + per-point projections
        (`models/fusion.compute_image_projection`). Scenes without an
        image/calib get an all-invalid projection, so the fused model still
        runs (the image branch contributes zeros)."""
        from ..models.fusion import compute_image_projection
        cfg = self._prep
        H, W = cfg.image_shape
        image = np.zeros((H, W, 3), np.float32)
        img = scene.get("image")
        if img is not None:
            h, w = min(H, img.shape[0]), min(W, img.shape[1])
            image[:h, :w] = np.asarray(img, np.float32)[:h, :w]
        rect = scene.get("calib/R0_rect")
        Trv2c = scene.get("calib/Tr_velo_to_cam")
        P2 = scene.get("calib/P2")
        P = cfg.max_points
        if rect is None or Trv2c is None or P2 is None:
            pix = np.zeros((P, 2), np.int32)
            bev = np.zeros((P, 2), np.int32)
            valid = np.zeros((P,), bool)
        else:
            img_hw = (scene.get("img_shape") or (H, W))[:2] if \
                img is None else img.shape[:2]
            pix, bev, valid = compute_image_projection(
                padded, mask, rect, Trv2c, P2, img_hw,
                cfg.pc_range, cfg.voxel_size, cfg.out_stride, self._bev_hw,
                image_stride=cfg.image_stride)
        out = {"image": image, "proj_pix": pix, "proj_bev": bev,
               "proj_valid": valid}
        if cfg.use_zslice:
            out.update(self._zslice_inputs(scene, img))
        return out

    def _zslice_inputs(self, scene: Dict, img) -> Dict:
        """Per-z-slice BEV-cell→P3-pixel grids (`idxs_norm`/`idxs_valid`).
        Depends only on the calibration, so results are cached per calib."""
        from ..models.fusion import compute_bev_zslice_projection
        cfg = self._prep
        D = cfg.num_z_slices
        H, W = self._bev_hw
        rect = scene.get("calib/R0_rect")
        Trv2c = scene.get("calib/Tr_velo_to_cam")
        P2 = scene.get("calib/P2")
        if rect is None or Trv2c is None or P2 is None:
            return {"idxs_norm": np.zeros((D, H, W, 2), np.float32),
                    "idxs_valid": np.zeros((D, H, W), bool)}
        img_hw = (scene.get("img_shape") or cfg.image_shape)[:2] if \
            img is None else img.shape[:2]
        key = (np.asarray(rect).tobytes(), np.asarray(Trv2c).tobytes(),
               np.asarray(P2).tobytes(), tuple(img_hw))
        cache = getattr(self, "_zslice_cache", None)
        if cache is None:
            cache = self._zslice_cache = {}
        if key not in cache:
            if len(cache) > 64:     # bound memory on varied-calib datasets
                cache.clear()
            cache[key] = compute_bev_zslice_projection(
                rect, Trv2c, P2, img_hw, cfg.pc_range,
                cfg.voxel_size, cfg.out_stride, (H, W), D,
                image_stride=cfg.image_stride)
        idxs, valid = cache[key]
        return {"idxs_norm": idxs, "idxs_valid": valid}

    def collate(self, examples: List[Dict]) -> Dict:
        """Stack examples + broadcast the anchor cache."""
        batch = {}
        for key in ("points", "points_mask", "p_points", "p_points_mask",
                    "labels", "reg_targets", "gt_boxes_padded", "gt_valid",
                    "anchors_mask", "image", "proj_pix", "proj_bev",
                    "proj_valid", "idxs_norm", "idxs_valid"):
            if key in examples[0]:
                batch[key] = np.stack([e[key] for e in examples])
        batch["anchors"] = np.broadcast_to(
            self._anchors[None], (len(examples),) + self._anchors.shape).copy()
        batch["image_idx"] = np.array([e["image_idx"] for e in examples])
        return batch


    def sat_mask_info(self):
        """(sat_corners [A,4] int32, grid_hw, threshold) for the in-graph
        eval anchors mask (ops/anchors_mask.py), or None when the
        anchor-area threshold is off."""
        if self._anchors_bv is None:
            return None
        from ..ops.anchors_mask import sat_corner_indices
        cfg = self._prep
        vsize = np.asarray(cfg.voxel_size, np.float32)
        rng_ = np.asarray(cfg.pc_range, np.float32)
        grid = np.round((rng_[3:] - rng_[:3]) / vsize).astype(np.int64)
        corners = sat_corner_indices(self._anchors_bv, vsize, rng_,
                                     (int(grid[0]), int(grid[1])))
        return corners, (int(grid[1]), int(grid[0])), \
            float(cfg.anchor_area_threshold)

    def _compute_anchors_mask(self, points):
        """Occupancy-SAT anchors mask: anchors whose BEV footprint contains
        fewer than `anchor_area_threshold` occupied voxels are pruned
        (reference prep_pointcloud via fused_get_anchors_area)."""
        from .. import runtime
        cfg = self._prep
        vsize = np.asarray(cfg.voxel_size, np.float32)
        rng_ = np.asarray(cfg.pc_range, np.float32)
        _, coords, _ = runtime.points_to_voxel(
            np.ascontiguousarray(points), list(vsize), list(rng_), 1, 200000)
        grid = np.round((rng_[3:] - rng_[:3]) / vsize).astype(np.int64)
        dense = box_np.sparse_sum_for_anchors_mask(
            coords, (int(grid[1]), int(grid[0])))
        cumsum = dense.cumsum(0).cumsum(1)
        area = box_np.fused_get_anchors_area(
            cumsum, self._anchors_bv, vsize[:2], rng_[:2],
            (int(grid[0]), int(grid[1])))
        return area > cfg.anchor_area_threshold
