"""Framework-agnostic inference context — the port of
`second_tpu/core/inference_ctx.py`.

Equivalent of the reference's `second/core/inference.py:11-108`
(`InferenceContext`: build from config, construct a single-example input from
(points, calib, image shape) with a cached anchor grid, run the net, return
detections) — here backed by the port's eval step (`train/state.py`
`make_eval_step`: voxelize → VFE → middle → RPN → decode + rotated NMS on
the card, the anchor-area mask computed there from the voxelizer's coords).
The net is fp32 whatever the config's mixed-precision flag, as JAX's
`build_voxelnet(cfg.model)` builds it.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..config import load_pipeline_config


class InferenceContext:
    """Single-frame inference API over a trained checkpoint.

    Usage:
        ctx = InferenceContext(config_path)
        ctx.build(model_dir)           # the latest checkpoint, or flax's
                                       # initialisers without one
        dets = ctx.inference(points)   # dict boxes/scores/labels (numpy)
    """

    def __init__(self, config_path):
        self.config_path = config_path
        self.cfg = load_pipeline_config(config_path)
        self._built = False

    def build(self, model_dir: Optional[str] = None, max_points=25000,
              device="cuda"):
        """The net, its prep and its eval step on `device` (the CUDA card
        unless the caller asks for the CPU); the latest checkpoint that the
        port's `Trainer` wrote under `model_dir`, where there is one, over
        flax's initialisers (seed 0, JAX's `TrainState.create`)."""
        from ..data import ExamplePrep, PrepConfig
        from ..device import resolve_device
        from ..models import build_voxelnet
        from ..train.checkpoint import CheckpointManager
        from ..train.state import VoxelizeSpec, create_state, make_eval_step

        self.device = resolve_device(device)
        (self.module, self.spec, self.info, self.assigner,
         self.coder) = build_voxelnet(self.cfg.model, device=self.device)
        self.vspec = VoxelizeSpec.from_config(
            self.cfg.model.voxel_generator,
            self.cfg.eval_input_reader.max_number_of_voxels)
        vg = self.cfg.model.voxel_generator
        self.prep = ExamplePrep(
            self.assigner, self.info.feature_map_size,
            PrepConfig(max_points=max_points, training=False,
                       anchor_area_threshold=(
                           self.cfg.eval_input_reader.anchor_area_threshold),
                       voxel_size=tuple(vg.voxel_size),
                       pc_range=tuple(vg.point_cloud_range),
                       # the mask computed on the card (ops/anchors_mask.py),
                       # the reference anchor_cache's anchors_bv contract
                       # (core/inference.py:57-75) without host SAT work
                       device_anchors_mask=True))
        self.state = create_state(self.module,
                                  self.cfg.train_config.optimizer,
                                  self.cfg.train_config.steps)
        self.restored_step = None
        if model_dir is not None:
            ckpt = CheckpointManager(model_dir)
            if ckpt.try_restore_latest(self.state) is not None:
                self.restored_step = self.state.step
        self.module.eval()
        mi = self.prep.sat_mask_info()
        mask_info = None if mi is None else (
            torch.as_tensor(mi[0], device=self.device), mi[1], mi[2])
        self._eval_step = make_eval_step(self.spec, self.vspec,
                                         mask_info=mask_info)
        self._dev_const = {}   # anchors on the device, keyed by shape
        self._built = True
        return self

    def _example(self, points, image_idx=0) -> Dict:
        # each example's padding draws from a generator of its own with one
        # seed (a cloud above max_points is subsampled), so a cloud gives
        # the same detections alone or in any batch
        return self.prep({"points": points, "image_idx": image_idx},
                         np.random.default_rng(0))

    def get_inference_input_dict(self, points: np.ndarray) -> Dict:
        """points [P, C] → batched fixed-shape example (anchor cache
        baked)."""
        assert self._built
        return self.prep.collate([self._example(points)])

    def inference(self, points: np.ndarray) -> Dict:
        return self.inference_batch([points])[0]

    def inference_batch(self, point_clouds) -> list:
        """One forward over a batch of frames (serving micro-batching), in
        `torch.inference_mode`, and one copy of its detections to the
        host: per frame a dict of boxes [n, 7], scores [n], labels [n]
        (numpy) and class_names."""
        assert self._built
        batch = self.prep.collate([self._example(p, i)
                                   for i, p in enumerate(point_clouds)])
        with torch.inference_mode():
            tb = {}
            for k, v in batch.items():
                if k == "image_idx":
                    continue
                if k == "anchors":     # identical every call: upload once
                    key = (k, v.shape)
                    if key not in self._dev_const:
                        self._dev_const[key] = torch.as_tensor(
                            v, device=self.device)
                    tb[k] = self._dev_const[key]
                else:
                    tb[k] = torch.as_tensor(v, device=self.device)
            det = self._eval_step(self.state, tb)
            # the scalar telemetry (voxel and stage overflow) dropped; the
            # rest packed into one tensor and fetched in one copy
            packed = torch.cat(
                [det["boxes"], det["scores"][..., None],
                 det["labels"][..., None].to(det["boxes"].dtype),
                 det["valid"][..., None].to(det["boxes"].dtype)], -1).cpu()
        packed = packed.numpy()
        out = []
        for b in range(len(point_clouds)):
            keep = packed[b, :, 9] > 0
            labels = packed[b, keep, 8].astype(np.int64)
            out.append({
                "boxes": packed[b, keep, :7],
                "scores": packed[b, keep, 7],
                "labels": labels,
                "class_names": [self.assigner.classes[i] for i in labels],
            })
        return out
