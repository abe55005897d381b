"""Training/evaluation CLI — the port of `second_tpu/train/run.py` for the
one-stage model, on a prepared KITTI tree or on synthetic LiDAR scans.

Mirrors the reference's entry points (`second/pytorch/train.py:91 train`,
`:647 evaluate`): config → builders → restore-latest → train loop with
periodic logging, timed checkpointing, crash-save (`train.py:305,434-438,
505-509`), and periodic full evaluation with official KITTI AP. Runs on the
CUDA card unless `--device cpu` is given.

Usage:
    python -m second_tpu_torch.train.run train --config_path C \
        --model_dir D [--synthetic] [--steps N] [--profile_steps N] \
        [--device cpu]
    python -m second_tpu_torch.train.run evaluate --config_path C \
        --model_dir D [--synthetic] [--device cpu]

Every model type of the JAX trainer: `model_type="one_stage"` (SECOND
car.fhd and multi-class, PointPillars), `"two_stage"` (any of them as stage
1 of the rotated-ROI refine detector, `models/detector_two_stage.py`),
`"temporal"` (the two-frame gated-fusion detector, `models/temporal.py`),
and the camera-fusion ones: `"fusion"` (`models/fusion.py`
`FusionVoxelNet`), `"fusion_two_stage"` (`models/detector_fusion_two_stage.py`)
and `"temporal_fusion"` (`models/temporal.py` `TemporalFusionVoxelNet`),
whose examples carry the camera image on an `image_hw` canvas (`--image_hw
H W`; 192 x 624 for synthetic data, KITTI's 384 x 1248 otherwise) and its
projections. The data: the KITTI infos the config's input readers name
(`data/kitti_dataset.py`, prepared by `python -m
second_tpu_torch.data.kitti_dataset`, with the `image_2` frames for the
fusion types; for `temporal` and `temporal_fusion`, (cur, prev) frame
pairs of the KITTI-tracking split root the readers' `kitti_root_path`
names, `data/tracking.py`, with its `image_02` frames for
`temporal_fusion`) or, with `synthetic=True`, the scan scenes the JAX
trainer uses under `--synthetic` (frame pairs, `SyntheticPairDataset`, for
the temporal types; rendered camera images for the fusion types). The
config's anchor-area mask is computed on the host for target assignment in
training; in evaluation on the device from the voxelizer's coords, except
for the fusion types, whose eval examples carry the host mask, as JAX's
trainer prepares them.

Data parallelism, as JAX's `Trainer` takes it up over its devices: under a
`torch.distributed` process group of more than one rank (`torchrun
--nproc_per_node=N -m second_tpu_torch.train.run ...`: NCCL on the cards,
gloo with `--device cpu`), training runs data-parallel where the train
reader's batch divides by the ranks, and evaluation where the eval
reader's does (`parallel/`): every rank builds the same global batch and
takes its slice; only rank 0 writes checkpoints, logs and results.
"""

from __future__ import annotations

import argparse
import datetime
import os
import pathlib
import pickle
import shutil
import sys
import time
from typing import Optional

import numpy as np
import torch

from ..config import load_pipeline_config
from ..data import ExamplePrep, PrepConfig
from ..data import kitti
from ..data.kitti_dataset import KittiDataset
from ..data.synthetic import SyntheticDataset
from ..device import resolve_device
from ..models import (build_fusion_two_stage_voxelnet,
                      build_fusion_voxelnet, build_temporal_fusion_voxelnet,
                      build_temporal_voxelnet, build_two_stage_voxelnet,
                      build_voxelnet)
from ..parallel.mesh import data_sharding, make_dp_train_step, make_group
from ..utils import kitti_eval
from .checkpoint import CheckpointManager
from .metrics import MetricsLogger, Scalar, StageTimer
from .prefetch import PrefetchIterator, bounded_ordered_map
from .state import (VoxelizeSpec, create_state, make_eval_step,
                    make_train_step)
from .steps_multistage import (make_fusion_steps,
                               make_fusion_two_stage_steps,
                               make_temporal_fusion_steps,
                               make_temporal_steps, make_two_stage_steps)

# model type → (builder, steps maker); one_stage's are `build_voxelnet`
# with the config's mixed precision and `make_train_step` /
# `make_eval_step`. Every other model is fp32 on every config, as JAX's
# `Trainer` builds it (`build_*_voxelnet(cfg.model)`)
_MULTISTAGE = {
    "two_stage": (build_two_stage_voxelnet, make_two_stage_steps),
    "temporal": (build_temporal_voxelnet, make_temporal_steps),
    "fusion": (build_fusion_voxelnet, make_fusion_steps),
    "fusion_two_stage": (build_fusion_two_stage_voxelnet,
                         make_fusion_two_stage_steps),
    "temporal_fusion": (build_temporal_fusion_voxelnet,
                        make_temporal_fusion_steps),
}
MODEL_TYPES = ("one_stage", *_MULTISTAGE)
FUSION_TYPES = ("fusion", "fusion_two_stage", "temporal_fusion")


def _synthetic_lidar_to_camera_annos(boxes, names=None, scores=None):
    """Map lidar-frame boxes to camera-frame anno dicts with dummy image
    boxes, for AP computation on synthetic data (no real calib). gt and dt
    must go through this same transform, so overlaps are preserved."""
    boxes = np.asarray(boxes, np.float64).reshape(-1, 7)
    n = len(boxes)
    loc = np.stack([-boxes[:, 1], -boxes[:, 2], boxes[:, 0]], 1)
    dims = np.stack([boxes[:, 4], boxes[:, 5], boxes[:, 3]], 1)  # l, h, w
    rot = -boxes[:, 6]
    anno = {
        "name": np.array(names if names is not None else ["Car"] * n),
        "truncated": np.zeros(n),
        "occluded": np.zeros(n, np.int64),
        "alpha": np.full(n, -10.0),
        "bbox": np.tile(np.array([[0.0, 0.0, 200.0, 200.0]]), (n, 1)),
        "dimensions": dims,
        "location": loc,
        "rotation_y": rot,
        "score": (np.asarray(scores, np.float64) if scores is not None
                  else np.zeros(n)),
    }
    return anno


def apply_config_patches(cfg, patches):
    """Apply `--patchs` runtime config edits (reference `train.py:109-121`
    exec's `config.<patch>`; here the path is navigated and the value
    literal-eval'd — same expressiveness for the assignment form, no exec).

    Each patch is `dotted.path=python_literal`, e.g.
    `train_config.steps=100` or
    `model.target_assigner.anchor_generators[0].sizes=[1.6, 3.9, 1.56]`.
    """
    import ast
    import re
    for patch in patches or []:
        path, sep, value = patch.partition("=")
        if not sep:
            raise ValueError(f"patch {patch!r} must look like path=value")
        obj = cfg
        parts = path.strip().split(".")
        for i, part in enumerate(parts):
            m = re.fullmatch(r"(\w+)((?:\[\d+\])*)", part)
            if not m:
                raise ValueError(f"bad patch path component {part!r}")
            name, idxs = m.group(1), re.findall(r"\[(\d+)\]", m.group(2))
            last = i == len(parts) - 1
            if last and not idxs:
                setattr(obj, name, ast.literal_eval(value.strip()))
            else:
                obj = getattr(obj, name)
                for j, idx in enumerate(idxs):
                    if last and j == len(idxs) - 1:
                        obj[int(idx)] = ast.literal_eval(value.strip())
                    else:
                        obj = obj[int(idx)]
    return cfg


class _Silent:
    """The logger of a rank other than 0: it writes nothing."""

    def log(self, *args, **kwargs):
        pass

    def log_text(self, *args, **kwargs):
        pass

    def close(self):
        pass


class Trainer:
    def __init__(self, config_path, model_dir, synthetic=False,
                 dataset_size=256, max_points=20000, total_steps=None,
                 model_type="one_stage", patches=None, device="cuda",
                 image_hw=None):
        if model_type not in MODEL_TYPES:
            raise ValueError(f"unknown model_type {model_type!r}")
        self.model_type = model_type
        self.use_fusion = model_type in FUSION_TYPES
        self.use_zslice = model_type == "temporal_fusion"
        self.device = resolve_device(device)
        # the process group this trainer is a rank of (one rank without)
        self.group = make_group()
        self.rank, self.world = data_sharding(self.group)
        self.is_chief = self.rank == 0
        self.cfg = apply_config_patches(load_pipeline_config(config_path),
                                        patches)
        self.model_dir = pathlib.Path(model_dir)
        self.model_dir.mkdir(parents=True, exist_ok=True)
        # keep the resolved config beside the run (reference train.py:114-122)
        if self.is_chief:
            shutil.copy(config_path, self.model_dir / "pipeline.config")

        if model_type == "one_stage":
            (self.module, self.spec, self.info, self.assigner,
             self.coder) = build_voxelnet(
                self.cfg.model, device=self.device,
                mixed_precision=self.cfg.train_config.enable_mixed_precision)
        else:
            (self.module, self.spec, self.info, self.assigner,
             self.coder) = _MULTISTAGE[model_type][0](self.cfg.model,
                                                      device=self.device)
        # shuffle_overflow: the train cap is sized for memory (reference
        # trains fhd at 16k voxels vs 40k eval, config `:121-123`) so
        # overflow is expected — drop a pseudorandom subset, not the
        # z-biased smallest-key cut that amputates the scene top
        self.vspec = VoxelizeSpec.from_config(
            self.cfg.model.voxel_generator,
            self.cfg.train_input_reader.max_number_of_voxels,
            shuffle_overflow=True)
        # eval gets its own voxel capacity (reference evaluates fhd with 40k
        # voxels vs 16k train, config `:121,198`)
        self.eval_vspec = VoxelizeSpec.from_config(
            self.cfg.model.voxel_generator,
            self.cfg.eval_input_reader.max_number_of_voxels
            or self.cfg.train_input_reader.max_number_of_voxels)
        vg = self.cfg.model.voxel_generator
        # the camera canvas of the fusion types' examples
        self.image_shape = tuple(image_hw) if image_hw else (
            (192, 624) if synthetic else (384, 1248))
        fusion_kwargs = dict(use_fusion=self.use_fusion,
                             image_shape=self.image_shape,
                             out_stride=self.info.out_size_factor,
                             use_zslice=self.use_zslice)
        # the anchor-area mask, where the config asks for one, prunes the
        # target assignment on the host (`runtime.points_to_voxel` → SAT)
        self.prep = ExamplePrep(
            self.assigner, self.info.feature_map_size,
            PrepConfig(max_points=max_points,
                       shuffle_points=self.cfg.train_input_reader.shuffle_points,
                       training=True,
                       anchor_area_threshold=(
                           self.cfg.train_input_reader.anchor_area_threshold),
                       voxel_size=tuple(vg.voxel_size),
                       pc_range=tuple(vg.point_cloud_range),
                       **fusion_kwargs))
        # eval-time prep: no target assignment (the reference's
        # prep_pointcloud with training=False); the anchor-area mask moves
        # onto the device, computed from the voxelizer's coords, except for
        # the fusion types (JAX's trainer prepares theirs on the host)
        self.eval_prep = ExamplePrep(
            self.assigner, self.info.feature_map_size,
            PrepConfig(max_points=max_points, training=False,
                       anchor_area_threshold=(
                           self.cfg.eval_input_reader.anchor_area_threshold),
                       voxel_size=tuple(vg.voxel_size),
                       pc_range=tuple(vg.point_cloud_range),
                       device_anchors_mask=not self.use_fusion,
                       **fusion_kwargs))
        self.synthetic = synthetic
        pairs = model_type in ("temporal", "temporal_fusion")
        if synthetic and pairs:
            from ..data.synthetic import SyntheticPairDataset
            pair_kwargs = dict(pc_range=tuple(vg.point_cloud_range),
                               with_image=self.use_zslice,
                               image_shape=self.image_shape)
            self.train_ds = SyntheticPairDataset(dataset_size, seed=1,
                                                 **pair_kwargs)
            self.eval_ds = SyntheticPairDataset(max(32, dataset_size // 8),
                                                seed=2, **pair_kwargs)
        elif synthetic:
            # scan geometry (not uniform scatter): realistic voxel
            # occupancy and sparse-stage dilation. Scenes carry every class
            # the config's target assigner detects.
            pc_range = tuple(vg.point_cloud_range)
            cls = set(self.assigner.classes)
            cls_kwargs = {}
            if "Pedestrian" in cls:
                cls_kwargs["num_peds"] = (1, 6)
            if "Cyclist" in cls:
                cls_kwargs["num_cyclists"] = (1, 4)
            if "Car" not in cls:
                cls_kwargs["num_cars"] = (0, 0)
            cls_kwargs.update(with_image=self.use_fusion,
                              image_shape=self.image_shape)
            self.train_ds = SyntheticDataset(dataset_size, seed=1,
                                             pc_range=pc_range, scan=True,
                                             **cls_kwargs)
            self.eval_ds = SyntheticDataset(max(32, dataset_size // 8),
                                            seed=2, pc_range=pc_range,
                                            scan=True, **cls_kwargs)
        elif pairs:
            # KITTI tracking-benchmark sequences → (cur, prev) frame pairs
            # (reader root = the tracking split dir: label_02, velodyne,
            # calib; temporal_fusion also loads the image_02 frames)
            from ..data.tracking import (KittiTrackingDataset,
                                         TrackingPairDataset)
            self.train_ds = TrackingPairDataset(KittiTrackingDataset(
                self.cfg.train_input_reader.kitti_root_path,
                load_image=self.use_zslice))
            self.eval_ds = TrackingPairDataset(KittiTrackingDataset(
                self.cfg.eval_input_reader.kitti_root_path,
                load_image=self.use_zslice))
        else:
            self.train_ds = KittiDataset(
                self.cfg.train_input_reader.kitti_info_path,
                self.cfg.train_input_reader.kitti_root_path,
                training=True, load_image=self.use_fusion,
                input_cfg=self.cfg.train_input_reader)
            self.eval_ds = KittiDataset(
                self.cfg.eval_input_reader.kitti_info_path,
                self.cfg.eval_input_reader.kitti_root_path,
                training=False, load_image=self.use_fusion,
                input_cfg=self.cfg.eval_input_reader)

        self.total_steps = total_steps or self.cfg.train_config.steps
        # the in-graph anchors mask: its SAT corners uploaded once
        mi = self.eval_prep.sat_mask_info()
        self._eval_mask_info = None if mi is None else \
            (torch.as_tensor(mi[0], device=self.device), mi[1], mi[2])
        if model_type == "one_stage":
            self.train_step = make_train_step(self.spec, self.vspec)
            self.eval_step = make_eval_step(self.spec, self.vspec,
                                            self.eval_vspec,
                                            mask_info=self._eval_mask_info)
        else:
            self.train_step, self.eval_step = _MULTISTAGE[model_type][1](
                self.spec, self.vspec, self.eval_vspec,
                mask_info=self._eval_mask_info)
        # data parallelism over the group's ranks where a reader's batch
        # divides by them (JAX `:256-299`): the eval step sharded with its
        # statistics reduced, and the train step sharded through DDP with
        # the norms' statistics over the global batch
        self._last_eval_stats = None
        if self.world > 1 and \
                self.cfg.eval_input_reader.batch_size % self.world == 0:
            if model_type == "one_stage":
                self._setup_dp_eval()
            else:
                self._setup_dp_eval_generic()
        self._train_group = None
        if self.world > 1 and \
                self.cfg.train_input_reader.batch_size % self.world == 0:
            self._setup_dp_train()
        self.ckpt = CheckpointManager(self.model_dir)
        self.logger = MetricsLogger(self.model_dir) if self.is_chief \
            else _Silent()
        self.timer = StageTimer()

    def _setup_dp_train(self):
        """The train step over the group: each rank's slice of the global
        batch, through DDP (`parallel.mesh.make_dp_train_step`, which wraps
        the module, and so broadcasts it from rank 0, at its first step)."""
        self._train_group = self.group
        self.train_step = make_dp_train_step(self.train_step, self.group)

    def _setup_dp_eval(self):
        """The one-stage eval step over the group: each rank's slice,
        statistics reduced, detections gathered
        (`parallel.eval_dp.make_dp_eval_step`)."""
        from ..parallel.eval_dp import make_dp_eval_step, stats_to_dict
        dp_step = make_dp_eval_step(self.spec, self.eval_vspec, self.group,
                                    mask_info=self._eval_mask_info)

        def eval_step(state, batch):
            det, stats = dp_step(state, batch)
            det["voxel_overflow"] = stats[-1]
            self._last_eval_stats = stats_to_dict(stats)
            return det

        self.eval_step = eval_step

    def _setup_dp_eval_generic(self):
        """Any other model type's eval step over the group
        (`parallel.eval_dp.make_dp_eval_any`)."""
        from ..parallel.eval_dp import make_dp_eval_any, stats_to_dict
        dp_step = make_dp_eval_any(self.eval_step, self.group)

        def eval_step(state, batch):
            det, stats = dp_step(state, batch)
            self._last_eval_stats = stats_to_dict(stats)
            return det

        self.eval_step = eval_step

    # -- data --------------------------------------------------------------
    def _to_device(self, batch, dev_const):
        """numpy batch → tensors on the device; the anchors (the same grid
        every batch) are uploaded once."""
        out = {}
        for k, v in batch.items():
            if k == "image_idx":
                continue
            if k == "anchors":
                key = (k, v.shape)
                if key not in dev_const:
                    dev_const[key] = torch.as_tensor(v, device=self.device)
                out[k] = dev_const[key]
            else:
                out[k] = torch.as_tensor(v, device=self.device)
        return out

    def _batch_iter(self, batch_size, rng):
        order = rng.permutation(len(self.train_ds))
        pos = 0
        dev_const = {}
        while True:
            if pos + batch_size > len(order):
                order = rng.permutation(len(self.train_ds))
                pos = 0
            examples = [self.prep(self.train_ds[int(i)], rng)
                        for i in order[pos:pos + batch_size]]
            pos += batch_size
            yield self._to_device(self.prep.collate(examples), dev_const)

    def _init_state(self, ckpt_step=None):
        """A fresh state (flax's initialisers, seed 0), then the requested
        or latest checkpoint over it if there is one."""
        state = create_state(self.module, self.cfg.train_config.optimizer,
                             self.total_steps)
        if ckpt_step is not None:   # reference evaluate(ckpt_path=...)
            state = self.ckpt.restore(state, step=ckpt_step)
            print(f"restored checkpoint at step {ckpt_step}")
        else:
            restored = self.ckpt.try_restore_latest(state)
            if restored is not None:
                state = restored
                print(f"restored checkpoint at step {state.step}")
        return state

    # -- loops -------------------------------------------------------------
    def train(self, total_steps: Optional[int] = None,
              profile_steps: int = 0):
        """`profile_steps > 0` traces that many steps with torch.profiler
        (host, and the card's kernels on the card) into model_dir/profile,
        a TensorBoard/Chrome trace; off, it adds nothing to the loop."""
        tc = self.cfg.train_config
        total_steps = total_steps or self.total_steps
        batch_size = self.cfg.train_input_reader.batch_size
        rng = np.random.default_rng(0)
        raw = self._batch_iter(batch_size, rng)
        workers = max(1, min(4, self.cfg.train_input_reader.num_workers))
        batches = PrefetchIterator(
            lambda: next(raw), num_workers=workers,
            prefetch_size=min(8, self.cfg.train_input_reader.prefetch_size))
        state = self._init_state()
        avg_loss = Scalar()
        last_ckpt_time = time.time()
        step = state.step
        profiler = self._start_profile() if profile_steps else None
        profile_until = step + profile_steps
        try:
            while step < total_steps:
                if profiler is not None and step == profile_until:
                    profiler.stop()
                    profiler = None
                self.timer.start("data")
                batch = next(batches)
                self.timer.end("data")
                self.timer.start("step")
                state, metrics = self.train_step(state, batch)
                step = state.step
                self.timer.end("step")
                avg_loss.update(metrics["loss"])
                if step % tc.save_summary_steps == 0:
                    log = {k: float(v) for k, v in metrics.items()}
                    log["lr"] = float(state.lr_sched(step))
                    log["avg_loss"] = avg_loss.value
                    log.update({f"time/{k}": v
                                for k, v in self.timer.averages().items()})
                    self.logger.log(step, log, prefix="train")
                    self.timer.clear()
                if time.time() - last_ckpt_time > tc.save_checkpoints_secs:
                    self._save(state, step)
                    last_ckpt_time = time.time()
                if tc.steps_per_eval and step % tc.steps_per_eval == 0:
                    self._save(state, step)
                    self.evaluate(state)
        except BaseException:
            # crash-save, like the reference's try/except around the loop
            self._save(state, state.step)
            raise
        finally:
            if profiler is not None:
                profiler.stop()
            batches.close()
        self._save(state, state.step)
        return state

    def _save(self, state, step):
        """A checkpoint, written by rank 0 only."""
        if self.is_chief:
            self.ckpt.save(state, step)

    def _start_profile(self):
        from torch.profiler import (ProfilerActivity, profile,
                                    tensorboard_trace_handler)
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        profiler = profile(activities=acts, on_trace_ready=(
            tensorboard_trace_handler(str(self.model_dir / "profile"))))
        profiler.start()
        return profiler

    def _convert_detections(self, det, scenes, gt_annos, dt_annos):
        """Detections of one batch (numpy) → camera-frame anno dicts: for
        synthetic scenes gt and dt through the same mapping; for KITTI
        frames the detections through the frame's calibration, the gt as
        the frame's annos."""
        class_names = np.asarray(self.assigner.classes)
        for b, scene in enumerate(scenes):
            valid = det["valid"][b]
            if self.synthetic or "annos" not in scene:
                if not self._predict_test:
                    gt_annos.append(_synthetic_lidar_to_camera_annos(
                        scene["gt_boxes"], scene["gt_names"]))
                dt_annos.append(_synthetic_lidar_to_camera_annos(
                    det["boxes"][b][valid],
                    class_names[np.clip(det["labels"][b][valid], 0,
                                        len(class_names) - 1)],
                    det["scores"][b][valid]))
            else:
                dt_annos.append(kitti.detections_to_kitti_annos(
                    {k: v[b] for k, v in det.items()},
                    scene["calib/R0_rect"], scene["calib/Tr_velo_to_cam"],
                    scene["calib/P2"], scene.get("img_shape"),
                    self.assigner.classes,
                    self.cfg.model.post_center_limit_range))
                if not self._predict_test:
                    gt_annos.append(scene["annos"])

    def evaluate(self, state=None, max_frames: Optional[int] = None,
                 ckpt_step: Optional[int] = None,
                 predict_test: bool = False):
        """predict_test: write detections (pkl + KITTI txt) without scoring
        against gt (the reference's test-split submission mode,
        train.py:652,659-662). ckpt_step: evaluate a specific saved step
        instead of the latest (reference `ckpt_path`)."""
        self._predict_test = predict_test
        if state is None:
            state = self._init_state(ckpt_step=ckpt_step)
        batch_size = self.cfg.eval_input_reader.batch_size
        n = len(self.eval_ds)
        if max_frames:
            n = min(n, max_frames)
        dev_const = {}

        def make_batch(start):
            rng = np.random.default_rng(start)
            scenes = [self.eval_ds[i] for i in range(start,
                                                     start + batch_size)]
            examples = [self.eval_prep(s, rng) for s in scenes]
            return scenes, self.eval_prep.collate(examples)

        workers = max(1, min(4, self.cfg.eval_input_reader.num_workers))
        starts = range(0, n - n % batch_size, batch_size)
        gt_annos, dt_annos = [], []
        overflow = {"voxel_overflow": 0, "stage_overflow": 0}
        t0 = time.time()
        t_first = None   # end of the first batch
        bar = None
        if sys.stdout.isatty() and len(starts) > 1:
            from ..utils.misc import ProgressBar
            bar = ProgressBar(len(starts))
        for scenes, batch in bounded_ordered_map(
                make_batch, starts, num_workers=workers, prefetch=8):
            det = self.eval_step(state, self._to_device(batch, dev_const))
            det = {k: v.cpu().numpy() for k, v in det.items()}
            for key in overflow:
                overflow[key] += int(det.pop(key))
            self._convert_detections(det, scenes, gt_annos, dt_annos)
            if t_first is None:
                t_first = time.time()
            if bar is not None:
                bar.update()
        dt = time.time() - t0
        fps = len(dt_annos) / max(dt, 1e-9)
        steady_fps = (max(0, len(dt_annos) - batch_size) /
                      max(time.time() - (t_first or t0), 1e-9))
        classes = list(self.assigner.classes)
        if predict_test:
            text, detail = "predict_test: detections written, no gt eval", {}
        else:
            text, detail = kitti_eval.get_official_eval_result(
                gt_annos, dt_annos, classes)
            # reference prints the COCO-style AP right after the official
            # one on every eval (train.py:772-776)
            coco_text, _ = kitti_eval.get_coco_eval_result(
                gt_annos, dt_annos, classes)
            text = text + "\n" + coco_text
        step = state.step
        if self.is_chief:
            self._write_results(step, predict_test, dt_annos, gt_annos)
        self.logger.log_text(step, "eval", text)
        self.logger.log(step, {"frames_per_sec": fps,
                               "frames_per_sec_steady": steady_fps,
                               **overflow, **{
            k: v[1] for k, v in detail.items() if "/3d" in k}}, prefix="eval")
        return detail

    def _write_results(self, step, predict_test, dt_annos, gt_annos):
        """The detections persisted like the reference's (train.py:443,501:
        per-frame KITTI annos under eval_results/step_N/result.pkl), by
        rank 0."""
        result_name = "predict_test" if predict_test else "eval_results"
        result_dir = self.model_dir / result_name / f"step_{step}"
        result_dir.mkdir(parents=True, exist_ok=True)
        with open(result_dir / "result.pkl", "wb") as f:
            pickle.dump(dt_annos, f)
        if not predict_test:
            with open(result_dir / "gt.pkl", "wb") as f:
                pickle.dump(gt_annos, f)
        # KITTI submission-format label files, one per frame (reference
        # train.py:781-790)
        txt_dir = result_dir / "txt"
        txt_dir.mkdir(exist_ok=True)
        for i, anno in enumerate(dt_annos):
            idx = anno.get("image_idx", i)
            idx = int(np.atleast_1d(idx)[0]) if np.size(idx) else i
            lines = kitti.annos_to_kitti_label(anno)
            with open(txt_dir / f"{idx:06d}.txt", "w") as f:
                f.write("\n".join(lines) + ("\n" if lines else ""))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("command", choices=["train", "evaluate"])
    parser.add_argument("--config_path", required=True)
    parser.add_argument("--model_dir", required=True)
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--steps", type=int, default=None)
    parser.add_argument("--dataset_size", type=int, default=256)
    parser.add_argument("--max_points", type=int, default=20000)
    parser.add_argument("--max_frames", type=int, default=None)
    parser.add_argument("--model_type", default="one_stage",
                        choices=MODEL_TYPES)
    parser.add_argument("--patchs", action="append", default=None,
                        metavar="PATH=VALUE",
                        help="runtime config patch, repeatable "
                             "(e.g. --patchs train_config.steps=100)")
    parser.add_argument("--ckpt_step", type=int, default=None,
                        help="evaluate a specific checkpoint step instead "
                             "of the latest (reference --ckpt_path)")
    parser.add_argument("--predict_test", action="store_true",
                        help="write detections (pkl + KITTI txt) without "
                             "scoring against gt (reference predict_test "
                             "test-split submission mode)")
    parser.add_argument("--profile_steps", type=int, default=0,
                        help="trace the first N train steps with "
                             "torch.profiler into model_dir/profile")
    parser.add_argument("--device", default="cuda",
                        help="torch device; the CUDA card by default")
    parser.add_argument("--image_hw", type=int, nargs=2, default=None,
                        metavar=("H", "W"),
                        help="camera canvas override for fusion model types")
    args = parser.parse_args(argv)
    device, joined = join_launch_group(args.device)
    try:
        trainer = Trainer(args.config_path, args.model_dir, args.synthetic,
                          args.dataset_size, args.max_points,
                          total_steps=args.steps,
                          model_type=args.model_type, patches=args.patchs,
                          device=device, image_hw=args.image_hw)
        if args.command == "train":
            trainer.train(args.steps, profile_steps=args.profile_steps)
        else:
            trainer.evaluate(max_frames=args.max_frames,
                             ckpt_step=args.ckpt_step,
                             predict_test=args.predict_test)
    finally:
        if joined:
            import torch.distributed as dist
            dist.destroy_process_group()


# how long a collective waits for the other ranks before it fails
GROUP_TIMEOUT = datetime.timedelta(minutes=10)


def join_launch_group(device):
    """Join the process group that `torchrun` describes in the environment
    (WORLD_SIZE, RANK, LOCAL_RANK, MASTER_ADDR, MASTER_PORT), if it does:
    NCCL with this rank on card LOCAL_RANK, or gloo where `device` is the
    CPU, collectives timing out after GROUP_TIMEOUT. Returns (this rank's
    device, whether a group was joined)."""
    if "WORLD_SIZE" not in os.environ:
        return device, False
    import torch.distributed as dist
    if torch.device(device).type == "cpu":
        dist.init_process_group("gloo", timeout=GROUP_TIMEOUT)
        return device, True
    local = int(os.environ.get("LOCAL_RANK", 0))
    torch.cuda.set_device(local)
    dist.init_process_group("nccl", timeout=GROUP_TIMEOUT)
    return f"cuda:{local}", True


if __name__ == "__main__":
    main()
