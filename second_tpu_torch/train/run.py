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

Ported: `model_type="one_stage"` (SECOND car.fhd and multi-class,
PointPillars) and `"two_stage"` (any of them as stage 1 of the rotated-ROI
refine detector, `models/detector_two_stage.py`), on the KITTI infos the config's input readers name
(`data/kitti_dataset.py`, prepared by `python -m
second_tpu_torch.data.kitti_dataset`) or, with `synthetic=True`, on the
scan scenes the JAX trainer uses under `--synthetic`; with the config's
anchor-area mask: computed on the host for target assignment in training,
on the device from the voxelizer's coords in evaluation. Every other model
type and data-parallel training raise `NotImplementedError` naming their
ROADMAP item.
"""

from __future__ import annotations

import argparse
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
from ..models import build_two_stage_voxelnet, build_voxelnet
from ..utils import kitti_eval
from .checkpoint import CheckpointManager
from .metrics import MetricsLogger, Scalar, StageTimer
from .prefetch import PrefetchIterator, bounded_ordered_map
from .state import (VoxelizeSpec, create_state, make_eval_step,
                    make_train_step)
from .steps_multistage import make_two_stage_steps

_NOT_PORTED = {
    "fusion": "ROADMAP item 14 (fusion)",
    "fusion_two_stage": "ROADMAP item 14 (fusion)",
    "temporal": "ROADMAP item 15 (temporal and tracking)",
    "temporal_fusion": "ROADMAP item 15 (temporal and tracking)",
}


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


class Trainer:
    def __init__(self, config_path, model_dir, synthetic=False,
                 dataset_size=256, max_points=20000, total_steps=None,
                 model_type="one_stage", patches=None, device="cuda"):
        if model_type in _NOT_PORTED:
            raise NotImplementedError(
                f"model_type {model_type!r} is not ported yet: "
                f"{_NOT_PORTED[model_type]}")
        if model_type not in ("one_stage", "two_stage"):
            raise ValueError(f"unknown model_type {model_type!r}")
        self.model_type = model_type
        self.device = resolve_device(device)
        self.cfg = apply_config_patches(load_pipeline_config(config_path),
                                        patches)
        self.model_dir = pathlib.Path(model_dir)
        self.model_dir.mkdir(parents=True, exist_ok=True)
        # keep the resolved config beside the run (reference train.py:114-122)
        shutil.copy(config_path, self.model_dir / "pipeline.config")

        build = build_voxelnet if model_type == "one_stage" \
            else build_two_stage_voxelnet
        (self.module, self.spec, self.info, self.assigner,
         self.coder) = build(
            self.cfg.model, device=self.device,
            mixed_precision=self.cfg.train_config.enable_mixed_precision)
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
                       pc_range=tuple(vg.point_cloud_range)))
        # eval-time prep: no target assignment (the reference's
        # prep_pointcloud with training=False); the anchor-area mask moves
        # onto the device, computed from the voxelizer's coords
        self.eval_prep = ExamplePrep(
            self.assigner, self.info.feature_map_size,
            PrepConfig(max_points=max_points, training=False,
                       anchor_area_threshold=(
                           self.cfg.eval_input_reader.anchor_area_threshold),
                       voxel_size=tuple(vg.voxel_size),
                       pc_range=tuple(vg.point_cloud_range),
                       device_anchors_mask=True))
        self.synthetic = synthetic
        if synthetic:
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
            self.train_ds = SyntheticDataset(dataset_size, seed=1,
                                             pc_range=pc_range, scan=True,
                                             **cls_kwargs)
            self.eval_ds = SyntheticDataset(max(32, dataset_size // 8),
                                            seed=2, pc_range=pc_range,
                                            scan=True, **cls_kwargs)
        else:
            self.train_ds = KittiDataset(
                self.cfg.train_input_reader.kitti_info_path,
                self.cfg.train_input_reader.kitti_root_path,
                training=True, input_cfg=self.cfg.train_input_reader)
            self.eval_ds = KittiDataset(
                self.cfg.eval_input_reader.kitti_info_path,
                self.cfg.eval_input_reader.kitti_root_path,
                training=False, input_cfg=self.cfg.eval_input_reader)

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
            self.train_step, self.eval_step = make_two_stage_steps(
                self.spec, self.vspec, self.eval_vspec,
                mask_info=self._eval_mask_info)
        self.ckpt = CheckpointManager(self.model_dir)
        self.logger = MetricsLogger(self.model_dir)
        self.timer = StageTimer()

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
                    self.ckpt.save(state, step)
                    last_ckpt_time = time.time()
                if tc.steps_per_eval and step % tc.steps_per_eval == 0:
                    self.ckpt.save(state, step)
                    self.evaluate(state)
        except BaseException:
            # crash-save, like the reference's try/except around the loop
            self.ckpt.save(state, state.step)
            raise
        finally:
            if profiler is not None:
                profiler.stop()
            batches.close()
        self.ckpt.save(state, state.step)
        return state

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
        # detections persisted like the reference's (train.py:443,501:
        # per-frame KITTI annos under eval_results/step_N/result.pkl)
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
        self.logger.log_text(step, "eval", text)
        self.logger.log(step, {"frames_per_sec": fps,
                               "frames_per_sec_steady": steady_fps,
                               **overflow, **{
            k: v[1] for k, v in detail.items() if "/3d" in k}}, prefix="eval")
        return detail


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
                        choices=["one_stage", "two_stage", *_NOT_PORTED])
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
    args = parser.parse_args(argv)
    trainer = Trainer(args.config_path, args.model_dir, args.synthetic,
                      args.dataset_size, args.max_points,
                      total_steps=args.steps, model_type=args.model_type,
                      patches=args.patchs, device=args.device)
    if args.command == "train":
        trainer.train(args.steps, profile_steps=args.profile_steps)
    else:
        trainer.evaluate(max_frames=args.max_frames,
                         ckpt_step=args.ckpt_step,
                         predict_test=args.predict_test)


if __name__ == "__main__":
    main()
