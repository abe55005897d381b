"""Tracking training + MOT evaluation CLI — the port of
`second_tpu/train/run_tracking.py` (`TrackingTrainer`, `JointTrainer` and
their CLI).

The `train_2st_spatio.py:66-138` equivalent (validate → validate_seq →
write_kitti_result → evaluate_tracking): one `SequenceTrackNet` forward
scores a whole padded [T, D] sequence window (det/link/new/end logits) on
the card, the host runs the Hungarian solver and the id management per
frame pair, and CLEAR-MOT metrics come from `utils.mot_metrics`.
Detections are simulated from the gt unless `--detector_config` names a
detector (`--detector_dir` its checkpoint), whose detections
(`core/inference_ctx.py`, one batch a sequence) pass through `nms_vid`.
`--with_detector` is the joint fine-tune (`JointTrainer`,
`models/joint_track.py`): detection and tracking losses train together,
the tracking loss's gradients reaching the temporal detector. Runs on the
CUDA card unless `--device cpu` is given.

Usage:
  python -m second_tpu_torch.train.run_tracking train --model_dir /tmp/tr
  python -m second_tpu_torch.train.run_tracking evaluate --model_dir /tmp/tr
  python -m second_tpu_torch.train.run_tracking train --model_dir /tmp/tr \
      --detector_config CFG --detector_dir DET   # a detector's detections
  python -m second_tpu_torch.train.run_tracking train --model_dir /tmp/j \
      --with_detector --detector_config CFG [--detector_dir TEMPORAL_DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from ..core import box_np
from ..data.tracking import (KittiTrackingDataset, SyntheticTrackingDataset,
                             TrackingPrep, TrackingPrepConfig,
                             write_kitti_tracking_result)
from ..device import resolve_device
from ..models.build import init_train_weights_
from ..models.tracking import (MemoryTracker, SequenceStitcher,
                               SequenceTrackNet, Tracker)
from ..models.tracking_train import generate_gt, tracking_loss
from ..utils.assignment import solve_frame_pair
from ..utils.mot_metrics import MOTAccumulator
from .checkpoint import CheckpointManager

def _det_keep_reward(det_logit, logit_threshold):
    """Detection keep-reward for the joint assignment objective — the
    reference's `determine_det` eval path (spatio `:1658-1671`): sigmoid
    score, minus 1 for dets below threshold (negative reward: dropped unless
    a strong link rescues them). Threshold is given in logit space for
    backwards compatibility with the old hard gate (0.0 ⇒ p=0.5)."""
    p = 1.0 / (1.0 + np.exp(-np.asarray(det_logit, np.float64)))
    p_thr = 1.0 / (1.0 + np.exp(-float(logit_threshold)))
    return p - (p < p_thr).astype(np.float64)


class TrackingTrainer:
    """Trains the affinity net on (synthetic or KITTI) tracking sequences
    and evaluates CLEAR-MOT end-to-end. Adam at `lr` from flax's
    initialisers drawn from `seed`; checkpoints (net, optimizer, step)
    under `model_dir` as `tracknet-N.pt`."""

    def __init__(self, model_dir, *, data_root: Optional[str] = None,
                 num_frames: int = 4, max_dets: int = 16,
                 feature_dim: int = 128, lr: float = 1e-3, seed: int = 0,
                 dataset_size: int = 64, detector_config: Optional[str] = None,
                 detector_dir: Optional[str] = None,
                 detector_max_points: int = 25000, camera: bool = False,
                 device="cuda"):
        self.device = resolve_device(device)
        self.model_dir = Path(model_dir)
        os.makedirs(self.model_dir, exist_ok=True)
        # camera=True feeds the appearance net CAMERA crops (the reference's
        # modality, spatio `:1594-1642`): KITTI frames load image_02, the
        # synthetic fallback renders a consistent camera per frame
        if data_root:
            self.dataset = KittiTrackingDataset(data_root, load_image=camera)
        else:
            self.dataset = SyntheticTrackingDataset(
                size=dataset_size, seed=seed, num_frames=num_frames,
                with_image=camera,
                num_cars=(3, min(8, max_dets - 2)), num_ground=2000)
        # tracking-by-detection with a real trained detector
        # (`train_2st_spatio.py` runs the spatio detector then tracks;
        # without these args detections are simulated from gt)
        self.det_ctx = None
        if detector_config is not None:
            from ..core.inference_ctx import InferenceContext
            self.det_ctx = InferenceContext(detector_config).build(
                detector_dir, max_points=detector_max_points,
                device=self.device)
        self.prep = TrackingPrep(TrackingPrepConfig(max_dets=max_dets))
        self._rng = np.random.default_rng(seed)
        # JAX's trainer prepares sequence 0 once to initialise its params;
        # drawing it here too keeps the rng, so a seed gives JAX's batches
        self._prep_item(0)
        self.net = SequenceTrackNet(feature_dim=feature_dim)
        init_train_weights_(self.net, seed)
        self.net.to(self.device)
        self.optimizer = torch.optim.Adam(self.net.parameters(), lr=lr)
        self.step = 0
        self.ckpt = CheckpointManager(self.model_dir, name="tracknet")

    # -- checkpoint state ---------------------------------------------------
    def state_dict(self) -> dict:
        return {"model": self.net.state_dict(),
                "optimizer": self.optimizer.state_dict(), "step": self.step}

    def load_state_dict(self, state: dict) -> None:
        self.net.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])

    # -- data -------------------------------------------------------------
    def _sequence(self, idx: int):
        item = self.dataset[idx % len(self.dataset)]
        if not isinstance(item, list):          # KittiTrackingSequence
            item = [item[i] for i in range(len(item))]
        return item

    def _detections(self, frames):
        """Run the detector on a sequence's frames, one batch (None →
        simulate from gt). Its outputs pass through `nms_vid` — the
        reference's pre-tracking cleanup (score gate 0.2 + rotated NMS,
        spatio `:1872-1910`)."""
        if self.det_ctx is None:
            return None
        from ..data.tracking import nms_vid
        dets = self.det_ctx.inference_batch([f["points"] for f in frames])
        return [nms_vid(d["boxes"], d["scores"]) for d in dets]

    def _prep_item(self, idx: int) -> Dict[str, np.ndarray]:
        frames = self._sequence(idx)
        return self.prep(frames, self._rng,
                         detections=self._detections(frames))

    def _tensors(self, arrays) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in arrays.items()}

    @torch.no_grad()
    def _forward(self, crops, points, pmask) -> Dict[str, np.ndarray]:
        """The net's eval forward on one window → numpy outputs."""
        self.net.eval()
        t = self._tensors({"crops": crops, "points": points, "pmask": pmask})
        out = self.net(t["crops"], t["points"], t["pmask"])
        return {k: v.cpu().numpy() for k, v in out.items()}

    # -- training ---------------------------------------------------------
    def train_step(self, batch: Dict[str, torch.Tensor]):
        """One Adam step on one prepared sequence → the loss dict (0-d
        tensors on the device; nothing here reads one on the host)."""
        self.net.train()
        with torch.enable_grad():
            out = self.net(batch["crops"], batch["points"], batch["pmask"])
            gt = generate_gt(batch["det_cls"], batch["det_id"],
                             batch["det_valid"])
            losses = tracking_loss(out["link_logits"], out["end_logits"],
                                   out["new_logits"], out["det_logits"], gt,
                                   batch["det_cls"], batch["det_valid"])
            self.optimizer.zero_grad()
            losses["loss"].backward()
        self.optimizer.step()
        self.step += 1
        return {k: v.detach() for k, v in losses.items()}

    def train(self, steps: int = 200, log_every: int = 20) -> Dict:
        log_path = self.model_dir / "log_tracking.json"
        history = []
        t0 = time.time()
        for step in range(steps):
            losses = self.train_step(self._tensors(self._prep_item(step)))
            if step % log_every == 0 or step == steps - 1:
                rec = {"step": step,
                       **{k: float(v) for k, v in losses.items()},
                       "elapsed_s": round(time.time() - t0, 2)}
                history.append(rec)
                print(json.dumps(rec))
        self.save()
        log_path.write_text(json.dumps(history, indent=1))
        return {"first_loss": history[0]["loss"],
                "last_loss": history[-1]["loss"]}

    def save(self):
        self.ckpt.save(self, self.step)

    def restore(self):
        return self.ckpt.try_restore_latest(self) is not None

    # -- evaluation -------------------------------------------------------
    def evaluate(self, num_sequences: Optional[int] = None,
                 result_dir: Optional[str] = None,
                 det_score_threshold: float = 0.0,
                 tracker_kind: str = "simple") -> Dict:
        """Run tracking over held-out sequences: the affinity forward →
        per-pair Hungarian assignment → Tracker ids → CLEAR-MOT, plus
        KITTI-format result files.

        tracker_kind: "simple" (pairwise id handoff) or "memory"
        (MemoryTracker — tracks carry an embedding refreshed on match,
        the reference's `mem_assign_det_id` semantics)."""
        n = num_sequences or min(len(self.dataset), 8)
        acc = MOTAccumulator()
        result_dir = Path(result_dir or (self.model_dir / "tracking_results"))
        for s in range(n):
            frames = self._sequence(s)
            arrays = self.prep(frames, np.random.default_rng(10_000 + s),
                               detections=self._detections(frames))
            out = self._forward(arrays["crops"], arrays["points"],
                                arrays["pmask"])
            link, end, new = (out["link_logits"], out["end_logits"],
                              out["new_logits"])
            det_logit, feats = out["det_logits"], out["feats"]
            valid = arrays["det_valid"]
            # det keep-reward in the assignment objective (reference
            # `determine_det`: sigmoid score, minus 1 below the threshold so
            # weak dets are kept only when strong links rescue them)
            reward = _det_keep_reward(det_logit, det_score_threshold)

            use_memory = tracker_kind == "memory"
            tracker = MemoryTracker() if use_memory else Tracker()
            frames_id, frames_det = [], []
            prev_keep = None
            for t in range(len(frames)):
                if prev_keep is None:
                    # no pair to solve: keep dets with positive reward
                    kt = np.flatnonzero(valid[t] & (reward[t] > 0))
                    matches = np.zeros((0, 2), np.int64)
                else:
                    ct = np.flatnonzero(valid[t])
                    sub = link[t - 1][np.ix_(prev_keep, ct)]
                    matches, _, kept_cur = solve_frame_pair(
                        sub, end[t - 1][prev_keep], new[t - 1][ct],
                        det_scores_cur=reward[t][ct])
                    kt = ct[kept_cur]
                    # remap cur match indices from ct-space to kt-space
                    pos_in_kt = np.cumsum(kept_cur) - 1
                    matches = np.stack(
                        [matches[:, 0], pos_in_kt[matches[:, 1]]],
                        -1) if len(matches) else matches
                if use_memory:
                    ids = tracker.step(matches, feats[t][kt])
                else:
                    ids = tracker.step(matches, len(kt))
                boxes = arrays["det_boxes"][t][kt]
                bev = box_np.center_to_minmax_2d(boxes[:, :2], boxes[:, 3:5])
                gt_boxes = frames[t]["gt_boxes"]
                gt_bev = box_np.center_to_minmax_2d(
                    gt_boxes[:, :2], gt_boxes[:, 3:5]) if len(gt_boxes) \
                    else np.zeros((0, 4))
                acc.update(list(frames[t]["track_ids"]), gt_bev,
                           list(ids), bev)
                frames_id.append(ids)
                frames_det.append({
                    "frame_idx": frames[t].get("frame_idx", t),
                    "location": boxes[:, :3],
                    "dimensions": boxes[:, 3:6],
                    "rotation_y": boxes[:, 6],
                    "bbox": bev,
                    "score": arrays["det_scores"][t][kt],
                    "name": ["Car"] * len(kt),
                })
                prev_keep = kt
            write_kitti_tracking_result(
                result_dir, f"{s:04d}", frames_id, frames_det)
        summary = {k: float(v) for k, v in acc.summary().items()}
        print(json.dumps(summary))
        (self.model_dir / "mot_summary.json").write_text(
            json.dumps(summary, indent=1))
        return summary

    def evaluate_windowed(self, window: int = 4,
                          num_sequences: Optional[int] = None,
                          det_score_threshold: float = 0.0) -> Dict:
        """Streaming evaluation in bounded windows: sequences longer than
        the net window are processed in overlapping chunks (stride
        window-1, one shared frame) and window-local ids are stitched to
        sequence-global ids by `SequenceStitcher` — the reference's
        `align_id` path (spatio `:407-516`) end-to-end."""
        n = num_sequences or min(len(self.dataset), 8)
        acc = MOTAccumulator()
        for s in range(n):
            frames = self._sequence(s)
            arrays = self.prep(frames, np.random.default_rng(10_000 + s),
                               detections=self._detections(frames))
            T = len(frames)
            stitcher = SequenceStitcher()
            stride = max(1, window - 1)
            for w0 in range(0, max(1, T - 1), stride):
                w1 = min(w0 + window, T)
                if w1 - w0 < 2 and w0 > 0:
                    break
                sl = slice(w0, w1)
                out = self._forward(arrays["crops"][sl],
                                    arrays["points"][sl],
                                    arrays["pmask"][sl])
                link, end, new = (out["link_logits"], out["end_logits"],
                                  out["new_logits"])
                det_logit = out["det_logits"]
                valid_w = arrays["det_valid"][sl]
                reward = _det_keep_reward(det_logit, det_score_threshold)
                tracker = Tracker()
                win_ids, win_dets = [], []
                prev_keep = None
                for t in range(w1 - w0):
                    if prev_keep is None:
                        kt = np.flatnonzero(valid_w[t] & (reward[t] > 0))
                        ids = tracker.step(np.zeros((0, 2), np.int64),
                                           len(kt))
                    else:
                        ct = np.flatnonzero(valid_w[t])
                        sub = link[t - 1][np.ix_(prev_keep, ct)]
                        matches, _, kept_cur = solve_frame_pair(
                            sub, end[t - 1][prev_keep], new[t - 1][ct],
                            det_scores_cur=reward[t][ct])
                        kt = ct[kept_cur]
                        pos_in_kt = np.cumsum(kept_cur) - 1
                        if len(matches):
                            matches = np.stack(
                                [matches[:, 0], pos_in_kt[matches[:, 1]]], -1)
                        ids = tracker.step(matches, len(kt))
                    boxes = arrays["det_boxes"][w0 + t][kt]
                    bev = box_np.center_to_minmax_2d(boxes[:, :2],
                                                     boxes[:, 3:5])
                    win_ids.append(ids)
                    win_dets.append({
                        "frame_idx": frames[w0 + t].get("frame_idx",
                                                        w0 + t),
                        "location": boxes[:, :3], "bbox": bev,
                    })
                    prev_keep = kt
                stitcher.update(win_ids, win_dets,
                                list(range(w0, w1)))
                if w1 == T:
                    break
            # MOT over the stitched global ids
            for t, (ids, det) in enumerate(zip(stitcher.frames_id,
                                               stitcher.frames_det)):
                gt_boxes = frames[t]["gt_boxes"]
                gt_bev = box_np.center_to_minmax_2d(
                    gt_boxes[:, :2], gt_boxes[:, 3:5]) if len(gt_boxes) \
                    else np.zeros((0, 4))
                acc.update(list(frames[t]["track_ids"]), gt_bev,
                           list(ids), det["bbox"])
        summary = {k: float(v) for k, v in acc.summary().items()}
        print(json.dumps({"windowed": True, **summary}))
        return summary


class JointTrainer:
    """Joint detector+tracker fine-tuning — the `train_2st_spatio.py:201-476`
    loop: a temporal-detector checkpoint is restored and detection +
    tracking losses train together, tracking-loss gradients reaching the
    detector's second stage through the differentiable BEV-feature crops
    (`models/joint_track.JointDetTrack`). Adam at `lr` (optax's) from
    flax's initialisers drawn from `seed`; `detector_dir` grafts the latest
    checkpoint of the port's `Trainer --model_type temporal` into the
    detector (strictly: a name or shape that differs raises); checkpoints
    (module, optimizer, step) under `model_dir` as `joint-N.pt`."""

    def __init__(self, model_dir, detector_config, *,
                 detector_dir: Optional[str] = None,
                 data_root: Optional[str] = None, num_frames: int = 4,
                 num_dets: int = 16, lr: float = 3e-4, seed: int = 0,
                 dataset_size: int = 64, max_points: int = 12000,
                 tracking_weight: float = 1.0, device="cuda"):
        from ..config import load_pipeline_config
        from ..data import ExamplePrep, PrepConfig
        from ..models.joint_track import build_joint_det_track
        from ..ops.voxelize import VoxelizeSpec

        self.device = resolve_device(device)
        self.model_dir = Path(model_dir)
        os.makedirs(self.model_dir, exist_ok=True)
        self.cfg = load_pipeline_config(detector_config)
        (self.module, self.spec, self.info, self.assigner,
         self.coder) = build_joint_det_track(self.cfg.model,
                                             num_dets=num_dets,
                                             device=self.device)
        init_train_weights_(self.module, seed)
        vg = self.cfg.model.voxel_generator
        self.vspec = VoxelizeSpec.from_config(
            vg, self.cfg.train_input_reader.max_number_of_voxels)
        self.prep = ExamplePrep(
            self.assigner, self.info.feature_map_size,
            PrepConfig(max_points=max_points, training=True,
                       voxel_size=tuple(vg.voxel_size),
                       pc_range=tuple(vg.point_cloud_range)))
        self.num_frames = num_frames
        self.tracking_weight = tracking_weight
        if data_root:
            self.dataset = KittiTrackingDataset(data_root)
        else:
            self.dataset = SyntheticTrackingDataset(
                size=dataset_size, seed=seed, num_frames=num_frames,
                num_cars=(3, min(8, num_dets - 2)), num_ground=2000,
                pc_range=tuple(vg.point_cloud_range))
        self._rng = np.random.default_rng(seed)
        self._anchors = {}
        # JAX's trainer prepares window 0 once to initialise its params;
        # drawing it here too keeps the rng, so a seed gives JAX's windows
        self._window(0)
        self.restored_detector = False
        if detector_dir is not None:
            raw = CheckpointManager(detector_dir).restore_raw()
            if raw is not None:
                self.module.detector.load_state_dict(raw["model"],
                                                     strict=True)
                self.restored_detector = True
        self.optimizer = torch.optim.Adam(self.module.parameters(), lr=lr)
        self.step = 0
        self.ckpt = CheckpointManager(self.model_dir, name="joint")

    # -- checkpoint state ---------------------------------------------------
    def state_dict(self) -> dict:
        return {"model": self.module.state_dict(),
                "optimizer": self.optimizer.state_dict(), "step": self.step}

    def load_state_dict(self, state: dict) -> None:
        self.module.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])

    # -- data -------------------------------------------------------------
    def _window(self, idx: int) -> Dict[str, torch.Tensor]:
        """One T-frame window → stacked fixed-shape tensors on the device
        (detection targets per frame via ExamplePrep + aligned padded gt
        track ids); the anchors are uploaded once."""
        frames = self.dataset[idx % len(self.dataset)]
        if not isinstance(frames, list):        # KittiTrackingSequence
            frames = [frames[i] for i in range(len(frames))]
        frames = frames[:self.num_frames]
        while len(frames) < self.num_frames:
            frames.append(frames[-1])
        exs, ids_padded = [], []
        G = self.prep._prep.max_gt
        for f in frames:
            exs.append(self.prep(f, self._rng))
            names = np.asarray(f.get(
                "gt_names", np.array(["Car"] * len(f["gt_boxes"]))))
            keep = np.array([n in self.assigner.classes for n in names],
                            bool) if len(names) else np.zeros(0, bool)
            ids = np.asarray(f["track_ids"])[keep][:G]
            pad = np.full(G, -1, np.int64)
            pad[:len(ids)] = ids
            ids_padded.append(pad)
        batch = {k: torch.as_tensor(np.stack([e[k] for e in exs]),
                                    device=self.device)
                 for k in ("points", "points_mask", "labels", "reg_targets",
                           "gt_boxes_padded", "gt_valid")}
        batch["gt_ids"] = torch.as_tensor(np.stack(ids_padded),
                                          device=self.device)
        shape = (self.num_frames,) + self.prep.anchors.shape
        if shape not in self._anchors:
            self._anchors[shape] = torch.as_tensor(
                np.broadcast_to(self.prep.anchors[None], shape).copy(),
                device=self.device)
        batch["anchors"] = self._anchors[shape]
        return batch

    def frames(self, batch) -> Dict[str, torch.Tensor]:
        """The window's clouds voxelized on the device (no grad), with the
        raw clouds: the module's `frames`."""
        from ..models.temporal import _FRAME_KEYS
        from ..ops.voxelize import device_voxelize
        with torch.no_grad():
            vox = device_voxelize(self.vspec, batch["points"],
                                  batch["points_mask"], self.device)
        out = {k: vox[k] for k in _FRAME_KEYS}
        out["points"] = batch["points"]
        out["points_mask"] = batch["points_mask"]
        return out

    def loss(self, batch):
        """The joint loss dict of one window, the module in train mode
        (its norms use and update batch statistics)."""
        from ..models.joint_track import compute_joint_loss
        frames = self.frames(batch)
        self.module.train()
        with torch.enable_grad():
            preds = self.module(frames, batch["anchors"])
            return compute_joint_loss(self.spec, preds, batch,
                                      tracking_weight=self.tracking_weight)

    # -- training ---------------------------------------------------------
    def train_step(self, batch: Dict[str, torch.Tensor]):
        """One Adam step on one window → the loss dict (0-d tensors on the
        device; nothing here reads one on the host)."""
        with torch.enable_grad():
            losses = self.loss(batch)
            self.optimizer.zero_grad()
            losses["loss"].backward()
        self.optimizer.step()
        self.step += 1
        return {k: v.detach() for k, v in losses.items()}

    def train(self, steps: int = 100, log_every: int = 10) -> Dict:
        history = []
        t0 = time.time()
        for step in range(steps):
            losses = self.train_step(self._window(step))
            if step % log_every == 0 or step == steps - 1:
                rec = {"step": step,
                       **{k: float(v) for k, v in losses.items()},
                       "elapsed_s": round(time.time() - t0, 2)}
                history.append(rec)
                print(json.dumps(rec))
        self.ckpt.save(self, self.step)
        (self.model_dir / "log_joint.json").write_text(
            json.dumps(history, indent=1))
        return {"first_loss": history[0]["loss"],
                "last_loss": history[-1]["loss"]}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("action", choices=["train", "evaluate"])
    parser.add_argument("--model_dir", required=True)
    parser.add_argument("--data_root", default=None,
                        help="KITTI tracking split root; synthetic if unset")
    parser.add_argument("--steps", type=int, default=200)
    parser.add_argument("--num_frames", type=int, default=4)
    parser.add_argument("--max_dets", type=int, default=16)
    parser.add_argument("--feature_dim", type=int, default=128)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--num_sequences", type=int, default=None)
    parser.add_argument("--detector_config", default=None,
                        help="pipeline config of a trained detector: track "
                             "its real detections instead of gt-simulated "
                             "ones")
    parser.add_argument("--detector_dir", default=None,
                        help="checkpoint dir for --detector_config")
    parser.add_argument("--camera", action="store_true",
                        help="appearance net consumes camera image crops "
                             "(top_to_img): loads image_02 for KITTI roots, "
                             "renders a synthetic camera otherwise")
    parser.add_argument("--tracker", default="simple",
                        choices=["simple", "memory"],
                        help="id management: pairwise handoff or "
                             "feature-memory (mem_assign_det_id)")
    parser.add_argument("--window", type=int, default=0,
                        help="evaluate in overlapping N-frame windows "
                             "stitched by align_id (0 = whole sequence)")
    parser.add_argument("--with_detector", action="store_true",
                        help="joint detector+tracker fine-tune "
                             "(train_2st_spatio): tracking-loss gradients "
                             "flow into the temporal detector; requires "
                             "--detector_config (+ --detector_dir to resume "
                             "from a temporal detector's checkpoint)")
    parser.add_argument("--tracking_weight", type=float, default=1.0)
    parser.add_argument("--device", default="cuda",
                        help="torch device; the CUDA card by default")
    args = parser.parse_args(argv)
    if args.with_detector:
        if not args.detector_config:
            parser.error("--with_detector needs --detector_config")
        if args.action != "train":
            parser.error("--with_detector is a training mode")
        joint = JointTrainer(
            args.model_dir, args.detector_config,
            detector_dir=args.detector_dir, data_root=args.data_root,
            num_frames=args.num_frames, num_dets=args.max_dets, lr=args.lr,
            tracking_weight=args.tracking_weight, device=args.device)
        return joint.train(args.steps)
    trainer = TrackingTrainer(
        args.model_dir, data_root=args.data_root,
        num_frames=args.num_frames, max_dets=args.max_dets,
        feature_dim=args.feature_dim, lr=args.lr,
        detector_config=args.detector_config,
        detector_dir=args.detector_dir, camera=args.camera,
        device=args.device)
    if args.action == "train":
        trainer.restore()
        trainer.train(args.steps)
        return None
    if not trainer.restore():
        print("warning: no checkpoint found, evaluating untrained net")
    if args.window > 0:
        return trainer.evaluate_windowed(args.window,
                                         num_sequences=args.num_sequences)
    return trainer.evaluate(args.num_sequences, tracker_kind=args.tracker)


if __name__ == "__main__":
    main()
