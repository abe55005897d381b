"""KITTI tracking-benchmark data layer + tracking training prep.

Reconstruction of the reference's `kitti_common_tracking_vid` reader and
`utils_tr.data_util.write_kitti_result` (both imported by
`train_2st_spatio.py:22-64` from modules absent in the reference tree —
rebuilt here from the KITTI tracking devkit format and the call sites),
plus a synthetic-sequence fallback so the tracking loop trains and
evaluates without mounted data.

TPU-first prep: a sequence window is padded to static [T, D] detections
(validity-masked), per-det inputs are fixed-size BEV rasters and point
sets, so one jitted `SequenceTrackNet` forward covers the whole window.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..core import box_np
from .kitti import parse_calib_lines
from .synthetic import render_synthetic_image, sample_sequence, synthetic_calib


# ---------------------------------------------------------------------------
# KITTI tracking benchmark reader
# ---------------------------------------------------------------------------

def parse_tracking_label(path) -> Dict[int, Dict]:
    """Parse one `label_02/SSSS.txt`: per line
    `frame track_id type trunc occl alpha bbox(4) dims(hwl) loc(xyz) ry`.
    Returns {frame: annotation dict with track_ids}."""
    frames: Dict[int, Dict] = {}
    with open(path) as f:
        for line in f:
            parts = line.strip().split(" ")
            if len(parts) < 17:
                continue
            frame = int(parts[0])
            anno = frames.setdefault(frame, {
                "track_ids": [], "name": [], "truncated": [], "occluded": [],
                "alpha": [], "bbox": [], "dimensions": [], "location": [],
                "rotation_y": []})
            anno["track_ids"].append(int(parts[1]))
            anno["name"].append(parts[2])
            anno["truncated"].append(float(parts[3]))
            anno["occluded"].append(int(float(parts[4])))
            anno["alpha"].append(float(parts[5]))
            anno["bbox"].append([float(x) for x in parts[6:10]])
            # KITTI label order h, w, l → store l, h, w (camera box conv)
            h, w, l = (float(parts[10]), float(parts[11]), float(parts[12]))
            anno["dimensions"].append([l, h, w])
            anno["location"].append([float(x) for x in parts[13:16]])
            anno["rotation_y"].append(float(parts[16]))
    for anno in frames.values():
        anno["track_ids"] = np.array(anno["track_ids"], np.int64)
        anno["name"] = np.array(anno["name"])
        for k in ("truncated", "alpha", "rotation_y"):
            anno[k] = np.array(anno[k], np.float32)
        anno["occluded"] = np.array(anno["occluded"], np.int32)
        for k in ("bbox", "dimensions", "location"):
            anno[k] = np.array(anno[k], np.float32).reshape(
                len(anno["track_ids"]), -1)
    return frames


class KittiTrackingSequence:
    """One KITTI tracking sequence: frames with lidar points, lidar-frame gt
    boxes, names, and track ids. Layout:
    root/velodyne/SSSS/FFFFFF.bin, root/label_02/SSSS.txt,
    root/calib/SSSS.txt."""

    def __init__(self, root, seq: str, tracked_classes=("Car", "Van"),
                 load_image: bool = False):
        self.root = Path(root)
        self.name = seq
        self.load_image = load_image
        self.tracked_classes = set(tracked_classes)
        self.calib = None
        calib_path = self.root / "calib" / f"{seq}.txt"
        if calib_path.exists():
            # tracking-devkit calibs spell the keys R_rect / Tr_velo_cam,
            # sometimes without the trailing colon
            lines = []
            for ln in calib_path.read_text().splitlines():
                ln = (ln.replace("R_rect", "R0_rect")
                        .replace("Tr_velo_cam", "Tr_velo_to_cam")
                        .replace("Tr_imu_velo", "Tr_imu_to_velo"))
                if ln.strip() and ":" not in ln:
                    key, _, rest = ln.partition(" ")
                    ln = f"{key}: {rest}"
                lines.append(ln)
            raw = parse_calib_lines(lines)
            self.calib = {k.split("/", 1)[-1]: v for k, v in raw.items()}
        label_path = self.root / "label_02" / f"{seq}.txt"
        self.labels = (parse_tracking_label(label_path)
                       if label_path.exists() else {})
        velo_dir = self.root / "velodyne" / seq
        self.frame_ids = sorted(
            int(p.stem) for p in velo_dir.glob("*.bin")) if \
            velo_dir.exists() else sorted(self.labels)

    def __len__(self):
        return len(self.frame_ids)

    def __getitem__(self, i: int) -> Dict:
        frame = self.frame_ids[i]
        velo = self.root / "velodyne" / self.name / f"{frame:06d}.bin"
        points = (np.fromfile(velo, np.float32).reshape(-1, 4)
                  if velo.exists() else np.zeros((0, 4), np.float32))
        anno = self.labels.get(frame)
        if anno is None or len(anno["track_ids"]) == 0:
            gt_boxes = np.zeros((0, 7), np.float32)
            names = np.array([], dtype="<U16")
            ids = np.zeros((0,), np.int64)
            bbox = np.zeros((0, 4), np.float32)
        else:
            keep = np.array([n in self.tracked_classes or n == "DontCare"
                             for n in anno["name"]])
            cam = np.concatenate(
                [anno["location"], anno["dimensions"],
                 anno["rotation_y"][:, None]], axis=1)[keep]
            if self.calib is not None and len(cam):
                gt_boxes = box_np.box_camera_to_lidar(
                    cam, self.calib["R0_rect"],
                    self.calib["Tr_velo_to_cam"]).astype(np.float32)
            else:
                gt_boxes = cam.astype(np.float32)
            names = anno["name"][keep]
            ids = anno["track_ids"][keep]
            bbox = anno["bbox"][keep]
        out = {"points": points, "gt_boxes": gt_boxes, "gt_names": names,
               "track_ids": ids, "gt_bbox2d": bbox, "frame_idx": frame,
               "calib": self.calib}
        if self.calib is not None:
            for k in ("R0_rect", "Tr_velo_to_cam", "P2"):
                if k in self.calib:
                    out[f"calib/{k}"] = self.calib[k]
        if self.load_image:
            img_path = self.root / "image_02" / self.name / f"{frame:06d}.png"
            if img_path.exists():
                from PIL import Image
                img = np.asarray(Image.open(img_path), np.float32) / 255.0
                out["image"] = img
                out["img_shape"] = img.shape[:2]
        return out


class KittiTrackingDataset:
    """All sequences under a KITTI tracking split root."""

    def __init__(self, root, sequences: Optional[Sequence[str]] = None,
                 **seq_kwargs):
        self.root = Path(root)
        if sequences is None:
            label_dir = self.root / "label_02"
            velo_dir = self.root / "velodyne"
            if label_dir.exists():
                sequences = sorted(p.stem for p in label_dir.glob("*.txt"))
            elif velo_dir.exists():
                sequences = sorted(p.name for p in velo_dir.iterdir())
            else:
                sequences = []
        self.sequences = [KittiTrackingSequence(root, s, **seq_kwargs)
                          for s in sequences]

    def __len__(self):
        return len(self.sequences)

    def __getitem__(self, i) -> KittiTrackingSequence:
        return self.sequences[i]


def write_kitti_tracking_result(result_dir, seq_name: str, frames_id,
                                frames_det, part: str = "val") -> str:
    """KITTI tracking submission format, one file per sequence
    (`write_kitti_result` equivalent): per line
    `frame id type trunc occl alpha bbox(4) hwl loc ry score`."""
    out_dir = Path(result_dir) / part
    os.makedirs(out_dir, exist_ok=True)
    path = out_dir / f"{seq_name}.txt"
    lines = []
    for ids, det in zip(frames_id, frames_det):
        frame = int(det.get("frame_idx", 0))
        n = len(ids)
        if n == 0:
            continue
        bbox = np.asarray(det.get("bbox", np.zeros((n, 4)))).reshape(n, -1)
        dims = np.asarray(det.get("dimensions",
                                  np.zeros((n, 3)))).reshape(n, -1)
        loc = np.asarray(det.get("location", np.zeros((n, 3)))).reshape(n, -1)
        rot = np.asarray(det.get("rotation_y", np.zeros(n))).reshape(n)
        alpha = np.asarray(det.get("alpha", np.zeros(n))).reshape(n)
        score = np.asarray(det.get("score", np.ones(n))).reshape(n)
        names = det.get("name", ["Car"] * n)
        for j in range(n):
            # result dims order back to KITTI h, w, l
            l, h, w = dims[j] if dims.shape[1] == 3 else (0, 0, 0)
            lines.append(
                f"{frame} {int(ids[j])} {names[j]} 0 0 {alpha[j]:.4f} "
                f"{bbox[j, 0]:.2f} {bbox[j, 1]:.2f} {bbox[j, 2]:.2f} "
                f"{bbox[j, 3]:.2f} {h:.2f} {w:.2f} {l:.2f} "
                f"{loc[j, 0]:.2f} {loc[j, 1]:.2f} {loc[j, 2]:.2f} "
                f"{rot[j]:.4f} {score[j]:.4f}")
    path.write_text("\n".join(lines) + ("\n" if lines else ""))
    return str(path)


class TrackingPairDataset:
    """Flattens tracking sequences into (cur, prev) frame-pair examples for
    the temporal detector — the `input_reader_tr_vid_spatio` equivalent
    (`train_2st_spatio.py:22-32` imports it from an absent module; the
    example contract is the `p_*` keys consumed by
    `train/steps_multistage.make_temporal_steps`).

    Wraps any dataset of sequences (:class:`KittiTrackingDataset` or
    :class:`SyntheticTrackingDataset`-style); item t of a sequence pairs
    with its predecessor (frame 0 pairs with itself, matching the
    reference's first-frame handling).
    """

    def __init__(self, sequences):
        self._seqs = sequences
        self._index: List = []
        for s in range(len(sequences)):
            seq = sequences[s]
            for t in range(len(seq)):
                self._index.append((s, t))

    def __len__(self):
        return len(self._index)

    def __getitem__(self, idx) -> Dict:
        s, t = self._index[idx]
        seq = self._seqs[s]
        cur = seq[t]
        prev = seq[t - 1] if t > 0 else cur
        out = {
            "points": cur["points"],
            "gt_boxes": cur["gt_boxes"],
            "gt_names": cur.get("gt_names",
                                np.array(["Car"] * len(cur["gt_boxes"]))),
            "track_ids": cur.get("track_ids"),
            "p_points": prev["points"],
            "p_gt_boxes": prev["gt_boxes"],
            "image_idx": idx,
            "calib": cur.get("calib"),
        }
        # camera keys for the temporal-fusion (spatio) model: only the
        # CURRENT frame's image feeds the RPN (reference spatio :712-716)
        for k in ("image", "img_shape", "calib/R0_rect",
                  "calib/Tr_velo_to_cam", "calib/P2"):
            if isinstance(cur, dict) and k in cur:
                out[k] = cur[k]
        return out


# ---------------------------------------------------------------------------
# Synthetic tracking sequences (no mounted data)
# ---------------------------------------------------------------------------

class SyntheticTrackingDataset:
    """Sequences of moving synthetic scenes with persistent track ids — the
    stand-in for :class:`KittiTrackingDataset`. With `with_image=True` every
    frame carries a synthetic camera render + calib keys, so the tracker's
    appearance branch sees camera crops (the reference's modality)."""

    def __init__(self, size=32, seed=0, num_frames=4, with_image=False,
                 image_shape=(192, 624), **seq_kwargs):
        self._size = size
        self._seed = seed
        self._num_frames = num_frames
        self._with_image = with_image
        self._image_shape = tuple(image_shape)
        self._kwargs = seq_kwargs

    def __len__(self):
        return self._size

    def __getitem__(self, idx) -> List[Dict]:
        rng = np.random.default_rng(self._seed * 7919 + idx)
        frames = sample_sequence(rng, num_frames=self._num_frames,
                                 **self._kwargs)
        for t, f in enumerate(frames):
            f["frame_idx"] = t
            if self._with_image:
                rect, velo2cam, P2 = synthetic_calib(self._image_shape)
                f["image"] = render_synthetic_image(
                    f["points"], self._image_shape, rect, velo2cam, P2)
                f["img_shape"] = self._image_shape
                f["calib/R0_rect"] = rect
                f["calib/Tr_velo_to_cam"] = velo2cam
                f["calib/P2"] = P2
        return frames


def simulate_detections(gt_boxes, rng, *, loc_noise=0.15, dim_noise=0.05,
                        yaw_noise=0.05, drop_p=0.1, num_fp=(0, 2),
                        pc_range=(0.0, -39.68, -3.0, 69.12, 39.68, 1.0)):
    """Detector-output stand-in for tracking training: gt boxes jittered,
    some dropped, plus background false positives. Returns det boxes
    [D, 7] and scores [D]."""
    dets = []
    for b in np.asarray(gt_boxes, np.float32):
        if rng.random() < drop_p:
            continue
        d = b.copy()
        d[:2] += rng.normal(0, loc_noise, 2)
        d[3:6] *= 1 + rng.normal(0, dim_noise, 3)
        d[6] += rng.normal(0, yaw_noise)
        dets.append(d)
    for _ in range(int(rng.integers(num_fp[0], num_fp[1] + 1))):
        x = rng.uniform(pc_range[0] + 2, pc_range[3] - 2)
        y = rng.uniform(pc_range[1] + 2, pc_range[4] - 2)
        dets.append(np.array(
            [x, y, -1.7, 1.6, 3.9, 1.56, rng.uniform(-np.pi, np.pi)],
            np.float32))
    det_boxes = (np.stack(dets) if dets else
                 np.zeros((0, 7), np.float32)).astype(np.float32)
    scores = np.clip(rng.uniform(0.4, 1.0, len(det_boxes)), 0, 1)
    return det_boxes, scores.astype(np.float32)


def nms_vid(det_boxes, det_scores, *, score_threshold: float = 0.2,
            iou_threshold: float = 0.1, post_max_size: int = 100):
    """Pre-tracking detection cleanup — the reference's `nms_vid`
    (spatio `:1872-1910`): sigmoid-score gate at 0.2, then rotated BEV NMS
    over the survivors. Returns (boxes, scores) of the kept detections."""
    from ..core import nms_np
    det_boxes = np.asarray(det_boxes, np.float32)
    det_scores = np.asarray(det_scores, np.float32)
    keep = det_scores >= score_threshold
    det_boxes, det_scores = det_boxes[keep], det_scores[keep]
    if not len(det_boxes):
        return det_boxes, det_scores
    bev = det_boxes[:, [0, 1, 3, 4, 6]]
    sel = nms_np.greedy_nms(bev, det_scores, iou_threshold=iou_threshold,
                            rotated=True, max_out=post_max_size)
    return det_boxes[sel], det_scores[sel]


def bilinear_resize(img, out_hw):
    """Bilinear resize [h, w, C] → [H, W, C] (numpy, half-pixel centers)."""
    h, w = img.shape[:2]
    H, W = out_hw
    if h == 0 or w == 0:
        return np.zeros((H, W) + img.shape[2:], np.float32)
    ys = np.clip((np.arange(H) + 0.5) * h / H - 0.5, 0, h - 1)
    xs = np.clip((np.arange(W) + 0.5) * w / W - 0.5, 0, w - 1)
    y0 = np.floor(ys).astype(np.int32)
    x0 = np.floor(xs).astype(np.int32)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    fy = (ys - y0).astype(np.float32)[:, None, None]
    fx = (xs - x0).astype(np.float32)[None, :, None]
    im = np.asarray(img, np.float32)
    top = im[y0][:, x0] * (1 - fx) + im[y0][:, x1] * fx
    bot = im[y1][:, x0] * (1 - fx) + im[y1][:, x1] * fx
    return top * (1 - fy) + bot * fy


def camera_det_crops(image, det_boxes, rect, Trv2c, P2, size: int):
    """Camera image crops of lidar-frame detections — the reference's
    `top_to_img` (spatio `:1912-1986`): lidar box → camera box → 3D corners
    (origin (0.5, 1.0, 0.5)) → projected 2D bbox, clamped to the image;
    crops are bilinear-resized to [size, size]. Boxes behind the camera or
    with a degenerate on-image footprint get ok=False (caller falls back to
    the BEV raster). Returns (crops [n, S, S, C], ok [n] bool)."""
    det_boxes = np.asarray(det_boxes, np.float32)
    n = len(det_boxes)
    C = image.shape[2] if image.ndim == 3 else 1
    crops = np.zeros((n, size, size, C), np.float32)
    ok = np.zeros(n, bool)
    if n == 0:
        return crops, ok
    cam = box_np.box_lidar_to_camera(det_boxes, rect, Trv2c)
    bbox = box_np.box3d_to_bbox(cam, P2)                   # [n, 4] xyxy
    H, W = image.shape[:2]
    behind = cam[:, 2] <= 0.1                              # camera-frame depth
    x1 = np.clip(bbox[:, 0], 0, W).astype(np.int32)
    y1 = np.clip(bbox[:, 1], 0, H).astype(np.int32)
    x2 = np.clip(bbox[:, 2], 0, W).astype(np.int32)
    y2 = np.clip(bbox[:, 3], 0, H).astype(np.int32)
    img = np.asarray(image, np.float32).reshape(H, W, C)
    for i in range(n):
        if behind[i] or x2[i] - x1[i] < 2 or y2[i] - y1[i] < 2:
            continue
        crops[i] = bilinear_resize(img[y1[i]:y2[i], x1[i]:x2[i]],
                                   (size, size))
        ok[i] = True
    return crops, ok


# ---------------------------------------------------------------------------
# Static-shape per-detection inputs
# ---------------------------------------------------------------------------

def bev_det_raster(points, box, size: int = 24, extent: float = 1.5):
    """Fixed-size BEV raster around one detection: channels (log point
    count, max height above box bottom, mean intensity). The lidar-only
    analog of the reference's camera image crops (`top_to_img`,
    spatio `:1912-2055`) for the appearance net."""
    cx, cy, cz = box[0], box[1], box[2]
    half_w = max(box[3], 0.5) * extent / 2
    half_l = max(box[4], 0.5) * extent / 2
    c, s = np.cos(-box[6]), np.sin(-box[6])
    dx = points[:, 0] - cx
    dy = points[:, 1] - cy
    lx = dx * c - dy * s
    ly = dx * s + dy * c
    m = (np.abs(lx) < half_l) & (np.abs(ly) < half_w)
    out = np.zeros((size, size, 3), np.float32)
    if not np.any(m):
        return out
    ix = np.clip(((lx[m] / half_l + 1) * 0.5 * size).astype(np.int32),
                 0, size - 1)
    iy = np.clip(((ly[m] / half_w + 1) * 0.5 * size).astype(np.int32),
                 0, size - 1)
    hz = (points[m, 2] - cz).astype(np.float32)
    inten = points[m, 3].astype(np.float32) if points.shape[1] > 3 else \
        np.zeros(m.sum(), np.float32)
    np.add.at(out[:, :, 0], (iy, ix), 1.0)
    np.maximum.at(out[:, :, 1], (iy, ix), hz)
    np.add.at(out[:, :, 2], (iy, ix), inten)
    cnt = np.maximum(out[:, :, 0], 1.0)
    out[:, :, 2] /= cnt
    out[:, :, 0] = np.log1p(out[:, :, 0])
    return out


def det_point_set(points, box, max_points: int, rng, extent: float = 1.2):
    """Up-to-`max_points` points inside the (slightly enlarged) box, in the
    box-local frame — PointNet input. Returns (pts [P, 3], mask [P])."""
    enlarged = np.asarray(box, np.float32).copy()
    enlarged[3:6] *= extent
    mask = box_np.points_in_rbbox(points[:, :3], enlarged[None])[:, 0]
    idx = np.flatnonzero(mask)
    out = np.zeros((max_points, 3), np.float32)
    valid = np.zeros(max_points, bool)
    if len(idx):
        if len(idx) > max_points:
            idx = rng.choice(idx, max_points, replace=False)
        local = points[idx, :3] - box[None, :3]
        c, s = np.cos(-box[6]), np.sin(-box[6])
        out[:len(idx), 0] = local[:, 0] * c - local[:, 1] * s
        out[:len(idx), 1] = local[:, 0] * s + local[:, 1] * c
        out[:len(idx), 2] = local[:, 2]
        valid[:len(idx)] = True
    return out, valid


@dataclass
class TrackingPrepConfig:
    max_dets: int = 16          # D: static per-frame detection budget
    crop_size: int = 24
    max_points_per_det: int = 128
    iou_threshold: float = 0.5
    tracked_class: str = "Car"


class TrackingPrep:
    """Sequence of frames → static [T, D] tracking-training arrays.

    Each frame contributes up to D detections (simulated from gt when no
    detector output is supplied) with appearance crops, local point sets,
    and gt association labels from
    :func:`models.tracking_train.match_dets_to_gt`.

    Appearance crops are CAMERA image crops (the reference's `top_to_img` →
    AppearanceNet modality, spatio `:1594-1642,1912-1986`) whenever the
    frame carries an image + calib; detections that don't project into the
    image — and frames without a camera — fall back to BEV point rasters.
    """

    def __init__(self, cfg: TrackingPrepConfig = TrackingPrepConfig()):
        self.cfg = cfg

    def __call__(self, frames: List[Dict], rng,
                 detections: Optional[List] = None) -> Dict:
        from ..models.tracking_train import match_dets_to_gt

        cfg = self.cfg
        T, D, S, P = (len(frames), cfg.max_dets, cfg.crop_size,
                      cfg.max_points_per_det)
        out = {
            "crops": np.zeros((T, D, S, S, 3), np.float32),
            "points": np.zeros((T, D, P, 3), np.float32),
            "pmask": np.zeros((T, D, P), bool),
            "det_boxes": np.zeros((T, D, 7), np.float32),
            "det_scores": np.zeros((T, D), np.float32),
            "det_valid": np.zeros((T, D), bool),
            "det_id": -np.ones((T, D), np.int64),
            "det_cls": np.zeros((T, D), np.int8),
        }
        for t, frame in enumerate(frames):
            if detections is not None:
                det_boxes, det_scores = detections[t]
            else:
                det_boxes, det_scores = simulate_detections(
                    frame["gt_boxes"], rng)
            n = min(len(det_boxes), D)
            if len(det_boxes) > D:      # keep highest-score dets
                keep = np.argsort(-det_scores)[:D]
                det_boxes, det_scores = det_boxes[keep], det_scores[keep]
            det_bev = box_np.center_to_minmax_2d(
                det_boxes[:n, :2], det_boxes[:n, 3:5])
            gt = frame["gt_boxes"]
            gt_bev = box_np.center_to_minmax_2d(gt[:, :2], gt[:, 3:5]) if \
                len(gt) else np.zeros((0, 4), np.float32)
            det_id, det_cls = match_dets_to_gt(
                det_bev, gt_bev, frame["track_ids"],
                frame.get("gt_names", np.array(["Car"] * len(gt))),
                tracked_class=cfg.tracked_class,
                iou_threshold=cfg.iou_threshold)
            pts = frame["points"]
            img = frame.get("image")
            cam_ok = np.zeros(n, bool)
            if img is not None and "calib/P2" in frame:
                cam_crops, cam_ok = camera_det_crops(
                    img, det_boxes[:n], frame["calib/R0_rect"],
                    frame["calib/Tr_velo_to_cam"], frame["calib/P2"], S)
                if cam_crops.shape[-1] < 3:       # grayscale → 3 channels
                    cam_crops = np.repeat(cam_crops[..., :1], 3, -1)
            for j in range(n):
                out["crops"][t, j] = (cam_crops[j][..., :3] if cam_ok[j]
                                      else bev_det_raster(pts, det_boxes[j],
                                                          S))
                out["points"][t, j], out["pmask"][t, j] = det_point_set(
                    pts, det_boxes[j], P, rng)
            out["det_boxes"][t, :n] = det_boxes[:n]
            out["det_scores"][t, :n] = det_scores[:n]
            out["det_valid"][t, :n] = True
            out["det_id"][t, :n] = det_id
            out["det_cls"][t, :n] = det_cls
        return out
