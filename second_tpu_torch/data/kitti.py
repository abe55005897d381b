"""KITTI dataset utilities: labels, calib, infos, result writing.

Reconstruction of the reference's absent `second/data/kitti_common.py`
(imported at `second/create_data.py:20-50` and `second/pytorch/train.py:481+`;
required behavior catalogued in SURVEY.md §2.4): label/calib parsing into anno
dicts, image-info pkl creation, difficulty computation, KITTI result-file
formatting, and the camera-frame box extraction used by the training pipeline.

Anno dict fields: name, truncated, occluded, alpha, bbox [N,4],
dimensions [N,3 (l,h,w)], location [N,3], rotation_y [N], score [N],
index, group_ids, difficulty.
"""

from __future__ import annotations

import pathlib
import pickle
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..core import box_np


def get_image_index_str(img_idx: int) -> str:
    return f"{img_idx:06d}"


def area(boxes):
    return (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])


# ---------------------------------------------------------------------------
# Label files
# ---------------------------------------------------------------------------

def empty_annotations() -> Dict:
    return {
        "name": np.zeros((0,), dtype="<U20"),
        "truncated": np.zeros((0,)),
        "occluded": np.zeros((0,), np.int64),
        "alpha": np.zeros((0,)),
        "bbox": np.zeros((0, 4)),
        "dimensions": np.zeros((0, 3)),
        "location": np.zeros((0, 3)),
        "rotation_y": np.zeros((0,)),
        "score": np.zeros((0,)),
    }


def get_start_result_anno() -> Dict:
    """Growable result anno (reference kitti_common.get_start_result_anno)."""
    return {k: [] for k in ("name", "truncated", "occluded", "alpha", "bbox",
                            "dimensions", "location", "rotation_y", "score")}


def empty_result_anno() -> Dict:
    return empty_annotations()


def parse_label_lines(lines: Sequence[str]) -> Dict:
    """KITTI label.txt lines → anno dict."""
    anno = get_start_result_anno()
    for line in lines:
        parts = line.strip().split(" ")
        if len(parts) < 15:
            continue
        anno["name"].append(parts[0])
        anno["truncated"].append(float(parts[1]))
        anno["occluded"].append(int(float(parts[2])))
        anno["alpha"].append(float(parts[3]))
        anno["bbox"].append([float(v) for v in parts[4:8]])
        # file order is h, w, l → store (l, h, w) like the reference
        h, w, l = (float(v) for v in parts[8:11])
        anno["dimensions"].append([l, h, w])
        anno["location"].append([float(v) for v in parts[11:14]])
        anno["rotation_y"].append(float(parts[14]))
        anno["score"].append(float(parts[15]) if len(parts) > 15 else 0.0)
    n = len(anno["name"])
    out = {
        "name": np.array(anno["name"]),
        "truncated": np.array(anno["truncated"]),
        "occluded": np.array(anno["occluded"], np.int64),
        "alpha": np.array(anno["alpha"]),
        "bbox": np.array(anno["bbox"]).reshape(n, 4),
        "dimensions": np.array(anno["dimensions"]).reshape(n, 3),
        "location": np.array(anno["location"]).reshape(n, 3),
        "rotation_y": np.array(anno["rotation_y"]),
        "score": np.array(anno["score"]),
    }
    num_objects = int((out["name"] != "DontCare").sum())
    out["index"] = np.concatenate(
        [np.arange(num_objects, dtype=np.int32),
         -np.ones(n - num_objects, np.int32)])
    out["group_ids"] = np.arange(n, dtype=np.int32)
    return out


def get_label_anno(label_path) -> Dict:
    with open(label_path, "r") as f:
        return parse_label_lines(f.readlines())


def get_label_annos(label_folder, image_ids=None) -> List[Dict]:
    folder = pathlib.Path(label_folder)
    if image_ids is None:
        image_ids = sorted(int(p.stem) for p in folder.glob("*.txt"))
    annos = []
    for idx in image_ids:
        anno = get_label_anno(folder / f"{get_image_index_str(idx)}.txt")
        anno["image_idx"] = idx
        annos.append(anno)
    return annos


def kitti_result_line(result_dict: Dict, precision: int = 4) -> str:
    """One KITTI result-file line from a per-object dict."""
    p = precision
    name = result_dict["name"]
    bbox = result_dict["bbox"]
    dims = result_dict["dimensions"]      # (l, h, w)
    loc = result_dict["location"]
    return " ".join([
        name,
        f"{result_dict.get('truncated', -1):.{p}f}",
        str(int(result_dict.get('occluded', -1))),
        f"{result_dict.get('alpha', -10):.{p}f}",
        *(f"{v:.{p}f}" for v in bbox),
        f"{dims[1]:.{p}f}", f"{dims[2]:.{p}f}", f"{dims[0]:.{p}f}",  # h w l
        *(f"{v:.{p}f}" for v in loc),
        f"{result_dict['rotation_y']:.{p}f}",
        f"{result_dict.get('score', 0.0):.{p}f}",
    ])


def annos_to_kitti_label(annos: Dict) -> List[str]:
    lines = []
    for i in range(len(annos["name"])):
        lines.append(kitti_result_line({
            "name": annos["name"][i],
            "truncated": annos["truncated"][i],
            "occluded": annos["occluded"][i],
            "alpha": annos["alpha"][i],
            "bbox": annos["bbox"][i],
            "dimensions": annos["dimensions"][i],
            "location": annos["location"][i],
            "rotation_y": annos["rotation_y"][i],
            "score": annos["score"][i],
        }))
    return lines


# ---------------------------------------------------------------------------
# Calibration files
# ---------------------------------------------------------------------------

def _extend_matrix(mat):
    return np.concatenate([mat, np.array([[0., 0., 0., 1.]])], axis=0)


def parse_calib_lines(lines: Sequence[str], extend: bool = True) -> Dict:
    vals = {}
    for line in lines:
        if ":" not in line:
            continue
        key, data = line.split(":", 1)
        vals[key.strip()] = np.array(
            [float(v) for v in data.strip().split(" ")])
    out = {}
    for i in range(4):
        key = f"P{i}"
        if key in vals:
            P = vals[key].reshape(3, 4)
            out[f"calib/{key}"] = _extend_matrix(P) if extend else P
    if "R0_rect" in vals:
        r = np.eye(4)
        r[:3, :3] = vals["R0_rect"].reshape(3, 3)
        out["calib/R0_rect"] = r if extend else r[:3, :3]
    if "Tr_velo_to_cam" in vals:
        tr = vals["Tr_velo_to_cam"].reshape(3, 4)
        out["calib/Tr_velo_to_cam"] = _extend_matrix(tr) if extend else tr
    if "Tr_imu_to_velo" in vals:
        tr = vals["Tr_imu_to_velo"].reshape(3, 4)
        out["calib/Tr_imu_to_velo"] = _extend_matrix(tr) if extend else tr
    return out


def get_calib(calib_path, extend: bool = True) -> Dict:
    with open(calib_path, "r") as f:
        return parse_calib_lines(f.readlines(), extend)


# ---------------------------------------------------------------------------
# Info dicts (create_data support)
# ---------------------------------------------------------------------------

def add_difficulty_to_annos(annos: Dict) -> np.ndarray:
    """Per-object KITTI difficulty (0 easy / 1 moderate / 2 hard / -1)."""
    min_height = [40, 25, 25]
    max_occlusion = [0, 1, 2]
    max_trunc = [0.15, 0.3, 0.5]
    dims = annos["bbox"]
    height = dims[:, 3] - dims[:, 1]
    occlusion = annos["occluded"]
    truncation = annos["truncated"]
    diff = []
    for h, o, t in zip(height, occlusion, truncation):
        if h >= min_height[0] and o <= max_occlusion[0] and t <= max_trunc[0]:
            diff.append(0)
        elif h >= min_height[1] and o <= max_occlusion[1] and t <= max_trunc[1]:
            diff.append(1)
        elif h >= min_height[2] and o <= max_occlusion[2] and t <= max_trunc[2]:
            diff.append(2)
        else:
            diff.append(-1)
    annos["difficulty"] = np.array(diff, np.int32)
    return annos["difficulty"]


def get_kitti_image_info(path, training=True, label_info=True, velodyne=False,
                         calib=False, image_ids=None, relative_path=True,
                         with_imageshape=True):
    """Build per-frame info dicts (reference kitti_common.get_kitti_image_info,
    consumed at `create_data.py:67-121`).

    Keys: image_idx, velodyne_path, img_path, img_shape, calib/* , annos.
    """
    root = pathlib.Path(path)
    if image_ids is None:
        image_ids = sorted(
            int(p.stem)
            for p in (root / ("training" if training else "testing") /
                      "image_2").glob("*.png"))
    split = "training" if training else "testing"
    infos = []
    for idx in image_ids:
        stem = get_image_index_str(idx)
        info = {"image_idx": idx}
        img_path = pathlib.Path(split) / "image_2" / f"{stem}.png"
        velo_path = pathlib.Path(split) / "velodyne" / f"{stem}.bin"
        info["img_path"] = str(img_path if relative_path
                               else root / img_path)
        if velodyne:
            info["velodyne_path"] = str(velo_path if relative_path
                                        else root / velo_path)
        if with_imageshape:
            img_file = root / img_path
            if img_file.exists():
                info["img_shape"] = _png_shape(img_file)
        if label_info and training:
            label_path = root / split / "label_2" / f"{stem}.txt"
            if label_path.exists():
                annos = get_label_anno(label_path)
                add_difficulty_to_annos(annos)
                info["annos"] = annos
        if calib:
            calib_path = root / split / "calib" / f"{stem}.txt"
            if calib_path.exists():
                info.update(get_calib(calib_path))
        infos.append(info)
    return infos


def _png_shape(path) -> np.ndarray:
    """(height, width) from a PNG header without decoding the image."""
    import struct
    with open(path, "rb") as f:
        head = f.read(26)
    if head[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path} is not a PNG")
    w, h = struct.unpack(">II", head[16:24])
    return np.array([h, w], np.int32)


def anno_to_rbboxes(anno: Dict) -> np.ndarray:
    """Camera-frame boxes [N, 7(x, y, z, l, h, w, ry)] from an anno dict
    (reference kitti_common.anno_to_rbboxes, used `create_data.py:208`)."""
    return np.concatenate(
        [anno["location"], anno["dimensions"], anno["rotation_y"][:, None]],
        axis=1)


def read_velodyne(path, num_features: int = 4) -> np.ndarray:
    return np.fromfile(path, dtype=np.float32).reshape(-1, num_features)


# ---------------------------------------------------------------------------
# Prediction → KITTI annos (reference train.py predict_kitti_to_anno :575-644)
# ---------------------------------------------------------------------------

def detections_to_kitti_annos(det, calib_rect, calib_velo2cam, calib_P2,
                              image_shape, class_names,
                              center_limit_range=None) -> Dict:
    """Convert one frame's lidar-frame detections to a KITTI anno dict.

    det: dict with boxes [P, 7] (lidar), scores [P], labels [P], valid [P]
    (numpy). Projects to camera frame + image bbox, filters by image bounds
    and center-limit range.
    """
    boxes = np.asarray(det["boxes"])
    scores = np.asarray(det["scores"])
    labels = np.asarray(det["labels"])
    valid = np.asarray(det["valid"]).astype(bool)
    if center_limit_range is not None and len(center_limit_range) == 0:
        center_limit_range = None   # configs may leave the field empty
    anno = get_start_result_anno()
    for box, score, label, ok in zip(boxes, scores, labels, valid):
        if not ok:
            continue
        if center_limit_range is not None:
            lim = np.asarray(center_limit_range)
            if ((box[:3] < lim[:3]).any() or (box[:3] > lim[3:]).any()):
                continue
        box_cam = box_np.box_lidar_to_camera(
            box[None], calib_rect, calib_velo2cam)[0]
        bbox = box_np.box3d_to_bbox(box_cam[None], calib_P2)[0]
        if image_shape is not None:
            if bbox[0] >= image_shape[1] or bbox[1] >= image_shape[0] or \
                    bbox[2] <= 0 or bbox[3] <= 0:
                continue
            bbox[0] = max(0.0, bbox[0])
            bbox[1] = max(0.0, bbox[1])
            bbox[2] = min(float(image_shape[1]), bbox[2])
            bbox[3] = min(float(image_shape[0]), bbox[3])
        x, y, z, l, h, w, ry = box_cam
        anno["name"].append(class_names[int(label)])
        anno["truncated"].append(0.0)
        anno["occluded"].append(0)
        anno["alpha"].append(float(-np.arctan2(-box[1], box[0]) + ry))
        anno["bbox"].append(bbox)
        anno["dimensions"].append([l, h, w])
        anno["location"].append([x, y, z])
        anno["rotation_y"].append(float(ry))
        anno["score"].append(float(score))
    if anno["name"]:
        return {k: np.stack(v) if k in ("bbox", "dimensions", "location")
                else np.array(v) for k, v in anno.items()}
    return empty_annotations()
