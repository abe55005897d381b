"""A small KITTI object-detection tree written to disk, for runs that need
the KITTI reader's real-data path without the dataset: `training/` with
velodyne clouds, label_2, calib and image_2 files, and `ImageSets/` split
files. Each frame has the same labels (moved sideways from frame to frame
where asked) and calibration (KITTI frame 000000's); its cloud is a cluster
of points inside each labelled box plus ground clutter, drawn from the
caller's numpy generator. It is prepared as a real tree is, by
`data/kitti_dataset.py`'s create-data functions (`create_kitti_info_file`,
`create_reduced_point_cloud`, `create_groundtruth_database`).
"""

from __future__ import annotations

import pathlib
import struct
import zlib

import numpy as np

from ..core import box_np
from . import kitti

# two cars and a don't-care region
CAR_LABEL = """Car 0.00 0 -1.58 587.01 173.33 614.12 200.12 1.65 1.67 3.64 -0.65 1.71 46.70 -1.59
Car 0.00 1 1.85 387.63 181.54 423.81 203.12 1.67 1.87 3.69 -16.53 2.39 58.49 1.57
DontCare -1 -1 -10 503.89 169.71 590.61 190.13 -1 -1 -1 -1000 -1000 -1000 -10
"""

# the same, with a pedestrian and a cyclist in front of the cars
MULTICLASS_LABEL = CAR_LABEL.replace("DontCare", """Pedestrian 0.00 0 -1.82 768.00 173.00 802.00 270.00 1.73 0.60 0.80 3.20 1.60 12.50 -1.57
Cyclist 0.00 0 1.76 435.00 175.00 496.00 236.00 1.73 0.60 1.76 -4.00 1.60 20.30 1.57
DontCare""")

CALIB = """P0: 707.0493 0 604.0814 0 0 707.0493 180.5066 0 0 0 1 0
P1: 707.0493 0 604.0814 -379.7842 0 707.0493 180.5066 0 0 0 1 0
P2: 707.0493 0 604.0814 45.75831 0 707.0493 180.5066 -0.3454157 0 0 1 0.004981016
P3: 707.0493 0 604.0814 -334.1081 0 707.0493 180.5066 2.33966 0 0 1 0.003068011
R0_rect: 0.9999128 0.01009263 -0.008511932 -0.01012729 0.9999406 -0.004037671 0.008470675 0.004123522 0.9999556
Tr_velo_to_cam: 0.006927964 -0.9999722 -0.002757829 -0.02457729 -0.001162982 0.002749836 -0.9999955 -0.06127237 0.9999753 0.006931141 0.00116072 -0.3321029
Tr_imu_to_velo: 0.9999976 0.0007553071 -0.002035826 -0.8086759 -0.0007854027 0.9998898 -0.01482298 0.3195559 0.002024406 0.01482454 0.9998881 -0.7997231
"""


def _png(w: int, h: int) -> bytes:
    """A black 8-bit grey PNG of w x h (the reader takes its shape)."""
    def chunk(typ, data):
        c = typ + data
        return struct.pack(">I", len(data)) + c + \
            struct.pack(">I", zlib.crc32(c))
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)
    raw = zlib.compress(b"".join(b"\x00" + b"\x00" * w for _ in range(h)))
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) +
            chunk(b"IDAT", raw) + chunk(b"IEND", b""))


def _shifted(label: str, dx: float) -> str:
    """`label` with every object moved dx metres along the camera's x axis
    (sideways); the don't-care lines as they are."""
    lines = []
    for line in label.strip().split("\n"):
        tok = line.split()
        if tok[0] != "DontCare":
            tok[11] = f"{float(tok[11]) + dx:.2f}"
        lines.append(" ".join(tok))
    return "\n".join(lines) + "\n"


def write_tree(root, rng: np.random.Generator, ids=(0, 1),
               label: str = CAR_LABEL, points_per_box: int = 50,
               clutter: int = 500, splits=("train",),
               shift: float = 0.0) -> pathlib.Path:
    """Write the tree under `root` with frames `ids` and each of `splits`
    listing all of them; returns `root`. Frame k of the n frames holds
    `label` moved sideways by shift x (k - (n - 1) / 2) metres (so objects
    pasted from another frame's database entries need not collide). The
    frames' clouds: for each labelled box `points_per_box` points uniform
    in its inner 80%, then `clutter` ground points 0-60 m ahead, each with
    a uniform intensity."""
    root = pathlib.Path(root)
    for sub in ("velodyne", "label_2", "calib", "image_2"):
        (root / "training" / sub).mkdir(parents=True, exist_ok=True)
    (root / "ImageSets").mkdir(exist_ok=True)
    for split in splits:
        (root / "ImageSets" / f"{split}.txt").write_text(
            "\n".join(f"{i:06d}" for i in ids))
    calib = kitti.parse_calib_lines(CALIB.strip().split("\n"))
    png = _png(1242, 375)
    ids = list(ids)
    for k, i in enumerate(ids):
        stem = f"{i:06d}"
        text = _shifted(label, shift * (k - (len(ids) - 1) / 2)) if shift \
            else label
        anno = kitti.parse_label_lines(text.strip().split("\n"))
        keep = anno["name"] != "DontCare"
        cam = np.concatenate([anno["location"][keep],
                              anno["dimensions"][keep],
                              anno["rotation_y"][keep][:, None]], 1)
        lidar = box_np.box_camera_to_lidar(
            cam, calib["calib/R0_rect"], calib["calib/Tr_velo_to_cam"])
        pts = [b[:3] + [0, 0, b[5] / 2] +
               rng.uniform(-0.4, 0.4, (points_per_box, 3)) * b[3:6]
               for b in lidar]
        pts.append(np.stack([rng.uniform(0, 60, clutter),
                             rng.uniform(-20, 20, clutter),
                             rng.normal(-1.7, 0.05, clutter)], 1))
        points = np.concatenate(pts).astype(np.float32)
        points = np.concatenate(
            [points, rng.uniform(0, 1, (len(points), 1)).astype(np.float32)],
            1)
        points.tofile(root / "training" / "velodyne" / f"{stem}.bin")
        (root / "training" / "label_2" / f"{stem}.txt").write_text(text)
        (root / "training" / "calib" / f"{stem}.txt").write_text(CALIB)
        (root / "training" / "image_2" / f"{stem}.png").write_bytes(png)
    return root

