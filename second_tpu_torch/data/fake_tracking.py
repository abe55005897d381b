"""A small KITTI tracking-benchmark tree written to disk, for runs that need
the tracking reader's real-data path (`data/tracking.py`
`KittiTrackingDataset`, `TrackingPairDataset`) without the dataset: one
sequence `0000` under `root/` with `label_02/0000.txt`, `calib/0000.txt`
and `velodyne/0000/FFFFFF.bin`. Two cars move slowly from frame to frame
(camera frame: z ahead, lidar x); each frame's cloud is a cluster of
points around each car plus ground clutter in 0-16 m ahead and ±8 m to the
sides, drawn from the caller's numpy generator. The layout and numbers are
those of the JAX package's tracking-tree test
(`tests/test_tracking_train.py`, `test_temporal_cli_on_fabricated_tracking_tree`).
With `image_shape` the tree has a camera too: `image_02/0000/FFFFFF.png`,
each frame's cloud rendered through the tree's calibration
(`data/synthetic.py` `render_synthetic_image`) as 8-bit RGB, the frames the
reader loads for the temporal-fusion model.
"""

from __future__ import annotations

import pathlib

import numpy as np

# the devkit's raw calib keys (`R_rect`, `Tr_velo_cam`), which the reader
# renames; velodyne → camera is (x, y, z) → (-y, -z, x)
CALIB = "\n".join([
    "P0: 700 0 600 0 0 700 180 0 0 0 1 0",
    "P1: 700 0 600 0 0 700 180 0 0 0 1 0",
    "P2: 700 0 600 44 0 700 180 0 0 0 1 0",
    "P3: 700 0 600 0 0 700 180 0 0 0 1 0",
    "R_rect 1 0 0 0 1 0 0 0 1",
    "Tr_velo_cam 0 -1 0 0 0 0 -1 0 1 0 0 0",
    "Tr_imu_velo 1 0 0 0 0 1 0 0 0 0 1 0",
]) + "\n"


def write_tracking_tree(root, rng: np.random.Generator,
                        num_frames: int = 4,
                        image_shape=None) -> pathlib.Path:
    """Write sequence 0000 of `num_frames` frames under `root` (the split
    directory a reader's `kitti_root_path` names), with an (H, W) camera
    frame each where `image_shape` is given, and return it."""
    root = pathlib.Path(root)
    (root / "label_02").mkdir(parents=True, exist_ok=True)
    (root / "calib").mkdir(exist_ok=True)
    velo = root / "velodyne" / "0000"
    velo.mkdir(parents=True, exist_ok=True)
    lines = []
    for f in range(num_frames):
        lines.append(f"{f} 1 Car 0 0 -1.5 100 150 200 250 1.5 1.6 3.9 "
                     f"{2.0 + 0.1 * f:.2f} 1.5 {10.0 + 0.2 * f:.2f} 0.1")
        lines.append(f"{f} 2 Car 0 0 -1.2 300 150 380 250 1.5 1.6 3.9 "
                     f"{-3.0 + 0.1 * f:.2f} 1.5 {7.0 + 0.3 * f:.2f} -0.4")
    (root / "label_02" / "0000.txt").write_text("\n".join(lines) + "\n")
    (root / "calib" / "0000.txt").write_text(CALIB)
    for f in range(num_frames):
        pts = [np.array([10 + 0.2 * f, -2 - 0.1 * f, -1.0]) +
               rng.uniform(-0.7, 0.7, (120, 3)),
               np.array([7 + 0.3 * f, 3 - 0.1 * f, -1.0]) +
               rng.uniform(-0.7, 0.7, (120, 3)),
               np.stack([rng.uniform(0, 16, 800), rng.uniform(-8, 8, 800),
                         rng.normal(-1.7, 0.03, 800)], 1)]
        cloud = np.concatenate(pts).astype(np.float32)
        cloud = np.concatenate(
            [cloud, rng.uniform(0, 1, (len(cloud), 1)).astype(np.float32)],
            1)
        cloud.tofile(velo / f"{f:06d}.bin")
        if image_shape is not None:
            _write_frame_image(root, f, cloud, image_shape)
    return root


def _write_frame_image(root, frame, cloud, image_shape):
    from PIL import Image

    from .synthetic import render_synthetic_image
    cam = {}
    for line in CALIB.splitlines():
        key, *vals = line.split()
        cam[key.rstrip(":")] = np.array(vals, np.float64)
    P2 = np.eye(4)
    P2[:3] = cam["P2"].reshape(3, 4)
    rect = np.eye(4)
    rect[:3, :3] = cam["R_rect"].reshape(3, 3)
    velo2cam = np.eye(4)
    velo2cam[:3] = cam["Tr_velo_cam"].reshape(3, 4)
    img = render_synthetic_image(cloud, tuple(image_shape), rect, velo2cam,
                                 P2)
    out = root / "image_02" / "0000"
    out.mkdir(parents=True, exist_ok=True)
    Image.fromarray(np.clip(img * 255, 0, 255).astype(np.uint8)).save(
        out / f"{frame:06d}.png")
