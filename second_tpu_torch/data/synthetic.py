"""Synthetic KITTI-like scene generator.

Stands in for the KITTI dataset when no data is mounted (tests, benchmarks,
smoke training): random car-sized boxes with interior point clusters over a
noisy ground plane, in lidar frame with the framework's box convention
([x, y, z_bottom, w, l, h, yaw]).
"""

from __future__ import annotations

import numpy as np


CAR_MEAN_DIMS = np.array([1.6, 3.9, 1.56])  # w, l, h

# KITTI mean dimensions per class (w, l, h) — matches the reference configs'
# anchor sizes (e.g. people.fhd ped/cyclist anchor_generator sizes).
CLASS_MEAN_DIMS = {
    "Car": CAR_MEAN_DIMS,
    "Pedestrian": np.array([0.6, 0.8, 1.73]),
    "Cyclist": np.array([0.6, 1.76, 1.73]),
}


def _sample_class_boxes(rng, name, count_range, pc_range, ground_z,
                        existing, min_sep):
    """Rejection-sample `count` boxes of `name` away from `existing` centers.
    Consumes NO rng draws when the class is disabled (max count 0), so
    default Car-only streams stay bit-identical."""
    if count_range[1] <= 0:
        return []
    mean = CLASS_MEAN_DIMS[name]
    n = int(rng.integers(count_range[0], count_range[1] + 1))
    out = []
    for _ in range(n):
        for _attempt in range(20):
            dims = mean * rng.uniform(0.85, 1.15, 3)
            x = rng.uniform(pc_range[0] + 3, pc_range[3] - 3)
            y = rng.uniform(pc_range[1] + 3, pc_range[4] - 3)
            z = ground_z + rng.uniform(-0.05, 0.05)
            yaw = rng.uniform(-np.pi, np.pi)
            if all(np.hypot(b[0] - x, b[1] - y) > min_sep
                   for b in existing + out):
                out.append([x, y, z, dims[0], dims[1], dims[2], yaw])
                break
    return out


def sample_scene(rng: np.random.Generator, *,
                 pc_range=(0.0, -39.68, -3.0, 69.12, 39.68, 1.0),
                 num_cars=(3, 12), points_per_car=(60, 300),
                 num_ground=8000, ground_z=-1.73,
                 num_peds=(0, 0), num_cyclists=(0, 0)):
    """Returns (points [P, 4] f32, gt_boxes [G, 7] f32, gt_names [G] str).

    `num_peds`/`num_cyclists` default to disabled (0, 0) — when disabled they
    consume no rng draws, keeping historical Car-only seeded scenes
    bit-identical."""
    n_cars = int(rng.integers(num_cars[0], num_cars[1] + 1))
    boxes = []
    for _ in range(n_cars):
        for _attempt in range(20):
            dims = CAR_MEAN_DIMS * rng.uniform(0.85, 1.15, 3)
            x = rng.uniform(pc_range[0] + 3, pc_range[3] - 3)
            y = rng.uniform(pc_range[1] + 3, pc_range[4] - 3)
            z = ground_z + rng.uniform(-0.05, 0.05)
            yaw = rng.uniform(-np.pi, np.pi)
            cand = np.array([x, y, z, dims[0], dims[1], dims[2], yaw])
            # reject heavy center overlap with existing boxes
            if all(np.hypot(b[0] - x, b[1] - y) > 4.0 for b in boxes):
                boxes.append(cand)
                break
    names = ["Car"] * len(boxes)
    boxes = [np.asarray(b) for b in boxes]
    for cls, cnt, sep in (("Pedestrian", num_peds, 1.5),
                          ("Cyclist", num_cyclists, 2.0)):
        extra = _sample_class_boxes(rng, cls, cnt, pc_range, ground_z,
                                    boxes, sep)
        boxes.extend(np.asarray(b) for b in extra)
        names.extend([cls] * len(extra))
    gt_boxes = np.array(boxes, np.float32) if boxes else \
        np.zeros((0, 7), np.float32)

    pts = []
    for b, name in zip(gt_boxes, names):
        lo, hi = points_per_car
        if name != "Car":       # smaller objects carry fewer returns
            lo, hi = max(8, lo // 4), max(16, hi // 4)
        n = int(rng.integers(lo, hi + 1))
        local = rng.uniform(-0.5, 0.5, (n, 3)) * b[3:6]
        local[:, 2] += b[5] / 2  # boxes are bottom-anchored
        c, s = np.cos(b[6]), np.sin(b[6])
        world_x = local[:, 0] * c - local[:, 1] * s + b[0]
        world_y = local[:, 0] * s + local[:, 1] * c + b[1]
        world_z = local[:, 2] + b[2]
        pts.append(np.stack([world_x, world_y, world_z], 1))
    ground = np.stack([
        rng.uniform(pc_range[0], pc_range[3], num_ground),
        rng.uniform(pc_range[1], pc_range[4], num_ground),
        rng.normal(ground_z, 0.03, num_ground)], 1)
    pts.append(ground)
    points = np.concatenate(pts).astype(np.float32)
    intensity = rng.uniform(0, 1, (len(points), 1)).astype(np.float32)
    points = np.concatenate([points, intensity], 1)
    gt_names = np.array(names)
    return points, gt_boxes, gt_names


def lidar_scan_scene(rng: np.random.Generator, *,
                     pc_range=(0.0, -39.68, -3.0, 69.12, 39.68, 1.0),
                     num_cars=(3, 12), num_beams=64, num_azimuth=2048,
                     ground_z=-1.73, sensor_z=0.0, max_range=75.0,
                     num_peds=(0, 0), num_cyclists=(0, 0)):
    """KITTI-like LiDAR scan: rays from the sensor over a beam/azimuth grid
    intersect the ground plane and car boxes; first hit wins.

    Unlike :func:`sample_scene`'s uniform clutter, returns cluster along
    scan rings and surfaces, so voxel occupancy and sparse-conv dilation
    match real point-cloud geometry — use for benchmarks and capacity
    sizing. Returns (points [P, 4], gt_boxes [G, 7], gt_names [G]).
    """
    n_cars = int(rng.integers(num_cars[0], num_cars[1] + 1))
    boxes = []
    for _ in range(n_cars):
        for _attempt in range(20):
            dims = CAR_MEAN_DIMS * rng.uniform(0.85, 1.15, 3)
            x = rng.uniform(pc_range[0] + 5, pc_range[3] - 3)
            y = rng.uniform(pc_range[1] + 3, pc_range[4] - 3)
            z = ground_z + rng.uniform(-0.05, 0.05)
            yaw = rng.uniform(-np.pi, np.pi)
            if all(np.hypot(b[0] - x, b[1] - y) > 4.5 for b in boxes):
                boxes.append([x, y, z, dims[0], dims[1], dims[2], yaw])
                break
    names = ["Car"] * len(boxes)
    for cls, cnt, sep in (("Pedestrian", num_peds, 1.5),
                          ("Cyclist", num_cyclists, 2.0)):
        extra = _sample_class_boxes(rng, cls, cnt, pc_range, ground_z,
                                    boxes, sep)
        boxes.extend(extra)
        names.extend([cls] * len(extra))
    gt_boxes = np.array(boxes, np.float32) if boxes else \
        np.zeros((0, 7), np.float32)

    # front 90° sector (the KITTI reduced-cloud frustum)
    az = np.linspace(-np.pi / 4, np.pi / 4, num_azimuth, dtype=np.float32)
    el = np.linspace(np.deg2rad(-24.8), np.deg2rad(2.0), num_beams,
                     dtype=np.float32)
    az, el = np.meshgrid(az, el)
    az = az.ravel() + rng.normal(0, 1e-3, az.size).astype(np.float32)
    el = el.ravel()
    dx = np.cos(el) * np.cos(az)
    dy = np.cos(el) * np.sin(az)
    dz = np.sin(el)
    # ground-plane hit distance (only for downward rays)
    with np.errstate(divide="ignore"):
        t_ground = np.where(dz < -1e-6, (ground_z - sensor_z) / dz, np.inf)
    t_hit = np.minimum(t_ground, np.inf).astype(np.float32)

    # box hits: slab test in each box's local frame
    for b in gt_boxes:
        c, s = np.cos(b[6]), np.sin(b[6])
        # ray origin relative to box center (z at box middle)
        ox, oy = -b[0], -b[1]
        oz = sensor_z - (b[2] + b[5] / 2)
        lox = ox * c + oy * s
        loy = -ox * s + oy * c
        ldx = dx * c + dy * s
        ldy = -dx * s + dy * c
        half = b[3:6] / 2            # w, l, h → local y, x, z? boxes are
        # [x, y, z, w, l, h]: l along local x, w along local y
        with np.errstate(divide="ignore", invalid="ignore"):
            t1 = (-half[1] - lox) / ldx
            t2 = (half[1] - lox) / ldx
            tx0, tx1 = np.minimum(t1, t2), np.maximum(t1, t2)
            t1 = (-half[0] - loy) / ldy
            t2 = (half[0] - loy) / ldy
            ty0, ty1 = np.minimum(t1, t2), np.maximum(t1, t2)
            t1 = (-half[2] - oz) / dz
            t2 = (half[2] - oz) / dz
            tz0, tz1 = np.minimum(t1, t2), np.maximum(t1, t2)
        tin = np.maximum(np.maximum(tx0, ty0), tz0)
        tout = np.minimum(np.minimum(tx1, ty1), tz1)
        hit = (tin > 0.5) & (tin <= tout)
        t_hit = np.where(hit & (tin < t_hit), tin, t_hit)

    ok = np.isfinite(t_hit) & (t_hit < max_range)
    t = (t_hit[ok] * (1 + rng.normal(0, 0.002, ok.sum()))).astype(np.float32)
    pts = np.stack([dx[ok] * t, dy[ok] * t, sensor_z + dz[ok] * t], 1)
    inb = ((pts[:, 0] >= pc_range[0]) & (pts[:, 0] < pc_range[3]) &
           (pts[:, 1] >= pc_range[1]) & (pts[:, 1] < pc_range[4]) &
           (pts[:, 2] >= pc_range[2]) & (pts[:, 2] < pc_range[5]))
    pts = pts[inb]
    intensity = rng.uniform(0, 1, (len(pts), 1)).astype(np.float32)
    points = np.concatenate([pts, intensity], 1).astype(np.float32)
    gt_names = np.array(names)
    return points, gt_boxes, gt_names


def synthetic_calib(image_shape=(192, 624)):
    """A KITTI-like synthetic camera: identity rectification, the standard
    lidar→camera axis permutation, and a centered pinhole P2."""
    rect = np.eye(4)
    velo2cam = np.array([[0, -1, 0, 0], [0, 0, -1, 0],
                         [1, 0, 0, 0], [0, 0, 0, 1]], np.float64)
    f = image_shape[1] * 0.5
    P2 = np.array([[f, 0, image_shape[1] / 2, 0],
                   [0, f, image_shape[0] / 2, 0],
                   [0, 0, 1, 0], [0, 0, 0, 1]], np.float64)
    return rect, velo2cam, P2


def render_synthetic_image(points, image_shape, rect, velo2cam, P2):
    """Cheap camera image: splat point intensity / inverse depth at each
    projected pixel — gives the fusion image branch real structure that is
    geometrically consistent with the cloud."""
    from ..core import box_np
    cam = box_np.lidar_to_camera(points[:, :3], rect, velo2cam)
    uv = box_np.project_to_image(cam, P2)
    H, W = image_shape
    m = ((cam[:, 2] > 0.5) & (uv[:, 0] >= 0) & (uv[:, 0] < W) &
         (uv[:, 1] >= 0) & (uv[:, 1] < H))
    img = np.zeros((H, W, 3), np.float32)
    r = uv[m, 1].astype(np.int32)
    c = uv[m, 0].astype(np.int32)
    inten = points[m, 3] if points.shape[1] > 3 else np.ones(m.sum())
    np.maximum.at(img[:, :, 0], (r, c), inten.astype(np.float32))
    np.maximum.at(img[:, :, 1], (r, c),
                  (1.0 / np.maximum(cam[m, 2], 1.0)).astype(np.float32))
    np.maximum.at(img[:, :, 2], (r, c),
                  np.clip(cam[m, 1] + 1.5, 0, 3).astype(np.float32) / 3)
    return img


class SyntheticDataset:
    """Synthetic drop-in for KittiDataset: indexable, returns raw scenes.

    With `with_image=True`, scenes also carry a synthetic camera image and
    flat `calib/*` keys, matching the fusion contract of
    :class:`..data.pipeline.ExamplePrep`.
    """

    def __init__(self, size=256, seed=0, with_image=False,
                 image_shape=(192, 624), scan=False, cache=True,
                 **scene_kwargs):
        self._size = size
        self._seed = seed
        self._with_image = with_image
        self._image_shape = tuple(image_shape)
        self._scan = scan
        self._scene_kwargs = scene_kwargs
        # scenes are deterministic per idx, so caching changes nothing
        # semantically (per-example augmentation happens in ExamplePrep) but
        # removes scene regeneration from the train-loop host path — on this
        # 1-core host scan-scene generation is ~0.5 s/scene, the dominant
        # step cost when uncached
        self._cache: dict | None = {} if cache else None

    def __len__(self):
        return self._size

    def __getitem__(self, idx):
        if self._cache is not None and idx in self._cache:
            return self._cache[idx]
        rng = np.random.default_rng(self._seed * 100003 + idx)
        if self._scan:
            kwargs = {k: v for k, v in self._scene_kwargs.items()
                      if k in ("pc_range", "num_cars", "num_peds",
                               "num_cyclists")}
            points, gt_boxes, gt_names = lidar_scan_scene(
                rng, num_azimuth=512, **kwargs)
        else:
            points, gt_boxes, gt_names = sample_scene(
                rng, **self._scene_kwargs)
        scene = {
            "points": points,
            "gt_boxes": gt_boxes,
            "gt_names": gt_names,
            "image_idx": idx,
            "calib": None,
        }
        if self._with_image:
            rect, velo2cam, P2 = synthetic_calib(self._image_shape)
            scene["image"] = render_synthetic_image(
                points, self._image_shape, rect, velo2cam, P2)
            scene["img_shape"] = self._image_shape
            scene["calib/R0_rect"] = rect
            scene["calib/Tr_velo_to_cam"] = velo2cam
            scene["calib/P2"] = P2
        if self._cache is not None:
            self._cache[idx] = scene
        return scene


def sample_sequence(rng: np.random.Generator, num_frames: int = 4, *,
                    pc_range=(0.0, -39.68, -3.0, 69.12, 39.68, 1.0),
                    num_cars=(3, 8), points_per_car=(60, 300),
                    num_ground=8000, ground_z=-1.73, dt=0.1):
    """Synthetic KITTI-tracking-like sequence: cars move with constant
    velocity across frames; per-frame points are regenerated around the moved
    boxes. Returns a list of (points, gt_boxes, gt_names, track_ids)."""
    points0, boxes0, names0 = sample_scene(
        rng, pc_range=pc_range, num_cars=num_cars,
        points_per_car=points_per_car, num_ground=num_ground,
        ground_z=ground_z)
    n = len(boxes0)
    vel = rng.uniform(-8, 8, (n, 2))        # m/s in xy
    track_ids = np.arange(n, dtype=np.int64)
    frames = []
    for t in range(num_frames):
        boxes = boxes0.copy()
        boxes[:, 0] += vel[:, 0] * dt * t
        boxes[:, 1] += vel[:, 1] * dt * t
        keep = ((boxes[:, 0] > pc_range[0] + 2) &
                (boxes[:, 0] < pc_range[3] - 2) &
                (boxes[:, 1] > pc_range[1] + 2) &
                (boxes[:, 1] < pc_range[4] - 2))
        boxes = boxes[keep]
        pts = []
        for b in boxes:
            m = int(rng.integers(points_per_car[0], points_per_car[1] + 1))
            local = rng.uniform(-0.5, 0.5, (m, 3)) * b[3:6]
            local[:, 2] += b[5] / 2
            c, s = np.cos(b[6]), np.sin(b[6])
            pts.append(np.stack([local[:, 0] * c - local[:, 1] * s + b[0],
                                 local[:, 0] * s + local[:, 1] * c + b[1],
                                 local[:, 2] + b[2]], 1))
        pts.append(np.stack([
            rng.uniform(pc_range[0], pc_range[3], num_ground),
            rng.uniform(pc_range[1], pc_range[4], num_ground),
            rng.normal(ground_z, 0.03, num_ground)], 1))
        points = np.concatenate(pts).astype(np.float32)
        intensity = rng.uniform(0, 1, (len(points), 1)).astype(np.float32)
        frames.append({
            "points": np.concatenate([points, intensity], 1),
            "gt_boxes": boxes.astype(np.float32),
            "gt_names": np.array(["Car"] * len(boxes)),
            "track_ids": track_ids[keep],
        })
    return frames


class SyntheticPairDataset:
    """Synthetic (cur, prev) frame pairs for the temporal model — the stand-in
    for the KITTI-tracking dataset's `p_*` example keys."""

    def __init__(self, size=128, seed=0, with_image=False,
                 image_shape=(192, 624), **seq_kwargs):
        self._size = size
        self._seed = seed
        self._with_image = with_image
        self._image_shape = tuple(image_shape)
        self._kwargs = seq_kwargs

    def __len__(self):
        return self._size

    def __getitem__(self, idx):
        rng = np.random.default_rng(self._seed * 99991 + idx)
        prev, cur = sample_sequence(rng, num_frames=2, **self._kwargs)
        scene = {
            "points": cur["points"],
            "gt_boxes": cur["gt_boxes"],
            "gt_names": cur["gt_names"],
            "track_ids": cur["track_ids"],
            "p_points": prev["points"],
            "p_gt_boxes": prev["gt_boxes"],
            "image_idx": idx,
            "calib": None,
        }
        if self._with_image:
            # current-frame camera (the spatio fusion RPN consumes only the
            # current frame's image, reference spatio :712-716)
            rect, velo2cam, P2 = synthetic_calib(self._image_shape)
            scene["image"] = render_synthetic_image(
                cur["points"], self._image_shape, rect, velo2cam, P2)
            scene["img_shape"] = self._image_shape
            scene["calib/R0_rect"] = rect
            scene["calib/Tr_velo_to_cam"] = velo2cam
            scene["calib/P2"] = P2
        return scene
