"""KITTI dataset + offline data creation.

Reconstructions of the reference's absent `second/data/dataset.py`
(`KittiDataset`, built at `second/builder/dataset_builder.py:81-87`), the
train-time `prep_pointcloud` pipeline (call-site contract at
`dataset_builder.py:51-80`), and `second/create_data.py` (info pkls, reduced
clouds, gt database, `:53-290`) — redesigned for the on-device voxelizer: the
dataset emits augmented raw scenes; padding/targets happen in
`data/pipeline.ExamplePrep`, voxelization on device.
"""

from __future__ import annotations

import pathlib
import pickle
from typing import Dict, List, Optional

import numpy as np

from ..core import augment, box_np
from ..core.db_sampler import DataBaseSampler
from . import kitti


def annos_to_lidar_boxes(annos: Dict, rect, Trv2c):
    """Camera-frame annos → lidar gt boxes [N, 7] + names, skipping DontCare."""
    keep = annos["name"] != "DontCare"
    cam_boxes = np.concatenate(
        [annos["location"][keep], annos["dimensions"][keep],
         annos["rotation_y"][keep][:, None]], axis=1)
    lidar = box_np.box_camera_to_lidar(cam_boxes, rect, Trv2c)
    return lidar, annos["name"][keep]


class KittiDataset:
    """Indexable dataset of raw (optionally augmented) KITTI scenes."""

    def __init__(self, info_path, root_path, training=True, input_cfg=None,
                 num_point_features=4, load_image=False,
                 rng: Optional[np.random.Generator] = None):
        with open(info_path, "rb") as f:
            self._infos = pickle.load(f)
        self._root = pathlib.Path(root_path)
        self._training = training
        self._load_image = load_image
        self._cfg = input_cfg
        self._nfeat = num_point_features
        self._rng = rng or np.random.default_rng()
        self._sampler = None
        if training and input_cfg is not None and \
                input_cfg.database_sampler is not None and \
                input_cfg.database_sampler.database_info_path:
            self._sampler = DataBaseSampler.from_config(
                input_cfg.database_sampler, rng=self._rng,
                root_path=root_path)

    @property
    def kitti_infos(self):
        return self._infos

    @property
    def root_path(self):
        return self._root

    def __len__(self):
        return len(self._infos)

    def __getitem__(self, idx) -> Dict:
        info = self._infos[idx]
        velo = self._root / info["velodyne_path"]
        # prefer the frustum-culled reduced cloud if it exists
        reduced = pathlib.Path(str(velo).replace("velodyne",
                                                 "velodyne_reduced"))
        points = kitti.read_velodyne(reduced if reduced.exists() else velo,
                                     self._nfeat)
        rect = info["calib/R0_rect"]
        Trv2c = info["calib/Tr_velo_to_cam"]
        scene = {
            "points": points,
            "image_idx": info["image_idx"],
            "calib/R0_rect": rect,
            "calib/Tr_velo_to_cam": Trv2c,
            "calib/P2": info["calib/P2"],
            "img_shape": info.get("img_shape"),
        }
        if self._load_image and "img_path" in info:
            img_file = self._root / info["img_path"]
            if img_file.exists():
                from PIL import Image
                scene["image"] = (np.asarray(Image.open(img_file),
                                             np.float32) / 255.0)
        if "annos" in info:
            gt_boxes, gt_names = annos_to_lidar_boxes(info["annos"], rect,
                                                      Trv2c)
            scene["annos"] = info["annos"]
            if self._training:
                points, gt_boxes, gt_names = self._augment(
                    points, gt_boxes, gt_names)
            scene["points"] = points
            scene["gt_boxes"] = gt_boxes.astype(np.float32)
            scene["gt_names"] = gt_names
        return scene

    # -- train-time augmentation (prep_pointcloud equivalent) ---------------
    def _augment(self, points, gt_boxes, gt_names):
        cfg = self._cfg
        rng = self._rng
        gt_boxes = gt_boxes.astype(np.float64).copy()
        # group ids only matter under multi-class sample groups (the
        # reference threads them the same way, prep_pointcloud
        # `group_ids=...` only when sampler.use_group_sampling)
        group_mode = (self._sampler is not None
                      and getattr(self._sampler, "_group_mode", False))
        group_ids = np.arange(len(gt_boxes)) if group_mode else None
        if self._sampler is not None:
            sampled = self._sampler.sample_all(gt_boxes, gt_names,
                                               self._nfeat,
                                               gt_group_ids=group_ids)
            if sampled is not None:
                if cfg.remove_points_after_sample:
                    points = augment.remove_points_in_boxes(
                        points, sampled["gt_boxes"].astype(np.float64))
                points = np.concatenate([sampled["points"], points])
                gt_boxes = np.concatenate(
                    [gt_boxes, sampled["gt_boxes"].astype(np.float64)])
                gt_names = np.concatenate([gt_names, sampled["gt_names"]])
                if group_mode:
                    group_ids = np.concatenate(
                        [group_ids, sampled["group_ids"]])
        if cfg is not None:
            if cfg.groundtruth_rotation_uniform_noise:
                augment.noise_per_object(
                    gt_boxes, points,
                    rotation_perturb=tuple(
                        cfg.groundtruth_rotation_uniform_noise),
                    center_noise_std=tuple(
                        cfg.groundtruth_localization_noise_std or
                        (1.0, 1.0, 0.5)),
                    rng=rng, group_ids=group_ids)
            gt_boxes, points = augment.random_flip(gt_boxes, points, rng=rng)
            if cfg.global_rotation_uniform_noise:
                gt_boxes, points = augment.global_rotation(
                    gt_boxes, points,
                    tuple(cfg.global_rotation_uniform_noise), rng=rng)
            if cfg.global_scaling_uniform_noise:
                gt_boxes, points = augment.global_scaling(
                    gt_boxes, points,
                    tuple(cfg.global_scaling_uniform_noise), rng=rng)
        return points.astype(np.float32), gt_boxes, gt_names


# ---------------------------------------------------------------------------
# Offline data creation (reference create_data.py)
# ---------------------------------------------------------------------------

def _read_imageset(path) -> List[int]:
    with open(path) as f:
        return [int(line.strip()) for line in f if line.strip()]


def create_kitti_info_file(data_path, save_path=None, relative_path=True):
    """ImageSets txt → kitti_infos_{train, val, trainval, test}.pkl with
    per-gt point counts (reference `create_data.py:53-121`)."""
    data_path = pathlib.Path(data_path)
    save_path = pathlib.Path(save_path or data_path)
    sets = {}
    for split in ("train", "val", "test"):
        p = data_path / "ImageSets" / f"{split}.txt"
        if p.exists():
            sets[split] = _read_imageset(p)
    for split, ids in sets.items():
        training = split != "test"
        infos = kitti.get_kitti_image_info(
            data_path, training=training, velodyne=True, calib=True,
            image_ids=ids, relative_path=relative_path)
        if training:
            for info in infos:
                _add_num_points_in_gt(data_path, info)
        out = save_path / f"kitti_infos_{split}.pkl"
        with open(out, "wb") as f:
            pickle.dump(infos, f)
        print(f"wrote {out} ({len(infos)} frames)")
    if "train" in sets and "val" in sets:
        both = []
        for split in ("train", "val"):
            with open(save_path / f"kitti_infos_{split}.pkl", "rb") as f:
                both += pickle.load(f)
        with open(save_path / "kitti_infos_trainval.pkl", "wb") as f:
            pickle.dump(both, f)


def _add_num_points_in_gt(root, info):
    from .. import runtime
    points = kitti.read_velodyne(pathlib.Path(root) / info["velodyne_path"])
    rect = info["calib/R0_rect"]
    Trv2c = info["calib/Tr_velo_to_cam"]
    if "img_shape" in info:
        points = box_np.remove_outside_points(
            points, rect, Trv2c, info["calib/P2"], info["img_shape"])
    annos = info["annos"]
    keep = annos["name"] != "DontCare"
    cam_boxes = np.concatenate(
        [annos["location"][keep], annos["dimensions"][keep],
         annos["rotation_y"][keep][:, None]], axis=1)
    gt_boxes = box_np.box_camera_to_lidar(cam_boxes, rect, Trv2c)
    inside = runtime.points_in_rbbox(points, gt_boxes)
    counts = inside.sum(0)
    annos["num_points_in_gt"] = np.concatenate(
        [counts, -np.ones(int((~keep).sum()), counts.dtype)]).astype(np.int32)


def create_demo_info_file(data_path, scene: str = "demo", save_path=None,
                          relative_path=True):
    """Label-free info file for a KITTI-raw drive laid out like a `testing`
    split (reference `create_data_demo.py:53-128` — that script hardcodes
    user paths and an inline pdb; this is the working equivalent).

    Frames come from `testing/test.txt` if present, else every image in
    `testing/image_2`. Writes `kitti_infos_test_<scene>.pkl`.
    """
    data_path = pathlib.Path(data_path)
    save_path = pathlib.Path(save_path or data_path)
    ids_file = data_path / "testing" / "test.txt"
    ids = _read_imageset(ids_file) if ids_file.exists() else None
    infos = kitti.get_kitti_image_info(
        data_path, training=False, label_info=False, velodyne=True,
        calib=True, image_ids=ids, relative_path=relative_path)
    out = save_path / f"kitti_infos_test_{scene}.pkl"
    with open(out, "wb") as f:
        pickle.dump(infos, f)
    print(f"wrote {out} ({len(infos)} frames)")
    return str(out)


def convert_raw_calib(raw_calib_dir, out_dir, image_dir=None):
    """KITTI-raw drive calibration (`calib_cam_to_cam.txt` /
    `calib_velo_to_cam.txt` / `calib_imu_to_velo.txt`) → per-frame
    object-format `calib/FFFFFF.txt` files (reference `calib_mapping.py`,
    which hardcodes user paths; this is the reusable equivalent).

    One file per image in `image_dir` (or a single `000000.txt` if None).
    Returns the list of files written.
    """
    raw = pathlib.Path(raw_calib_dir)

    def kv(path):
        out = {}
        for line in pathlib.Path(path).read_text().splitlines():
            key, _, rest = line.partition(":")
            out[key.strip()] = rest.split()
        return out

    c2c = kv(raw / "calib_cam_to_cam.txt")
    v2c = kv(raw / "calib_velo_to_cam.txt")
    i2v = kv(raw / "calib_imu_to_velo.txt")

    def rt(d):
        R = np.array(d["R"], np.float64).reshape(3, 3)
        T = np.array(d["T"], np.float64).reshape(3, 1)
        return np.concatenate([R, T], 1).reshape(-1)

    lines = []
    for i in range(4):
        lines.append(f"P{i}: " + " ".join(c2c[f"P_rect_0{i}"]))
    lines.append("R0_rect: " + " ".join(c2c["R_rect_00"]))
    lines.append("Tr_velo_to_cam: " +
                 " ".join(f"{x:.12e}" for x in rt(v2c)))
    lines.append("Tr_imu_to_velo: " +
                 " ".join(f"{x:.12e}" for x in rt(i2v)))
    text = "\n".join(lines) + "\n"

    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    if image_dir is not None:
        stems = sorted(p.stem for p in pathlib.Path(image_dir).glob("*.png"))
    else:
        stems = ["000000"]
    written = []
    for stem in stems:
        path = out_dir / f"{stem}.txt"
        path.write_text(text)
        written.append(str(path))
    print(f"wrote {len(written)} calib files to {out_dir}")
    return written


def create_reduced_point_cloud(data_path, info_path=None, save_path=None):
    """Frustum-cull each cloud to the camera FOV → velodyne_reduced
    (reference `create_data.py:124-182`)."""
    data_path = pathlib.Path(data_path)
    info_paths = ([info_path] if info_path else
                  sorted(data_path.glob("kitti_infos_*.pkl")))
    for ip in info_paths:
        with open(ip, "rb") as f:
            infos = pickle.load(f)
        for info in infos:
            velo = data_path / info["velodyne_path"]
            points = kitti.read_velodyne(velo)
            points = box_np.remove_outside_points(
                points, info["calib/R0_rect"], info["calib/Tr_velo_to_cam"],
                info["calib/P2"], info["img_shape"])
            out = pathlib.Path(
                str(velo).replace("velodyne", "velodyne_reduced")) \
                if save_path is None else \
                pathlib.Path(save_path) / velo.name
            out.parent.mkdir(parents=True, exist_ok=True)
            points.astype(np.float32).tofile(out)
        print(f"reduced clouds for {ip}")


def create_groundtruth_database(data_path, info_path=None, save_path=None,
                                used_classes=None):
    """Crop per-gt point patches (center-subtracted) + db-info pkl
    (reference `create_data.py:185-290`)."""
    data_path = pathlib.Path(data_path)
    info_path = info_path or data_path / "kitti_infos_train.pkl"
    db_path = pathlib.Path(save_path or data_path / "gt_database")
    db_path.mkdir(parents=True, exist_ok=True)
    with open(info_path, "rb") as f:
        infos = pickle.load(f)
    db_infos: Dict[str, List] = {}
    for info in infos:
        idx = info["image_idx"]
        velo = data_path / info["velodyne_path"]
        reduced = pathlib.Path(str(velo).replace("velodyne",
                                                 "velodyne_reduced"))
        points = kitti.read_velodyne(reduced if reduced.exists() else velo)
        rect = info["calib/R0_rect"]
        Trv2c = info["calib/Tr_velo_to_cam"]
        annos = info["annos"]
        keep = annos["name"] != "DontCare"
        names = annos["name"][keep]
        difficulty = annos.get("difficulty", np.zeros(len(names)))[
            :len(names)]
        cam_boxes = np.concatenate(
            [annos["location"][keep], annos["dimensions"][keep],
             annos["rotation_y"][keep][:, None]], axis=1)
        gt_boxes = box_np.box_camera_to_lidar(cam_boxes, rect, Trv2c)
        from .. import runtime
        inside = runtime.points_in_rbbox(points, gt_boxes)
        for i, name in enumerate(names):
            if used_classes is not None and name not in used_classes:
                continue
            pts = points[inside[:, i]].copy()
            pts[:, :3] -= gt_boxes[i, :3]
            fname = f"{idx}_{name}_{i}.bin"
            pts.astype(np.float32).tofile(db_path / fname)
            db_infos.setdefault(name, []).append({
                "name": name,
                "path": str(pathlib.Path(db_path.name) / fname),
                "image_idx": idx,
                "gt_idx": i,
                "box3d_lidar": gt_boxes[i].astype(np.float32),
                "num_points_in_gt": int(inside[:, i].sum()),
                "difficulty": int(difficulty[i]) if i < len(difficulty)
                else 0,
                "group_id": i,
            })
    out = data_path / "kitti_dbinfos_train.pkl"
    with open(out, "wb") as f:
        pickle.dump(db_infos, f)
    print(f"wrote {out}: " + ", ".join(
        f"{k}: {len(v)}" for k, v in db_infos.items()))


def main():
    import argparse
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("command", choices=[
        "create_kitti_info_file", "create_reduced_point_cloud",
        "create_groundtruth_database", "create_demo_info_file"])
    parser.add_argument("--data_path", required=True)
    parser.add_argument("--save_path", default=None)
    parser.add_argument("--scene", default="demo",
                        help="scene tag for create_demo_info_file")
    args = parser.parse_args()
    if args.command == "create_demo_info_file":
        create_demo_info_file(args.data_path, scene=args.scene,
                              save_path=args.save_path)
    else:
        globals()[args.command](args.data_path, save_path=args.save_path)


if __name__ == "__main__":
    main()
