"""Ground-truth database sampling ("sample-paste" augmentation).

Equivalent of the reference's `second/core/sample_ops.py` DataBaseSamplerV2
(`sample_all :95-211`, `sample_class_v2 :234-281`) + `BatchSampler`
(`preprocess.py:17-50`) + db filters (`preprocess.py:62-101`): per-class quota
sampling from a pre-cropped object database, BEV collision rejection against
the scene's existing boxes, and pasting each sampled object's points into the
frame.
"""

from __future__ import annotations

import pathlib
import pickle
from typing import Dict, List, Optional, Sequence

import numpy as np

from .augment import box_collision_test


class BatchSampler:
    """Epoch-shuffled sampling without replacement from one class's infos."""

    def __init__(self, sampled_list, rng: Optional[np.random.Generator] = None,
                 shuffle=True):
        self._list = sampled_list
        self._shuffle = shuffle
        self._rng = rng or np.random.default_rng()
        self._idx = 0
        self._order = self._new_order()

    def _new_order(self):
        order = np.arange(len(self._list))
        if self._shuffle:
            self._rng.shuffle(order)
        return order

    def sample(self, num: int) -> List:
        if num > len(self._list):
            num = len(self._list)
        if self._idx + num > len(self._list):
            self._order = self._new_order()
            self._idx = 0
        out = [self._list[i]
               for i in self._order[self._idx:self._idx + num]]
        self._idx += num
        return out


def filter_by_difficulty(db_infos: Dict[str, List], removed: Sequence[int]):
    return {name: [info for info in infos
                   if info.get("difficulty", 0) not in removed]
            for name, infos in db_infos.items()}


def filter_by_min_num_points(db_infos: Dict[str, List],
                             min_points: Dict[str, int]):
    out = dict(db_infos)
    for name, num in min_points.items():
        if name in out and num > 0:
            out[name] = [info for info in out[name]
                         if info["num_points_in_gt"] >= num]
    return out


class DataBaseSampler:
    """Sample per-class gt crops and paste them into a scene."""

    def __init__(self, db_infos: Dict[str, List],
                 sample_groups,
                 root_path="", rate=1.0,
                 rng: Optional[np.random.Generator] = None):
        """`sample_groups`: either a flat {class: max_num} dict (every class
        its own group) or a list of {class: max_num} dicts — a dict with >1
        class enables GROUP sampling (whole co-occurring object groups,
        keyed by the database's `group_id`; reference `sample_ops.py:30-63`,
        `sample_group :283-345`). No shipped reference config uses multi-
        class groups, but the machinery is config-reachable."""
        self._db_infos = db_infos
        self._root = pathlib.Path(root_path)
        self._rate = rate
        self._rng = rng or np.random.default_rng()
        if isinstance(sample_groups, dict):
            group_list = [{k: v} for k, v in sample_groups.items()]
        else:
            group_list = [dict(g) for g in sample_groups]
        self._group_mode = any(len(g) > 1 for g in group_list)
        self._groups = {}
        for g in group_list:
            self._groups.update(g)
        if not self._group_mode:
            self._samplers = {name: BatchSampler(infos, self._rng)
                              for name, infos in db_infos.items()}
        else:
            # bucket member infos by their database group_id; sample whole
            # co-occurring groups
            self._group_name_to_names = []
            self._samplers = {}
            for g in group_list:
                names = list(g.keys())
                gname = ", ".join(names)
                self._group_name_to_names.append((gname, names))
                buckets: Dict[int, List] = {}
                for name in names:
                    for info in db_infos.get(name, []):
                        buckets.setdefault(info["group_id"], []).append(info)
                self._samplers[gname] = BatchSampler(list(buckets.values()),
                                                     self._rng)

    @classmethod
    def from_config(cls, sampler_cfg, rng=None, root_path=""):
        """From schema.SamplerConfig (reference `dbsampler_builder.py`)."""
        with open(sampler_cfg.database_info_path, "rb") as f:
            db_infos = pickle.load(f)
        for step in sampler_cfg.database_prep_steps:
            if step.kind == "filter_by_difficulty":
                db_infos = filter_by_difficulty(db_infos,
                                                step.removed_difficulties)
            elif step.kind == "filter_by_min_num_points":
                db_infos = filter_by_min_num_points(db_infos,
                                                    step.min_num_point_pairs)
        groups = [dict(grp.name_to_max_num)
                  for grp in sampler_cfg.sample_groups]
        return cls(db_infos, groups, root_path=root_path,
                   rate=sampler_cfg.rate, rng=rng)

    def sample_all(self, gt_boxes, gt_names, num_point_features=4,
                   gt_group_ids=None):
        """Sample objects up to each class quota, rejecting BEV collisions.

        Returns None or a dict with gt_boxes [S, 7], gt_names [S],
        points [P, C], difficulty [S] (+ group_ids [S] in group mode).
        In group mode whole co-occurring groups are accepted or rejected
        together and sampled group ids are rewritten past the scene's
        (reference `sample_group :283-345`).
        """
        if self._group_mode:
            return self._sample_all_grouped(gt_boxes, gt_names,
                                            num_point_features, gt_group_ids)
        sampled = []
        sampled_boxes = []
        avoid = gt_boxes[:, [0, 1, 3, 4, 6]].copy()
        for name, max_num in self._groups.items():
            if name not in self._samplers:
                continue
            have = int((gt_names == name).sum())
            quota = int(self._rate * (max_num - have))
            if quota <= 0:
                continue
            cands = self._samplers[name].sample(quota)
            for info in cands:
                box = np.asarray(info["box3d_lidar"], np.float64)
                bev = box[[0, 1, 3, 4, 6]][None]
                existing = avoid if len(sampled_boxes) == 0 else np.concatenate(
                    [avoid] + [b[[0, 1, 3, 4, 6]][None]
                               for b in sampled_boxes])
                if box_collision_test(bev, existing).any():
                    continue
                sampled.append(info)
                sampled_boxes.append(box)
        if not sampled:
            return None
        boxes = np.stack(sampled_boxes)
        points_list = []
        for info, box in zip(sampled, boxes):
            pts = self._load_points(info, num_point_features)
            pts = pts.copy()
            pts[:, :3] += box[:3]    # db crops are center-subtracted
            points_list.append(pts)
        return {
            "gt_boxes": boxes.astype(np.float32),
            "gt_names": np.array([info["name"] for info in sampled]),
            "points": np.concatenate(points_list).astype(np.float32),
            "difficulty": np.array(
                [info.get("difficulty", 0) for info in sampled]),
        }

    def _sample_all_grouped(self, gt_boxes, gt_names, num_point_features,
                            gt_group_ids):
        """Group-mode sample_all: quota per group = max over member-class
        deficits; whole-group collision accept/reject; group ids rewritten
        to continue past the scene's."""
        next_gid = 1 + (int(np.max(gt_group_ids))
                        if gt_group_ids is not None and len(gt_group_ids)
                        else -1)
        sampled, sampled_boxes, sampled_gids = [], [], []
        avoid = gt_boxes[:, [0, 1, 3, 4, 6]].copy()
        for gname, names in self._group_name_to_names:
            deficits = [int(self._rate * (self._groups[n] -
                                          int((gt_names == n).sum())))
                        for n in names]
            quota = max(deficits)
            if quota <= 0:
                continue
            for grp in self._samplers[gname].sample(quota):
                boxes = np.stack([np.asarray(i["box3d_lidar"], np.float64)
                                  for i in grp])
                bev = boxes[:, [0, 1, 3, 4, 6]]
                existing = avoid if not sampled_boxes else np.concatenate(
                    [avoid] + [b[[0, 1, 3, 4, 6]][None]
                               for b in sampled_boxes])
                if box_collision_test(bev, existing).any():
                    continue        # reject the WHOLE group
                # intra-group overlap is genuine (e.g. rider on bicycle)
                sampled.extend(grp)
                sampled_boxes.extend(boxes)
                sampled_gids.extend([next_gid] * len(grp))
                next_gid += 1
        if not sampled:
            return None
        boxes = np.stack(sampled_boxes)
        points_list = []
        for info, box in zip(sampled, boxes):
            pts = self._load_points(info, num_point_features).copy()
            pts[:, :3] += box[:3]
            points_list.append(pts)
        return {
            "gt_boxes": boxes.astype(np.float32),
            "gt_names": np.array([info["name"] for info in sampled]),
            "points": np.concatenate(points_list).astype(np.float32),
            "difficulty": np.array(
                [info.get("difficulty", 0) for info in sampled]),
            "group_ids": np.array(sampled_gids, np.int64),
        }

    def _load_points(self, info, num_point_features):
        if "points" in info:    # in-memory database (tests)
            return np.asarray(info["points"], np.float32)
        path = self._root / info["path"]
        return np.fromfile(path, np.float32).reshape(-1, num_point_features)
