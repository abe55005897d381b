"""The port's model entry point — the counterpart of the JAX package's
`__graft_entry__.entry()`.

    from second_tpu_torch.entry import entry
    forward, args = entry()              # on the CUDA card
    detections = forward(*args)

`entry()` builds the PointPillars car model
(`configs/pointpillars_car.config`: pillar encoder → BEV scatter → 3-stage
RPN, bf16 trunk as the config asks) with flax's initialisers drawn from a
seed, and one example of synthetic points at batch 1, 20 000 points and
12 000 pillars. `forward(points, points_mask, anchors)` is the eval
forward: voxelize → encoder → scatter → RPN → decode + rotated NMS.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from .config import load_pipeline_config
from .data import ExamplePrep, PrepConfig, sample_scene
from .device import resolve_device
from .models import build_voxelnet, detect, init_train_weights_
from .ops.voxelize import VoxelizeSpec

CONFIG = Path(__file__).resolve().parent / "configs" / \
    "pointpillars_car.config"
MAX_POINTS, MAX_VOXELS, BATCH = 20000, 12000, 1


def entry(device="cuda", seed: int = 0):
    """(forward, example_args): the PointPillars eval forward and its
    inputs (points [1, 20000, 4], points_mask [1, 20000], anchors
    [1, A, 7]) on `device`, the CUDA card unless the caller asks for the
    CPU."""
    dev = resolve_device(device)
    cfg = load_pipeline_config(CONFIG)
    net, spec, info, assigner, _ = build_voxelnet(
        cfg.model, device=dev,
        mixed_precision=cfg.train_config.enable_mixed_precision, seed=seed)
    init_train_weights_(net, seed)
    vspec = VoxelizeSpec.from_config(cfg.model.voxel_generator, MAX_VOXELS)
    prep = ExamplePrep(assigner, info.feature_map_size,
                       PrepConfig(max_points=MAX_POINTS, training=False))
    pc_range = tuple(cfg.model.voxel_generator.point_cloud_range)
    rng = np.random.default_rng(seed)
    examples = []
    for i in range(BATCH):
        p, b, n = sample_scene(np.random.default_rng(seed * 7 + i),
                               pc_range=pc_range, num_ground=MAX_POINTS // 3)
        examples.append(prep({"points": p, "gt_boxes": b, "gt_names": n,
                              "image_idx": i}, rng))
    batch = prep.collate(examples)
    example_args = tuple(torch.as_tensor(batch[k], device=dev)
                         for k in ("points", "points_mask", "anchors"))

    def forward(points, points_mask, anchors):
        return detect(net, spec, vspec, points, points_mask, anchors,
                      device=dev)[0]

    return forward, example_args
