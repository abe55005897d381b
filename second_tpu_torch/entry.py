"""The port's model entry point and multi-device dry run — the
counterparts of the JAX package's `__graft_entry__.entry()` and
`dryrun_multichip`.

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
# the multi-device dry run's configuration
TINY_CONFIG = Path(__file__).resolve().parent / "configs" / \
    "tiny_sparse.config"


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


def dryrun_multichip(n_devices: int, steps: int = 2) -> dict:
    """The counterpart of the JAX package's `dryrun_multichip`: the CLI's
    data-parallel training (`train.run.Trainer` on synthetic scans of
    `configs/tiny_sparse.config`, the train batch set to `n_devices`, 512
    voxels) for `steps` steps at world size `n_devices`, in `n_devices` CPU
    processes of a gloo group (`parallel.launch.run_world`; the machine
    has one card). Every rank must take the data-parallel path, end at
    the same finite parameters and log finite losses. Returns rank 0's
    result."""
    import tempfile

    from .parallel.launch import run_world
    with tempfile.TemporaryDirectory() as tmp:
        results = run_world("second_tpu_torch.entry:dryrun_rank", n_devices,
                            Path(tmp) / "world", args=(tmp, steps),
                            deadline=300.0)
    first = results[0]
    for r, res in enumerate(results):
        if not res["data_parallel"] or res["step"] != steps:
            raise RuntimeError(f"dryrun_multichip: rank {r} took no "
                               f"data-parallel step: {res}")
        if not np.isfinite(res["param_sum"]) or \
                res["param_sum"] != first["param_sum"]:
            raise RuntimeError(f"dryrun_multichip: rank {r}'s parameters "
                               f"differ from rank 0's or are not finite")
    if len(first["losses"]) != steps or \
            not np.isfinite(first["losses"]).all():
        raise RuntimeError(f"dryrun_multichip: losses {first['losses']}")
    print(f"dryrun_multichip({n_devices}): CLI DP train {steps} steps on "
          f"{n_devices} ranks, losses {first['losses']}")
    return first


def dryrun_rank(tmp: str, steps: int) -> dict:
    """One rank of `dryrun_multichip` (run by `parallel.launch`)."""
    import json

    import torch.distributed as dist

    from .train.run import Trainer
    n = dist.get_world_size()
    trainer = Trainer(TINY_CONFIG, Path(tmp) / "model", synthetic=True,
                      dataset_size=2 * n, max_points=2048, device="cpu",
                      patches=[f"train_input_reader.batch_size={n}",
                               "train_input_reader.max_number_of_voxels=512",
                               "train_config.save_summary_steps=1"])
    state = trainer.train(total_steps=steps)
    losses = []
    if trainer.is_chief:
        log = Path(tmp) / "model" / "log.json"
        losses = [rec["train.loss"] for rec in map(json.loads,
                                                   log.read_text().split(
                                                       "\n")[:-1])
                  if "train.loss" in rec]
    return {"data_parallel": trainer._train_group is not None,
            "step": state.step, "losses": np.asarray(losses),
            "param_sum": float(sum(p.double().abs().sum()
                                   for p in state.module.parameters()))}
