"""Data-parallel evaluation with the detection statistics reduced over the
ranks — the port of `second_tpu/parallel/eval_dp.py`.

JAX runs the eval forward under `shard_map` over the `data` axis, each shard
counts its detections and a `psum` reduces the counts; the detections stay
sharded on the batch axis and the host reads them whole. Here each rank
evaluates its slice of the global batch (`mesh.shard_batch`), all-reduces
the statistics vector and all-gathers the detections, so every rank returns
the global batch's detections, as JAX's sharded arrays read on the host.
At one rank (no group, or a group of one) the collectives are skipped.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..models.detector import DetectorSpec, detect
from ..ops.voxelize import VoxelizeSpec
from .mesh import data_sharding, globalise, shard_batch, sum_ranks

SCORE_THRESHOLDS = (0.1, 0.3, 0.5, 0.7, 0.9)


def _local_stats(det):
    """This rank's detection statistics: its valid detections and their
    counts at or above each score threshold, [T + 1] int32."""
    valid = det["valid"]
    scores = torch.where(valid, det["scores"], -1.0)
    counts = [(scores >= t).sum() for t in SCORE_THRESHOLDS]
    return torch.stack([valid.sum(), *counts]).to(torch.int32)


def make_dp_eval_step(spec: DetectorSpec, vspec: VoxelizeSpec, group=None,
                      mask_info=None):
    """The one-stage eval step over the ranks of `group`.

    Returns `eval_step(state, batch) -> (det, stats)`: `batch` is the global
    batch (points, points_mask, anchors, the optional host anchors_mask),
    of which this rank voxelizes, runs forward and predicts its slice;
    `det` is the global batch's detections on every rank, with
    stage_overflow summed over the ranks, and `stats` the reduced
    [T + 2] int32 vector (`_local_stats` and the voxel overflow),
    identical on every rank. B must divide by the number of ranks.

    `mask_info = (sat_corners, grid_hw, threshold)` computes the occupancy
    anchors mask on the device from each slice's voxel coords
    (`ops/anchors_mask.py`), as JAX's does per shard."""
    rank, world = data_sharding(group)

    @torch.no_grad()
    def eval_step(state, batch: Dict):
        keys = [k for k in ("points", "points_mask", "anchors",
                            "anchors_mask") if k in batch]
        local = shard_batch({k: batch[k] for k in keys}, rank, world)
        net = state.module
        net.eval()
        det, vox, preds = detect(net, spec, vspec, local["points"],
                                 local["points_mask"], local["anchors"],
                                 device=state.device, mask_info=mask_info,
                                 anchors_mask=local.get("anchors_mask"))
        stats = sum_ranks(torch.cat([
            _local_stats(det),
            torch.as_tensor(vox["voxel_overflow"],
                            device=det["valid"].device).to(
                                torch.int32)[None]]), group)
        det = globalise(det, group)
        det["stage_overflow"] = sum_ranks(torch.as_tensor(
            preds["stage_overflow"], device=stats.device), group)
        return det, stats

    return eval_step


def make_dp_eval_any(eval_step, group=None):
    """Any `(state, batch) -> det` eval step (two-stage, temporal, fusion)
    over the ranks of `group`: each rank runs `eval_step` on its slice of
    every batch leaf; the 0-d leaves of `det` (voxel_overflow,
    stage_overflow) are summed over the ranks, the batched ones gathered,
    and the detection statistics (`_local_stats`, no voxel overflow) are
    reduced. Returns `dp_step(state, batch) -> (det, stats)`; `det` must
    carry `scores` and `valid`, as every predict does."""
    rank, world = data_sharding(group)

    def dp_step(state, batch: Dict):
        det = eval_step(state, shard_batch(batch, rank, world))
        stats = sum_ranks(_local_stats(det), group)
        return globalise(det, group), stats

    return dp_step


def stats_to_dict(stats) -> Dict[str, int]:
    """Readable form of the reduced statistics vector (its trailing
    voxel_overflow element optional: `make_dp_eval_any` has none)."""
    stats = [int(v) for v in torch.as_tensor(stats).reshape(-1).tolist()]
    out = {"num_detections": stats[0]}
    for i, t in enumerate(SCORE_THRESHOLDS):
        out[f"num_score_ge_{t}"] = stats[i + 1]
    if len(stats) > len(SCORE_THRESHOLDS) + 1:
        out["voxel_overflow"] = stats[-1]
    return out


__all__ = ["SCORE_THRESHOLDS", "make_dp_eval_step", "make_dp_eval_any",
           "stats_to_dict"]
