"""Train and eval steps for the two-stage detector — the port of
`second_tpu/train/steps_multistage.py` (`make_two_stage_steps`; the
counterpart of its `create_two_stage_state` is `train/state.py`
`create_state`, which serves both detectors).

The steps are `train/state.py`'s: the same voxelize, backward, gradient
norm, clip and optimizer step, and no host sync; only the forward (stage 1,
proposals, crops, refine head) and the loss ((stage 1 + stage 2) / 2)
differ. The eval step decodes and NMSes the refined proposals
(`predict_two_stage`).
"""

from __future__ import annotations

from typing import Dict

import torch

from ..models.detector_two_stage import (compute_two_stage_loss,
                                         predict_two_stage)
from ..ops.anchors_mask import anchors_mask_from_coords
from ..ops.voxelize import VoxelizeSpec, device_voxelize
from .state import TrainState, step_of


def _forward(net, vox, batch, anchors_mask=None):
    return net(vox["voxels"], vox["num_points"], vox["coordinates"],
               vox["voxel_valid"], batch["anchors"],
               anchors_mask=batch.get("anchors_mask", anchors_mask))


def make_two_stage_steps(spec, vspec: VoxelizeSpec,
                         eval_vspec: VoxelizeSpec = None, mask_info=None):
    """(train_step, eval_step) for `TwoStageVoxelNet` batches.

    train_step(state, batch) → (state, metrics): batch as
    `make_train_step`'s (with the optional host anchors_mask [B, A], which
    the proposals respect); the metrics are JAX's keys (loss, cls_loss,
    loc_loss, second_cls_loss, second_loc_loss, num_pos, second_num_pos,
    grad_norm, dir_loss with the direction classifier) plus
    second_dir_loss, voxel_overflow and stage_overflow.

    eval_step(state, batch) → detections (`predict_two_stage`) with the
    voxel and stage overflow counts, at the eval voxel capacity. Where the
    batch has no anchors_mask, `mask_info = (sat_corners [A, 4], grid_hw,
    threshold)` computes it on the device from the voxelizer's coords
    (`ops/anchors_mask.py`), the mask the host would give."""
    eval_vspec = eval_vspec or vspec

    def forward_loss(net, vox, batch):
        preds = _forward(net, vox, batch)
        return preds, compute_two_stage_loss(
            spec, preds, batch["labels"], batch["reg_targets"],
            batch["anchors"], batch.get("gt_boxes_padded"),
            batch.get("gt_valid"))

    def metrics_of(aux):
        out = {"cls_loss": aux["cls_loss_reduced"].detach(),
               "loc_loss": aux["loc_loss_reduced"].detach(),
               "second_cls_loss": aux["second_cls_loss_reduced"].detach(),
               "second_loc_loss": aux["second_loc_loss_reduced"].detach(),
               "num_pos": aux["num_pos"],
               "second_num_pos": aux["second_num_pos"]}
        if "dir_loss_reduced" in aux:
            out["dir_loss"] = aux["dir_loss_reduced"].detach()
        if "second_dir_loss_reduced" in aux:
            out["second_dir_loss"] = aux["second_dir_loss_reduced"].detach()
        return out

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Dict):
        net = state.module
        net.eval()
        vox = device_voxelize(eval_vspec, batch["points"],
                              batch["points_mask"], state.device)
        mask = None
        if "anchors_mask" not in batch and mask_info is not None:
            corners, grid_hw, threshold = mask_info
            mask = anchors_mask_from_coords(vox["coordinates"],
                                            vox["voxel_valid"], corners,
                                            grid_hw, threshold)
        preds = _forward(net, vox, batch, mask)
        det = predict_two_stage(spec, preds, batch["anchors"])
        det["voxel_overflow"] = vox["voxel_overflow"]
        det["stage_overflow"] = preds["stage_overflow"]
        return det

    return step_of(vspec, forward_loss, metrics_of), eval_step

