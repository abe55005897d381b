"""Train and eval steps for the two-stage, temporal and camera-fusion
detectors — the port of `second_tpu/train/steps_multistage.py`
(`make_two_stage_steps`, `make_temporal_steps`, `make_fusion_steps`,
`make_fusion_two_stage_steps`, `make_temporal_fusion_steps`; the
counterpart of its `create_two_stage_state`, `create_temporal_state` and
`create_fusion_state` is `train/state.py` `create_state`, which serves
every detector: the port's modules need no example batch, camera inputs
included, to build).

The steps are `train/state.py`'s: the same voxelize, backward, gradient
norm, clip and optimizer step, and no host sync; only the forward (stage 1,
proposals, crops, refine head) and the loss ((stage 1 + stage 2) / 2)
differ. The temporal steps voxelize the previous frame too, from the
batch's `p_points` / `p_points_mask`, with the same spec. The eval steps
decode and NMS the refined proposals (`predict_two_stage`); the one-stage
fusion model's decode and NMS its RPN's predictions (`predict`). The
fusion steps pass the batch's camera inputs on: `image` [B, Hi, Wi, 3]
and the points' projections `proj_pix`, `proj_bev`, `proj_valid`, or for
the temporal-fusion model the z-slice grids `idxs_norm`, `idxs_valid`.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..models.detector import compute_loss, predict
from ..models.detector_two_stage import (compute_two_stage_loss,
                                         predict_two_stage)
from ..ops.anchors_mask import anchors_mask_from_coords
from ..ops.voxelize import VoxelizeSpec, device_voxelize
from .state import TrainState, step_of


def _forward(net, vox, batch, anchors_mask=None):
    return net(vox["voxels"], vox["num_points"], vox["coordinates"],
               vox["voxel_valid"], batch["anchors"],
               anchors_mask=batch.get("anchors_mask", anchors_mask))


def _metrics_of(aux):
    """The two-stage loss dict → the step's metrics."""
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


def _loss(spec, preds, batch):
    return compute_two_stage_loss(
        spec, preds, batch["labels"], batch["reg_targets"], batch["anchors"],
        batch.get("gt_boxes_padded"), batch.get("gt_valid"))


def _eval_mask(batch, vox, mask_info):
    """The anchors mask on the device from the (current) frame's coords,
    where the batch has none and `mask_info` is given; else None."""
    if "anchors_mask" in batch or mask_info is None:
        return None
    corners, grid_hw, threshold = mask_info
    return anchors_mask_from_coords(vox["coordinates"], vox["voxel_valid"],
                                    corners, grid_hw, threshold)


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
        return preds, _loss(spec, preds, batch)

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Dict):
        net = state.module
        net.eval()
        vox = device_voxelize(eval_vspec, batch["points"],
                              batch["points_mask"], state.device)
        preds = _forward(net, vox, batch, _eval_mask(batch, vox, mask_info))
        det = predict_two_stage(spec, preds, batch["anchors"])
        det["voxel_overflow"] = vox["voxel_overflow"]
        det["stage_overflow"] = preds["stage_overflow"]
        return det

    return step_of(vspec, forward_loss, _metrics_of), eval_step


def voxelize_pair(vspec, batch, dev):
    """The current and the previous frames voxelized with one spec →
    ((cur, prev), their summed voxel overflow)."""
    cur = device_voxelize(vspec, batch["points"], batch["points_mask"], dev)
    prev = device_voxelize(vspec, batch["p_points"], batch["p_points_mask"],
                           dev)
    return (cur, prev), cur["voxel_overflow"] + prev["voxel_overflow"]


def _forward_pair(net, pair, batch, anchors_mask=None):
    return net(*pair, batch["anchors"],
               anchors_mask=batch.get("anchors_mask", anchors_mask))


def make_temporal_steps(spec, vspec: VoxelizeSpec,
                        eval_vspec: VoxelizeSpec = None, mask_info=None):
    """(train_step, eval_step) for `TemporalVoxelNet` batches: the
    two-stage steps' batch keys plus the previous frame's points,
    p_points [B, P, C] and p_points_mask [B, P] (the reference's `p_*`
    example keys, spatio :666-677). Both frames are voxelized with the
    same spec (the eval capacity in eval); voxel_overflow counts both.
    The metrics are `make_two_stage_steps`'; the eval step's anchors mask,
    where the batch has none, comes from the current frame's coords."""
    eval_vspec = eval_vspec or vspec

    def forward_loss(net, pair, batch):
        preds = _forward_pair(net, pair, batch)
        return preds, _loss(spec, preds, batch)

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Dict):
        net = state.module
        net.eval()
        pair, overflow = voxelize_pair(eval_vspec, batch, state.device)
        preds = _forward_pair(net, pair, batch,
                              _eval_mask(batch, pair[0], mask_info))
        det = predict_two_stage(spec, preds, batch["anchors"])
        det["voxel_overflow"] = overflow
        det["stage_overflow"] = preds["stage_overflow"]
        return det

    return step_of(vspec, forward_loss, _metrics_of,
                   voxelize=voxelize_pair), eval_step



_PROJECTION_KEYS = ("image", "proj_pix", "proj_bev", "proj_valid")
_ZSLICE_KEYS = ("image", "idxs_norm", "idxs_valid")


def _camera(batch, keys=_PROJECTION_KEYS):
    return [batch[k] for k in keys]


def make_fusion_steps(spec, vspec: VoxelizeSpec,
                      eval_vspec: VoxelizeSpec = None, mask_info=None):
    """(train_step, eval_step) for the one-stage `FusionVoxelNet`: batches
    as `make_train_step`'s plus `image`, `proj_pix`, `proj_bev` and
    `proj_valid` (the reference's `--use_fusion` example keys). The metrics
    are JAX's keys (loss, cls_loss, loc_loss, num_pos, grad_norm,
    voxel_overflow, stage_overflow, dir_loss with the direction
    classifier); eval decodes and NMSes the RPN's predictions under the
    batch's anchors_mask (or the device mask from `mask_info` where the
    batch has none)."""
    eval_vspec = eval_vspec or vspec

    def forward(net, vox, batch):
        return net(vox["voxels"], vox["num_points"], vox["coordinates"],
                   vox["voxel_valid"], *_camera(batch))

    def forward_loss(net, vox, batch):
        preds = forward(net, vox, batch)
        return preds, compute_loss(spec, preds, batch["labels"],
                                   batch["reg_targets"], batch["anchors"],
                                   batch.get("gt_boxes_padded"),
                                   batch.get("gt_valid"))

    def metrics_of(aux):
        out = {"cls_loss": aux["cls_loss_reduced"].detach(),
               "loc_loss": aux["loc_loss_reduced"].detach(),
               "num_pos": aux["num_pos"]}
        if "dir_loss_reduced" in aux:
            out["dir_loss"] = aux["dir_loss_reduced"].detach()
        return out

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Dict):
        net = state.module
        net.eval()
        vox = device_voxelize(eval_vspec, batch["points"],
                              batch["points_mask"], state.device)
        preds = forward(net, vox, batch)
        mask = batch.get("anchors_mask", _eval_mask(batch, vox, mask_info))
        det = predict(spec, preds, batch["anchors"], mask)
        det["voxel_overflow"] = vox["voxel_overflow"]
        det["stage_overflow"] = preds["stage_overflow"]
        return det

    return step_of(vspec, forward_loss, metrics_of), eval_step


def make_fusion_two_stage_steps(spec, vspec: VoxelizeSpec,
                                eval_vspec: VoxelizeSpec = None,
                                mask_info=None):
    """(train_step, eval_step) for `FusionTwoStageVoxelNet` (the reference's
    fused endtoend path): `make_two_stage_steps`' with the camera inputs of
    `make_fusion_steps`."""
    eval_vspec = eval_vspec or vspec

    def forward(net, vox, batch, anchors_mask=None):
        return net(vox["voxels"], vox["num_points"], vox["coordinates"],
                   vox["voxel_valid"], *_camera(batch), batch["anchors"],
                   anchors_mask=batch.get("anchors_mask", anchors_mask))

    def forward_loss(net, vox, batch):
        preds = forward(net, vox, batch)
        return preds, _loss(spec, preds, batch)

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Dict):
        net = state.module
        net.eval()
        vox = device_voxelize(eval_vspec, batch["points"],
                              batch["points_mask"], state.device)
        preds = forward(net, vox, batch, _eval_mask(batch, vox, mask_info))
        det = predict_two_stage(spec, preds, batch["anchors"])
        det["voxel_overflow"] = vox["voxel_overflow"]
        det["stage_overflow"] = preds["stage_overflow"]
        return det

    return step_of(vspec, forward_loss, _metrics_of), eval_step


def make_temporal_fusion_steps(spec, vspec: VoxelizeSpec,
                               eval_vspec: VoxelizeSpec = None,
                               mask_info=None):
    """(train_step, eval_step) for `TemporalFusionVoxelNet` (the full spatio
    model): `make_temporal_steps`' with the current frame's camera inputs,
    `image`, `idxs_norm` [B, D, H, W, 2] and `idxs_valid` [B, D, H, W]."""
    eval_vspec = eval_vspec or vspec

    def forward(net, pair, batch, anchors_mask=None):
        return net(*pair, *_camera(batch, _ZSLICE_KEYS), batch["anchors"],
                   anchors_mask=batch.get("anchors_mask", anchors_mask))

    def forward_loss(net, pair, batch):
        preds = forward(net, pair, batch)
        return preds, _loss(spec, preds, batch)

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Dict):
        net = state.module
        net.eval()
        pair, overflow = voxelize_pair(eval_vspec, batch, state.device)
        preds = forward(net, pair, batch,
                        _eval_mask(batch, pair[0], mask_info))
        det = predict_two_stage(spec, preds, batch["anchors"])
        det["voxel_overflow"] = overflow
        det["stage_overflow"] = preds["stage_overflow"]
        return det

    return step_of(vspec, forward_loss, _metrics_of,
                   voxelize=voxelize_pair), eval_step
