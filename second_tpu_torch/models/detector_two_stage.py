"""Two-stage detector: stage-1 VoxelNet + rotated-ROI refine — the port of
`second_tpu/models/detector_two_stage.py` (`RoiSpec`, `TwoStageVoxelNet`,
`compute_two_stage_loss`, `predict_two_stage`,
`build_two_stage_voxelnet`).

Stage-1 forward → the top N proposals of each example by standup NMS →
k x k rotated BEV crops of the trunk (the ROI-align kernel on the card) →
refine head → residual-added encodings; the training loss is (stage 1 +
stage 2) / 2, and eval decodes the refined proposals and runs rotated NMS
over them. The whole batch goes through each step at once, as JAX's
`vmap`s compute it; on the card nothing in the forward, the loss or
predict reads a tensor on the host.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
from torch import nn

from ..device import resolve_device
from ..ops import box_ops
from ..ops.cuda.gather import flat_rows
from ..ops.nms import nms
from .detector import VoxelNet, build_detector_spec, compute_loss
from .second_stage import (ProposalSpec, SecondStageHead, crop_rois,
                           second_stage_loss, select_proposals, take)


@dataclasses.dataclass(frozen=True)
class RoiSpec:
    pc_range: Tuple[float, ...]
    voxel_size: Tuple[float, float, float]
    out_stride: int
    crop_size: int = 14
    samples: int = 2


class TwoStageVoxelNet(nn.Module):
    """Stage-1 VoxelNet (`stage1`) + proposal crops + SECOND refine head
    (`second_rpn`), the JAX module's names."""

    def __init__(self, vfe_class_name, vfe_kwargs, middle_class_name,
                 middle_kwargs, rpn_kwargs, spec, pspec: ProposalSpec,
                 roi: RoiSpec):
        super().__init__()
        self.spec, self.pspec, self.roi = spec, pspec, roi
        self.stage1 = VoxelNet(vfe_class_name, vfe_kwargs, middle_class_name,
                               middle_kwargs, rpn_kwargs)
        self.second_rpn = SecondStageHead(
            sum(rpn_kwargs["num_upsample_filters"]), spec.num_class,
            spec.box_code_size, crop_size=roi.crop_size,
            use_direction_classifier=spec.use_direction_classifier)

    def forward(self, voxels, num_points, coords, voxel_valid, anchors,
                anchors_mask=None):
        """VoxelNet's inputs, anchors [B, A, 7] and the optional anchors
        mask [B, A] → stage 1's outputs plus proposals (`select_proposals`)
        and second_box_preds [B, N, code], second_cls_preds [B, N, C]
        (second_dir_preds [B, N, 2] with the direction classifier)."""
        stage1 = self.stage1(voxels, num_points, coords, voxel_valid)
        return self.refine(stage1, anchors, anchors_mask)

    def refine(self, stage1, anchors, anchors_mask=None):
        """The second stage on stage 1's outputs."""
        proposals = select_proposals(self.pspec, self.spec, stage1, anchors,
                                     anchors_mask)
        crops = self.crops(stage1["trunk"], proposals)
        B, N = proposals["indices"].shape
        out = self.second_rpn(crops)
        result = {**stage1, "proposals": proposals,
                  # residual refinement in encoding space (reference
                  # spatio :870)
                  "second_box_preds": out["box_preds"].reshape(
                      B, N, self.spec.box_code_size) + proposals["box_enc"],
                  "second_cls_preds": out["cls_preds"].reshape(B, N, -1)}
        if "dir_preds" in out:
            result["second_dir_preds"] = out["dir_preds"].reshape(B, N, 2)
        return result

    def crops(self, trunk, proposals):
        """[B * N, C, k, k] crops of the proposals' boxes."""
        r = self.roi
        return crop_rois(trunk, proposals["boxes"], r.pc_range, r.voxel_size,
                         r.out_stride, r.crop_size, r.samples)


def compute_two_stage_loss(spec, preds, labels, reg_targets, anchors,
                           gt_boxes=None, gt_valid=None):
    """(stage1 + stage2) / 2 (reference endtoend loss pattern)."""
    l1 = compute_loss(spec, preds, labels, reg_targets, anchors, gt_boxes,
                      gt_valid)
    second_preds = {"box_preds": preds["second_box_preds"],
                    "cls_preds": preds["second_cls_preds"]}
    if "second_dir_preds" in preds:
        second_preds["dir_preds"] = preds["second_dir_preds"]
    l2 = second_stage_loss(spec, second_preds, preds["proposals"], labels,
                           reg_targets, anchors, gt_boxes, gt_valid)
    out = {**l1, **l2}
    out["loss"] = (l1["loss"] + l2["second_loss"]) / 2.0
    return out


def predict_two_stage(spec, preds, anchors):
    """Decode + rotated NMS over the refined proposals, the whole batch at
    once. Returns boxes [B, P, 7], scores [B, P], labels [B, P] and valid
    [B, P] with P = nms_post_max_size; the scores follow the keep mask
    after the center-range cut, as in JAX."""
    proposals = preds["proposals"]
    idx = proposals["indices"]
    anchors = torch.as_tensor(anchors, device=idx.device)
    boxes = box_ops.second_box_decode(preds["second_box_preds"],
                                      take(anchors, idx))
    if spec.use_direction_classifier and "second_dir_preds" in preds:
        # stage-2 direction flip, the rule of stage 1 (detector.predict)
        dir_labels = preds["second_dir_preds"].argmax(-1)
        opp = (boxes[..., -1] > 0) != (dir_labels > 0)
        yaw = boxes[..., -1] + torch.where(opp, math.pi, 0.0)
        boxes = torch.cat([boxes[..., :-1], yaw[..., None]], -1)
    scores = torch.sigmoid(preds["second_cls_preds"])
    if scores.shape[-1] == 1:
        top_scores = scores[..., 0]
        top_labels = torch.zeros(scores.shape[:2], dtype=torch.int64,
                                 device=scores.device)
    else:
        top_scores = scores.amax(-1)
        top_labels = scores.argmax(-1)
    ok = proposals["valid"] & (top_scores >= spec.nms_score_threshold)
    N = idx.shape[1]
    sel, keep = nms(box_ops.bev_boxes(boxes), top_scores, ok,
                    pre_max_size=N, post_max_size=spec.nms_post_max_size,
                    iou_threshold=spec.nms_iou_threshold)
    out_boxes = flat_rows(boxes, sel)
    lim = spec.post_center_limit_range
    if lim:
        # compared with Python floats: a tensor of them would copy to the card
        for d in range(3):
            keep = keep & (out_boxes[..., d] >= lim[d]) & \
                (out_boxes[..., d] <= lim[3 + d])
    return {"boxes": out_boxes,
            "scores": torch.where(keep, top_scores.gather(1, sel), 0.0),
            "labels": top_labels.gather(1, sel), "valid": keep}


def build_two_stage_voxelnet(cfg, num_proposals: int = 512, device="cuda",
                             mixed_precision: bool = False, seed: int = 0):
    """ModelConfig → (module, spec, info, assigner, coder), two-stage: the
    one-stage builder's stage 1 (without an IoU head, as in JAX), the refine
    head on the trunk's channels, `num_proposals` proposals an example. The
    module is in eval mode on `device` (the CUDA card unless the caller
    asks for the CPU), with weights drawn by `init_weights_` from `seed`;
    under `mixed_precision` stage 1 computes as the one-stage model does,
    the head in fp32."""
    from .build import init_weights_, voxelnet_args
    dev = resolve_device(device)
    args, info, assigner, coder = voxelnet_args(cfg, mixed_precision)
    vg = cfg.voxel_generator
    roi = RoiSpec(pc_range=tuple(vg.point_cloud_range),
                  voxel_size=tuple(vg.voxel_size),
                  out_stride=info.out_size_factor)
    spec = build_detector_spec(cfg)
    module = TwoStageVoxelNet(*args[:5], spec=spec,
                              pspec=ProposalSpec(num_proposals=num_proposals),
                              roi=roi)
    init_weights_(module, seed)
    return module.to(dev).eval(), spec, info, assigner, coder
