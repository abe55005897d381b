"""Two-stage refinement: proposal selection, rotated-ROI crops and the
refine head — the port of `second_tpu/models/second_stage.py`
(`ProposalSpec`, `select_proposals`, `ConvTower`, `SecondStageHead`,
`crop_rois`, `second_stage_loss`).

`select_proposals` runs the whole batch through one standup NMS
(`nearest_nms`: a batched top-k, the standup-overlap bitmask kernel and
the suppression kernel on the card), as `jax.vmap` of JAX's per-example
function computes it, and keeps JAX's gradients: the proposals' boxes and
encodings are gathered differentiably, so the crops pull on stage 1's box
predictions through the decode. The crops come from the rotated ROI-align
kernel (`ops/roi_align_rotated.py` `roi_align_batched`) as [B * N, C, k,
k], the layout the head's convs take. The head is NCHW and computes in
fp32 (fp64 in an fp64 model) whatever the trunk's dtype, as flax promotes
the crops.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..device import at_least_fp32, constant
from ..ops import box_ops
from ..ops.nms import nearest_nms
from ..ops.roi_align_rotated import boxes_to_bev_rois, roi_align_batched
from ..ops.rotated_iou import d3_iou_matrix
from . import losses as loss_lib


@dataclasses.dataclass(frozen=True)
class ProposalSpec:
    """Stage-1 proposal selection parameters (reference predict_for_rpn:
    score-ordered standup NMS, thr 0.7, pre 9000, keep 512)."""
    num_proposals: int = 512
    nms_pre_max_size: int = 2048
    nms_iou_threshold: float = 0.7


def take(src, idx):
    """src [B, A, ...] at idx [B, N] → [B, N, ...], differentiable."""
    idx = idx.long().view(*idx.shape, *([1] * (src.dim() - 2)))
    return torch.take_along_dim(src, idx, dim=1)


def select_proposals(pspec: ProposalSpec, spec, preds_dict, anchors,
                     anchors_mask=None):
    """Top-N stage-1 proposals per example.

    anchors [B, A, 7]; anchors_mask: optional [B, A] bool, the anchors the
    NMS may take. Returns a dict of indices [B, N] anchor indices, valid
    [B, N], boxes [B, N, 7] decoded proposals, box_enc [B, N, code] stage-1
    encodings and cls_logits [B, N, C1]; every row is filled, the invalid
    ones from the NMS's filler indices, as in JAX."""
    B, A = anchors.shape[:2]
    code = spec.box_code_size
    box_preds = preds_dict["box_preds"].reshape(B, A, code)
    nc = spec.num_class if spec.encode_background_as_zeros \
        else spec.num_class + 1
    cls_preds = preds_dict["cls_preds"].reshape(B, A, nc)
    dev, dtype = box_preds.device, box_preds.dtype
    # clamp dim encodings so exp() stays finite for untrained/diverged
    # nets; minimum(maximum(.)) splits the gradient at a bound as jnp.clip
    dims = torch.minimum(torch.maximum(box_preds[..., 3:6],
                                       constant(-10.0, dev, dtype)),
                         constant(6.0, dev, dtype))
    safe = torch.cat([box_preds[..., :3], dims, box_preds[..., 6:]], -1)
    boxes = box_ops.second_box_decode(safe, anchors)
    with torch.no_grad():
        scores = torch.sigmoid(cls_preds).amax(-1)
        if anchors_mask is None:
            anchors_mask = torch.ones((B, A), dtype=torch.bool, device=dev)
        idx, keep = nearest_nms(
            box_ops.bev_boxes(boxes.detach()), scores, anchors_mask,
            pre_max_size=pspec.nms_pre_max_size,
            post_max_size=pspec.num_proposals,
            iou_threshold=pspec.nms_iou_threshold)
    return {"indices": idx, "valid": keep, "boxes": take(boxes, idx),
            "box_enc": take(box_preds, idx),
            "cls_logits": take(cls_preds, idx)}


class ConvTower(nn.Module):
    """5 x (conv3x3 + ReLU), no norm (reference SECOND_RPNV2 towers)."""

    def __init__(self, in_channels, features=128, depth=5):
        super().__init__()
        self.convs = nn.ModuleList(
            nn.Conv2d(in_channels if i == 0 else features, features, 3,
                      padding=1) for i in range(depth))

    def forward(self, x):
        for conv in self.convs:
            x = torch.relu(conv(x))
        return x


class SecondStageHead(nn.Module):
    """Refine head over [R, C, crop, crop] ROI crops → per-ROI box, cls
    (and, with `use_direction_classifier`, 2-way direction) logits, each
    from a crop-sized VALID conv over its tower (box and direction on the
    reg tower, cls on the cls tower). With `concat_crops` the cls tower
    takes those (JAX's fusion variants), of `concat_channels` channels
    (`in_channels` unless given: flax's towers infer theirs)."""

    def __init__(self, in_channels, num_class=1, box_code_size=7,
                 features=128, crop_size=14, use_direction_classifier=False,
                 concat_channels=None):
        super().__init__()
        self.reg_tower = ConvTower(in_channels, features)
        self.cls_tower = ConvTower(concat_channels or in_channels, features)
        k = crop_size
        self.conv_box_second = nn.Conv2d(features, box_code_size, k)
        self.conv_cls_second = nn.Conv2d(features, num_class, k)
        self.conv_dir_second = nn.Conv2d(features, 2, k) \
            if use_direction_classifier else None

    def forward(self, bev_crops, concat_crops=None):
        bev_crops = at_least_fp32(bev_crops)
        concat_crops = bev_crops if concat_crops is None \
            else at_least_fp32(concat_crops)
        reg = self.reg_tower(bev_crops)
        cls = self.cls_tower(concat_crops)
        out = {"box_preds": self.conv_box_second(reg)[:, :, 0, 0],
               "cls_preds": self.conv_cls_second(cls)[:, :, 0, 0]}
        if self.conv_dir_second is not None:
            out["dir_preds"] = self.conv_dir_second(reg)[:, :, 0, 0]
        return out


def crop_rois(trunk, proposal_boxes, pc_range, voxel_size, out_stride,
              crop_size=14, samples=2):
    """Rotated-ROI crops of the proposals' footprints, the whole batch at
    once: trunk [B, C, H, W], proposal_boxes [B, N, 7] lidar frame →
    [B * N, C, crop, crop] (fp32, fp64 for fp64)."""
    rois = boxes_to_bev_rois(proposal_boxes, pc_range, out_stride,
                             voxel_size)
    return roi_align_batched(trunk, rois, (crop_size, crop_size), samples)


def second_stage_loss(spec, second_preds, proposals, labels, reg_targets,
                      anchors, gt_boxes=None, gt_valid=None):
    """Stage-2 loss on the selected anchors (reference `spatio :902-1025`).

    second_preds: box_preds [B, N, code] (already residual-added),
    cls_preds [B, N, C1] and, with the direction classifier, dir_preds
    [B, N, 2]. labels / reg_targets / anchors: the full [B, A, ...],
    gathered here at the proposal indices. With gt_boxes / gt_valid
    (padded [B, G, 7] / [B, G]) and `spec.use_iou_param_partaa` the
    positives' classification targets are the Part-A² soft labels of the
    refined proposals' 3-D IoU with the gt (no gradient)."""
    idx = proposals["indices"]
    B = idx.shape[0]
    sel_labels = take(labels, idx)
    sel_targets = take(reg_targets, idx)
    sel_labels = torch.where(proposals["valid"], sel_labels, -1)
    dtype = second_preds["box_preds"].dtype

    cls_weights, reg_weights, cared = loss_lib.prepare_loss_weights(
        sel_labels, spec.pos_cls_weight, spec.neg_cls_weight,
        spec.loss_norm_type, dtype)
    cls_targets = sel_labels.long() * cared.long()
    one_hot = torch.nn.functional.one_hot(cls_targets,
                                          spec.num_class + 1).to(dtype)
    if spec.encode_background_as_zeros:
        one_hot = one_hot[..., 1:]
    if spec.use_iou_param_partaa and gt_boxes is not None:
        with torch.no_grad():
            decoded = box_ops.second_box_decode(
                second_preds["box_preds"].detach(), take(anchors, idx))
            iou = d3_iou_matrix(decoded, gt_boxes.to(dtype))  # [B, N, G]
            iou = torch.where(gt_valid[:, None, :], iou, 0.0).amax(-1)
            soft = torch.clamp(iou * 2.0 - 0.5, 0.0, 1.0)
            soft = torch.where(iou > 0.75, 1.0,
                               torch.where(iou < 0.25, 0.0, soft))
        one_hot = one_hot * torch.where(sel_labels > 0, soft,
                                        1.0)[..., None]

    bp, rt = second_preds["box_preds"], sel_targets
    if spec.encode_rad_error_by_sin:
        bp, rt = box_ops.add_sin_difference(bp, rt)
    loc_losses = spec.loc_loss_fn(bp, rt, reg_weights)
    cls_losses = spec.cls_loss_fn(second_preds["cls_preds"], one_hot,
                                  cls_weights)
    loc_loss = loc_losses.sum() / B * spec.loc_loss_weight
    cls_loss = cls_losses.sum() / B * spec.cls_loss_weight
    out = {
        "second_loc_loss_reduced": loc_loss,
        "second_cls_loss_reduced": cls_loss,
        "second_loss": loc_loss + cls_loss,
        "second_num_pos": (sel_labels > 0).sum(),
    }
    if spec.use_direction_classifier and "dir_preds" in second_preds:
        # stage-2 direction loss on the selected anchors (spatio :1016-1025)
        dir_targets = box_ops.get_direction_target(take(anchors, idx),
                                                   sel_targets)
        weights = (sel_labels > 0).to(dtype)
        weights = weights / torch.clamp(weights.sum(-1, keepdim=True),
                                        min=1.0)
        dir_one_hot = torch.nn.functional.one_hot(dir_targets, 2).to(dtype)
        dir_loss = loss_lib.weighted_softmax_loss(
            second_preds["dir_preds"], dir_one_hot, weights).sum() / B
        out["second_dir_loss_reduced"] = dir_loss
        out["second_loss"] = out["second_loss"] + \
            dir_loss * spec.direction_loss_weight
    return out
