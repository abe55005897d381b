"""One-stage detector assembly — the port of `second_tpu/models/detector.py`
(`DetectorSpec`, `IoUHead`, `VoxelNet`, `compute_loss` with the IoU branch,
`predict` with single- and multi-class NMS, `build_detector_spec`).

`predict` keeps the JAX package's fixed-size outputs: [B, post_max_size]
boxes, scores, labels and a valid mask, computed for the whole batch at
once. Top-k is a stable descending sort (ties resolve lowest index first,
as `lax.top_k` does), and the candidate gathers go through the row-gather
kernel. Multi-class NMS runs every class of every example as one batch of
the NMS kernels.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Tuple

import torch
from torch import nn

from ..device import at_least_fp32
from ..ops import box_ops
from ..ops.anchors_mask import anchors_mask_from_coords
from ..ops.cuda.gather import flat_rows
from ..ops.nms import multiclass_nms, nearest_nms, nms, top_k
from ..ops.rotated_iou import d3_iou_matrix
from ..ops.voxelize import device_voxelize
from . import losses as loss_lib
from .middle import MIDDLE_REGISTRY
from .rpn import RPN, RPNHead
from .voxel_encoder import VFE_REGISTRY


@dataclasses.dataclass(frozen=True)
class DetectorSpec:
    """Static hyperparameters shared by loss and predict (from ModelConfig).
    The loss callables are set by `build_detector_spec`."""
    num_class: int = 1
    box_code_size: int = 7
    encode_background_as_zeros: bool = True
    encode_rad_error_by_sin: bool = True
    use_sigmoid_score: bool = True
    use_direction_classifier: bool = False
    direction_loss_weight: float = 0.2
    pos_cls_weight: float = 1.0
    neg_cls_weight: float = 1.0
    loss_norm_type: str = "NormByNumPositives"
    cls_loss_weight: float = 1.0
    loc_loss_weight: float = 1.0
    use_rotate_nms: bool = True
    use_multi_class_nms: bool = False
    nms_pre_max_size: int = 1000
    nms_post_max_size: int = 100
    nms_score_threshold: float = 0.3
    nms_iou_threshold: float = 0.01
    post_center_limit_range: Tuple[float, ...] = ()
    cls_loss_fn: Callable = None
    loc_loss_fn: Callable = None
    # the IoU-prediction branch
    use_iou_branch: bool = False
    use_iou_param_partaa: bool = False
    iou_loss_weight: float = 1.0
    iou_loss_fn: Callable = None


class IoUHead(nn.Module):
    """Per-anchor IoU prediction over the RPN trunk: 3x3 convs with ReLU,
    then a 1x1 conv to one logit an anchor (JAX `IoUHead`), fp32 whatever
    the trunk's dtype (flax promotes the bf16 trunk to the fp32 kernels).
    Returns [B, H*W*A, 1] in the heads' anchor order."""

    def __init__(self, in_channels, num_filters=(128, 128),
                 num_anchor_per_loc=2):
        super().__init__()
        convs, c = [], in_channels
        for f in num_filters:
            convs.append(nn.Conv2d(c, f, 3, padding=1))
            c = f
        self.convs = nn.ModuleList(convs)
        self.out = nn.Conv2d(c, num_anchor_per_loc, 1)

    def forward(self, trunk):
        x = at_least_fp32(trunk)
        for conv in self.convs:
            x = torch.relu(conv(x))
        return RPNHead._flatten(self.out(x), 1)


class VoxelNet(nn.Module):
    """VFE → middle → RPN (→ IoU head) over batched fixed-capacity voxel
    tensors."""

    def __init__(self, vfe_class_name, vfe_kwargs, middle_class_name,
                 middle_kwargs, rpn_kwargs, iou_kwargs=None):
        super().__init__()
        self.vfe = VFE_REGISTRY[vfe_class_name](**vfe_kwargs)
        self.middle = MIDDLE_REGISTRY[middle_class_name](**middle_kwargs)
        self.rpn = RPN(self.middle.out_channels, **rpn_kwargs)
        self.iou = None if iou_kwargs is None else IoUHead(
            sum(rpn_kwargs["num_upsample_filters"]), **iou_kwargs)

    def forward(self, voxels, num_points, coords, voxel_valid):
        """voxels [B, V, T, C], num_points [B, V], coords [B, V, 3] zyx,
        voxel_valid [B, V] → dict of box_preds [B, A, code], cls_preds
        [B, A, num_cls] (and dir_cls_preds; iou_preds [B, A, 1] with the
        IoU branch), the trunk map and the stage_overflow count (active
        sites cut by the stage capacities). In `train()` mode the norms use
        and update batch statistics."""
        vf = self.vfe(voxels, num_points, coords)
        vf = torch.where(voxel_valid[..., None], vf, 0.0)
        bev, overflow = self.middle(vf, coords, voxel_valid)
        out = self.rpn(bev)
        if self.iou is not None:
            out["iou_preds"] = self.iou(out["trunk"])
        out["stage_overflow"] = overflow
        return out


@torch.no_grad()
def _iou_targets(spec: DetectorSpec, box_preds, labels, anchors, gt_boxes,
                 gt_valid):
    """Per-anchor IoU targets [B, A], without grad: the 3-D IoU of each
    decoded prediction with its best valid gt box (`d3_iou_matrix`, the
    3-D rotated-IoU kernel on the card), Part-A² soft labels under
    `use_iou_param_partaa`, 0 where the anchor is not positive."""
    decoded = box_ops.second_box_decode(box_preds.detach(), anchors)
    iou = d3_iou_matrix(decoded, gt_boxes.to(decoded.dtype))   # [B, A, G]
    iou = torch.where(gt_valid[:, None, :], iou, 0.0).amax(-1)
    if spec.use_iou_param_partaa:
        soft = torch.clamp(iou * 2.0 - 0.5, 0.0, 1.0)
        iou = torch.where(iou > 0.75, 1.0, torch.where(iou < 0.25, 0.0,
                                                       soft))
    return torch.where(labels > 0, iou, 0.0)


def compute_loss(spec: DetectorSpec, preds_dict, labels, reg_targets,
                 anchors, gt_boxes=None, gt_valid=None):
    """Assemble the cls/loc(/dir/iou) losses (reference
    `voxelnet.py:310-369`, JAX `second_tpu/models/detector.py:126-201`).

    labels [B, A] integer, reg_targets [B, A, code], anchors [B, A, code];
    gt_boxes [B, G, 7] / gt_valid [B, G], the padded gt boxes, needed by
    the IoU branch and the Part-A² soft labels. Returns a dict of scalar
    tensors."""
    B = labels.shape[0]
    box_preds = preds_dict["box_preds"].reshape(B, -1, spec.box_code_size)
    nc = spec.num_class if spec.encode_background_as_zeros \
        else spec.num_class + 1
    cls_preds = preds_dict["cls_preds"].reshape(B, -1, nc)

    cls_weights, reg_weights, cared = loss_lib.prepare_loss_weights(
        labels, spec.pos_cls_weight, spec.neg_cls_weight, spec.loss_norm_type,
        box_preds.dtype)
    cls_targets = labels.long() * cared.long()
    one_hot = torch.nn.functional.one_hot(
        cls_targets, spec.num_class + 1).to(box_preds.dtype)
    if spec.encode_background_as_zeros:
        one_hot = one_hot[..., 1:]

    iou_t = None
    if (spec.use_iou_branch or spec.use_iou_param_partaa) and \
            gt_boxes is not None:
        iou_t = _iou_targets(spec, box_preds, labels, anchors, gt_boxes,
                             gt_valid)
        if spec.use_iou_param_partaa:
            one_hot = one_hot * iou_t[..., None].to(one_hot.dtype)

    bp, rt = box_preds, reg_targets
    if spec.encode_rad_error_by_sin:
        bp, rt = box_ops.add_sin_difference(box_preds, reg_targets)
    loc_losses = spec.loc_loss_fn(bp, rt, reg_weights)         # [B, A, code]
    cls_losses = spec.cls_loss_fn(cls_preds, one_hot, cls_weights)

    loc_loss_reduced = loc_losses.sum() / B * spec.loc_loss_weight
    cls_loss_reduced = cls_losses.sum() / B * spec.cls_loss_weight
    loss = loc_loss_reduced + cls_loss_reduced

    cls_anchorwise = cls_losses.sum(-1)
    cls_pos = (torch.where(labels > 0, cls_anchorwise, 0.0).sum() / B /
               spec.pos_cls_weight)
    cls_neg = (torch.where(labels == 0, cls_anchorwise, 0.0).sum() / B /
               spec.neg_cls_weight)
    out = {
        "loc_loss_reduced": loc_loss_reduced,
        "cls_loss_reduced": cls_loss_reduced,
        "cls_pos_loss": cls_pos,
        "cls_neg_loss": cls_neg,
        "num_pos": (labels > 0).sum(),
    }
    if spec.use_iou_branch and iou_t is not None and \
            "iou_preds" in preds_dict:
        iou_preds = preds_dict["iou_preds"].reshape(B, -1, 1)
        iou_losses = spec.iou_loss_fn(iou_preds, iou_t[..., None],
                                      reg_weights)
        iou_loss_reduced = iou_losses.sum() / B * spec.iou_loss_weight
        loss = loss + iou_loss_reduced
        out["iou_loss_reduced"] = iou_loss_reduced
    if spec.use_direction_classifier:
        dir_targets = box_ops.get_direction_target(anchors, reg_targets)
        dir_logits = preds_dict["dir_cls_preds"].reshape(B, -1, 2)
        weights = (labels > 0).to(box_preds.dtype)
        weights = weights / torch.clamp(weights.sum(-1, keepdim=True),
                                        min=1.0)
        dir_one_hot = torch.nn.functional.one_hot(dir_targets, 2).to(
            box_preds.dtype)
        dir_loss = loss_lib.weighted_softmax_loss(dir_logits, dir_one_hot,
                                                  weights)
        dir_loss = dir_loss.sum() / B
        loss = loss + dir_loss * spec.direction_loss_weight
        out["dir_loss_reduced"] = dir_loss
    out["loss"] = loss
    return out


def predict(spec: DetectorSpec, preds_dict, anchors, anchors_mask=None):
    """Decode + score + NMS for the whole batch, on the device of the
    predictions, as JAX's `vmap` over examples does: batched top-k and row
    gathers, and on the card no host sync (no Python loop over examples or
    classes).

    anchors [B, A, code] (array or tensor), anchors_mask [B, A] or None.
    Returns boxes [B, P, code], scores [B, P], labels [B, P], valid [B, P]
    with P = nms_post_max_size. With the IoU branch the predicted IoU ranks
    and thresholds the NMS candidates, and the reported scores stay the
    classification scores (single-class NMS, as in JAX)."""
    box_preds = preds_dict["box_preds"]
    dev = box_preds.device
    anchors = torch.as_tensor(anchors, dtype=torch.float32, device=dev)
    B, A = anchors.shape[:2]
    box_preds = box_preds.reshape(B, A, spec.box_code_size)
    nc = spec.num_class if spec.encode_background_as_zeros \
        else spec.num_class + 1
    cls_preds = preds_dict["cls_preds"].reshape(B, A, nc)
    if spec.encode_background_as_zeros:
        scores_all = torch.sigmoid(cls_preds)
    elif spec.use_sigmoid_score:
        scores_all = torch.sigmoid(cls_preds)[..., 1:]
    else:
        scores_all = torch.softmax(cls_preds, dim=-1)[..., 1:]
    valid = torch.ones((B, A), dtype=torch.bool, device=dev) \
        if anchors_mask is None else torch.as_tensor(anchors_mask, device=dev)

    if spec.use_multi_class_nms:
        sel_boxes, sel_idx, sel_lab, sel_keep, scores = _multiclass_select(
            spec, box_preds, anchors, scores_all, valid)
    else:
        sel_boxes, sel_idx, sel_lab, sel_keep, scores = _single_select(
            spec, preds_dict, box_preds, anchors, scores_all, valid)
    if spec.use_direction_classifier:
        dir_labels = preds_dict["dir_cls_preds"].reshape(B, A, 2).argmax(-1)
        opp = (sel_boxes[..., -1] > 0) != (dir_labels.gather(1, sel_idx) > 0)
        yaw = sel_boxes[..., -1] + torch.where(opp, math.pi, 0.0)
        sel_boxes = torch.cat([sel_boxes[..., :-1], yaw[..., None]], -1)
    lim = spec.post_center_limit_range
    if lim:
        # compared with Python floats: a tensor of them would copy to the card
        for d in range(3):
            sel_keep = sel_keep & (sel_boxes[..., d] >= lim[d]) & \
                (sel_boxes[..., d] <= lim[3 + d])
    return {"boxes": sel_boxes, "scores": scores, "labels": sel_lab,
            "valid": sel_keep}


def _decoded_rows(box_preds, anchors, idx):
    """The decoded boxes of the anchors idx [B, k] (decoding is per
    anchor, so this equals decoding all and gathering)."""
    return box_ops.second_box_decode(flat_rows(box_preds, idx),
                                     flat_rows(anchors, idx))


def _single_select(spec, preds_dict, box_preds, anchors, scores_all, valid):
    """Single-class NMS over each example's best class score (or the
    predicted IoU with the IoU branch). Returns the selected boxes, anchor
    indices, labels, keep mask and scores, each [B, P]."""
    B, A = valid.shape
    if scores_all.shape[-1] == 1:
        top_scores = scores_all[..., 0]
        top_labels = torch.zeros((B, A), dtype=torch.int64,
                                 device=valid.device)
    else:
        top_scores, top_labels = scores_all.max(-1)
    nms_scores = top_scores
    if spec.use_iou_branch and "iou_preds" in preds_dict:
        nms_scores = torch.sigmoid(preds_dict["iou_preds"].reshape(B, A))
    ok = valid & (nms_scores >= spec.nms_score_threshold)
    masked = torch.where(ok, nms_scores, float("-inf"))
    k = min(spec.nms_pre_max_size, A)
    # prefilter first, decode only the k candidates
    cand_scores, cand_idx = top_k(masked, k)                     # [B, k]
    cand_valid = torch.isfinite(cand_scores)
    cand_boxes = _decoded_rows(box_preds, anchors, cand_idx)
    nms_fn = nms if spec.use_rotate_nms else nearest_nms
    rel_idx, sel_keep = nms_fn(
        box_ops.bev_boxes(cand_boxes),
        torch.where(cand_valid, cand_scores, 0.0), cand_valid,
        pre_max_size=k, post_max_size=spec.nms_post_max_size,
        iou_threshold=spec.nms_iou_threshold)                    # [B, P]
    sel_idx = cand_idx.gather(1, rel_idx)
    # scores follow the NMS keep mask, before the center-range cut
    scores = torch.where(sel_keep, top_scores.gather(1, sel_idx), 0.0)
    return (flat_rows(cand_boxes, rel_idx), sel_idx,
            top_labels.gather(1, sel_idx), sel_keep, scores)


def _multiclass_select(spec, box_preds, anchors, scores_all, valid):
    """Per-class NMS (every class of every example in one batch of the NMS
    kernels, the candidates decoded only), then each example's global top P
    of the kept detections by score, ties lowest class-major position
    first (JAX's multi-class branch). Returns the selected boxes, anchor
    indices, labels, keep mask and scores, each [B, P]."""
    B, A = valid.shape
    P = spec.nms_post_max_size
    idx, keep, cls_scores = multiclass_nms(
        lambda rows: box_ops.bev_boxes(_decoded_rows(box_preds, anchors,
                                                     rows)),
        scores_all, valid, num_classes=spec.num_class,
        pre_max_size=spec.nms_pre_max_size, post_max_size=P,
        iou_threshold=spec.nms_iou_threshold,
        score_threshold=spec.nms_score_threshold)                # [B, C, P']
    keep_scores = torch.where(keep, cls_scores, float("-inf")).reshape(B, -1)
    top_sc, sel = top_k(keep_scores, P)                          # [B, P]
    sel_idx = idx.reshape(B, -1).gather(1, sel)
    sel_keep = torch.isfinite(top_sc)
    return (_decoded_rows(box_preds, anchors, sel_idx), sel_idx,
            torch.div(sel, idx.shape[-1], rounding_mode="floor"), sel_keep,
            torch.where(sel_keep, top_sc, 0.0))


@torch.no_grad()
def detect(net, spec, vspec, points, points_mask, anchors, device="cuda",
           mask_info=None, anchors_mask=None):
    """The eval forward: voxelize → VFE → middle → RPN → predict.

    points [B, P, C] and points_mask [B, P] (arrays or tensors) are moved to
    `device`, the CUDA card unless the caller asks for the CPU; `net` must
    already live there. `anchors_mask` [B, A], or else `mask_info =
    (sat_corners [A, 4], grid_hw, threshold)`, which computes the occupancy
    anchors mask from the voxelizer's coords on the device
    (`ops/anchors_mask.py`), as JAX's eval step does. Returns (detections,
    voxelizer output, preds)."""
    vox = device_voxelize(vspec, points, points_mask, device)
    preds = net(vox["voxels"], vox["num_points"], vox["coordinates"],
                vox["voxel_valid"])
    if anchors_mask is None and mask_info is not None:
        corners, grid_hw, threshold = mask_info
        anchors_mask = anchors_mask_from_coords(
            vox["coordinates"], vox["voxel_valid"], corners, grid_hw,
            threshold)
    return predict(spec, preds, anchors, anchors_mask), vox, preds


def build_detector_spec(model_cfg) -> DetectorSpec:
    """ModelConfig → DetectorSpec (static loss and predict parameters)."""
    num_class = max(1, len(model_cfg.target_assigner.anchor_generators))
    code_size = 8 if model_cfg.box_coder.encode_angle_vector else 7
    if model_cfg.box_coder.kind == "bev_box_coder":
        code_size -= 2
    if model_cfg.use_multi_class_nms and not model_cfg.use_rotate_nms:
        raise NotImplementedError(
            "use_multi_class_nms with use_rotate_nms: false: multi-class NMS "
            "is rotated only (the JAX package's fails on the 5-wide boxes)")
    return DetectorSpec(
        num_class=num_class,
        box_code_size=code_size,
        encode_background_as_zeros=model_cfg.encode_background_as_zeros,
        encode_rad_error_by_sin=model_cfg.encode_rad_error_by_sin,
        use_sigmoid_score=model_cfg.use_sigmoid_score,
        use_direction_classifier=model_cfg.use_direction_classifier,
        direction_loss_weight=model_cfg.direction_loss_weight,
        pos_cls_weight=model_cfg.pos_class_weight,
        neg_cls_weight=model_cfg.neg_class_weight,
        loss_norm_type=model_cfg.loss_norm_type,
        cls_loss_weight=model_cfg.loss.classification_weight,
        loc_loss_weight=model_cfg.loss.localization_weight,
        use_rotate_nms=model_cfg.use_rotate_nms,
        use_multi_class_nms=model_cfg.use_multi_class_nms,
        nms_pre_max_size=model_cfg.nms_pre_max_size,
        nms_post_max_size=model_cfg.nms_post_max_size,
        nms_score_threshold=model_cfg.nms_score_threshold,
        nms_iou_threshold=model_cfg.nms_iou_threshold,
        post_center_limit_range=tuple(model_cfg.post_center_limit_range),
        cls_loss_fn=loss_lib.build_classification_loss(
            model_cfg.loss.classification_loss),
        loc_loss_fn=loss_lib.build_localization_loss(
            model_cfg.loss.localization_loss),
        use_iou_branch=model_cfg.use_iou_branch,
        use_iou_param_partaa=model_cfg.target_assigner.use_iou_param_partaa,
        iou_loss_weight=model_cfg.loss.iou_loss_weight,
        iou_loss_fn=loss_lib.build_classification_loss(
            model_cfg.loss.iou_loss),
    )
