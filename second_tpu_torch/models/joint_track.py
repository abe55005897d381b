"""Joint temporal-detector + tracker training graph — the port of
`second_tpu/models/joint_track.py` (`select_detections`,
`gather_box_points`, `match_dets_to_gt`, `JointDetTrack`,
`compute_joint_loss`, `build_joint_det_track`).

Equivalent of the reference's joint fine-tune loop (`train_2st_spatio.py:
201-476`): the spatio detector and the mmMOT tracking heads train together,
tracking losses flowing back into the detector. One forward runs the
temporal detector over a T-frame window (frames folded into the batch axis,
prev = frame t−1, frame 0 paired with itself), picks the top-D second-stage
detections per frame on the card, and scores det/link/new/end logits with
the tracking heads (`models/tracking.py`); no host round-trips.

The tracker's appearance input is a differentiable rotated-ROI crop of the
detector's gated BEV map at the predicted boxes (`crop_rois`: the ROI-align
kernels, their backward giving the boxes' gradient too), and the point sets
are gathered relative to those boxes, so tracking-loss gradients reach the
second stage and the backbone. det↔gt matching for the tracking labels is
the rotated BEV IoU (the `riou_matrix` kernel, one launch for the whole
window) and an argmax, without gradient.

Static shapes throughout: T frames × D detections × P′ points per det. The
top-k selections are stable descending sorts, so equal scores keep
`lax.top_k`'s order, the lowest index first (every invalid proposal scores
-1.0; points outside a box score -inf).
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from ..ops import box_ops
from ..ops.rotated_iou import rotated_iou_matrix
from .detector_two_stage import RoiSpec, compute_two_stage_loss
from .second_stage import ProposalSpec, crop_rois, take
from .temporal import _FRAME_KEYS, TemporalVoxelNet
from .tracking import _Embed
from .tracking_train import generate_gt, tracking_loss


def _top(values, k):
    """The k largest entries of the last axis and their indices, equal
    values in index order (`lax.top_k`'s tie rule)."""
    top, idx = torch.sort(values, dim=-1, descending=True, stable=True)
    return top[..., :k], idx[..., :k]


def select_detections(spec, preds, anchors, num_dets: int):
    """Top-D second-stage detections per frame.

    Returns boxes [T, D, 7] (decoded lidar frame), scores [T, D] sigmoid
    clipped to [0, 1], valid [T, D]. The proposal set is already
    NMS-deduplicated, so a plain score top-k suffices (the reference
    thresholds + solver-drops later). The boxes keep their gradient into
    the second stage's box predictions."""
    proposals = preds["proposals"]
    boxes = box_ops.second_box_decode(preds["second_box_preds"],
                                      take(anchors, proposals["indices"]))
    scores = torch.sigmoid(preds["second_cls_preds"]).amax(-1)
    scores = torch.where(proposals["valid"], scores, -1.0)
    top_scores, top_idx = _top(scores, num_dets)
    return (take(boxes, top_idx), torch.clamp(top_scores, 0.0, 1.0),
            top_scores > 0.0)


def gather_box_points(points, points_mask, boxes, num_out: int):
    """Per-detection point sets (the reference's `det_info['points']`
    PointNet input, gathered on the host there).

    points [..., P, C≥3], points_mask [..., P], boxes [..., D, 7] lidar
    frame (any leading axes, shared). Returns pts [..., D, num_out, 3]
    (box-centered xyz) and mask [..., D, num_out]. Selection: points inside
    the (slightly inflated) box footprint, nearest-to-center first."""
    xyz = points[..., None, :, :3]                       # [..., 1, P, 3]
    box = boxes[..., :, None, :]                         # [..., D, 1, 7]
    rel_x, rel_y = xyz[..., 0] - box[..., 0], xyz[..., 1] - box[..., 1]
    c, s = torch.cos(-box[..., 6]), torch.sin(-box[..., 6])
    lx = rel_x * c - rel_y * s
    ly = rel_x * s + rel_y * c
    lz = xyz[..., 2] - box[..., 2]
    inside = ((torch.abs(lx) < box[..., 3] * 0.6) &
              (torch.abs(ly) < box[..., 4] * 0.6) &
              (lz > -0.5) & (lz < box[..., 5] + 0.5) &
              points_mask[..., None, :])
    d2 = lx * lx + ly * ly + lz * lz
    top, idx = _top(torch.where(inside, -d2, float("-inf")), num_out)
    sel = torch.stack([torch.gather(lx, -1, idx), torch.gather(ly, -1, idx),
                       torch.gather(lz, -1, idx) - box[..., 5] * 0.5], -1)
    m = torch.isfinite(top)
    return torch.where(m[..., None], sel, 0.0), m


def match_dets_to_gt(det_boxes, det_valid, gt_boxes, gt_ids, gt_valid,
                     iou_threshold: float = 0.5):
    """det↔gt matching → tracking labels (the reference's
    `generate_det_id_matrix_3d`, spatio `:1767-1815`: motmetrics BEV-IoU
    distance, matched dets labeled positive and stamped with the gt track
    id).

    det_boxes [T, D, 7], gt_boxes [T, G, 7], gt_ids [T, G] (or one frame
    without the T axis). Returns det_cls [T, D] (1 pos / 0 neg) and det_id
    [T, D] (gt track id or −1). The IoU of every frame's dets with every
    frame's gt is one rotated-IoU matrix [T·D, T·G] (one kernel launch on
    the card), of which the T diagonal blocks are kept."""
    if det_boxes.dim() == 2:
        cls, ids = match_dets_to_gt(det_boxes[None], det_valid[None],
                                    gt_boxes[None], gt_ids[None],
                                    gt_valid[None], iou_threshold)
        return cls[0], ids[0]
    T, D = det_boxes.shape[:2]
    G = gt_boxes.shape[1]
    iou = rotated_iou_matrix(box_ops.bev_boxes(det_boxes).reshape(T * D, 5),
                             box_ops.bev_boxes(gt_boxes).reshape(T * G, 5))
    iou = iou.view(T, D, T, G).diagonal(dim1=0, dim2=2).movedim(-1, 0)
    iou = torch.where(gt_valid[:, None, :], iou, 0.0)      # [T, D, G]
    best_iou, best = iou.max(-1)
    matched = (best_iou > iou_threshold) & det_valid
    det_id = torch.where(matched, torch.gather(gt_ids, -1, best), -1)
    return matched.to(torch.int32), det_id


class JointDetTrack(_Embed):
    """Temporal two-stage detector + tracking heads in one module.

    The detector submodule is named ``detector`` so a checkpoint trained by
    ``train.run --model_type temporal`` grafts directly into it. The
    tracking heads (``appearance``, ``point_net``, ``fusion``, ``w_det``,
    ``w_link``) are `SequenceTrackNet`'s, the appearance net taking the
    gated map's channels."""

    def __init__(self, detector_args, spec, pspec: ProposalSpec,
                 roi: RoiSpec, feature_dim: int = 128, num_dets: int = 16,
                 points_per_det: int = 128, track_crop_size: int = 16):
        detector = TemporalVoxelNet(*detector_args, spec=spec, pspec=pspec,
                                    roi=roi)
        super().__init__(feature_dim, detector.middle.out_channels)
        self.detector = detector
        self.spec, self.roi = spec, roi
        self.num_dets = num_dets
        self.points_per_det = points_per_det
        self.track_crop_size = track_crop_size

    def forward(self, frames, anchors, anchors_mask=None):
        """frames: dict of the window's voxelized [T, ...] tensors
        (voxels, num_points, coordinates, voxel_valid) plus the raw clouds
        points [T, P, C] and points_mask [T, P]; anchors [T, A, 7]. Returns
        the detector's outputs plus det_boxes / det_scores / det_valid [T,
        D], track_feats [T, D, F], det_logits [T, D], link_logits [T-1, D,
        D], end_logits and new_logits [T-1, D]."""
        cur = {k: frames[k] for k in _FRAME_KEYS}
        # prev frame of the window: shift by one, frame 0 pairs with itself
        prev = {k: torch.cat([v[:1], v[:-1]], 0) for k, v in cur.items()}
        preds = self.detector(cur, prev, anchors, anchors_mask)
        return self.track(preds, frames, anchors)

    def track(self, preds, frames, anchors):
        """The tracking half on the detector's outputs `preds`: the top-D
        detections, their crops and point sets, the heads' logits, added
        to `preds`."""
        det_boxes, det_scores, det_valid = select_detections(
            self.spec, preds, anchors, self.num_dets)
        r = self.roi
        crops = crop_rois(preds["gated_bev_feat"], det_boxes, r.pc_range,
                          r.voxel_size, r.out_stride, self.track_crop_size,
                          r.samples)                      # [T * D, C, S, S]
        pts, pmask = gather_box_points(frames["points"],
                                       frames["points_mask"], det_boxes,
                                       self.points_per_det)
        T, D = det_boxes.shape[:2]
        P = self.points_per_det
        feats = self.fusion(
            self.appearance(crops.permute(0, 2, 3, 1)),
            self.point_net(pts.reshape(T * D, P, 3),
                           pmask.reshape(T * D, P))).reshape(
                               T, D, self.feature_dim)
        link, end, new = self.w_link(feats[:-1], feats[1:])
        preds.update({
            "det_boxes": det_boxes, "det_scores": det_scores,
            "det_valid": det_valid, "track_feats": feats,
            "det_logits": self.w_det(feats), "link_logits": link,
            "end_logits": end, "new_logits": new,
        })
        return preds


def compute_joint_loss(spec, preds, batch, tracking_weight: float = 1.0,
                       iou_threshold: float = 0.5):
    """Detection (stage1+stage2)/2 loss + tracking det/link loss.

    batch: labels / reg_targets / anchors [T, ...] detection targets for
    the window's frames plus gt_boxes_padded [T, G, 7], gt_ids [T, G],
    gt_valid [T, G]."""
    det_losses = compute_two_stage_loss(
        spec, preds, batch["labels"], batch["reg_targets"], batch["anchors"],
        batch.get("gt_boxes_padded"), batch.get("gt_valid"))
    with torch.no_grad():
        det_cls, det_id = match_dets_to_gt(
            preds["det_boxes"].detach(), preds["det_valid"],
            batch["gt_boxes_padded"], batch["gt_ids"], batch["gt_valid"],
            iou_threshold)
    gt = generate_gt(det_cls, det_id, preds["det_valid"])
    tr = tracking_loss(preds["link_logits"], preds["end_logits"],
                       preds["new_logits"], preds["det_logits"], gt,
                       det_cls, preds["det_valid"])
    return {
        **det_losses,
        "tracking_loss": tr["loss"],
        "tracking_det_loss": tr["det_loss"],
        "tracking_link_loss": tr["link_loss"],
        "detection_loss": det_losses["loss"],
        "loss": det_losses["loss"] + tracking_weight * tr["loss"],
    }


def build_joint_det_track(cfg, num_dets: int = 16, feature_dim: int = 128,
                          num_proposals: int = 256, device="cuda",
                          seed: int = 0):
    """ModelConfig → (JointDetTrack, spec, info, assigner, coder) for joint
    detector+tracker fine-tuning: the temporal detector of
    `build_temporal_voxelnet` with `num_proposals` proposals an example,
    the tracking heads on its gated map. The module is in eval mode on
    `device` (the CUDA card unless the caller asks for the CPU), with
    weights drawn by `init_weights_` from `seed`, and computes in fp32
    whatever the config's `enable_mixed_precision`, as JAX's
    `build_joint_det_track` does."""
    from .build import init_weights_, voxelnet_args
    from .detector import build_detector_spec
    dev = resolve_device(device)
    args, info, assigner, coder = voxelnet_args(cfg)
    vg = cfg.voxel_generator
    roi = RoiSpec(pc_range=tuple(vg.point_cloud_range),
                  voxel_size=tuple(vg.voxel_size),
                  out_stride=info.out_size_factor)
    spec = build_detector_spec(cfg)
    module = JointDetTrack(args[:5], spec,
                           ProposalSpec(num_proposals=num_proposals), roi,
                           feature_dim=feature_dim, num_dets=num_dets)
    init_weights_(module, seed)
    return module.to(dev).eval(), spec, info, assigner, coder


__all__ = ["select_detections", "gather_box_points", "match_dets_to_gt",
           "JointDetTrack", "compute_joint_loss", "build_joint_det_track"]
