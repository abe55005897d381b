"""Tracking training: gt association matrices, losses, det↔gt matching —
the port of `second_tpu/models/tracking_train.py` (`generate_gt`, `_bce`,
`tracking_loss`, `match_dets_to_gt`, `nms_vid`).

A sequence is padded to [T, D] detections with a validity mask; the
association matrices come from vectorised id equality. The link loss is a
masked softmax cross-entropy over an augmented row [link_logits[j, :],
end_logit[j]] (and column [link_logits[:, k], new_logit[k]]), the
structure the assignment solver (`utils/assignment.solve_frame_pair`)
consumes. `match_dets_to_gt` is host numpy, copied as it is; `nms_vid`
runs the port's rotated NMS (`ops/nms.py`: the overlap and suppression
kernels on the card).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch.nn import functional as F

from ..core import box_np


def generate_gt(det_cls, det_id, det_valid):
    """Vectorized equivalent of the reference's ``generate_gt``.

    Args:
      det_cls: [T, D] int — 1 positive (matched to a tracked gt), 0
        negative, -1 ignore (matched to DontCare).
      det_id: [T, D] int — gt track id per detection, -1 if unmatched.
      det_valid: [T, D] bool — padding mask.

    Returns dict with gt_det [T, D], gt_new [T, D], gt_end [T, D] (f32 0/1)
    and gt_link [T-1, D, D] (f32 0/1): link[t, j, k] = det j of frame t and
    det k of frame t+1 share a (non-negative) gt track id.
    """
    det_cls = torch.as_tensor(det_cls)
    det_id = torch.as_tensor(det_id)
    det_valid = torch.as_tensor(det_valid)
    pos = (det_cls == 1) & det_valid & (det_id >= 0)

    # id-equality between consecutive frames, both endpoints positive
    same = det_id[:-1, :, None] == det_id[1:, None, :]          # [T-1, D, D]
    gt_link = same & pos[:-1, :, None] & pos[1:, None, :]

    has_next = gt_link.any(2)                                    # [T-1, D]
    has_prev = gt_link.any(1)                                    # [T-1, D]
    # end: positive det with no successor (last frame always ends)
    gt_end = pos & torch.cat([~has_next, torch.ones_like(pos[-1:])], 0)
    # new: positive det with no predecessor (first frame always new)
    gt_new = pos & torch.cat([torch.ones_like(pos[:1]), ~has_prev], 0)
    return {"gt_det": pos.float(), "gt_link": gt_link.float(),
            "gt_new": gt_new.float(), "gt_end": gt_end.float()}


def _bce(logits, targets, weights):
    loss = -(targets * F.logsigmoid(logits) +
             (1.0 - targets) * F.logsigmoid(-logits))
    return (loss * weights).sum() / torch.clamp(weights.sum(), min=1.0)


def tracking_loss(link_logits, end_logits, new_logits, det_logits,
                  gt, det_cls, det_valid) -> Dict[str, torch.Tensor]:
    """det/link/new/end losses for one sequence.

    Args:
      link_logits: [T-1, D, D] affinity logits between consecutive frames.
      end_logits:  [T-1, D] frame-t det terminates (vs links forward).
      new_logits:  [T-1, D] frame-t+1 det starts a track (vs links back).
      det_logits:  [T, D] detection confidence logits.
      gt: output of :func:`generate_gt`.
      det_cls / det_valid: [T, D] as in :func:`generate_gt`.

    The row loss trains, for every positive frame-t det, a softmax over
    [its D link slots to frame t+1, its end slot]; the column loss trains,
    for every positive frame-t+1 det, a softmax over [D link slots back,
    its new slot]. The det loss is a masked sigmoid BCE (ignore cls −1).
    """
    det_cls = torch.as_tensor(det_cls, device=det_logits.device)
    det_valid = torch.as_tensor(det_valid, device=det_logits.device)
    neg_inf = -1e9
    dtype = det_logits.dtype

    det_w = (det_valid & (det_cls >= 0)).to(dtype)
    det_loss = _bce(det_logits, gt["gt_det"], det_w)

    pos = gt["gt_det"] > 0                                        # [T, D]
    valid_next = det_valid[1:]                                    # [T-1, D]
    valid_prev = det_valid[:-1]

    # --- rows: prev det j → softmax over [links to t+1, end] -------------
    row_logits = torch.cat(
        [torch.where(valid_next[:, None, :], link_logits, neg_inf),
         end_logits[..., None]], -1)                               # [T-1,D,D+1]
    row_tgt = torch.cat([gt["gt_link"], gt["gt_end"][:-1][..., None]], -1)
    row_w = pos[:-1].to(dtype)
    row_ce = -(row_tgt * F.log_softmax(row_logits, -1)).sum(-1)
    link_row_loss = (row_ce * row_w).sum() / torch.clamp(row_w.sum(),
                                                         min=1.0)

    # --- cols: cur det k → softmax over [links from t, new] --------------
    col_logits = torch.cat(
        [torch.where(valid_prev[:, :, None], link_logits, neg_inf),
         new_logits[:, None, :]], 1)                               # [T-1,D+1,D]
    col_tgt = torch.cat([gt["gt_link"], gt["gt_new"][1:][:, None, :]], 1)
    col_w = pos[1:].to(dtype)
    col_ce = -(col_tgt * F.log_softmax(col_logits, 1)).sum(1)
    link_col_loss = (col_ce * col_w).sum() / torch.clamp(col_w.sum(),
                                                         min=1.0)

    link_loss = 0.5 * (link_row_loss + link_col_loss)
    return {"loss": det_loss + link_loss, "det_loss": det_loss,
            "link_loss": link_loss, "link_row_loss": link_row_loss,
            "link_col_loss": link_col_loss}


def match_dets_to_gt(det_bboxes, gt_bboxes, gt_ids, gt_names,
                     tracked_class: str = "Car",
                     iou_threshold: float = 0.5):
    """Host-side det↔gt matching (reference ``generate_det_id_matrix[_3d]``
    `:1765-1870`): axis-aligned IoU between detection and gt 2D boxes; the
    closest det per gt inherits the gt's track id and class label.

    Args:
      det_bboxes: [D, 4] det boxes (x1, y1, x2, y2) — image bboxes for the
        2D variant, BEV min/max boxes for the 3D variant (the reference's
        `_3d` takes columns [0,1,3,4] of the BEV box, same thing).
      gt_bboxes: [G, 4]; gt_ids: [G] int; gt_names: [G] str.

    Returns (det_id [D] int64, det_cls [D] int8) with det_cls ∈
    {1 tracked-class match, 0 unmatched, -1 DontCare match}.
    """
    det_bboxes = np.asarray(det_bboxes, np.float64).reshape(-1, 4)
    gt_bboxes = np.asarray(gt_bboxes, np.float64).reshape(-1, 4)
    D, G = len(det_bboxes), len(gt_bboxes)
    det_id = -np.ones(D, np.int64)
    det_cls = np.zeros(D, np.int8)
    if D == 0 or G == 0:
        return det_id, det_cls
    iou = box_np.iou_matrix(gt_bboxes, det_bboxes)        # [G, D]
    for g in np.argsort(-iou.max(axis=1)):                # best-first per gt
        d = int(np.argmax(iou[g]))
        if iou[g, d] < iou_threshold:
            continue
        det_id[d] = int(gt_ids[g])
        name = str(gt_names[g])
        det_cls[d] = 1 if name == tracked_class else (
            -1 if name == "DontCare" else 0)
        iou[:, d] = -1.0                                  # det consumed
    return det_id, det_cls


def nms_vid(box_preds, cls_preds, valid, *, score_threshold: float = 0.2,
            pre_max_size: int = 1024, post_max_size: int = 128,
            iou_threshold: float = 0.1):
    """Per-frame rotated NMS for the tracking pipeline (reference
    ``nms_vid`` `:1872-1910`: sigmoid scores, 0.2 floor, rotated NMS on
    [x, y, w, l, yaw]). Fixed-size: returns (boxes [post, 7], scores
    [post], keep_mask [post]); box_preds [N, 7], cls_preds [N] or [N, 1],
    valid [N] tensors on one device."""
    from ..ops import nms as nms_ops

    scores = torch.sigmoid(cls_preds.reshape(-1))
    valid = torch.as_tensor(valid, device=scores.device).reshape(-1) & \
        (scores >= score_threshold)
    boxes_bev = box_preds[:, [0, 1, 3, 4, 6]]
    sel_idx, sel_valid = nms_ops.nms(
        boxes_bev, scores, valid, pre_max_size=pre_max_size,
        post_max_size=post_max_size, iou_threshold=iou_threshold)
    return box_preds[sel_idx], scores[sel_idx], sel_valid
