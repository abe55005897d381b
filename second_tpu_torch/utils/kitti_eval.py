"""Official KITTI AP evaluation (host-side numpy).

Equivalent of the reference's `second/utils/eval.py`: 41-recall-point AP over
bbox / bev / 3d / aos metrics at easy/moderate/hard difficulty, with the
official ignore rules (occlusion/truncation/height), DontCare handling,
neighboring-class equivalences (Van↔Car, Person_sitting↔Pedestrian), adaptive
score-threshold resampling, and the COCO-style overlap-range variant
(reference `get_official_eval_result :791-852`, `get_coco_eval_result :853+`,
`compute_statistics_jit :164-283`, `get_thresholds :17-36`,
`clean_data :39-92`). Pure numpy — the sequential gt→det greedy matching keeps
the reference's exact tie-breaking by vectorizing only the inner det scan.

Annotations are dicts in KITTI camera-frame convention:
    name, truncated, occluded, alpha, bbox [N,4], dimensions [N,3 lhw],
    location [N,3], rotation_y [N], score [N].
"""

from __future__ import annotations

import io
from typing import Dict, List, Sequence

import numpy as np

from ..core.box_np import iou_matrix
from ..core.rotated_iou_np import d3_box_overlap, rotated_iou

CLASS_NAMES = ["Car", "Pedestrian", "Cyclist", "Van", "Person_sitting"]
MIN_HEIGHT = [40, 25, 25]
MAX_OCCLUSION = [0, 1, 2]
MAX_TRUNCATION = [0.15, 0.3, 0.5]
N_SAMPLE_PTS = 41
_NO_DET = -1


def image_box_overlap(boxes, query_boxes, criterion=-1):
    """2D bbox overlap [N, K]; criterion -1 union / 0 area1 / 1 area2."""
    if criterion == -1:
        return iou_matrix(boxes, query_boxes)
    boxes = np.asarray(boxes)
    query_boxes = np.asarray(query_boxes)
    lt = np.maximum(boxes[:, None, :2], query_boxes[None, :, :2])
    rb = np.minimum(boxes[:, None, 2:], query_boxes[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    if criterion == 0:
        area = ((boxes[:, 2] - boxes[:, 0]) *
                (boxes[:, 3] - boxes[:, 1]))[:, None]
    else:
        area = ((query_boxes[:, 2] - query_boxes[:, 0]) *
                (query_boxes[:, 3] - query_boxes[:, 1]))[None, :]
    return np.where(inter > 0, inter / np.maximum(area, 1e-12), 0.0)


def bev_box_overlap(boxes, qboxes, criterion=-1):
    """Camera-frame BEV ([x, z, l, w, ry]) rotated overlap."""
    return rotated_iou(boxes, qboxes, criterion)


def get_thresholds(scores, num_gt, num_sample_pts=N_SAMPLE_PTS):
    """Resample matched-det scores to ~41 evenly spaced recall thresholds."""
    scores = np.sort(scores)[::-1]
    current_recall = 0.0
    thresholds = []
    for i, score in enumerate(scores):
        l_recall = (i + 1) / num_gt
        r_recall = (i + 2) / num_gt if i < len(scores) - 1 else l_recall
        if ((r_recall - current_recall) < (current_recall - l_recall)
                and i < len(scores) - 1):
            continue
        thresholds.append(score)
        current_recall += 1 / (num_sample_pts - 1.0)
    return thresholds


def clean_data(gt_anno, dt_anno, current_class, difficulty):
    """Ignore flags per KITTI rules. Returns (num_valid_gt, ignored_gt,
    ignored_dt, dontcare_bboxes)."""
    cls_name = CLASS_NAMES[current_class].lower()
    ignored_gt, ignored_dt, dc_bboxes = [], [], []
    num_valid_gt = 0
    for i in range(len(gt_anno["name"])):
        name = gt_anno["name"][i].lower()
        height = gt_anno["bbox"][i, 3] - gt_anno["bbox"][i, 1]
        if name == cls_name:
            valid_class = 1
        elif cls_name == "pedestrian" and name == "person_sitting":
            valid_class = 0
        elif cls_name == "car" and name == "van":
            valid_class = 0
        else:
            valid_class = -1
        ignore = (gt_anno["occluded"][i] > MAX_OCCLUSION[difficulty]
                  or gt_anno["truncated"][i] > MAX_TRUNCATION[difficulty]
                  or height <= MIN_HEIGHT[difficulty])
        if valid_class == 1 and not ignore:
            ignored_gt.append(0)
            num_valid_gt += 1
        elif valid_class == 0 or (ignore and valid_class == 1):
            ignored_gt.append(1)
        else:
            ignored_gt.append(-1)
        if gt_anno["name"][i] == "DontCare":
            dc_bboxes.append(gt_anno["bbox"][i])
    for i in range(len(dt_anno["name"])):
        valid_class = 1 if dt_anno["name"][i].lower() == cls_name else -1
        height = abs(dt_anno["bbox"][i, 3] - dt_anno["bbox"][i, 1])
        if height < MIN_HEIGHT[difficulty]:
            ignored_dt.append(1)
        elif valid_class == 1:
            ignored_dt.append(0)
        else:
            ignored_dt.append(-1)
    dc = (np.stack(dc_bboxes, 0).astype(np.float64) if dc_bboxes
          else np.zeros((0, 4), np.float64))
    return num_valid_gt, np.array(ignored_gt), np.array(ignored_dt), dc


def compute_statistics(overlaps, gt_data, dt_data, ignored_gt, ignored_det,
                       dc_bboxes, metric, min_overlap, thresh=0.0,
                       compute_fp=False, compute_aos=False):
    """Greedy gt→det matching (reference compute_statistics_jit semantics).

    overlaps: [num_det, num_gt]. gt_data: [G, 5(bbox, alpha)];
    dt_data: [D, 6(bbox, alpha, score)].
    Returns (tp, fp, fn, similarity, matched_scores).
    """
    det_size = dt_data.shape[0]
    dt_scores = dt_data[:, 5]
    assigned = np.zeros(det_size, bool)
    ignored_threshold = (dt_scores < thresh) if compute_fp \
        else np.zeros(det_size, bool)
    tp = fp = fn = 0
    thresholds, delta = [], []
    for i in range(gt_data.shape[0]):
        if ignored_gt[i] == -1:
            continue
        ov = overlaps[:, i]
        usable = (ignored_det != -1) & ~assigned & ~ignored_threshold & \
            (ov > min_overlap)
        det_idx = _NO_DET
        assigned_ignored_det = False
        if not compute_fp:
            # best score among usable dets
            if usable.any():
                scores = np.where(usable, dt_scores, -np.inf)
                det_idx = int(np.argmax(scores))
        else:
            cand0 = usable & (ignored_det == 0)
            if cand0.any():
                det_idx = int(np.argmax(np.where(cand0, ov, -np.inf)))
            else:
                cand1 = usable & (ignored_det == 1)
                if cand1.any():
                    det_idx = int(np.argmax(cand1))  # first such det
                    assigned_ignored_det = True
        if det_idx == _NO_DET and ignored_gt[i] == 0:
            fn += 1
        elif det_idx != _NO_DET and (ignored_gt[i] == 1
                                     or ignored_det[det_idx] == 1):
            assigned[det_idx] = True
        elif det_idx != _NO_DET:
            tp += 1
            thresholds.append(dt_scores[det_idx])
            if compute_aos:
                delta.append(gt_data[i, 4] - dt_data[det_idx, 4])
            assigned[det_idx] = True
    similarity = 0.0
    if compute_fp:
        fp_mask = (~assigned & (ignored_det == 0) & ~ignored_threshold)
        fp = int(fp_mask.sum())
        if metric == 0 and len(dc_bboxes) > 0:
            # stuff detections matching DontCare regions are not FPs
            ov_dc = image_box_overlap(dt_data[:, :4], dc_bboxes, 0)
            stuff = fp_mask & (ov_dc > min_overlap).any(axis=1)
            fp -= int(stuff.sum())
        if compute_aos:
            if tp > 0 or fp > 0:
                similarity = float(
                    np.sum((1.0 + np.cos(np.array(delta))) / 2.0))
            else:
                similarity = -1.0
    return tp, fp, fn, similarity, thresholds


def compute_statistics_fused(overlaps, gt_data, dt_data, ignored_gt,
                             ignored_det, dc_bboxes, metric, min_overlap,
                             thresholds, compute_aos=False):
    """All-thresholds compute_statistics in one pass (compute_fp=True).

    Vectorizes the reference's `fused_compute_statistics`
    (`second/utils/eval.py:295-345`): instead of re-running the greedy
    gt→det matching once per score threshold (41×), the threshold axis is
    carried as a [T, D] assignment matrix and the sequential gt loop runs
    once per frame. Matching order/tie-breaking is identical to
    `compute_statistics` per threshold (golden-tested equal).

    Returns (tp[T], fp[T], fn[T], similarity[T]) int64/float64 arrays.
    """
    thresholds = np.asarray(thresholds, np.float64)
    num_t = thresholds.shape[0]
    det_size = dt_data.shape[0]
    dt_scores = dt_data[:, 5]
    ign_thr = dt_scores[None, :] < thresholds[:, None]      # [T, D]
    assigned = np.zeros((num_t, det_size), bool)
    tp = np.zeros(num_t, np.int64)
    fn = np.zeros(num_t, np.int64)
    sim = np.zeros(num_t, np.float64)
    if det_size == 0:
        # nothing to match (the loop below takes an argmax over the
        # detections): every counted gt is missed at every threshold
        fn += int((ignored_gt == 0).sum())
        similarity = np.full(num_t, -1.0) if compute_aos \
            else np.zeros(num_t, np.float64)
        return tp, np.zeros(num_t, np.int64), fn, similarity
    det_ok = (ignored_det != -1)[None, :]                   # [1, D]
    det_cls0 = (ignored_det == 0)[None, :]
    det_cls1 = (ignored_det == 1)[None, :]
    t_arange = np.arange(num_t)
    for i in range(gt_data.shape[0]):
        if ignored_gt[i] == -1:
            continue
        ov = overlaps[:, i]                                 # [D]
        usable = det_ok & ~assigned & ~ign_thr & (ov > min_overlap)[None, :]
        cand0 = usable & det_cls0
        has0 = cand0.any(axis=1)
        # max-overlap det, first index on ties (argmax semantics)
        idx0 = np.argmax(np.where(cand0, ov[None, :], -np.inf), axis=1)
        cand1 = usable & det_cls1
        has1 = cand1.any(axis=1)
        idx1 = np.argmax(cand1, axis=1)                     # first True
        has = has0 | has1
        det_idx = np.where(has0, idx0, idx1)
        if ignored_gt[i] == 0:
            fn += ~has
        det_idx_safe = np.where(has, det_idx, 0)
        matched_ignored = (ignored_gt[i] == 1) | \
            (ignored_det[det_idx_safe] == 1)
        is_tp = has & ~matched_ignored
        tp += is_tp
        if compute_aos:
            delta = gt_data[i, 4] - dt_data[det_idx_safe, 4]
            sim += np.where(is_tp, (1.0 + np.cos(delta)) / 2.0, 0.0)
        assigned[t_arange[has], det_idx[has]] = True
    fp_mask = ~assigned & det_cls0 & ~ign_thr               # [T, D]
    fp = fp_mask.sum(axis=1).astype(np.int64)
    if metric == 0 and len(dc_bboxes) > 0:
        ov_dc = image_box_overlap(dt_data[:, :4], dc_bboxes, 0)
        stuff_det = (ov_dc > min_overlap).any(axis=1)       # [D]
        fp -= (fp_mask & stuff_det[None, :]).sum(axis=1)
    similarity = np.where((tp > 0) | (fp > 0), sim, -1.0) if compute_aos \
        else np.zeros(num_t, np.float64)
    return tp, fp, fn, similarity


def _frame_overlaps(gt_annos, dt_annos, metric):
    """Per-frame overlap matrices [num_det, num_gt]."""
    out = []
    for gt, dt in zip(gt_annos, dt_annos):
        if metric == 0:
            ov = image_box_overlap(dt["bbox"], gt["bbox"])
        elif metric == 1:
            def bev(a):
                return np.concatenate(
                    [a["location"][:, [0, 2]], a["dimensions"][:, [0, 2]],
                     a["rotation_y"][:, None]], axis=1)
            ov = bev_box_overlap(bev(dt), bev(gt))
        elif metric == 2:
            def full(a):
                return np.concatenate(
                    [a["location"], a["dimensions"],
                     a["rotation_y"][:, None]], axis=1)
            ov = d3_box_overlap(full(dt), full(gt))
        else:
            raise ValueError("metric must be 0, 1, or 2")
        out.append(ov.astype(np.float64))
    return out


def eval_class(gt_annos, dt_annos, current_classes, difficultys, metric,
               min_overlaps, compute_aos=False):
    """AP curves for each (class, difficulty, min_overlap).

    min_overlaps: [num_minoverlap, 3(metric), num_class].
    Returns dict recall/precision/orientation of shape
    [num_class, num_difficulty, num_minoverlap, 41].
    """
    assert len(gt_annos) == len(dt_annos)
    overlaps = _frame_overlaps(gt_annos, dt_annos, metric)
    num_class, num_diff = len(current_classes), len(difficultys)
    num_ov = min_overlaps.shape[0]
    precision = np.zeros([num_class, num_diff, num_ov, N_SAMPLE_PTS])
    recall = np.zeros_like(precision)
    aos = np.zeros_like(precision)
    for m, cls in enumerate(current_classes):
        for d, diff in enumerate(difficultys):
            prepped = []
            total_valid_gt = 0
            for i in range(len(gt_annos)):
                nv, ig, idt, dc = clean_data(gt_annos[i], dt_annos[i], cls,
                                             diff)
                gt_data = np.concatenate(
                    [gt_annos[i]["bbox"],
                     gt_annos[i]["alpha"][:, None]], 1)
                dt_data = np.concatenate(
                    [dt_annos[i]["bbox"], dt_annos[i]["alpha"][:, None],
                     dt_annos[i]["score"][:, None]], 1)
                prepped.append((gt_data, dt_data, ig, idt, dc))
                total_valid_gt += nv
            for k in range(num_ov):
                min_ov = min_overlaps[k, metric, m]
                all_scores = []
                for i, (g, dtd, ig, idt, dc) in enumerate(prepped):
                    _, _, _, _, th = compute_statistics(
                        overlaps[i], g, dtd, ig, idt, dc, metric, min_ov,
                        compute_fp=False)
                    all_scores += th
                thresholds = np.array(
                    get_thresholds(np.array(all_scores), total_valid_gt))
                pr = np.zeros([len(thresholds), 4])
                for i, (g, dtd, ig, idt, dc) in enumerate(prepped):
                    tp, fp, fn, sim = compute_statistics_fused(
                        overlaps[i], g, dtd, ig, idt, dc, metric, min_ov,
                        thresholds, compute_aos=compute_aos)
                    pr[:, 0] += tp
                    pr[:, 1] += fp
                    pr[:, 2] += fn
                    pr[:, 3] += np.where(sim != -1, sim, 0.0)
                for i in range(len(thresholds)):
                    recall[m, d, k, i] = pr[i, 0] / (pr[i, 0] + pr[i, 2])
                    precision[m, d, k, i] = pr[i, 0] / (pr[i, 0] + pr[i, 1])
                    if compute_aos:
                        aos[m, d, k, i] = pr[i, 3] / (pr[i, 0] + pr[i, 1])
                # right-max smoothing
                for i in range(len(thresholds)):
                    precision[m, d, k, i] = precision[m, d, k, i:].max()
                    recall[m, d, k, i] = recall[m, d, k, i:].max()
                    if compute_aos:
                        aos[m, d, k, i] = aos[m, d, k, i:].max()
    return {"recall": recall, "precision": precision, "orientation": aos}


def get_mAP(prec):
    """Official 11-of-41-points AP (reference get_mAP_v2)."""
    return prec[..., ::4].sum(-1) / 11 * 100


def _compute_aos_flag(dt_annos):
    for anno in dt_annos:
        if anno["alpha"].shape[0] != 0:
            return anno["alpha"][0] != -10
    return False


def do_eval(gt_annos, dt_annos, current_classes, min_overlaps,
            compute_aos=False, difficultys=(0, 1, 2)):
    """Returns mAP arrays [num_class, num_diff, num_minoverlap] per metric."""
    ret = eval_class(gt_annos, dt_annos, current_classes, difficultys, 0,
                     min_overlaps, compute_aos)
    mAP_bbox = get_mAP(ret["precision"])
    mAP_aos = get_mAP(ret["orientation"]) if compute_aos else None
    ret = eval_class(gt_annos, dt_annos, current_classes, difficultys, 1,
                     min_overlaps)
    mAP_bev = get_mAP(ret["precision"])
    ret = eval_class(gt_annos, dt_annos, current_classes, difficultys, 2,
                     min_overlaps)
    mAP_3d = get_mAP(ret["precision"])
    return mAP_bbox, mAP_bev, mAP_3d, mAP_aos


_NAME_TO_CLASS = {n: i for i, n in enumerate(CLASS_NAMES)}


def get_official_eval_result(gt_annos, dt_annos, current_classes,
                             difficultys=(0, 1, 2)):
    """Official AP report. Returns (text, detail dict of float APs)."""
    overlap_07 = np.array([[0.7, 0.5, 0.5, 0.7, 0.5]] * 3)
    overlap_05 = np.array([[0.7, 0.5, 0.5, 0.7, 0.5],
                           [0.5, 0.25, 0.25, 0.5, 0.25],
                           [0.5, 0.25, 0.25, 0.5, 0.25]])
    min_overlaps = np.stack([overlap_07, overlap_05], axis=0)  # [2, 3, 5]
    if not isinstance(current_classes, (list, tuple)):
        current_classes = [current_classes]
    classes = [(_NAME_TO_CLASS[c] if isinstance(c, str) else c)
               for c in current_classes]
    min_overlaps = min_overlaps[:, :, classes]
    compute_aos = _compute_aos_flag(dt_annos)
    mAP_bbox, mAP_bev, mAP_3d, mAP_aos = do_eval(
        gt_annos, dt_annos, classes, min_overlaps, compute_aos,
        list(difficultys))
    out = io.StringIO()
    detail = {}
    for j, cls in enumerate(classes):
        name = CLASS_NAMES[cls]
        for i in range(min_overlaps.shape[0]):
            ovs = min_overlaps[i, :, j]
            print(f"{name} AP@{ovs[0]:.2f}, {ovs[1]:.2f}, {ovs[2]:.2f}:",
                  file=out)
            key = f"{name}_{ovs[0]:.2f}"
            for metric_name, arr in (("bbox", mAP_bbox), ("bev", mAP_bev),
                                     ("3d", mAP_3d)):
                vals = arr[j, :, i]
                pad = " " * (4 - len(metric_name))
                print(f"{metric_name}{pad} AP:{vals[0]:.2f}, {vals[1]:.2f}, "
                      f"{vals[2]:.2f}", file=out)
                detail[f"{key}/{metric_name}"] = vals.tolist()
            if compute_aos:
                vals = mAP_aos[j, :, i]
                print(f"aos  AP:{vals[0]:.2f}, {vals[1]:.2f}, {vals[2]:.2f}",
                      file=out)
                detail[f"{key}/aos"] = vals.tolist()
    return out.getvalue(), detail


def get_coco_eval_result(gt_annos, dt_annos, current_classes):
    """COCO-style AP over overlap range 0.5:0.05:0.95 (0.25:0.7 for small
    classes). Returns (text, detail dict)."""
    class_to_range = {
        0: [0.5, 0.95, 10], 1: [0.25, 0.7, 10], 2: [0.25, 0.7, 10],
        3: [0.5, 0.95, 10], 4: [0.25, 0.7, 10],
    }
    if not isinstance(current_classes, (list, tuple)):
        current_classes = [current_classes]
    classes = [(_NAME_TO_CLASS[c] if isinstance(c, str) else c)
               for c in current_classes]
    # min_overlaps: [10, 3(metric), num_class]
    min_overlaps = np.zeros([10, 3, len(classes)])
    for i, cls in enumerate(classes):
        lo, hi, n = class_to_range[cls]
        min_overlaps[:, :, i] = np.linspace(lo, hi, int(n))[:, None]
    compute_aos = _compute_aos_flag(dt_annos)
    mAP_bbox, mAP_bev, mAP_3d, mAP_aos = do_eval(
        gt_annos, dt_annos, classes, min_overlaps, compute_aos)
    mAP_bbox = mAP_bbox.mean(-1)
    mAP_bev = mAP_bev.mean(-1)
    mAP_3d = mAP_3d.mean(-1)
    if mAP_aos is not None:
        mAP_aos = mAP_aos.mean(-1)
    out = io.StringIO()
    detail = {}
    for j, cls in enumerate(classes):
        name = CLASS_NAMES[cls]
        lo, hi, n = class_to_range[cls]
        step = (hi - lo) / (int(n) - 1)
        print(f"{name} coco AP@{lo:.2f}:{step:.2f}:{hi:.2f}:", file=out)
        for metric_name, arr in (("bbox", mAP_bbox), ("bev", mAP_bev),
                                 ("3d", mAP_3d)):
            vals = arr[j]
            pad = " " * (4 - len(metric_name))
            print(f"{metric_name}{pad} AP:{vals[0]:.2f}, {vals[1]:.2f}, "
                  f"{vals[2]:.2f}", file=out)
            detail[f"{name}_coco/{metric_name}"] = vals.tolist()
        if compute_aos:
            vals = mAP_aos[j]
            print(f"aos  AP:{vals[0]:.2f}, {vals[1]:.2f}, {vals[2]:.2f}",
                  file=out)
            detail[f"{name}_coco/aos"] = vals.tolist()
    return out.getvalue(), detail
