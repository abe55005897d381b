"""Rotated BEV IoU kernel wrappers — the port of
`second_tpu/ops/pallas/riou.py`.

`riou_pairs` (a pair list into two box arrays: rotated NMS) and
`riou_matrix` (dense [N, K] with a criterion) launch `csrc/riou.cu` for CUDA
tensors and take their plain versions, built on `ops/rotated_iou.py`, for
CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from ..rotated_iou import (iou_from_inter, quad_intersection_area,
                           rbbox_to_corners)
from . import check, function, stream_ptr

# launches of the CUDA kernel (either entry point) since the last reset
launches = 0

# b1, b2, i, j, out, pairs, criterion, stream
_PAIRS_ARGTYPES = [ctypes.c_void_p] * 5 + \
    [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
# b1, b2, out, n1, n2, criterion, stream
_MATRIX_ARGTYPES = [ctypes.c_void_p] * 3 + \
    [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
# the C launch functions, resolved at their first launch
_pairs_launch = None
_matrix_launch = None


def _resolve_pairs():
    global _pairs_launch
    _pairs_launch = function("riou", "riou_pairs", _PAIRS_ARGTYPES)
    return _pairs_launch


def _resolve_matrix():
    global _matrix_launch
    _matrix_launch = function("riou", "riou_matrix", _MATRIX_ARGTYPES)
    return _matrix_launch


def riou_pairs_plain(boxes1, boxes2, i, j, criterion=-1):
    """IoU of the box pairs (boxes1[i[p]], boxes2[j[p]]): boxes [N, 5]
    (x, y, w, l, yaw) fp32, i/j [P] integer → [P] fp32."""
    i, j = i.long(), j.long()
    inter = quad_intersection_area(rbbox_to_corners(boxes1)[i],
                                   rbbox_to_corners(boxes2)[j])
    area1 = boxes1[:, 2] * boxes1[:, 3]
    area2 = boxes2[:, 2] * boxes2[:, 3]
    return iou_from_inter(inter, area1[i], area2[j], criterion)


def riou_matrix_plain(boxes1, boxes2, criterion=-1):
    """Pairwise IoU [N, 5] x [K, 5] → [N, K], in row chunks so the clip's
    [chunk, K, 16, 2] intermediates stay small."""
    N, K = boxes1.shape[0], boxes2.shape[0]
    c1 = rbbox_to_corners(boxes1)
    c2 = rbbox_to_corners(boxes2)
    area1 = boxes1[:, 2] * boxes1[:, 3]
    area2 = boxes2[:, 2] * boxes2[:, 3]
    chunk = max(1, 131072 // max(K, 1))
    rows = []
    for r0 in range(0, N, chunk):
        q1 = c1[r0:r0 + chunk, None].expand(-1, K, 4, 2)
        q2 = c2[None].expand(q1.shape[0], K, 4, 2)
        inter = quad_intersection_area(q1, q2)
        rows.append(iou_from_inter(inter, area1[r0:r0 + chunk, None],
                                   area2[None, :], criterion))
    if not rows:
        return torch.zeros((N, K), dtype=torch.float32, device=boxes1.device)
    return torch.cat(rows, dim=0)


def _check_boxes(name, *boxes):
    for b in boxes:
        if b.dim() != 2 or b.shape[1] != 5 or b.dtype != torch.float32:
            raise ValueError(f"{name}: boxes must be [N, 5] float32, got "
                             f"{tuple(b.shape)} {b.dtype}")


def riou_pairs(boxes1, boxes2, i, j, criterion=-1):
    """`riou_pairs_plain` semantics; the CUDA kernel for CUDA tensors."""
    if boxes1.device.type == "cpu":
        return riou_pairs_plain(boxes1, boxes2, i, j, criterion)
    if boxes1.device.type != "cuda":
        raise ValueError(f"riou_pairs: unsupported device {boxes1.device}")
    if criterion not in (-1, 0, 1):
        raise ValueError("criterion must be -1, 0, or 1")
    _check_boxes("riou_pairs", boxes1, boxes2)
    if i.shape != j.shape or i.dim() != 1:
        raise ValueError("riou_pairs: i and j must be [P] of one shape")
    if not (boxes2.device == i.device == j.device == boxes1.device):
        raise ValueError("riou_pairs: tensors on different devices")
    boxes1, boxes2 = boxes1.contiguous(), boxes2.contiguous()
    i = i.to(torch.int32).contiguous()
    j = j.to(torch.int32).contiguous()
    P = i.shape[0]
    out = torch.empty((P,), dtype=torch.float32, device=boxes1.device)
    if P == 0:
        return out
    rc = (_pairs_launch or _resolve_pairs())(
        boxes1.data_ptr(), boxes2.data_ptr(), i.data_ptr(), j.data_ptr(),
        out.data_ptr(), P, criterion, stream_ptr(boxes1.device))
    check("riou", rc)
    global launches
    launches += 1
    return out


def riou_matrix(boxes1, boxes2, criterion=-1):
    """`riou_matrix_plain` semantics; the CUDA kernel for CUDA tensors."""
    if boxes1.device.type == "cpu":
        return riou_matrix_plain(boxes1, boxes2, criterion)
    if boxes1.device.type != "cuda":
        raise ValueError(f"riou_matrix: unsupported device {boxes1.device}")
    if criterion not in (-1, 0, 1):
        raise ValueError("criterion must be -1, 0, or 1")
    _check_boxes("riou_matrix", boxes1, boxes2)
    if boxes2.device != boxes1.device:
        raise ValueError("riou_matrix: tensors on different devices")
    boxes1, boxes2 = boxes1.contiguous(), boxes2.contiguous()
    N, K = boxes1.shape[0], boxes2.shape[0]
    out = torch.empty((N, K), dtype=torch.float32, device=boxes1.device)
    if N * K == 0:
        return out
    rc = (_matrix_launch or _resolve_matrix())(
        boxes1.data_ptr(), boxes2.data_ptr(), out.data_ptr(), N, K,
        criterion, stream_ptr(boxes1.device))
    check("riou", rc)
    global launches
    launches += 1
    return out
