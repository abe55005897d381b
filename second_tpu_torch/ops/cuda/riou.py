"""Rotated BEV IoU kernel wrappers — the port of
`second_tpu/ops/pallas/riou.py`, and the two kernels of batched rotated NMS.

`riou_pairs` (a pair list into two box arrays) and `riou_matrix` (dense
[N, K] with a criterion) are the rotated IoU as such, off the main path.
`d3_iou` is its 3-D extension, batched [B, N, 7] x [B, K, 7] → [B, N, K]
(the BEV intersection times the vertical overlap over the union of the
volumes), the IoU branch's targets in training; its kernel culls the pairs
whose boxes cannot meet before it clips the rest, and `d3_cull_plain` is
that cull rule in plain PyTorch.
`nms_overlap` (the standup bound, the row-major pair list cut at
`max_pairs`, the clip and the threshold: the rotated IoU as rotated NMS
runs it, JAX `_sparse_rotated_over`) and `nms_suppress` (exact greedy
suppression, JAX `_greedy_suppress_over`) take a whole batch and meet in an
overlap bitmask [B, K, ceil(K / 32)] of int32 words: bit j % 32 of word
j // 32 of row i says that the higher-ranked box i suppresses box j.
`standup_overlap` writes that bitmask for standup NMS (the standup IoU of
axis-aligned boxes, thresholded). Each launches `csrc/riou.cu` for CUDA
tensors and takes its plain version, built on `ops/rotated_iou.py`, for
CPU tensors. None has a backward: under grad mode, boxes that require
grad raise.
"""

from __future__ import annotations

import ctypes

import torch

from ..box_ops import bev_boxes
from ..rotated_iou import (iou_from_inter, quad_intersection_area,
                           rbbox_to_corners, standup_iou_matrix)
from . import check, function, refuse_grad, stream_ptr

# launches since the last reset (set to 0 to reset): of the rotated-IoU
# kernels (`nms_overlap` on the main path, `riou_pairs`, `riou_matrix`), of
# the suppression kernel, and of the 3-D IoU kernel
launches = 0
launches_suppress = 0
launches_d3 = 0
# launches of the standup-NMS bitmask kernel
launches_standup = 0

NMS_MAX_K = 4096        # candidates an example (the kernel's list packing)
NMS_CLUSTERS = (1, 2, 4, 8, 16)
NMS_CLUSTER = 16        # blocks (SMs) an example in nms_overlap: the fastest
D3_TAME = 1e12          # the largest field magnitude d3_iou's cull takes

# b1, b2, i, j, out, pairs, criterion, stream
_PAIRS_ARGTYPES = [ctypes.c_void_p] * 5 + \
    [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
# b1, b2, out, n1, n2, criterion, stream
_MATRIX_ARGTYPES = [ctypes.c_void_p] * 3 + \
    [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
# cand, valid, over, maybe, count, batch, k, thr, cap, cluster, stream
_OVERLAP_ARGTYPES = [ctypes.c_void_p] * 5 + \
    [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
     ctypes.c_void_p]
# b1, b2, out, clipped, batch, n1, n2, stream
_D3_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
# cand, valid, over, batch, k, thr, double, stream
_STANDUP_ARGTYPES = [ctypes.c_void_p] * 3 + \
    [ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_int,
     ctypes.c_void_p]
# over, valid, keep, batch, k, stream
_SUPPRESS_ARGTYPES = [ctypes.c_void_p] * 3 + \
    [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
# the C launch functions, resolved at their first launch
_pairs_launch = None
_matrix_launch = None
_overlap_launch = None
_suppress_launch = None
_d3_launch = None
_standup_launch = None


def _resolve_pairs():
    global _pairs_launch
    _pairs_launch = function("riou", "riou_pairs", _PAIRS_ARGTYPES)
    return _pairs_launch


def _resolve_matrix():
    global _matrix_launch
    _matrix_launch = function("riou", "riou_matrix", _MATRIX_ARGTYPES)
    return _matrix_launch


def _resolve_overlap():
    global _overlap_launch
    _overlap_launch = function("riou", "nms_overlap", _OVERLAP_ARGTYPES)
    return _overlap_launch


def _resolve_suppress():
    global _suppress_launch
    _suppress_launch = function("riou", "nms_suppress", _SUPPRESS_ARGTYPES)
    return _suppress_launch


def _resolve_standup():
    global _standup_launch
    _standup_launch = function("riou", "standup_overlap", _STANDUP_ARGTYPES)
    return _standup_launch


def _resolve_d3():
    global _d3_launch
    _d3_launch = function("riou", "d3_iou", _D3_ARGTYPES)
    return _d3_launch


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


def d3_iou_plain(boxes1, boxes2):
    """Pairwise 3-D IoU of lidar boxes (x, y, z, w, l, h, yaw), z at the
    bottom: boxes1 [B, N, 7] x boxes2 [B, K, 7] → [B, N, K], BEV rotated
    intersection x max(vertical overlap, 0) / max(union, 1e-12), in row
    chunks so the clip's intermediates stay small."""
    B, N = boxes1.shape[:2]
    K = boxes2.shape[1]
    c1 = rbbox_to_corners(bev_boxes(boxes1))
    c2 = rbbox_to_corners(bev_boxes(boxes2))
    z1, z2 = boxes1[..., 2], boxes2[..., 2]
    top1, top2 = z1 + boxes1[..., 5], z2 + boxes2[..., 5]
    vol1 = boxes1[..., 3] * boxes1[..., 4] * boxes1[..., 5]
    vol2 = boxes2[..., 3] * boxes2[..., 4] * boxes2[..., 5]
    chunk = max(1, 131072 // max(B * K, 1))
    rows = []
    for r0 in range(0, N, chunk):
        r = slice(r0, r0 + chunk)
        q1 = c1[:, r, None].expand(-1, -1, K, 4, 2)
        q2 = c2[:, None].expand(-1, q1.shape[1], -1, -1, -1)
        inter = quad_intersection_area(q1, q2) * torch.clamp(
            torch.minimum(top1[:, r, None], top2[:, None]) -
            torch.maximum(z1[:, r, None], z2[:, None]), min=0.0)
        rows.append(inter / torch.clamp(
            vol1[:, r, None] + vol2[:, None] - inter, min=1e-12))
    if not rows:
        return boxes1.new_zeros((B, N, K))
    return torch.cat(rows, dim=1)


def d3_cull_plain(boxes1, boxes2):
    """The pairs that `d3_iou`'s kernel writes as 0 without clipping them,
    bool [B, N, K]: both boxes tame (every field finite and at most D3_TAME
    in magnitude, so no product of the clip overflows) and their vertical
    overlap at most 0, or both also solid (width and length positive and at
    least 1/256 of the reach |x| + |y| + |w| + |l|) and their BEV standup
    envelopes strictly apart on x or on y. The kernel's comparisons on the
    corners of `rbbox_to_corners`; the kernel's clipped count is the pairs
    this keeps. Nothing on the main path calls it."""
    def parts(b):
        c = rbbox_to_corners(bev_boxes(b))
        tame = (b.abs() <= D3_TAME).all(-1)
        w, l = b[..., 3], b[..., 4]
        reach = b[..., 0].abs() + b[..., 1].abs() + w.abs() + l.abs()
        solid = (w > 0) & (l > 0) & (256 * w >= reach) & (256 * l >= reach)
        return (c.amin(-2), c.amax(-2), b[..., 2], b[..., 2] + b[..., 5],
                tame, solid)
    lo1, hi1, zb1, zt1, tame1, solid1 = parts(boxes1)
    lo2, hi2, zb2, zt2, tame2, solid2 = parts(boxes2)
    w = torch.minimum(hi1[:, :, None], hi2[:, None]) - \
        torch.maximum(lo1[:, :, None], lo2[:, None])
    zo = torch.minimum(zt1[:, :, None], zt2[:, None]) - \
        torch.maximum(zb1[:, :, None], zb2[:, None])
    apart = solid1[:, :, None] & solid2[:, None] & \
        ((w[..., 0] < 0) | (w[..., 1] < 0))
    return tame1[:, :, None] & tame2[:, None] & ((zo <= 0) | apart)


def _check_boxes(name, *boxes):
    for b in boxes:
        if b.dim() != 2 or b.shape[1] != 5 or b.dtype != torch.float32:
            raise ValueError(f"{name}: boxes must be [N, 5] float32, got "
                             f"{tuple(b.shape)} {b.dtype}")


def riou_pairs(boxes1, boxes2, i, j, criterion=-1):
    """`riou_pairs_plain` semantics; the CUDA kernel for CUDA tensors."""
    refuse_grad("riou_pairs", boxes1, boxes2)
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
    refuse_grad("riou_matrix", boxes1, boxes2)
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


def d3_iou(boxes1, boxes2, count=False):
    """`d3_iou_plain` semantics; the CUDA kernel for CUDA tensors. With
    count=True, returns (iou, clipped [B] int32): the pairs of each example
    that the kernel clipped, those `d3_cull_plain` keeps (counted from it
    for CPU tensors)."""
    refuse_grad("d3_iou", boxes1, boxes2)
    dev = boxes1.device
    if dev.type == "cpu":
        out = d3_iou_plain(boxes1, boxes2)
        if not count:
            return out
        kept = ~d3_cull_plain(boxes1, boxes2)
        return out, kept.sum((1, 2), dtype=torch.int32)
    if dev.type != "cuda":
        raise ValueError(f"d3_iou: unsupported device {dev}")
    for b in (boxes1, boxes2):
        if b.dim() != 3 or b.shape[2] != 7 or b.dtype != torch.float32:
            raise ValueError(f"d3_iou: boxes must be [B, N, 7] float32, got "
                             f"{tuple(b.shape)} {b.dtype}")
    if boxes2.device != dev or boxes2.shape[0] != boxes1.shape[0]:
        raise ValueError("d3_iou: boxes of another device or batch")
    B, N = boxes1.shape[:2]
    K = boxes2.shape[1]
    if B > 65535 or max(N, K) > 2 ** 31 - 129:
        raise ValueError(f"d3_iou: [{B}, {N}] x [{B}, {K}] boxes; the "
                         f"kernel takes at most 65535 examples and 2**31 - "
                         f"129 boxes an example")
    out = torch.empty((B, N, K), dtype=torch.float32, device=dev)
    clipped = torch.zeros((B,), dtype=torch.int32, device=dev) \
        if count else None
    if B * N * K:
        boxes1, boxes2 = boxes1.contiguous(), boxes2.contiguous()
        rc = (_d3_launch or _resolve_d3())(
            boxes1.data_ptr(), boxes2.data_ptr(), out.data_ptr(),
            clipped.data_ptr() if count else None, B, N, K, stream_ptr(dev))
        check("riou", rc)
        global launches_d3
        launches_d3 += 1
    return (out, clipped) if count else out


# ------------------------------------------------------------ rotated NMS


def pack_bits(mask):
    """Bool [..., K] → int32 words [..., ceil(K / 32)]: bit t of word w is
    mask[..., 32 w + t]."""
    K = mask.shape[-1]
    W = (K + 31) // 32
    bits = torch.nn.functional.pad(mask.long(), (0, 32 * W - K))
    weights = 2 ** torch.arange(32, dtype=torch.int64, device=mask.device)
    words = (bits.reshape(*mask.shape[:-1], W, 32) * weights).sum(-1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(
        torch.int32)


def unpack_bits(words, K):
    """`pack_bits` inverted: int32 words [..., W] → bool [..., K]."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words[..., None] >> shifts) & 1
    return bits.reshape(*words.shape[:-1], -1)[..., :K].bool()


def standup_maybe(cand, valid, iou_threshold):
    """The pairs rotated NMS clips before its cap, [B, K, K] bool: i < j,
    both valid, and the standup-envelope bound on their rotated IoU,
    inter / max(a_i + a_j - inter, 1e-12), above the threshold."""
    K = cand.shape[1]
    corners = rbbox_to_corners(cand)                          # [B, K, 4, 2]
    standup = torch.cat([corners.amin(-2), corners.amax(-2)], -1)
    lt = torch.maximum(standup[:, :, None, :2], standup[:, None, :, :2])
    rb = torch.minimum(standup[:, :, None, 2:], standup[:, None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    areas = cand[..., 2] * cand[..., 3]
    asum = areas[:, :, None] + areas[:, None, :]
    bound = inter / torch.clamp(asum - inter, min=1e-12)
    upper = torch.ones((K, K), dtype=torch.bool, device=cand.device).triu(1)
    return (bound > iou_threshold) & upper & valid[:, :, None] & \
        valid[:, None, :]


def capped_pairs(cand, valid, iou_threshold, max_pairs):
    """The pairs rotated NMS clips: the first `max_pairs` of each example's
    `standup_maybe` pairs in row-major order, as (example b, i * K + j),
    and each example's pair count before the cap [B] int32."""
    B, K = valid.shape
    maybe = standup_maybe(cand, valid, iou_threshold).reshape(B, K * K)
    capped = maybe & (torch.cumsum(maybe, 1) <= max_pairs)
    b, lin = torch.nonzero(capped, as_tuple=True)
    return b, lin, maybe.sum(1).to(torch.int32)


def nms_overlap_plain(cand, valid, iou_threshold, max_pairs):
    """cand [B, K, 5] fp32 (sorted by descending score), valid [B, K] bool
    → (over bitmask [B, K, ceil(K / 32)] int32, pair count [B] int32): a
    bit for each of `capped_pairs` whose rotated IoU exceeds the threshold;
    the count is of `standup_maybe`'s pairs before the cap."""
    B, K = valid.shape
    b, lin, count = capped_pairs(cand, valid, iou_threshold, max_pairs)
    flat = cand.reshape(B * K, 5)
    iou = riou_pairs_plain(flat, flat, b * K + lin // K, b * K + lin % K)
    over = torch.zeros(B * K * K, dtype=torch.bool, device=cand.device)
    over[(b * K * K + lin)[iou > iou_threshold]] = True
    return pack_bits(over.view(B, K, K)), count


def standup_overlap_plain(cand, valid, iou_threshold):
    """The strictly-upper `standup IoU > threshold` matrix of valid pairs,
    packed: cand [B, K, 4] xyxy → [B, K, ceil(K / 32)] int32 (the dense
    `standup_iou_matrix`, then `pack_bits`)."""
    K = cand.shape[1]
    upper = torch.ones((K, K), dtype=torch.bool, device=cand.device).triu(1)
    over = (standup_iou_matrix(cand, cand) > iou_threshold) & upper & \
        valid[:, :, None] & valid[:, None, :]
    return pack_bits(over)


def nms_suppress_plain(over_bits, valid):
    """Exact greedy NMS over boxes sorted by descending score: over bitmask
    [B, K, W] (strictly upper), valid [B, K] → keep [B, K]. Frontier rounds,
    as a host loop: each round decides every box whose higher-ranked
    overlapping boxes are all decided (kept if none of those was kept)."""
    over_f = unpack_bits(over_bits, valid.shape[-1]).float()
    undecided = valid.clone()
    kept = torch.zeros_like(valid)
    while bool(undecided.any()):
        blocked = torch.bmm(undecided.float()[:, None], over_f)[:, 0] > 0.5
        suppressed = torch.bmm(kept.float()[:, None], over_f)[:, 0] > 0.5
        newly_kept = undecided & ~blocked & ~suppressed
        newly_removed = undecided & suppressed
        kept = kept | newly_kept
        undecided = undecided & ~newly_kept & ~newly_removed
    return kept


def _check_batch(name, tensor, valid, inner):
    if valid.dim() != 2 or tensor.shape[:2] != valid.shape or \
            tuple(tensor.shape[2:]) != inner:
        raise ValueError(f"{name}: expected [B, K, {', '.join(map(str, inner))}]"
                         f" and valid [B, K] bool, got {tuple(tensor.shape)} "
                         f"and {tuple(valid.shape)}")
    if valid.dtype != torch.bool or valid.device != tensor.device:
        raise ValueError(f"{name}: valid must be bool on {tensor.device}")
    K = valid.shape[1]
    if K > NMS_MAX_K:
        raise ValueError(f"{name}: {K} candidates an example; the kernel "
                         f"takes at most {NMS_MAX_K}")


def nms_overlap(cand, valid, iou_threshold, max_pairs, cluster=None):
    """`nms_overlap_plain` semantics; the CUDA kernel for CUDA tensors, with
    `cluster` blocks an example (default NMS_CLUSTER)."""
    refuse_grad("nms_overlap", cand)
    dev = cand.device
    if dev.type == "cpu":
        return nms_overlap_plain(cand, valid, iou_threshold, max_pairs)
    if dev.type != "cuda":
        raise ValueError(f"nms_overlap: unsupported device {dev}")
    if cand.dtype != torch.float32 or cand.dim() != 3:
        raise ValueError(f"nms_overlap: cand must be [B, K, 5] float32, got "
                         f"{tuple(cand.shape)} {cand.dtype}")
    _check_batch("nms_overlap", cand, valid, (5,))
    if not 0 <= max_pairs < 2 ** 31:
        raise ValueError(f"nms_overlap: max_pairs {max_pairs} outside "
                         f"[0, 2**31)")
    cluster = NMS_CLUSTER if cluster is None else cluster
    if cluster not in NMS_CLUSTERS:
        raise ValueError(f"nms_overlap: cluster must be one of {NMS_CLUSTERS}")
    B, K = valid.shape
    W = (K + 31) // 32
    over = torch.empty((B, K, W), dtype=torch.int32, device=dev)
    count = torch.zeros((B,), dtype=torch.int32, device=dev)
    if B * K == 0:
        return over, count
    cand, valid = cand.contiguous(), valid.contiguous()
    maybe = torch.empty_like(over)
    rc = (_overlap_launch or _resolve_overlap())(
        cand.data_ptr(), valid.data_ptr(), over.data_ptr(),
        maybe.data_ptr(), count.data_ptr(), B, K,
        iou_threshold, max_pairs, cluster, stream_ptr(dev))
    check("riou", rc)
    global launches
    launches += 1
    return over, count


def standup_overlap(cand, valid, iou_threshold):
    """`standup_overlap_plain` semantics, bit for bit; the CUDA kernel for
    CUDA tensors (fp32 or fp64 boxes)."""
    refuse_grad("standup_overlap", cand)
    dev = cand.device
    if dev.type == "cpu":
        return standup_overlap_plain(cand, valid, iou_threshold)
    if dev.type != "cuda":
        raise ValueError(f"standup_overlap: unsupported device {dev}")
    if cand.dtype not in (torch.float32, torch.float64) or cand.dim() != 3:
        raise ValueError(f"standup_overlap: cand must be [B, K, 4] float32 "
                         f"or float64, got {tuple(cand.shape)} {cand.dtype}")
    if valid.dim() != 2 or cand.shape[:2] != valid.shape or \
            cand.shape[2] != 4 or valid.dtype != torch.bool or \
            valid.device != dev:
        raise ValueError(f"standup_overlap: expected [B, K, 4] and valid "
                         f"[B, K] bool on {dev}, got {tuple(cand.shape)} and "
                         f"{tuple(valid.shape)} {valid.dtype}")
    B, K = valid.shape
    if B > 65535:
        raise ValueError(f"standup_overlap: {B} rows; the kernel takes at "
                         f"most 65535")
    over = torch.empty((B, K, (K + 31) // 32), dtype=torch.int32, device=dev)
    if B * K == 0:
        return over
    cand, valid = cand.contiguous(), valid.contiguous()
    rc = (_standup_launch or _resolve_standup())(
        cand.data_ptr(), valid.data_ptr(), over.data_ptr(), B, K,
        iou_threshold, int(cand.dtype == torch.float64), stream_ptr(dev))
    check("riou", rc)
    global launches_standup
    launches_standup += 1
    return over


def nms_suppress(over_bits, valid):
    """`nms_suppress_plain` semantics; the CUDA kernel for CUDA tensors."""
    refuse_grad("nms_suppress", over_bits)
    dev = over_bits.device
    if dev.type == "cpu":
        return nms_suppress_plain(over_bits, valid)
    if dev.type != "cuda":
        raise ValueError(f"nms_suppress: unsupported device {dev}")
    if over_bits.dtype != torch.int32 or over_bits.dim() != 3:
        raise ValueError(f"nms_suppress: over_bits must be [B, K, W] int32, "
                         f"got {tuple(over_bits.shape)} {over_bits.dtype}")
    _check_batch("nms_suppress", over_bits, valid,
                 ((valid.shape[-1] + 31) // 32,))
    B, K = valid.shape
    keep = torch.empty((B, K), dtype=torch.bool, device=dev)
    if B * K == 0:
        return keep
    over_bits, valid = over_bits.contiguous(), valid.contiguous()
    rc = (_suppress_launch or _resolve_suppress())(
        over_bits.data_ptr(), valid.data_ptr(), keep.data_ptr(), B, K,
        stream_ptr(dev))
    check("riou", rc)
    global launches_suppress
    launches_suppress += 1
    return keep
