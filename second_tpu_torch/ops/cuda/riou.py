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
axis-aligned boxes, thresholded). `soft_nms_decay_standup` runs the decay
steps of soft-NMS (JAX `soft_nms`'s `lax.scan`) over standup candidates'
boxes (standup soft-NMS: each step computes the pick's row of their IoU
matrix), and `soft_nms_decay_pairs` over the capped pair list of rotated
soft-NMS, which holds that matrix's only nonzero entries;
`soft_nms_decay_plain` is those steps over any IoU matrix, their plain
versions' core.
Each launches `csrc/riou.cu` for CUDA tensors and takes its plain version,
built on `ops/rotated_iou.py`, for CPU tensors. None has a backward: under
grad mode, inputs that require grad raise. On the card the rotated routes
(`nms_overlap`, `soft_nms_decay_pairs`) take up to ROTATED_MAX_K
candidates an example, the bound JAX's int32 pair index sets; the standup
ones and `nms_suppress` any K whose tensors the card holds. Past
NMS_MAX_K the kernels take wide routes of their own, with the same
results.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..box_ops import bev_boxes
from ..rotated_iou import (iou_from_inter, quad_intersection_area,
                           rbbox_to_corners, standup_iou_matrix)
from . import check, function, library, refuse_grad, stream_ptr

# launches since the last reset (set to 0 to reset): of the rotated-IoU
# kernels (`nms_overlap` on the main path, `riou_pairs`, `riou_matrix`), of
# the suppression kernel, and of the 3-D IoU kernel
launches = 0
launches_suppress = 0
launches_d3 = 0
# launches of the standup-NMS bitmask kernel
launches_standup = 0
# launches of the soft-NMS decay kernels: over standup boxes, and over a
# pair list
launches_soft_standup = 0
launches_soft_pairs = 0

# candidates an example of the kernels that hold an example in one block's
# shared memory; past it the wide routes
NMS_MAX_K = 4096
# candidates an example of rotated NMS and soft-NMS: JAX indexes their pairs
# as int32 `arange(K * K)` (second_tpu/ops/nms.py:100, :142), so K * K must
# stay below 2^31
ROTATED_MAX_K = 46340
# candidates an example of `nms_suppress`'s wide kernel (its removed mask in
# 200 KiB of shared memory), past what the card holds: their bitmask alone
# would take 335 GB an example
SUPPRESS_MAX_K = 32 * 200 * 1024 // 4
NMS_CLUSTERS = (1, 2, 4, 8, 16)
NMS_CLUSTER = 16        # blocks (SMs) an example in nms_overlap: the fastest
D3_TAME = 1e12          # the largest field magnitude d3_iou's cull takes

# b1, b2, i, j, out, pairs, criterion, stream
_PAIRS_ARGTYPES = [ctypes.c_void_p] * 5 + \
    [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
# b1, b2, out, n1, n2, criterion, stream
_MATRIX_ARGTYPES = [ctypes.c_void_p] * 3 + \
    [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
# cand, valid, over, maybe, count, scratch, batch, k, thr, cap, cluster,
# stream
_OVERLAP_ARGTYPES = [ctypes.c_void_p] * 6 + \
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
# cand, scores, picks, pick_scores, scratch, rows, k, m, gaussian, sigma,
# thr, stream
_SOFT_STANDUP_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + \
    [ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
# plist, ok, iou, scores, picks, pick_scores, scratch, rows, k, p, m,
# gaussian, sigma, thr, stream
_SOFT_PAIRS_ARGTYPES = [ctypes.c_void_p] * 7 + \
    [ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
     ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
# the C launch functions, resolved at their first launch
_pairs_launch = None
_matrix_launch = None
_overlap_launch = None
_suppress_launch = None
_d3_launch = None
_standup_launch = None
_soft_standup_launch = None
_soft_pairs_launch = None


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


def _resolve_soft_standup():
    global _soft_standup_launch
    _soft_standup_launch = function("riou", "soft_nms_decay_standup",
                                    _SOFT_STANDUP_ARGTYPES)
    return _soft_standup_launch


def _resolve_soft_pairs():
    global _soft_pairs_launch
    _soft_pairs_launch = function("riou", "soft_nms_decay_pairs",
                                  _SOFT_PAIRS_ARGTYPES)
    return _soft_pairs_launch


def _scratch_bytes(name, argtypes, *args):
    """The bytes of device scratch that csrc/riou.cu's `name` counts."""
    fn = getattr(library("riou"), name)
    if fn.restype is not ctypes.c_longlong:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_longlong
    return int(fn(*args))


def soft_pairs_scratch(K, P):
    """Bytes of device scratch a row of `soft_nms_decay_pairs` takes: 0
    where its adjacency fits in the block's shared memory, else its
    adjacency, or past NMS_MAX_K the wide route's whole row (csrc/riou.cu
    `soft_nms_pairs_scratch`)."""
    return _scratch_bytes("soft_nms_pairs_scratch",
                          [ctypes.c_int, ctypes.c_longlong], K, P)


def check_rotated_k(name, K):
    if K > ROTATED_MAX_K:
        raise ValueError(
            f"{name}: {K} candidates an example; rotated NMS takes at most "
            f"{ROTATED_MAX_K}, as JAX's does: it indexes the candidate pairs "
            f"as int32 arange(K * K), which overflows past that")


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


# elements of a row block of a [B, K, K] pair matrix that the plain
# versions build at once (their intermediates are some 2-8 times that), so
# that K up to ROTATED_MAX_K fits the card and the host
PLAIN_BLOCK = 1 << 24


def row_blocks(B, K):
    """The row ranges [r0, r1) of blocks of about PLAIN_BLOCK pairs."""
    rows = max(1, PLAIN_BLOCK // max(B * K, 1))
    return [(r0, min(r0 + rows, K)) for r0 in range(0, K, rows)]


def standup_maybe(cand, valid, iou_threshold, rows=None):
    """The pairs rotated NMS clips before its cap, [B, K, K] bool (with
    `rows` (r0, r1), only rows r0 to r1 - 1: [B, r1 - r0, K]): i < j, both
    valid, and the standup-envelope bound on their rotated IoU,
    inter / max(a_i + a_j - inter, 1e-12), above the threshold."""
    K = cand.shape[1]
    r0, r1 = rows or (0, K)
    corners = rbbox_to_corners(cand)                          # [B, K, 4, 2]
    standup = torch.cat([corners.amin(-2), corners.amax(-2)], -1)
    lt = torch.maximum(standup[:, r0:r1, None, :2], standup[:, None, :, :2])
    rb = torch.minimum(standup[:, r0:r1, None, 2:], standup[:, None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    areas = cand[..., 2] * cand[..., 3]
    asum = areas[:, r0:r1, None] + areas[:, None, :]
    bound = inter / torch.clamp(asum - inter, min=1e-12)
    upper = torch.arange(K, device=cand.device)[None, :] > \
        torch.arange(r0, r1, device=cand.device)[:, None]
    return (bound > iou_threshold) & upper & valid[:, r0:r1, None] & \
        valid[:, None, :]


def capped_pairs(cand, valid, iou_threshold, max_pairs):
    """The pairs rotated NMS clips: the first `max_pairs` of each example's
    `standup_maybe` pairs in row-major order, as (example b, i * K + j)
    sorted by example then i * K + j, and each example's pair count before
    the cap [B] int32. Built a block of rows at a time."""
    B, K = valid.shape
    seen = torch.zeros(B, dtype=torch.int64, device=cand.device)
    keys = []
    for r0, r1 in row_blocks(B, K):
        maybe = standup_maybe(cand, valid, iou_threshold,
                              (r0, r1)).reshape(B, -1)
        rank = seen[:, None] + torch.cumsum(maybe, 1)
        b, lin = torch.nonzero(maybe & (rank <= max_pairs), as_tuple=True)
        keys.append(b * K * K + r0 * K + lin)
        seen += maybe.sum(1)
    key = torch.cat(keys).sort()[0] if keys else \
        torch.zeros(0, dtype=torch.int64, device=cand.device)
    return key // (K * K), key % (K * K), seen.to(torch.int32)


def pairs_to_bits(B, K, b, i, j):
    """The bitmask [B, K, ceil(K / 32)] int32 with bit j of row i of example
    b set for each of the (distinct) pairs given, and no other."""
    W = (K + 31) // 32
    words = torch.zeros(B * K * W, dtype=torch.int64, device=b.device)
    # distinct pairs set distinct bits of a word: their sum is their OR
    words.index_add_(0, (b * K + i) * W + j // 32,
                     torch.ones_like(j) << (j % 32))
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    return words.to(torch.int32).view(B, K, W)


def nms_overlap_plain(cand, valid, iou_threshold, max_pairs):
    """cand [B, K, 5] fp32 (sorted by descending score), valid [B, K] bool
    → (over bitmask [B, K, ceil(K / 32)] int32, pair count [B] int32): a
    bit for each of `capped_pairs` whose rotated IoU exceeds the threshold;
    the count is of `standup_maybe`'s pairs before the cap."""
    B, K = valid.shape
    b, lin, count = capped_pairs(cand, valid, iou_threshold, max_pairs)
    flat = cand.reshape(B * K, 5)
    iou = riou_pairs_plain(flat, flat, b * K + lin // K, b * K + lin % K)
    hit = iou > iou_threshold
    return pairs_to_bits(B, K, b[hit], lin[hit] // K, lin[hit] % K), count


def standup_overlap_plain(cand, valid, iou_threshold):
    """The strictly-upper `standup IoU > threshold` matrix of valid pairs,
    packed: cand [B, K, 4] xyxy → [B, K, ceil(K / 32)] int32 (the dense
    `standup_iou_matrix`, then `pack_bits`, a block of rows at a time)."""
    B, K = valid.shape
    cols = torch.arange(K, device=cand.device)
    out = [pack_bits((standup_iou_matrix(cand[:, r0:r1], cand) >
                      iou_threshold) &
                     (cols[None, :] > cols[r0:r1, None]) &
                     valid[:, r0:r1, None] & valid[:, None, :])
           for r0, r1 in row_blocks(B, K)]
    if not out:
        return torch.zeros((B, K, (K + 31) // 32), dtype=torch.int32,
                           device=cand.device)
    return torch.cat(out, 1)


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


def nms_suppress_walk_plain(over_bits, valid, rounds=None):
    """The suppression kernel's walk in plain PyTorch, the mirror the CPU
    tests hold to `nms_suppress_plain` and to JAX's greedy suppression:
    over bitmask [B, K, W] (strictly upper), valid [B, K] → keep [B, K].
    The rows go in words of 32. Each row's earlier rows of its own word
    that suppress it (the word's diagonal block transposed) are taken
    first. Word g is settled against the rows removed before it, by the
    kept rows of words g - 3 and earlier (the kernel's helpers, run ahead)
    and of words g - 2 and g - 1 (the walk's own ORs), by rounds: an open
    row is removed once a kept row suppresses it, kept once no row before
    it is open and none kept suppresses it. Then word g's kept rows remove
    their overlaps in the later words. `rounds`, a list where given, gets
    each word's rounds (0 where no row has an open predecessor in its
    word: the kernel then keeps the open rows without a round)."""
    B, K = valid.shape
    W = (K + 31) // 32
    pad = 32 * W - K
    over = torch.nn.functional.pad(unpack_bits(over_bits, K),
                                   (0, pad, 0, pad))
    vpad = torch.nn.functional.pad(valid, (0, pad))
    earlier = torch.ones(32, 32, dtype=torch.bool,
                         device=valid.device).tril(-1)
    keep = torch.zeros_like(vpad)
    for b in range(B):
        # the helpers' masks (words g + 3 on) and the walk's (words g + 1
        # and g + 2)
        removed = torch.zeros(W, 32, dtype=torch.bool, device=valid.device)
        ahead = torch.zeros_like(removed)
        for g in range(W):
            rows = slice(32 * g, 32 * g + 32)
            # pred[t, r]: row r of the word suppresses its row t
            pred = over[b, rows, rows].T & earlier
            open_ = vpad[b, rows] & ~(removed[g] | ahead[g])
            kept = torch.zeros_like(open_)
            n = 0
            if (pred & open_[None, :]).any():
                while open_.any():
                    newly = open_ & ~(pred & (kept | open_)).any(1)
                    gone = open_ & (pred & kept).any(1)
                    kept |= newly
                    open_ &= ~(newly | gone)
                    n += 1
            else:
                kept = open_
            if rounds is not None:
                rounds.append(n)
            keep[b, rows] = kept
            hit = over[b, rows][kept].any(0).view(W, 32)
            ahead[g + 1:g + 3] |= hit[g + 1:g + 3]
            removed[g + 3:] |= hit[g + 3:]
    return keep[:, :K]


def _check_batch(name, tensor, valid, inner):
    if valid.dim() != 2 or tensor.shape[:2] != valid.shape or \
            tuple(tensor.shape[2:]) != inner:
        raise ValueError(f"{name}: expected [B, K, {', '.join(map(str, inner))}]"
                         f" and valid [B, K] bool, got {tuple(tensor.shape)} "
                         f"and {tuple(valid.shape)}")
    if valid.dtype != torch.bool or valid.device != tensor.device:
        raise ValueError(f"{name}: valid must be bool on {tensor.device}")


def nms_overlap(cand, valid, iou_threshold, max_pairs, cluster=None):
    """`nms_overlap_plain` semantics; the CUDA kernel for CUDA tensors, with
    `cluster` blocks an example (default NMS_CLUSTER) up to NMS_MAX_K
    candidates, past it the wide route (which takes no cluster shape), up
    to ROTATED_MAX_K."""
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
    check_rotated_k("nms_overlap", valid.shape[1])
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
    nbytes = _scratch_bytes("nms_overlap_scratch",
                            [ctypes.c_int, ctypes.c_int], B, K)
    scratch = torch.empty((nbytes,), dtype=torch.uint8, device=dev) \
        if nbytes else None
    rc = (_overlap_launch or _resolve_overlap())(
        cand.data_ptr(), valid.data_ptr(), over.data_ptr(), maybe.data_ptr(),
        count.data_ptr(), scratch.data_ptr() if nbytes else None, B, K,
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
    """`nms_suppress_plain` semantics; the CUDA kernel for CUDA tensors (a
    wide kernel past NMS_MAX_K candidates; a removed mask of ceil(K / 32)
    words in the block's shared memory: K up to SUPPRESS_MAX_K)."""
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
    if K > SUPPRESS_MAX_K:
        raise ValueError(f"nms_suppress: {K} candidates an example; the "
                         f"kernel takes at most {SUPPRESS_MAX_K}")
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


# -------------------------------------------------------------- soft-NMS


def soft_nms_decay_plain(iou, scores, m, method="gaussian", sigma=0.5,
                         iou_threshold=0.3):
    """The decay steps of soft-NMS (JAX `soft_nms`'s `lax.scan`), every row
    at once: iou [R, K, K], scores [R, K] sorted by descending score (-inf
    an invalid candidate) → (picks [R, m] int64, their scores [R, m]). A
    step picks the highest current score (ties to the lowest index; a row
    of -inf picks 0), multiplies every finite score by the decay of its
    IoU with the pick, exp(-iou² / sigma) for "gaussian", else 1 - iou
    where iou > iou_threshold (1 elsewhere), keeps -inf at -inf (no
    -inf · 0), then sets the pick to -inf."""
    R = scores.shape[0]
    rows = torch.arange(R, device=scores.device)
    cur = scores.clone()
    picks, picked = [], []
    for _ in range(m):
        best = torch.argmax(cur, dim=1)
        picks.append(best)
        picked.append(cur[rows, best])
        row = iou[rows, best]
        if method == "gaussian":
            decay = torch.exp(-(row * row) / sigma)
        else:
            decay = torch.where(row > iou_threshold, 1.0 - row, 1.0)
        cur = torch.where(torch.isfinite(cur), cur * decay, float("-inf"))
        cur[rows, best] = float("-inf")
    if not m:
        return (torch.zeros((R, 0), dtype=torch.int64, device=scores.device),
                scores.new_zeros((R, 0)))
    return torch.stack(picks, 1), torch.stack(picked, 1)


def soft_nms_decay_standup_plain(cand, scores, m, method="gaussian",
                                 sigma=0.5, iou_threshold=0.3):
    """`soft_nms_decay_plain` over the candidates' standup IoU matrix
    (`standup_iou_matrix(cand, cand)`, JAX's at second_tpu/ops/nms.py:227):
    cand [R, K, 4] xyxy, scores [R, K] → (picks [R, m] int64, their scores
    [R, m])."""
    return soft_nms_decay_plain(standup_iou_matrix(cand, cand), scores, m,
                                method, sigma, iou_threshold)


def soft_nms_decay_standup(cand, scores, m, method="gaussian", sigma=0.5,
                           iou_threshold=0.3):
    """`soft_nms_decay_standup_plain` semantics; the CUDA kernel for CUDA
    tensors (fp32, every row in one launch; each step computes the pick's
    row of the standup IoU matrix, which is never built; past NMS_MAX_K
    candidates the wide kernel, its scores in a device scratch)."""
    refuse_grad("soft_nms_decay_standup", cand, scores)
    if scores.dim() != 2 or cand.shape != (*scores.shape, 4) or \
            not 0 <= m <= scores.shape[1]:
        raise ValueError(f"soft_nms_decay_standup: expected cand [R, K, 4], "
                         f"scores [R, K] and 0 <= m <= K, got "
                         f"{tuple(cand.shape)}, {tuple(scores.shape)}, {m}")
    dev = scores.device
    if dev.type == "cpu":
        return soft_nms_decay_standup_plain(cand, scores, m, method, sigma,
                                            iou_threshold)
    if dev.type != "cuda":
        raise ValueError(f"soft_nms_decay_standup: unsupported device {dev}")
    if cand.dtype != torch.float32 or scores.dtype != torch.float32 or \
            cand.device != dev:
        raise ValueError(f"soft_nms_decay_standup: expected cand and scores "
                         f"float32 on one device, got {cand.dtype} on "
                         f"{cand.device} and {scores.dtype} on {dev}")
    R, K = scores.shape
    if R > 2 ** 31 - 1 or K > 2 ** 31 - 1:
        raise ValueError(f"soft_nms_decay_standup: {R} rows of {K} "
                         f"candidates; the kernel takes at most 2^31 - 1 "
                         f"of each")
    picks = torch.empty((R, m), dtype=torch.int64, device=dev)
    picked = torch.empty((R, m), dtype=torch.float32, device=dev)
    if R * K * m == 0:
        return picks, picked
    cand, scores = cand.contiguous(), scores.contiguous()
    if cand.data_ptr() % 16:            # the kernel reads a box as a float4
        cand = cand.clone()
    per_row = _scratch_bytes("soft_nms_standup_scratch", [ctypes.c_int], K)
    scratch = torch.empty((R * per_row,), dtype=torch.uint8, device=dev) \
        if per_row else None
    rc = (_soft_standup_launch or _resolve_soft_standup())(
        cand.data_ptr(), scores.data_ptr(), picks.data_ptr(),
        picked.data_ptr(), scratch.data_ptr() if per_row else None, R, K, m,
        int(method == "gaussian"), sigma, iou_threshold, stream_ptr(dev))
    check("riou", rc)
    global launches_soft_standup
    launches_soft_standup += 1
    return picks, picked


def pair_matrix(plist, ok, iou, K):
    """The symmetric [B, K, K] matrix a capped pair list makes (JAX
    `_sparse_rotated_iou_matrix`'s scatter): plist [B, P] of i * K + j
    (i < j), ok [B, P], the pairs' values iou [B, P]; each ok value at
    (i, j) and (j, i) as `max(out, out.T)` leaves it (negatives 0, NaN
    kept), every other entry 0. The slots that are not ok all write 0 at
    entry 0, the diagonal."""
    B = plist.shape[0]
    iou = torch.where(ok, iou, 0.0)
    out = torch.zeros((B, K * K), dtype=iou.dtype, device=iou.device)
    out = out.scatter_(1, plist, iou).view(B, K, K)
    return torch.maximum(out, out.transpose(1, 2))


def soft_nms_decay_pairs_plain(plist, ok, iou, scores, m, method="gaussian",
                               sigma=0.5, iou_threshold=0.3):
    """`soft_nms_decay_plain` over the matrix the pairs make
    (`pair_matrix`): plist [R, P] int64, ok [R, P] bool, iou [R, P],
    scores [R, K] → (picks [R, m] int64, their scores [R, m])."""
    return soft_nms_decay_plain(pair_matrix(plist, ok, iou, scores.shape[1]),
                                scores, m, method, sigma, iou_threshold)


def soft_nms_decay_pairs(plist, ok, iou, scores, m, method="gaussian",
                         sigma=0.5, iou_threshold=0.3):
    """`soft_nms_decay_pairs_plain` semantics; the CUDA kernel for CUDA
    tensors (fp32, K <= ROTATED_MAX_K, every row in one launch; the pairs'
    adjacency in shared memory where it fits, else in a device scratch;
    past NMS_MAX_K candidates the wide route, its scores in the scratch).
    The kernel walks only the pairs, which relies on a 0 decaying nothing:
    it refuses a gaussian sigma of 0 or NaN, where exp(-0 / sigma) is
    NaN."""
    refuse_grad("soft_nms_decay_pairs", iou, scores)
    dev = scores.device
    if dev.type == "cpu":
        return soft_nms_decay_pairs_plain(plist, ok, iou, scores, m, method,
                                          sigma, iou_threshold)
    if dev.type != "cuda":
        raise ValueError(f"soft_nms_decay_pairs: unsupported device {dev}")
    if scores.dim() != 2 or plist.dim() != 2 \
            or plist.shape[0] != scores.shape[0] \
            or ok.shape != plist.shape or iou.shape != plist.shape \
            or plist.dtype != torch.int64 or ok.dtype != torch.bool \
            or iou.dtype != torch.float32 or scores.dtype != torch.float32 \
            or not (plist.device == ok.device == iou.device == dev):
        raise ValueError(
            f"soft_nms_decay_pairs: expected plist [R, P] int64, ok [R, P] "
            f"bool, iou [R, P] and scores [R, K] float32 on one device, got "
            f"{tuple(plist.shape)} {plist.dtype}, {tuple(ok.shape)} "
            f"{ok.dtype}, {tuple(iou.shape)} {iou.dtype}, "
            f"{tuple(scores.shape)} {scores.dtype}")
    R, K = scores.shape
    P = plist.shape[1]
    check_rotated_k("soft_nms_decay_pairs", K)
    if not 0 <= m <= K or P > 2 ** 28:
        raise ValueError(f"soft_nms_decay_pairs: {R} rows of {K} candidates "
                         f"and {P} pairs, {m} steps; the kernel takes m <= K "
                         f"and P <= 2^28")
    if method == "gaussian" and (math.isnan(sigma) or sigma == 0):
        raise ValueError(f"soft_nms_decay_pairs: sigma {sigma}: a 0 IoU "
                         f"would decay by NaN")
    picks = torch.empty((R, m), dtype=torch.int64, device=dev)
    picked = torch.empty((R, m), dtype=torch.float32, device=dev)
    if R * K * m == 0:
        return picks, picked
    per_row = soft_pairs_scratch(K, P)
    scratch = torch.empty((R * per_row,), dtype=torch.uint8, device=dev) \
        if per_row else None
    plist, ok, iou = plist.contiguous(), ok.contiguous(), iou.contiguous()
    scores = scores.contiguous()
    rc = (_soft_pairs_launch or _resolve_soft_pairs())(
        plist.data_ptr(), ok.data_ptr(), iou.data_ptr(), scores.data_ptr(),
        picks.data_ptr(), picked.data_ptr(),
        scratch.data_ptr() if per_row else None, R, K, P, m,
        int(method == "gaussian"), sigma, iou_threshold, stream_ptr(dev))
    check("riou", rc)
    global launches_soft_pairs
    launches_soft_pairs += 1
    return picks, picked
