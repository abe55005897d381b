"""Rotated BEV IoU — the port of `second_tpu/ops/rotated_iou.py`.

The geometry here (corners, Sutherland-Hodgman clipping into 8 masked vertex
slots, shoelace area) is the plain PyTorch version of the rotated-IoU
kernel (`csrc/riou.cu`, wrappers in `ops/cuda/riou.py`): it computes on
whatever device its tensors lie on, with no kernel of its own.
`rotated_iou_matrix` is the public dense form and `d3_iou_matrix` its
batched 3-D form; both go through the kernel wrappers.
"""

from __future__ import annotations

import torch

from .box_ops import center_to_corner_box2d


def rbbox_to_corners(rbboxes):
    """[..., 5(x, y, w, l, yaw)] → [..., 4, 2]."""
    return center_to_corner_box2d(
        rbboxes[..., :2], rbboxes[..., 2:4], rbboxes[..., 4])


def _signed_area(quad):
    """Shoelace signed area of [..., 4, 2] quads."""
    x, y = quad[..., 0], quad[..., 1]
    xn, yn = torch.roll(x, -1, dims=-1), torch.roll(y, -1, dims=-1)
    return 0.5 * (x * yn - xn * y).sum(-1)


def _next_vertex(poly, cnt):
    """poly [..., S, 2] at the cyclic successor of each slot (slot cnt-1
    wraps to slot 0)."""
    S = poly.shape[-2]
    idx = torch.arange(S, device=poly.device)
    nxt_idx = torch.where(idx + 1 >= cnt[..., None], 0, idx + 1)
    return torch.gather(poly, -2, nxt_idx[..., None].expand(poly.shape))


def _clip_halfplane(poly, cnt, a, b, s):
    """Clip a masked polygon by the half-plane left/right of segment (a, b).

    poly: [..., 8, 2]; cnt: [...] int count; a, b: [..., 2]; s: [...] ±1
    winding sign of the clip quad. Returns (poly', cnt')."""
    S = poly.shape[-2]
    idx = torch.arange(S, device=poly.device)
    valid = idx < cnt[..., None]
    nxt = _next_vertex(poly, cnt)

    ab = b - a
    d_cur = s[..., None] * (
        ab[..., None, 0] * (poly[..., 1] - a[..., None, 1]) -
        ab[..., None, 1] * (poly[..., 0] - a[..., None, 0]))
    d_nxt = s[..., None] * (
        ab[..., None, 0] * (nxt[..., 1] - a[..., None, 1]) -
        ab[..., None, 1] * (nxt[..., 0] - a[..., None, 0]))
    inside_cur = d_cur >= 0
    inside_nxt = d_nxt >= 0

    denom = d_cur - d_nxt
    safe = torch.where(torch.abs(denom) < 1e-12, 1.0, denom)
    t = torch.clamp(d_cur / safe, 0.0, 1.0)
    ipt = poly + t[..., None] * (nxt - poly)

    emit_v = valid & inside_cur
    emit_i = valid & (inside_cur != inside_nxt)

    # interleave v0, i0, v1, i1, ... (keeps the cyclic order), then compact
    # the surviving vertices, in order, into slots [0, 8)
    verts16 = torch.stack([poly, ipt], dim=-2).reshape(
        *poly.shape[:-2], 2 * S, 2)
    valid16 = torch.stack([emit_v, emit_i], dim=-1).reshape(
        *emit_v.shape[:-1], 2 * S)
    pos = torch.cumsum(valid16.to(torch.int32), dim=-1) - 1
    slot = torch.where(valid16 & (pos < S), pos, S)
    out = torch.zeros(*poly.shape[:-2], S + 1, 2, dtype=poly.dtype,
                      device=poly.device)
    out.scatter_(-2, slot[..., None].expand(verts16.shape).long(), verts16)
    new_cnt = valid16.sum(-1).clamp(max=S)
    return out[..., :S, :], new_cnt


def _masked_shoelace(poly, cnt):
    """Area of the masked polygon [..., 8, 2] with cnt valid vertices."""
    S = poly.shape[-2]
    valid = torch.arange(S, device=poly.device) < cnt[..., None]
    nxt = _next_vertex(poly, cnt)
    cross = poly[..., 0] * nxt[..., 1] - nxt[..., 0] * poly[..., 1]
    cross = torch.where(valid, cross, 0.0)
    return 0.5 * torch.abs(cross.sum(-1))


def quad_intersection_area(q1, q2):
    """Intersection area of same-shape [..., 4, 2] convex quads."""
    S = 8
    pad = torch.zeros(*q1.shape[:-2], S - 4, 2, dtype=q1.dtype,
                      device=q1.device)
    poly = torch.cat([q1, pad], dim=-2)
    cnt = torch.full(q1.shape[:-2], 4, dtype=torch.int64, device=q1.device)
    s = torch.sign(_signed_area(q2))
    s = torch.where(s == 0, 1.0, s)
    for k in range(4):
        a = q2[..., k, :]
        b = q2[..., (k + 1) % 4, :]
        poly, cnt = _clip_halfplane(poly, cnt, a, b, s)
    return torch.where(cnt >= 3, _masked_shoelace(poly, cnt), 0.0)


def iou_from_inter(inter, area1, area2, criterion):
    if criterion == -1:
        denom = area1 + area2 - inter
    elif criterion == 0:
        denom = area1 + torch.zeros_like(inter)
    elif criterion == 1:
        denom = area2 + torch.zeros_like(inter)
    else:
        raise ValueError("criterion must be -1, 0, or 1")
    return inter / torch.clamp(denom, min=1e-12)


def rotated_iou_matrix(rbboxes1, rbboxes2, criterion=-1):
    """Pairwise rotated IoU of [N, 5] x [K, 5] BEV boxes → [N, K].

    criterion: -1 IoU, 0 inter/area1, 1 inter/area2. The rotated-IoU
    kernel on a CUDA tensor, its plain version on a CPU tensor."""
    from .cuda.riou import riou_matrix
    return riou_matrix(rbboxes1, rbboxes2, criterion)


def d3_iou_matrix(boxes1, boxes2):
    """Pairwise 3-D IoU of lidar boxes (x, y, z, w, l, h, yaw; z at the
    bottom): [B, N, 7] x [B, K, 7] → [B, N, K], or [N, 7] x [K, 7] → [N, K].
    BEV rotated intersection x vertical overlap over the union of the
    volumes. The 3-D rotated-IoU kernel on a CUDA tensor, its plain version
    on a CPU tensor."""
    from .cuda.riou import d3_iou
    if boxes1.dim() == 2:
        return d3_iou(boxes1[None], boxes2[None])[0]
    return d3_iou(boxes1, boxes2)


def standup_iou_matrix(boxes1, boxes2, eps=0.0):
    """Pairwise IoU of axis-aligned [..., N, 4] x [..., K, 4] xyxy boxes →
    [..., N, K]."""
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = rb - lt + eps
    inter = torch.where((wh > 0).all(-1), wh[..., 0] * wh[..., 1], 0.0)
    a1 = ((boxes1[..., 2] - boxes1[..., 0] + eps) *
          (boxes1[..., 3] - boxes1[..., 1] + eps))[..., :, None]
    a2 = ((boxes2[..., 2] - boxes2[..., 0] + eps) *
          (boxes2[..., 3] - boxes2[..., 1] + eps))[..., None, :]
    return torch.where(inter > 0, inter / (a1 + a2 - inter), 0.0)
