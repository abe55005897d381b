"""Rotated ROI-align on BEV feature maps — the port of
`second_tpu/ops/roi_align_rotated.py` (`bilinear_sample`,
`roi_align_rotated`, `boxes_to_bev_rois`), plus the batched form the
two-stage detector crops with (`roi_align_batched`).

Box-aligned rotated windows are sampled bilinearly and averaged per output
bin. `bilinear_sample` and `roi_align_rotated` keep JAX's layout (one map
[H, W, C], rois [R, 5] in pixels, crops [R, oh, ow, C]) and are plain
PyTorch, differentiable by autograd. `roi_align_batched` takes the RPN
trunk as it comes, [B, C, H, W], and rois [B, N, 5]: `sample_points` turns
the rois into sample coordinates in differentiable PyTorch, and the
hand-written kernel (`ops/cuda/roi_align.py`) crops them on the card; on
the CPU its plain version, the same vectorised gather as JAX's.

A tap outside the map contributes 0. Whether it lies inside is decided on
the floats (floor(x) against [0, W - 1]) before any integer conversion,
so a proposal far off the map, or one with non-finite coordinates, reads
nothing (JAX clips its int32 indices and masks them, which gives the same
values for every finite coordinate).
"""

from __future__ import annotations

from typing import Tuple

import torch


def bilinear_sample(feat, xs, ys, batch=None):
    """Bilinear sampling of feat at continuous pixel coords (x = column,
    y = row); a tap outside the map contributes 0 * its weight.

    feat [H, W, C] with xs, ys [...]; or feat [B, H, W, C] with `batch`, an
    integer tensor broadcastable to xs naming each point's example.
    Returns [..., C]: the four taps summed in JAX's order, each value
    times its fp32 weight (a bf16 map promotes to fp32)."""
    H, W = feat.shape[-3:-1]
    x0 = torch.floor(xs)
    y0 = torch.floor(ys)
    wx = xs - x0
    wy = ys - y0

    def tap(yf, xf, w):
        inb = (xf >= 0) & (xf <= W - 1) & (yf >= 0) & (yf <= H - 1)
        xi = torch.where(inb, xf, 0.0).long()
        yi = torch.where(inb, yf, 0.0).long()
        v = feat[yi, xi] if batch is None else feat[batch, yi, xi]
        return torch.where(inb[..., None], v, 0.0) * w[..., None]

    return (tap(y0, x0, (1 - wx) * (1 - wy)) +
            tap(y0, x0 + 1, wx * (1 - wy)) +
            tap(y0 + 1, x0, (1 - wx) * wy) +
            tap(y0 + 1, x0 + 1, wx * wy))


def bin_mean(sampled, samples):
    """[..., oh * s, ow * s, C] samples → [..., oh, ow, C]: each bin's
    s x s samples summed row by row, then divided by s * s."""
    *lead, sh, sw, C = sampled.shape
    x = sampled.reshape(*lead, sh // samples, samples, sw // samples,
                        samples, C)
    acc = None
    for sy in range(samples):
        for sx in range(samples):
            v = x[..., sy, :, sx, :]
            acc = v if acc is None else acc + v
    return acc / (samples * samples)


def _centers(n, s, like):
    """Sample-center offsets in [-0.5, 0.5), `s` per bin over n bins."""
    return (torch.arange(n * s, dtype=like.dtype, device=like.device) +
            0.5) / (n * s) - 0.5


def sample_points(rois, out_size: Tuple[int, int] = (14, 14),
                  samples: int = 2):
    """rois [..., 5] (cx, cy, w, l, yaw) in pixels → the sample coordinates
    [..., oh * s, ow * s, 2] (x, y): the box footprint rotated by yaw
    (clockwise positive; local +x spans w, +y spans l), as JAX computes
    them. Differentiable in the rois."""
    oh, ow = out_size
    u = _centers(ow, samples, rois)                         # local x / w
    v = _centers(oh, samples, rois)                         # local y / l
    uu = u[None, :].expand(oh * samples, -1)
    vv = v[:, None].expand(-1, ow * samples)
    lx = uu * rois[..., 2, None, None]
    ly = vv * rois[..., 3, None, None]
    c = torch.cos(rois[..., 4])[..., None, None]
    s_ = torch.sin(rois[..., 4])[..., None, None]
    # p_world = p_local @ [[c, -s], [s, c]]
    gx = rois[..., 0, None, None] + lx * c + ly * s_
    gy = rois[..., 1, None, None] - lx * s_ + ly * c
    return torch.stack([gx, gy], dim=-1)


def roi_align_rotated(feat, rois, out_size: Tuple[int, int] = (14, 14),
                      samples: int = 2):
    """Box-aligned rotated crops of one map, JAX's layout.

    feat [H, W, C] with row = y-bin, col = x-bin; rois [R, 5] (cx, cy, w, l,
    yaw) in pixels. Returns [R, oh, ow, C] (each bin the mean of its
    samples² bilinear taps). Plain PyTorch."""
    pts = sample_points(rois, out_size, samples)
    return bin_mean(bilinear_sample(feat, pts[..., 0], pts[..., 1]),
                    samples)


def roi_align_batched(trunk, rois, out_size: Tuple[int, int] = (14, 14),
                      samples: int = 2):
    """Crops of a batch: trunk [B, C, H, W] (bf16, fp32 or fp64), rois
    [B, N, 5] in pixels → [B * N, C, oh, ow], fp32 (fp64 for fp64), the
    refine head's input. The rotated ROI-align kernel on a CUDA tensor,
    its plain version on a CPU tensor; differentiable in the trunk and the
    rois either way."""
    from .cuda.roi_align import roi_align
    return roi_align(trunk, sample_points(rois, out_size, samples), samples)


def boxes_to_bev_rois(boxes, pc_range, out_stride, voxel_size):
    """Lidar boxes [..., 7] → ROI tuples [..., 5] in BEV feature-map pixels
    (row = y bin, col = x bin, pixel size voxel_size * out_stride)."""
    px = (boxes[..., 0] - pc_range[0]) / (voxel_size[0] * out_stride)
    py = (boxes[..., 1] - pc_range[1]) / (voxel_size[1] * out_stride)
    pw = boxes[..., 3] / (voxel_size[0] * out_stride)
    pl = boxes[..., 4] / (voxel_size[1] * out_stride)
    return torch.stack([px, py, pw, pl, boxes[..., 6]], dim=-1)
