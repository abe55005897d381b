"""Rotated ROI-align kernel wrappers: the two-stage detector's crops of the
RPN trunk (`csrc/roi_align.cu`), forward and backward.

`roi_align(feat, coords, samples)` crops feat [B, C, H, W] (bf16, fp32 or
fp64) at the sample coordinates coords [B, N, SH, SW, 2] (x, y in pixels;
`ops/roi_align_rotated.py` `sample_points` makes them from the rois) into
[B * N, C, SH / s, SW / s], each bin the mean of its s x s bilinear
samples, in the coordinates' dtype (fp32, or fp64 for fp64). It is
differentiable in both inputs: on a CUDA tensor a `torch.autograd.Function`
whose forward launches `roi_align_fwd` and whose backward launches the
backward kernels (`roi_align_bwd`: the map's gradient, fp32, and the
coordinates' gradient, deterministic); on a CPU tensor the plain version,
`roi_align_plain`, the vectorised gather JAX computes, under autograd.
`roi_align_bwd_cells_plain` is the backward's bookkeeping in plain PyTorch
(one key a sample, its cell; partial sums per (cell, corner); each pixel's
fixed-order sum of the partials whose corner it is), the mirror the CPU
tests hold to autograd and the card holds the kernel's counts to.

These kernels replace XLA code of the JAX package, not a Pallas kernel:
the gathers of `second_tpu/ops/roi_align_rotated.py:21-71` as
`crop_rois` (`second_tpu/models/second_stage.py:129`) runs them, and their
autodiff.
"""

from __future__ import annotations

import ctypes

import torch

from ..roi_align_rotated import bilinear_sample, bin_mean
from . import check, function, library, stream_ptr

# launches since the last reset (set to 0 to reset): of the forward kernel,
# and of the backward (one count for its kernels, a call)
launches = 0
launches_bwd = 0

# the map's dtype and the coordinates' it pairs with → the kernel's type code
_TYPES = {(torch.bfloat16, torch.float32): 0, (torch.float32, torch.float32): 1,
          (torch.float64, torch.float64): 2}
# feat, coords, out, type, B, C, H, W, N, oh, ow, s, stream
_FWD_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
# coords, keys, double, B, H, W, N, oh, ow, s, stream
_KEYS_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 8 + \
    [ctypes.c_void_p]
# feat, coords, grad, sorted, perm, gt, part, flags, head, keys,
# grad_feat, grad_coords, type, B, C, H, W, N, oh, ow, s, stream
_BWD_ARGTYPES = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 9 + \
    [ctypes.c_void_p]
_fwd_launch = None
_keys_launch = None
_bwd_launch = None
_chunks = None


def _resolve_fwd():
    global _fwd_launch
    _fwd_launch = function("roi_align", "roi_align_fwd", _FWD_ARGTYPES)
    return _fwd_launch


def _resolve_bwd():
    global _keys_launch, _bwd_launch, _chunks
    _keys_launch = function("roi_align", "roi_align_keys", _KEYS_ARGTYPES)
    _bwd_launch = function("roi_align", "roi_align_bwd", _BWD_ARGTYPES)
    _chunks = library("roi_align").roi_align_chunks
    _chunks.argtypes = [ctypes.c_longlong]
    _chunks.restype = ctypes.c_longlong
    return _bwd_launch


def roi_align_plain(feat, coords, samples):
    """feat [B, C, H, W], coords [B, N, SH, SW, 2] → [B * N, C, SH / s,
    SW / s]: `bilinear_sample` of every (roi, sample) point and all
    channels at once, then `bin_mean`; in the coordinates' dtype (a bf16
    map promotes). Differentiable by autograd."""
    B, N, SH, SW, _ = coords.shape
    C = feat.shape[1]
    bidx = torch.arange(B, device=feat.device).view(B, 1, 1, 1)
    sampled = bilinear_sample(feat.permute(0, 2, 3, 1), coords[..., 0],
                              coords[..., 1], bidx)   # [B, N, SH, SW, C]
    out = bin_mean(sampled, samples)                   # [B, N, oh, ow, C]
    return out.reshape(B * N, *out.shape[2:]).permute(0, 3, 1, 2)


def roi_align_backward_plain(feat, coords, grad, samples):
    """Autograd of `roi_align_plain` for the output gradient grad: (the
    map's gradient, in the map's dtype; the coordinates' gradient)."""
    with torch.enable_grad():
        f = feat.detach().requires_grad_(True)
        c = coords.detach().requires_grad_(True)
        out = roi_align_plain(f, c, samples)
        return torch.autograd.grad(out, (f, c), grad)


def sample_cells(coords, H: int, W: int):
    """coords [B, N, SH, SW, 2] → (keys [B * N * SH * SW] int64, the
    number of cells): each sample's cell (b, y0, x0), y0 = floor(y) in
    [-1, H - 1] and x0 = floor(x) in [-1, W - 1], as (b * (H + 1) + y0 + 1)
    * (W + 1) + x0 + 1, its taps the cell's four corners; the sentinel (the
    number of cells) where none of them lies inside. Decided on the floats,
    as the taps are."""
    B = coords.shape[0]
    x0 = torch.floor(coords[..., 0]).reshape(B, -1)
    y0 = torch.floor(coords[..., 1]).reshape(B, -1)
    inside = (x0 >= -1) & (x0 <= W - 1) & (y0 >= -1) & (y0 <= H - 1)
    b = torch.arange(B, device=coords.device).view(B, 1)
    cell = (b * (H + 1) + torch.where(inside, y0, 0.0).long() + 1) * \
        (W + 1) + torch.where(inside, x0, 0.0).long() + 1
    ncells = B * (H + 1) * (W + 1)
    return torch.where(inside, cell, ncells).reshape(-1), ncells


def cell_counts(keys, ncells: int):
    """(in-map samples, runs of one cell in the sorted keys): what the
    backward kernel counts."""
    inside = keys[keys < ncells]
    return int(inside.numel()), int(torch.unique(inside).numel())


def roi_align_bwd_cells_plain(feat, coords, grad, samples):
    """The backward kernel's bookkeeping in plain PyTorch: (the map's
    gradient [B, C, H, W] and the coordinates' gradient, in the
    coordinates' dtype; (in-map samples, cell runs)). Each sample's key is
    its cell (`sample_cells`); the keys are sorted stably; each sample's
    gradient row g / s^2 times each corner's bilinear weight is summed into
    a partial per (cell, corner) in sorted order; a pixel (y, x) sums
    corner 0 of cell (y, x), corner 1 of (y, x - 1), corner 2 of (y - 1, x)
    and corner 3 of (y - 1, x - 1) in that order. The coordinates' gradient
    of a sample is the sum over channels of g / s^2 ((v01 - v00)(1 - wy) +
    (v11 - v10) wy) for x and g / s^2 ((v10 - v00)(1 - wx) + (v11 - v01)
    wx) for y, v the four taps' values (0 outside the map)."""
    B, N, SH, SW, _ = coords.shape
    C, H, W = feat.shape[1:]
    s = samples
    dt = coords.dtype
    keys, ncells = sample_cells(coords, H, W)
    order = torch.sort(keys, stable=True).indices
    # each sample's gradient row, g / s^2 (times the reciprocal, as the
    # kernel takes it): the bin's row repeated s x s
    g = grad.permute(0, 2, 3, 1).repeat_interleave(s, 1) \
        .repeat_interleave(s, 2).reshape(-1, C) * (1.0 / (s * s))
    x, y = coords[..., 0].reshape(-1), coords[..., 1].reshape(-1)
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = x - x0, y - y0
    w = torch.stack([(1 - wx) * (1 - wy), wx * (1 - wy), (1 - wx) * wy,
                     wx * wy], -1)
    part = torch.zeros((ncells + 1, 4, C), dtype=dt, device=feat.device)
    part.index_add_(0, keys[order], g[order, None, :] * w[order, :, None])
    P = part[:ncells].view(B, H + 1, W + 1, 4, C)
    grad_feat = (((P[:, 1:, 1:, 0] + P[:, 1:, :-1, 1]) + P[:, :-1, 1:, 2]) +
                 P[:, :-1, :-1, 3]).permute(0, 3, 1, 2)
    # the four taps' values, 0 outside the map
    f = feat.to(dt).permute(0, 2, 3, 1)
    b = torch.arange(B, device=feat.device).repeat_interleave(N * SH * SW)
    v = []
    for dy in (0, 1):
        for dx in (0, 1):
            xt, yt = x0 + dx, y0 + dy
            inb = (xt >= 0) & (xt <= W - 1) & (yt >= 0) & (yt <= H - 1)
            xi = torch.where(inb, xt, 0.0).long()
            yi = torch.where(inb, yt, 0.0).long()
            v.append(torch.where(inb[:, None], f[b, yi, xi], 0.0))
    gx = (g * ((v[1] - v[0]) * (1 - wy)[:, None] +
               (v[3] - v[2]) * wy[:, None])).sum(-1)
    gy = (g * ((v[2] - v[0]) * (1 - wx)[:, None] +
               (v[3] - v[1]) * wx[:, None])).sum(-1)
    grad_coords = torch.stack([gx, gy], -1).view(coords.shape)
    return grad_feat, grad_coords, cell_counts(keys, ncells)


def _check(feat, coords, samples):
    dev = feat.device
    if feat.dim() != 4 or coords.dim() != 5 or coords.shape[-1] != 2:
        raise ValueError(f"roi_align: feat must be [B, C, H, W] and coords "
                         f"[B, N, SH, SW, 2], got {tuple(feat.shape)} and "
                         f"{tuple(coords.shape)}")
    if coords.device != dev or coords.shape[0] != feat.shape[0]:
        raise ValueError("roi_align: coords of another device or batch")
    code = _TYPES.get((feat.dtype, coords.dtype))
    if code is None:
        raise ValueError(f"roi_align: a {feat.dtype} map with {coords.dtype} "
                         f"coordinates; the kernel takes bf16 or fp32 with "
                         f"fp32, fp64 with fp64")
    B, N, SH, SW, _ = coords.shape
    if samples < 1 or SH % samples or SW % samples:
        raise ValueError(f"roi_align: {SH} x {SW} samples do not make bins "
                         f"of {samples} x {samples}")
    C, H, W = feat.shape[1:]
    if B * H * W >= 2 ** 31 or 4 * B * N * SH * SW >= 2 ** 31:
        raise ValueError(f"roi_align: {tuple(feat.shape)} map with "
                         f"{tuple(coords.shape)} samples is too large for "
                         f"the kernel's int32 indices")
    return code


def roi_align_fwd(feat, coords, samples):
    """The forward kernel on CUDA tensors (no autograd): [B * N, C, SH / s,
    SW / s] in the coordinates' dtype."""
    code = _check(feat, coords, samples)
    B, N, SH, SW, _ = coords.shape
    C, H, W = feat.shape[1:]
    oh, ow = SH // samples, SW // samples
    out = torch.empty((B * N, C, oh, ow), dtype=coords.dtype,
                      device=feat.device)
    if out.numel() == 0:
        return out
    feat, coords = feat.contiguous(), coords.contiguous()
    rc = (_fwd_launch or _resolve_fwd())(
        feat.data_ptr(), coords.data_ptr(), out.data_ptr(), code, B, C, H, W,
        N, oh, ow, samples, stream_ptr(feat.device))
    check("roi_align", rc)
    global launches
    launches += 1
    return out


def roi_align_bwd(feat, coords, grad, samples, counts=False):
    """The backward kernels on CUDA tensors: grad [B * N, C, oh, ow] (the
    coordinates' dtype) → (the map's gradient [B, C, H, W] in the
    coordinates' dtype, fp32 for a bf16 map; the coordinates' gradient),
    and with `counts` an int32 tensor (in-map samples, cell runs) as the
    kernel counted them. Bitwise the same from run to run: the samples are
    sorted by the cell they fall in (a stable sort of int32 keys, one a
    sample) and each gradient is summed in a fixed order, with no
    floating-point atomics (`roi_align_bwd_cells_plain` is its plain
    mirror)."""
    code = _check(feat, coords, samples)
    B, N, SH, SW, _ = coords.shape
    C, H, W = feat.shape[1:]
    oh, ow = SH // samples, SW // samples
    dev = feat.device
    if tuple(grad.shape) != (B * N, C, oh, ow) or grad.dtype != coords.dtype \
            or grad.device != dev:
        raise ValueError(f"roi_align_bwd: grad must be [{B * N}, {C}, {oh}, "
                         f"{ow}] {coords.dtype}, got {tuple(grad.shape)} "
                         f"{grad.dtype}")
    dt = coords.dtype
    grad_feat = torch.empty((B, C, H, W), dtype=dt, device=dev)
    grad_coords = torch.empty_like(coords, memory_format=torch.contiguous_format)
    ncells = B * (H + 1) * (W + 1)
    flags = torch.zeros((ncells + 2,), dtype=torch.int32, device=dev)
    if coords.numel() == 0:
        grad_feat.zero_()
        return (grad_feat, grad_coords, flags[ncells:]) if counts else \
            (grad_feat, grad_coords)
    feat, coords = feat.contiguous(), coords.contiguous()
    grad = grad.contiguous()
    launch = _bwd_launch or _resolve_bwd()
    stream = stream_ptr(dev)
    n = coords.numel() // 2
    keys = torch.empty((n,), dtype=torch.int32, device=dev)
    check("roi_align", _keys_launch(
        coords.data_ptr(), keys.data_ptr(), int(code == 2), B, H, W, N, oh,
        ow, samples, stream))
    sorted_keys, perm = torch.sort(keys, stable=True)
    chunks = _chunks(n)
    gt = torch.empty((B * N, oh * ow, C), dtype=dt, device=dev)
    part = torch.empty((ncells, 4, C), dtype=dt, device=dev)
    head = torch.empty((2, chunks, 4, C), dtype=dt, device=dev)
    run_keys = torch.empty((2, chunks), dtype=torch.int32, device=dev)
    check("roi_align", launch(
        feat.data_ptr(), coords.data_ptr(), grad.data_ptr(),
        sorted_keys.data_ptr(), perm.data_ptr(), gt.data_ptr(),
        part.data_ptr(), flags.data_ptr(), head.data_ptr(),
        run_keys.data_ptr(), grad_feat.data_ptr(), grad_coords.data_ptr(),
        code, B, C, H, W, N, oh, ow, samples, stream))
    global launches_bwd
    launches_bwd += 1
    if counts:
        return grad_feat, grad_coords, flags[ncells:]
    return grad_feat, grad_coords


class RoiAlign(torch.autograd.Function):
    """The kernels as an autograd Function: the map's gradient comes back
    in the map's dtype (the fp32 sums rounded once for a bf16 map)."""

    @staticmethod
    def forward(ctx, feat, coords, samples):
        ctx.save_for_backward(feat, coords)
        ctx.samples = samples
        return roi_align_fwd(feat, coords, samples)

    @staticmethod
    def backward(ctx, grad):
        feat, coords = ctx.saved_tensors
        grad_feat, grad_coords = roi_align_bwd(feat, coords,
                                               grad.to(coords.dtype),
                                               ctx.samples)
        return grad_feat.to(feat.dtype), grad_coords, None


def roi_align(feat, coords, samples):
    """`roi_align_plain` semantics: the kernels for CUDA tensors, the plain
    version for CPU tensors, differentiable either way."""
    dev = feat.device
    if dev.type == "cpu":
        return roi_align_plain(feat, coords, samples)
    if dev.type != "cuda":
        raise ValueError(f"roi_align: unsupported device {dev}")
    return RoiAlign.apply(feat, coords, samples)
