"""Sparse 3D convolution — the port of `second_tpu/ops/sparse_conv.py`:
its batch-native path (the `_b` functions), and its single-example public
functions (`lookup`, `subm_rulebook`, `subm_conv3d`, `downsample_coords`,
`sparse_conv3d`, `sparse_max_pool3d`, `densify`), each the B = 1 case of
its batched counterpart, so it runs through the same kernels on the card.

An active set is (coords [B, N, 3] zyx int32, features [B, N, C], valid
[B, N]) with static capacity N, kept sorted by linear key (invalid rows
last, keyed by the sentinel D*H*W).

The port keeps the semantics and drops the TPU mechanism. A rulebook is the
per-tap form (tap_idx [B, K, Q] int32, found [B, K, Q] bool): tap k of query
q is found iff its input site is in the grid, the query is valid, and the
site is active; tap_idx is then its row in the example's sorted active set
(0 where not found). It is built by `torch.searchsorted` over the batch-
flattened int64 keys b*(cells+1) + key, which is exact. Two things match
the JAX package exactly:

  * the tap order is `itertools.product` over (z, y, x), with the kernel
    origin at coords - k//2 (submanifold) or out*stride - pad (strided);
  * strided-conv capacity overflow keeps the rank-stratified subset of the
    active output sites (`downsample_coords_b`).

Applying a rulebook is the gather-GEMM kernel (`ops/cuda/subm.py`), an
autograd Function whose input gradient applies the same kernel with the
transposed rulebook (`transpose_rulebook_b`) and whose weight gradient is
the weight-gradient kernel; the rulebook's key checks and the active-set
sorts go through the row gather (`ops/cuda/gather.py`).
"""

from __future__ import annotations

import itertools
from typing import Tuple

import numpy as np
import torch

from ..device import constant
from .cuda.gather import flat_rows, gather_rows
from .cuda.subm import gather_gemm


def linearize(coords, grid_dhw):
    """zyx coords [..., 3] → int64 linear keys for a (D, H, W) grid."""
    D, H, W = grid_dhw
    c = coords.long()
    return (c[..., 0] * H + c[..., 1]) * W + c[..., 2]


def sentinel(grid_dhw) -> int:
    D, H, W = grid_dhw
    return int(D * H * W)


class _RowsWithGrad(torch.autograd.Function):
    """`flat_rows(features, idx)` (the row-gather kernel on the card) with a
    gradient: the rows' gradients summed back into their sources by
    `index_add_`, as XLA's transpose of JAX's gather scatters them. The
    active-set sort and the max pool gather features through it: an
    encoder with parameters trains through the sort."""

    @staticmethod
    def forward(ctx, features, idx):
        ctx.save_for_backward(idx)
        ctx.shape = features.shape
        return flat_rows(features, idx)

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        B, N, C = ctx.shape
        off = (torch.arange(B, device=idx.device) * N).reshape(
            (B,) + (1,) * (idx.dim() - 1))
        dx = grad.new_zeros((B * N, C))
        dx.index_add_(0, (idx.long() + off).reshape(-1), grad.reshape(-1, C))
        return dx.reshape(B, N, C), None


def sort_active(coords, features, valid, grid_dhw):
    """Sort each example's active set by linear key, invalid rows last.

    coords [B, N, 3], features [B, N, C], valid [B, N] → (coords, features,
    valid, keys [B, N] int64) in sorted order."""
    sen = sentinel(grid_dhw)
    keys = torch.where(valid, linearize(coords, grid_dhw), sen)
    keys, order = torch.sort(keys, dim=1, stable=True)
    return (flat_rows(coords, order), _RowsWithGrad.apply(features, order),
            keys < sen, keys)


def _offsets(kernel_size: Tuple[int, int, int]) -> np.ndarray:
    return np.array(list(itertools.product(
        *(range(k) for k in kernel_size))), np.int32)      # [K, 3] zyx


def build_rulebook_b(keys_sorted, base_coords, base_valid, grid_dhw,
                     kernel_size):
    """Per-tap rulebook of queries whose kernel origin (tap (0, 0, 0)) is
    base_coords [B, Q, 3], over the sorted active set keys_sorted [B, N].

    Returns (tap_idx [B, K, Q] int32, found [B, K, Q] bool), K taps in
    itertools.product order."""
    B, N = keys_sorted.shape
    dev = keys_sorted.device
    cells = sentinel(grid_dhw)
    boff = torch.arange(B, device=dev, dtype=torch.int64) * (cells + 1)
    flat = (keys_sorted + boff[:, None]).reshape(-1)        # sorted globally
    offs = constant(_offsets(tuple(int(k) for k in kernel_size)), dev)
    grid = constant(grid_dhw, dev, torch.int32)
    ic = base_coords[:, None, :, :] + offs[None, :, None, :]   # [B, K, Q, 3]
    inb = ((ic >= 0) & (ic < grid)).all(-1) & base_valid[:, None, :]
    query = torch.where(inb, linearize(ic, grid_dhw), cells) + \
        boff[:, None, None]
    pos = torch.searchsorted(flat, query.reshape(-1)).clamp_(max=B * N - 1)
    hit = gather_rows(flat[:, None], pos)[:, 0] == query.reshape(-1)
    found = inb & hit.reshape(inb.shape)
    row = pos.reshape(inb.shape) - \
        (torch.arange(B, device=dev) * N)[:, None, None]
    tap_idx = torch.where(found, row, 0).to(torch.int32)
    return tap_idx, found


def transpose_rulebook_b(tap_idx, found, n_in: int):
    """The rulebook of a conv's input gradient: for each input row n and tap
    k, the query q whose tap k found n. tap_idx/found [B, K, Q] → (inv_idx
    [B, K, n_in] int32, inv_found [B, K, n_in] bool), by one scatter
    inv[b, k, tap_idx[b, k, q]] = q where found.

    Exact and deterministic: for a fixed tap, q ↦ input row is injective
    (the row's site is q's site · stride − pad + the tap's offset, and a
    conv's valid queries have distinct sites), so no two writes meet; the
    not-found entries all go to a dump slot past n_in, dropped. The same
    code serves the submanifold and the strided convs; for a submanifold
    conv the result is the forward rulebook with its taps reversed."""
    B, K, Q = tap_idx.shape
    dev = tap_idx.device
    dest = torch.where(found, tap_idx.long(), n_in)
    q = torch.arange(Q, dtype=torch.int32, device=dev).expand(B, K, Q)
    inv_idx = torch.zeros((B, K, n_in + 1), dtype=torch.int32, device=dev)
    inv_idx.scatter_(2, dest, torch.where(found, q, 0))
    inv_found = torch.zeros((B, K, n_in + 1), dtype=torch.bool, device=dev)
    inv_found.scatter_(2, dest, found)
    return inv_idx[..., :n_in], inv_found[..., :n_in]


def subm_rulebook_b(coords, keys_sorted, valid, grid_dhw,
                    kernel_size=(3, 3, 3)):
    """Submanifold rulebook: built once per stage, shared by every
    submanifold conv over the same active set."""
    base = coords - constant(np.array(kernel_size, np.int32) // 2,
                             coords.device)
    return build_rulebook_b(keys_sorted, base, valid, grid_dhw, kernel_size)


def _round_kernel(K: int) -> Tuple[int, int, int]:
    k = round(K ** (1 / 3))
    if k * k * k == K:
        return (k, k, k)
    raise ValueError(f"cannot infer kernel size from K={K}")


def subm_conv3d_b(features, coords, keys_sorted, valid, grid_dhw, weights,
                  bias=None, rulebook=None):
    """Submanifold conv: features [B, N, Cin] → [B, N, Cout] fp32, zero on
    invalid rows. weights [K, Cin, Cout], K = k³ taps in product order."""
    if rulebook is None:
        rulebook = subm_rulebook_b(coords, keys_sorted, valid, grid_dhw,
                                   _round_kernel(weights.shape[0]))
    out = gather_gemm(features, rulebook[0], rulebook[1], weights)
    if bias is not None:
        out = out + bias
    return torch.where(valid[..., None], out, 0.0)


def out_grid(grid_dhw, kernel_size, stride, padding):
    """Output grid (D, H, W) of a strided sparse conv."""
    g, k, s, p = (np.array(v, np.int64) for v in
                  (grid_dhw, kernel_size, stride, padding))
    return tuple(int(v) for v in (g + 2 * p - k) // s + 1)


def downsample_coords_b(coords, valid, grid_dhw, kernel_size, stride,
                        padding, out_cap):
    """Active output sites of a strided sparse conv, per example.

    Returns (out_coords [B, M, 3] int32 sorted, out_valid [B, M], out_keys
    [B, M] int64, out_grid, n_unique [B]) with M = out_cap. n_unique is the
    number of active output sites before the capacity cut. Over capacity,
    slot = rank * out_cap // n_unique keeps one site per equal-width stratum
    of the sorted keys (the largest key of each), not the smallest keys."""
    dev = coords.device
    B = coords.shape[0]
    og = out_grid(grid_dhw, kernel_size, stride, padding)
    out_sen = sentinel(og)
    k_t = constant(kernel_size, dev, torch.int32)
    s_t = constant(stride, dev, torch.int32)
    og_t = constant(og, dev, torch.int32)
    # each input site reaches ceil(k/s) output sites per dimension:
    # with c' = c + p, tap (c' mod s) + j*s < k gives output (c' div s) - j
    reps = [-(-int(k) // int(s)) for k, s in zip(kernel_size, stride)]
    cprime = coords + constant(padding, dev, torch.int32)
    base = torch.div(cprime, s_t, rounding_mode="floor")
    rem = cprime - base * s_t
    cand = []
    for j in itertools.product(*(range(r) for r in reps)):
        jv = constant(j, dev, torch.int32)
        oc = base - jv
        tap_ok = ((rem + jv * s_t) < k_t).all(-1)
        inb = ((oc >= 0) & (oc < og_t)).all(-1)
        good = tap_ok & inb & valid
        cand.append(torch.where(good, linearize(oc, og), out_sen))
    keys = torch.sort(torch.cat(cand, dim=1), dim=1).values  # [B, R*N]
    is_first = torch.cat(
        [keys[:, :1] < out_sen,
         (keys[:, 1:] != keys[:, :-1]) & (keys[:, 1:] < out_sen)], dim=1)
    pos = torch.cumsum(is_first, dim=1) - 1
    n_uni = is_first.sum(1)
    ncl = torch.clamp(n_uni, min=1)[:, None]
    slot = torch.where(n_uni[:, None] > out_cap, (pos * out_cap) // ncl, pos)
    scatter_to = torch.where(is_first & (slot < out_cap), slot, out_cap)
    kept = torch.zeros((B, out_cap + 1), dtype=torch.int64, device=dev)
    kept.scatter_reduce_(1, scatter_to, torch.where(is_first, keys, 0),
                         reduce="amax")
    n_slots = torch.clamp(n_uni, max=out_cap)[:, None]
    out_valid = torch.arange(out_cap, device=dev)[None, :] < n_slots
    out_keys = torch.where(out_valid, kept[:, :out_cap], out_sen)
    D, H, W = og
    zyx = torch.stack([out_keys // (H * W), (out_keys // W) % H,
                       out_keys % W], -1).to(torch.int32)
    out_coords = torch.where(out_valid[..., None], zyx, 0)
    return out_coords, out_valid, out_keys, og, n_uni.to(torch.int32)


def sparse_conv3d_b(features, coords, keys_sorted, valid, grid_dhw, weights,
                    kernel_size, stride, padding, out_cap, bias=None,
                    precomputed=None):
    """Strided sparse conv. Returns (out [B, M, Cout] fp32, out_coords
    [B, M, 3], out_keys [B, M], out_valid [B, M], out_grid, n_unique [B]).
    `precomputed` (the tuple `downsample_coords_b` returns) reuses the
    output sites."""
    if precomputed is None:
        precomputed = downsample_coords_b(coords, valid, grid_dhw,
                                          kernel_size, stride, padding,
                                          out_cap)
    out_coords, out_valid, out_keys, og, n_unique = precomputed
    dev = coords.device
    base = out_coords * constant(stride, dev, torch.int32) - \
        constant(padding, dev, torch.int32)
    tap_idx, found = build_rulebook_b(keys_sorted, base, out_valid, grid_dhw,
                                      tuple(int(k) for k in kernel_size))
    out = gather_gemm(features, tap_idx, found, weights)
    if bias is not None:
        out = out + bias
    out = torch.where(out_valid[..., None], out, 0.0)
    return out, out_coords, out_keys, out_valid, og, n_unique


def densify_b(features, coords, valid, grid_dhw):
    """Scatter active sets [B, N, C] to dense [B, D, H, W, C] canvases."""
    B, N, C = features.shape
    D, H, W = grid_dhw
    cells = D * H * W
    dev = features.device
    keys = linearize(coords, grid_dhw) + \
        (torch.arange(B, device=dev) * cells)[:, None]
    keys = torch.where(valid, keys, B * cells)
    canvas = torch.zeros((B * cells + 1, C), dtype=features.dtype,
                         device=dev)
    canvas[keys.reshape(-1)] = features.reshape(B * N, C)
    return canvas[:B * cells].reshape(B, D, H, W, C)


def sparse_max_pool3d_b(features, coords, keys_sorted, valid, grid_dhw,
                        kernel_size, out_cap, stride=None,
                        padding=(0, 0, 0)):
    """Sparse max pool, stride the kernel unless given (JAX
    `sparse_max_pool3d_b`). Returns (out [B, M, C] in the feature dtype,
    out_coords [B, M, 3], out_keys [B, M], out_valid [B, M], out_grid,
    n_unique [B]) with M = out_cap: the output sites and their capacity cut
    are the strided conv's (`downsample_coords_b`), each valid site takes
    the max over the taps it found (`amax`: tied entries share the gradient
    evenly, as JAX's reduce-max does), invalid sites are zero."""
    kernel_size = tuple(int(k) for k in kernel_size)
    stride = kernel_size if stride is None else tuple(int(s) for s in stride)
    out_coords, out_valid, out_keys, og, n_unique = downsample_coords_b(
        coords, valid, grid_dhw, kernel_size, stride, padding, out_cap)
    dev = coords.device
    base = out_coords * constant(stride, dev, torch.int32) - \
        constant(padding, dev, torch.int32)
    tap_idx, found = build_rulebook_b(keys_sorted, base, out_valid, grid_dhw,
                                      kernel_size)
    rows = _RowsWithGrad.apply(features, tap_idx)         # [B, K, M, C]
    neg = torch.finfo(features.dtype).min
    out = torch.where(found[..., None], rows, neg).amax(1)
    out = torch.where(out_valid[..., None], out, 0.0)
    return out, out_coords, out_keys, out_valid, og, n_unique


# ------------------------------------------- single-example functions (JAX's)


def lookup(keys_sorted, query_keys, query_valid):
    """Binary-search query keys in one example's sorted (sentinel-padded)
    keys [N]. Returns (idx [Q] int32 clamped to N - 1, found [Q] bool), as
    JAX's `lookup`."""
    idx = torch.searchsorted(keys_sorted, query_keys.to(keys_sorted.dtype))
    idx = idx.clamp_(max=keys_sorted.shape[0] - 1)
    hit = gather_rows(keys_sorted[:, None], idx)[:, 0] == query_keys
    return idx.to(torch.int32), hit & query_valid


def subm_rulebook(coords, keys_sorted, valid, grid_dhw,
                  kernel_size=(3, 3, 3)):
    """One example's submanifold rulebook: (tap_idx [K, N] int32, found
    [K, N] bool), the port's per-tap form (`subm_rulebook_b` at B = 1), not
    JAX's window slabs; `subm_conv3d` takes it as its `rulebook`."""
    tap_idx, found = subm_rulebook_b(coords[None], keys_sorted[None],
                                     valid[None], grid_dhw, kernel_size)
    return tap_idx[0], found[0]


def subm_conv3d(features, coords, keys_sorted, valid, grid_dhw, weights,
                bias=None, rulebook=None):
    """Submanifold conv of one example: features [N, Cin] → [N, Cout] fp32,
    zero on invalid rows; weights [K, Cin, Cout] with K = k³ taps (any k).
    `rulebook` is `subm_rulebook`'s."""
    if rulebook is not None:
        rulebook = (rulebook[0][None], rulebook[1][None])
    return subm_conv3d_b(features[None], coords[None], keys_sorted[None],
                         valid[None], grid_dhw, weights, bias, rulebook)[0]


def downsample_coords(coords, valid, grid_dhw, kernel_size, stride, padding,
                      out_cap):
    """One example's active output sites of a strided sparse conv: (out_coords
    [M, 3] int32 sorted, out_valid [M], out_keys [M], out_grid, n_unique
    (a 0-d int32 tensor)), as JAX's `downsample_coords`."""
    oc, ov, ok, og, nu = downsample_coords_b(
        coords[None], valid[None], grid_dhw, kernel_size, stride, padding,
        out_cap)
    return oc[0], ov[0], ok[0], og, nu[0]


def sparse_conv3d(features, coords, keys_sorted, valid, grid_dhw, weights,
                  kernel_size, stride, padding, out_cap, bias=None,
                  precomputed=None):
    """Strided sparse conv of one example: (out [M, Cout] fp32, out_coords,
    out_keys, out_valid, out_grid, n_unique), as JAX's `sparse_conv3d`;
    `precomputed` is `downsample_coords`'s tuple."""
    if precomputed is not None:
        oc, ov, ok, og, nu = precomputed
        precomputed = (oc[None], ov[None], ok[None], og, nu[None])
    out, oc, ok, ov, og, nu = sparse_conv3d_b(
        features[None], coords[None], keys_sorted[None], valid[None],
        grid_dhw, weights, kernel_size, stride, padding, out_cap, bias,
        precomputed)
    return out[0], oc[0], ok[0], ov[0], og, nu[0]


def sparse_max_pool3d(features, coords, keys_sorted, valid, grid_dhw,
                      kernel_size, out_cap, stride=None, padding=(0, 0, 0)):
    """Sparse max pool of one example (stride the kernel unless given): (out
    [M, C], out_coords, out_keys, out_valid, out_grid, n_unique), as JAX's
    `sparse_max_pool3d`."""
    out, oc, ok, ov, og, nu = sparse_max_pool3d_b(
        features[None], coords[None], keys_sorted[None], valid[None],
        grid_dhw, kernel_size, out_cap, stride, padding)
    return out[0], oc[0], ok[0], ov[0], og, nu[0]


def densify(features, coords, valid, grid_dhw, batch_idx=None):
    """Scatter one example's active set [N, C] to a dense [D, H, W, C]
    canvas. `batch_idx` is taken and unused, as in JAX's `densify`."""
    return densify_b(features[None], coords[None], valid[None],
                     grid_dhw)[0]
