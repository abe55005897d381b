"""Sparse middle extractors — the port of `second_tpu/models/sparse_middle.py`:
the blocks (`MaskedBatchNorm`, `SubMBlock`, `SparseBasicBlock`,
`SparseBottleneck`, `DownBlock`, `MaxPoolBlock`), the fixed middles
(`SparseMiddleFHD`, `SparseMiddleFHDLite`, `SparseMiddleResNetFHD`), the
op-spec `SparseMiddleStack` with its seven registry entries, and
`SparseMiddleExtractor`.

Activations are batched active sets (coords, features, valid, keys) of
static capacity; every sparse conv applies through the gather-GEMM kernel,
at any width.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from ..device import at_least_fp32
from ..ops import sparse_conv as sp
from ..parallel.mesh import global_moments
from .middle import register_middle


def _sparse_kernel(K, cin, cout):
    """A sparse conv's [K, cin, cout] kernel."""
    return nn.Parameter(torch.empty(K, cin, cout))


class MaskedBatchNorm(nn.Module):
    """BatchNorm over the valid rows of [B, N, C] active-set features, in
    fp32 whatever the input dtype (fp64 stays fp64, as `at_least_fp32`);
    invalid rows come out zero. Training
    normalises with the masked batch statistics (the valid-row count
    clamped to 1, the biased variance) and updates the running statistics
    as ra = 0.99 · ra + 0.01 · stat, as JAX's does
    (`second_tpu/models/sparse_middle.py:42-50`), over the whole batch of
    all the ranks in a data-parallel step (`global_moments`); eval uses the
    running statistics."""

    MOMENTUM = 0.99                     # flax's: the running share kept

    def __init__(self, channels, eps=1e-3):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x, mask):
        out_dtype = x.dtype
        x = at_least_fp32(x)
        m = mask[..., None].to(x.dtype)
        if self.training:
            mean, var = global_moments(x, (0, 1), mask)
            with torch.no_grad():
                keep = self.MOMENTUM
                self.running_mean.mul_(keep).add_((1 - keep) * mean)
                self.running_var.mul_(keep).add_((1 - keep) * var)
        else:
            mean, var = self.running_mean, self.running_var
        y = (x - mean) * torch.rsqrt(var + self.eps)
        y = (y * self.weight + self.bias) * m
        return y.to(out_dtype)


class SubMBlock(nn.Module):
    """SubMConv3d(k=3) → masked BN → ReLU."""

    def __init__(self, in_channels, features):
        super().__init__()
        self.weight = _sparse_kernel(27, in_channels, features)
        self.bn = MaskedBatchNorm(features)

    def forward(self, feats, coords, keys, valid, grid_dhw, rulebook):
        out = sp.subm_conv3d_b(feats, coords, keys, valid, grid_dhw,
                               self.weight, rulebook=rulebook)
        out = self.bn(out, valid)
        return (torch.relu(out) * valid[..., None]).to(feats.dtype)


class SparseBasicBlock(nn.Module):
    """Residual submanifold block: SubM → BN → ReLU → SubM → BN, plus the
    input (through the 1x1 `proj` where the widths differ), → ReLU. The
    dtypes flow as JAX's: the first conv takes the block's input dtype, the
    second the fp32 output of the first norm, and the block casts back to
    its input dtype at its end; `proj` is a plain product in the input
    dtype (`feats @ w.astype(in_dtype)`, outside any Pallas kernel in
    JAX)."""

    def __init__(self, in_channels, features):
        super().__init__()
        self.proj = None if in_channels == features else \
            nn.Parameter(torch.empty(in_channels, features))
        self.kernel0 = _sparse_kernel(27, in_channels, features)
        self.kernel1 = _sparse_kernel(27, features, features)
        self.bn0 = MaskedBatchNorm(features)
        self.bn1 = MaskedBatchNorm(features)

    def kernels(self):
        """The block's kernels in flax's order of creation."""
        return [k for k in (self.proj, self.kernel0, self.kernel1)
                if k is not None]

    def forward(self, feats, coords, keys, valid, grid_dhw, rulebook):
        in_dtype = feats.dtype
        residual = feats if self.proj is None else \
            feats @ self.proj.to(in_dtype)
        out = sp.subm_conv3d_b(feats, coords, keys, valid, grid_dhw,
                               self.kernel0, rulebook=rulebook)
        out = torch.relu(self.bn0(out, valid))
        out = sp.subm_conv3d_b(out, coords, keys, valid, grid_dhw,
                               self.kernel1, rulebook=rulebook)
        out = torch.relu(self.bn1(out, valid) + residual.to(out.dtype))
        return (out * valid[..., None]).to(in_dtype)


class SparseBottleneck(nn.Module):
    """Residual bottleneck block, expansion 4: 1x1 → BN → ReLU → SubM 3x3 →
    BN → ReLU → 1x1 → BN, plus the input (through `proj` where the widths
    differ), → ReLU. The 1x1 convs are plain products in the dtype of
    their input, as JAX's; the 3x3 is the gather-GEMM."""

    EXPANSION = 4

    def __init__(self, in_channels, features):
        super().__init__()
        cout = features * self.EXPANSION
        self.proj = None if in_channels == cout else \
            nn.Parameter(torch.empty(in_channels, cout))
        self.kernel1x1_a = nn.Parameter(torch.empty(in_channels, features))
        self.kernel3x3 = _sparse_kernel(27, features, features)
        self.kernel1x1_b = nn.Parameter(torch.empty(features, cout))
        self.bn0 = MaskedBatchNorm(features)
        self.bn1 = MaskedBatchNorm(features)
        self.bn2 = MaskedBatchNorm(cout)

    def kernels(self):
        """The block's kernels in flax's order of creation."""
        return [k for k in (self.proj, self.kernel1x1_a, self.kernel3x3,
                            self.kernel1x1_b) if k is not None]

    def forward(self, feats, coords, keys, valid, grid_dhw, rulebook):
        in_dtype = feats.dtype
        residual = feats if self.proj is None else \
            feats @ self.proj.to(in_dtype)
        out = torch.relu(self.bn0(feats @ self.kernel1x1_a.to(in_dtype),
                                  valid))
        out = sp.subm_conv3d_b(out, coords, keys, valid, grid_dhw,
                               self.kernel3x3, rulebook=rulebook)
        out = torch.relu(self.bn1(out, valid))
        out = self.bn2(out @ self.kernel1x1_b.to(out.dtype), valid)
        out = torch.relu(out + residual.to(out.dtype))
        return (out * valid[..., None]).to(in_dtype)


class DownBlock(nn.Module):
    """SparseConv3d(stride) → masked BN → ReLU; emits a new active set and
    the number of active output sites cut by the capacity."""

    def __init__(self, in_channels, features, kernel_size=(3, 3, 3),
                 stride=(2, 2, 2), padding=(1, 1, 1)):
        super().__init__()
        self.kernel_size = tuple(kernel_size)
        self.stride = tuple(stride)
        self.padding = tuple(padding)
        K = int(np.prod(self.kernel_size))
        self.weight = _sparse_kernel(K, in_channels, features)
        self.bn = MaskedBatchNorm(features)

    def forward(self, feats, coords, keys, valid, grid_dhw, out_cap):
        out, oc, ok, ov, out_grid, nu = sp.sparse_conv3d_b(
            feats, coords, keys, valid, grid_dhw, self.weight,
            self.kernel_size, self.stride, self.padding, out_cap)
        overflow = torch.clamp(nu - out_cap, min=0).sum()
        out = self.bn(out, ov)
        out = (torch.relu(out) * ov[..., None]).to(feats.dtype)
        return out, oc, ok, ov, out_grid, overflow


class MaxPoolBlock(nn.Module):
    """Sparse max pool (stride = kernel, no padding); emits a new active
    set and the number of active output sites cut by the capacity, as
    `DownBlock` does."""

    def __init__(self, kernel_size=(2, 1, 1)):
        super().__init__()
        self.kernel_size = tuple(int(k) for k in kernel_size)
        self.stride = self.kernel_size
        self.padding = (0, 0, 0)

    def forward(self, feats, coords, keys, valid, grid_dhw, out_cap):
        out, oc, ok, ov, out_grid, nu = sp.sparse_max_pool3d_b(
            feats, coords, keys, valid, grid_dhw, self.kernel_size, out_cap)
        overflow = torch.clamp(nu - out_cap, min=0).sum()
        return out, oc, ok, ov, out_grid, overflow


def _to_bev(feats, coords, valid, grid):
    """Active set → dense BEV map [B, D*C, H, W] (channel index d*C + c)."""
    dense = sp.densify_b(feats, coords, valid, grid)        # [B, D, H, W, C]
    B, D, H, W, C = dense.shape
    return dense.permute(0, 1, 4, 2, 3).reshape(B, D * C, H, W)


def _round_cap(n: float, multiple: int = 1024) -> int:
    """Round a stage capacity up to a multiple of 1024."""
    return max(multiple, int(-(-n // multiple)) * multiple)


# Per-stage active-site capacity as a fraction of the input voxel capacity:
# the strided convs shrink LiDAR-scan active sets (1.0 → 0.84 → 0.40 → 0.17
# → 0.17 of N at fhd resolution), so the stages are sized to that profile
# with headroom. Truncation shows in each DownBlock's overflow count.
FHD_CAP_FACTORS = (1.0, 0.75, 0.375, 0.25)


def _fhd_downs(channels):
    """The four strided convs of the fhd family, by output width: (3, 3, 3)
    stride 2 twice, then with padding (0, 1, 1), then (3, 1, 1) stride
    (2, 1, 1) with no padding. Returns DownBlocks from `channels[0]` in."""
    cin = channels[0]
    specs = [dict(), dict(), dict(padding=(0, 1, 1)),
             dict(kernel_size=(3, 1, 1), stride=(2, 1, 1),
                  padding=(0, 0, 0))]
    downs = []
    for c, kw in zip(channels[1:], specs):
        downs.append(DownBlock(cin, c, **kw))
        cin = c
    return nn.ModuleList(downs)


def _bev_channels(grid, downs, channels):
    """BEV channels D*C of `channels`-wide features after `downs` from
    `grid`."""
    for d in downs:
        grid = sp.out_grid(grid, d.kernel_size, d.stride, d.padding)
    return grid[0] * channels


class SparseMiddleFHD(nn.Module):
    """SpMiddleFHD: SubM×2(16) → down(32) → SubM×2(32) → down(64) →
    SubM×3(64) → down(64, pad (0,1,1)) → SubM×3(64) → down (3,1,1)/(2,1,1)
    → dense BEV map [B, D*C, H, W] (channel index d*C + c).

    output_shape: dense zyx grid (D, H, W) = voxel grid + (1, 0, 0)."""

    def __init__(self, output_shape: Sequence[int], num_input_features=4,
                 channels: Sequence[int] = (16, 32, 64, 64, 64),
                 cap_factors: Sequence[float] = FHD_CAP_FACTORS,
                 dtype=None):
        super().__init__()
        self.grid0 = tuple(int(v) for v in output_shape)
        self.cap_factors = tuple(cap_factors)
        self.dtype = dtype
        c16, c32, c64, c64b, c64c = channels
        subm = [(num_input_features, c16), (c16, c16), (c32, c32),
                (c32, c32), (c64, c64), (c64, c64), (c64, c64),
                (c64b, c64b), (c64b, c64b), (c64b, c64b)]
        self.subm = nn.ModuleList(SubMBlock(i, o) for i, o in subm)
        self.down = _fhd_downs(tuple(channels))
        self.stage_subm = (2, 2, 3, 3)
        self.out_channels = _bev_channels(self.grid0, self.down, c64c)

    def forward(self, voxel_features, coords, valid):
        """voxel_features [B, N, C], coords [B, N, 3] zyx, valid [B, N] →
        (bev [B, D*C, H, W], stage_overflow scalar tensor)."""
        N = voxel_features.shape[1]
        caps = [_round_cap(N * f) for f in self.cap_factors]
        if self.dtype is not None:
            voxel_features = voxel_features.to(self.dtype)
        grid = self.grid0
        coords, feats, valid, keys = sp.sort_active(coords, voxel_features,
                                                    valid, grid)
        overflow = torch.zeros((), dtype=torch.int64, device=feats.device)
        j = 0
        for stage, n_subm in enumerate(self.stage_subm):
            rb = sp.subm_rulebook_b(coords, keys, valid, grid)
            for _ in range(n_subm):
                feats = self.subm[j](feats, coords, keys, valid, grid, rb)
                j += 1
            feats, coords, keys, valid, grid, ovf = self.down[stage](
                feats, coords, keys, valid, grid, caps[stage])
            overflow = overflow + ovf
        return _to_bev(feats, coords, valid, grid), overflow


class SparseMiddleFHDLite(nn.Module):
    """SpMiddleFHDLite: the fhd family's four strided convs with no
    submanifold conv between them (16, 32, 64, 64 wide), → dense BEV map
    [B, D*C, H, W]. Stage capacities as `SparseMiddleFHD`'s."""

    def __init__(self, output_shape: Sequence[int], num_input_features=4,
                 channels: Sequence[int] = (16, 32, 64, 64),
                 cap_factors: Sequence[float] = FHD_CAP_FACTORS,
                 dtype=None):
        super().__init__()
        self.grid0 = tuple(int(v) for v in output_shape)
        self.cap_factors = tuple(cap_factors)
        self.dtype = dtype
        self.down = _fhd_downs((num_input_features,) + tuple(channels))
        self.out_channels = _bev_channels(self.grid0, self.down, channels[3])

    def forward(self, voxel_features, coords, valid):
        N = voxel_features.shape[1]
        caps = [_round_cap(N * f) for f in self.cap_factors]
        if self.dtype is not None:
            voxel_features = voxel_features.to(self.dtype)
        grid = self.grid0
        coords, feats, valid, keys = sp.sort_active(coords, voxel_features,
                                                    valid, grid)
        overflow = torch.zeros((), dtype=torch.int64, device=feats.device)
        for cap, down in zip(caps, self.down):
            feats, coords, keys, valid, grid, ovf = down(
                feats, coords, keys, valid, grid, cap)
            overflow = overflow + ovf
        return _to_bev(feats, coords, valid, grid), overflow


class SparseMiddleResNetFHD(nn.Module):
    """SpMiddleResNetFHD: one `SparseBasicBlock` before each of the fhd
    family's four strided convs (16 → down 32 → 32 → down 64 → 64 → down
    64 → 64 → down 64), → dense BEV map [B, D*C, H, W]. Stage capacities as
    `SparseMiddleFHD`'s."""

    def __init__(self, output_shape: Sequence[int], num_input_features=4,
                 channels: Sequence[int] = (16, 32, 64, 64, 64),
                 cap_factors: Sequence[float] = FHD_CAP_FACTORS,
                 dtype=None):
        super().__init__()
        self.grid0 = tuple(int(v) for v in output_shape)
        self.cap_factors = tuple(cap_factors)
        self.dtype = dtype
        ins = (num_input_features,) + tuple(channels[1:4])
        self.res = nn.ModuleList(SparseBasicBlock(i, o) for i, o in
                                 zip(ins, channels[:4]))
        self.down = _fhd_downs(tuple(channels))
        self.out_channels = _bev_channels(self.grid0, self.down, channels[4])

    def forward(self, voxel_features, coords, valid):
        N = voxel_features.shape[1]
        caps = [_round_cap(N * f) for f in self.cap_factors]
        if self.dtype is not None:
            voxel_features = voxel_features.to(self.dtype)
        grid = self.grid0
        coords, feats, valid, keys = sp.sort_active(coords, voxel_features,
                                                    valid, grid)
        overflow = torch.zeros((), dtype=torch.int64, device=feats.device)
        for cap, res, down in zip(caps, self.res, self.down):
            rb = sp.subm_rulebook_b(coords, keys, valid, grid)
            feats = res(feats, coords, keys, valid, grid, rb)
            feats, coords, keys, valid, grid, ovf = down(
                feats, coords, keys, valid, grid, cap)
            overflow = overflow + ovf
        return _to_bev(feats, coords, valid, grid), overflow


class SparseMiddleStack(nn.Module):
    """A sparse middle driven by an op spec (JAX `SparseMiddleStack`):

        ("subm", ch)                         SubMConv3d(k=3) + BN + ReLU
        ("res", ch)                          SparseBasicBlock
        ("bottleneck", ch)                   SparseBottleneck (4 ch out)
        ("down", ch, kernel, stride, pad)    SparseConv3d + BN + ReLU
        ("maxpool", kernel)                  SparseMaxPool3d

    → dense BEV map [B, D*C, H, W]. Every down and max-pool step has the
    capacity int(N · cap_factor), not rounded; one submanifold rulebook
    serves the convs of a stage until a down or max-pool step ends it. The
    blocks sit in one ModuleList per kind, in op order (`subm`, `res`,
    `bottleneck`, `down`, `maxpool`), as flax numbers them per class."""

    KINDS = ("subm", "res", "bottleneck", "down", "maxpool")

    def __init__(self, output_shape: Sequence[int], ops=(),
                 num_input_features=4, cap_factor=1.0):
        super().__init__()
        self.grid0 = tuple(int(v) for v in output_shape)
        self.ops = tuple(ops)
        self.cap_factor = float(cap_factor)
        blocks = {k: [] for k in self.KINDS}
        grid, c = self.grid0, num_input_features
        for op in self.ops:
            kind = op[0]
            if kind == "subm":
                blocks[kind].append(SubMBlock(c, op[1]))
                c = op[1]
            elif kind == "res":
                blocks[kind].append(SparseBasicBlock(c, op[1]))
                c = op[1]
            elif kind == "bottleneck":
                blocks[kind].append(SparseBottleneck(c, op[1]))
                c = op[1] * SparseBottleneck.EXPANSION
            elif kind == "down":
                _, ch, kernel, stride, pad = op
                d = DownBlock(c, ch, kernel, stride, pad)
                blocks[kind].append(d)
                grid = sp.out_grid(grid, d.kernel_size, d.stride, d.padding)
                c = ch
            elif kind == "maxpool":
                m = MaxPoolBlock(op[1])
                blocks[kind].append(m)
                grid = sp.out_grid(grid, m.kernel_size, m.stride, m.padding)
            else:
                raise ValueError(f"unknown sparse-middle op {op!r}")
        for kind in self.KINDS:
            setattr(self, kind, nn.ModuleList(blocks[kind]))
        self.out_channels = grid[0] * c

    def forward(self, voxel_features, coords, valid):
        cap = int(voxel_features.shape[1] * self.cap_factor)
        grid = self.grid0
        coords, feats, valid, keys = sp.sort_active(coords, voxel_features,
                                                    valid, grid)
        overflow = torch.zeros((), dtype=torch.int64, device=feats.device)
        nth = dict.fromkeys(self.KINDS, 0)
        rb = None
        for op in self.ops:
            kind = op[0]
            block = getattr(self, kind)[nth[kind]]
            nth[kind] += 1
            if kind in ("down", "maxpool"):
                feats, coords, keys, valid, grid, ovf = block(
                    feats, coords, keys, valid, grid, cap)
                overflow = overflow + ovf
                rb = None
                continue
            if rb is None:
                rb = sp.subm_rulebook_b(coords, keys, valid, grid)
            feats = block(feats, coords, keys, valid, grid, rb)
        return _to_bev(feats, coords, valid, grid), overflow


def partial_stack(ops):
    """A middle-registry entry that builds a SparseMiddleStack with a fixed
    op spec (one entry per reference middle class)."""
    ops = tuple(tuple(tuple(x) if isinstance(x, (list, tuple)) else x
                      for x in op) for op in ops)

    def make(**kwargs):
        kwargs.setdefault("ops", ops)
        return SparseMiddleStack(**kwargs)
    return make


_K3, _S2, _P1, _P011 = (3, 3, 3), (2, 2, 2), (1, 1, 1), (0, 1, 1)
_KZ, _SZ, _P0 = (3, 1, 1), (2, 1, 1), (0, 0, 0)

# the op specs of JAX's registry (`second_tpu/models/sparse_middle.py:464-508`)
register_middle("SpMiddleD4HD", partial_stack((
    ("subm", 32), ("subm", 32), ("down", 64, _K3, _S2, _P1),
    ("subm", 64), ("subm", 64), ("subm", 64), ("down", 64, _K3, _S2, _P011),
    ("subm", 64), ("subm", 64), ("subm", 64), ("down", 64, _KZ, _SZ, _P0))))
register_middle("SpResNetD4HD", partial_stack((
    ("subm", 32), ("res", 32), ("res", 32), ("down", 64, _K3, _S2, _P1),
    ("res", 64), ("res", 64), ("down", 64, _K3, _S2, _P011),
    ("res", 64), ("res", 64), ("down", 64, _KZ, _SZ, _P0))))
register_middle("SpMiddleD4HDLite", partial_stack((
    ("subm", 16), ("subm", 16), ("down", 32, _K3, _S2, _P1),
    ("subm", 32), ("subm", 32), ("subm", 32), ("down", 64, _K3, _S2, _P011),
    ("subm", 64), ("subm", 64), ("subm", 64), ("down", 64, _KZ, _SZ, _P0))))
register_middle("SpMiddleD8HD", partial_stack((
    ("subm", 16), ("subm", 16), ("down", 32, _K3, _S2, _P1),
    ("subm", 32), ("subm", 32), ("subm", 32), ("down", 64, _K3, _S2, _P1),
    ("subm", 64), ("subm", 64), ("subm", 64), ("down", 64, _K3, _S2, _P011),
    ("subm", 64), ("subm", 64), ("subm", 64), ("down", 64, _KZ, _SZ, _P0))))
register_middle("SpMiddleFHDV2", partial_stack((
    ("subm", 16), ("subm", 16), ("down", 32, _K3, _S2, _P1),
    ("subm", 32), ("subm", 32), ("down", 64, _K3, _S2, _P1),
    ("subm", 64), ("subm", 64), ("subm", 64), ("down", 64, _K3, _S2, _P011),
    ("subm", 64), ("subm", 64), ("subm", 64), ("down", 64, _KZ, _SZ, _P0),
    ("maxpool", (2, 1, 1)))))
register_middle("SpMiddle2K", partial_stack((
    ("subm", 8), ("subm", 8), ("down", 16, _K3, _S2, _P1),
    ("subm", 16), ("subm", 16), ("down", 32, _K3, _S2, _P1),
    ("subm", 32), ("subm", 32), ("down", 64, _K3, _S2, _P1),
    ("subm", 64), ("subm", 64), ("subm", 64), ("down", 64, _K3, _S2, _P011),
    ("subm", 64), ("subm", 64), ("subm", 64), ("down", 64, _KZ, _SZ, _P0))))
register_middle("SpMiddleFHDLarge", partial_stack((
    ("subm", 16), ("subm", 16), ("down", 32, _K3, _S2, _P1),
    ("subm", 32), ("subm", 32), ("down", 64, _K3, _S2, _P1),
    ("subm", 64), ("subm", 64), ("subm", 64), ("down", 128, _K3, _S2, _P011),
    ("subm", 128), ("subm", 128), ("subm", 128),
    ("down", 128, _KZ, _SZ, _P0))))


def make_sparse_middle_extractor(output_shape, num_input_features=4,
                                 num_filters_down1=(), num_filters_down2=(),
                                 cap_factor=1.0, in_channels=None):
    """The original SECOND `SparseMiddleExtractor`: submanifold chains of
    the config's widths, each ended by a z-only strided conv. As in JAX,
    `num_input_features` (the config's) is the first strided conv's width
    where `num_filters_down1` is empty; `in_channels` is the width of the
    features that come in (the encoder's output; `num_input_features`
    where not given)."""
    ops = []
    last = num_input_features
    for ch in num_filters_down1 or ():
        ops.append(("subm", int(ch)))
        last = int(ch)
    ops.append(("down", last, _KZ, _SZ, _P0))
    for ch in num_filters_down2 or ():
        ops.append(("subm", int(ch)))
        last = int(ch)
    ops.append(("down", last, _KZ, _SZ, _P0))
    return SparseMiddleStack(
        output_shape, ops=tuple(ops),
        num_input_features=num_input_features if in_channels is None
        else in_channels, cap_factor=cap_factor)


register_middle("SparseMiddleExtractor", make_sparse_middle_extractor)
register_middle("SpMiddleFHD", SparseMiddleFHD)
register_middle("SpMiddleFHDLite", SparseMiddleFHDLite)
register_middle("SpMiddleResNetFHD", SparseMiddleResNetFHD)
