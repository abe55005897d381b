"""The port's hand-written CUDA kernels against their plain PyTorch versions
on the card. Marked `cuda`: they skip where there is no CUDA card (the CPU
has no nvcc and no kernel), and run on the card with

    python -m pytest -m cuda tests/test_torch_cuda.py -q

The main path's shapes are checked by `chip_smoke.py`; these are small
shapes with the edges (row widths, index types, channel counts, tap counts,
fills, tiles across examples, criteria, candidate counts, pair caps,
cluster shapes, ties) the kernels branch on, and the sparse conv's
backward: the weight-gradient kernel against its plain version, the input
gradient through the transposed rulebook and the weight gradient against
autograd of the plain gather-GEMM, and the sparse middle's weights getting
their gradients on the card. Then PointPillars at full width: the eval
forward card against CPU, the in-graph anchors mask against the host mask,
and the kernel launches of its eval forward and train step; the two-stage
refine card against CPU; and the temporal detector on second_car_fhd.config:
its forward card against CPU with both frames in one backbone call, a
train step's gradients reaching the gate, and the sequence model against
the pair model. This file
imports torch, numpy and the port only, and the 3-D IoU cull's geometry
cases from `test_torch_d3_cull.py` (which add hypothesis)."""

import copy
from pathlib import Path

import numpy as np
import pytest
import torch

from second_tpu_torch.config import load_pipeline_config
from second_tpu_torch.data import ExamplePrep, PrepConfig, lidar_scan_scene
from second_tpu_torch.data.synthetic import SyntheticDataset
from second_tpu_torch.models import (build_voxelnet, calibrate_norms_, detect,
                                     init_train_weights_, predict)
from second_tpu_torch.models.sparse_middle import (DownBlock,
                                                  SparseMiddleFHD, SubMBlock)
from second_tpu_torch.ops import nms
from second_tpu_torch.ops import sparse_conv as sp
from second_tpu_torch.ops.anchors_mask import anchors_mask_from_coords
from second_tpu_torch.ops.cuda import gather, riou, subm
from second_tpu_torch.ops.voxelize import VoxelizeSpec, device_voxelize
from second_tpu_torch.train.optimizer import build_optimizer
from second_tpu_torch.train.state import TrainState, make_train_step

from test_torch_d3_cull import CASES as D3_CASES
from test_torch_d3_cull import d3_case

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    # full-fp32 plain products: no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("dtype,width", [
    (torch.float32, 4), (torch.float32, 7), (torch.bfloat16, 4),
    (torch.bfloat16, 3), (torch.int64, 1), (torch.int32, 3),
    (torch.uint8, 5)])
def test_gather_rows_exact(dev, dtype, width):
    g = torch.Generator().manual_seed(0)
    src = (torch.randn(500, width, generator=g) * 100).to(dtype).to(dev)
    idx = torch.randint(0, 500, (777,), generator=g).to(dev)
    before = gather.launches
    got = gather.gather_rows(src, idx)
    assert gather.launches == before + 1
    assert torch.equal(got, gather.gather_rows_plain(src, idx))


@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
def test_gather_rows_index_dtypes_large(dev, idx_dtype):
    """8-byte rows (the rulebook key checks) at about 300 k rows, a row count
    that is not a multiple of the rows a block takes (1024); the indices go
    in as they are, int32 or int64."""
    g = torch.Generator().manual_seed(4)
    R, M = 160_000, 300_001
    src = torch.randint(-2 ** 62, 2 ** 62, (R, 1), generator=g).to(dev)
    idx = torch.randint(0, R, (M,), generator=g).to(idx_dtype).to(dev)
    idx[0], idx[-1] = 0, R - 1
    got = gather.gather_rows(src, idx)
    torch.cuda.synchronize()
    assert torch.equal(got, gather.gather_rows_plain(src, idx))


@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("dtype,width", [(torch.float32, 7),
                                         (torch.int32, 3),
                                         (torch.bfloat16, 4)])
def test_gather_rows_index_dtypes_rows(dev, idx_dtype, dtype, width):
    """Rows of several units (28, 12 and 8 bytes), both index types, a
    source that starts off the 16-byte grid (narrower units)."""
    g = torch.Generator().manual_seed(5)
    rows = (torch.randn(3001, width, generator=g) * 100).to(dtype)
    buf = torch.empty(rows.numel() + 1, dtype=dtype, device=dev)
    src = torch.as_strided(buf, rows.shape, (width, 1), 1).copy_(rows)
    assert src.is_contiguous() and src.data_ptr() % 16
    idx = torch.randint(0, 3001, (5000,), generator=g).to(idx_dtype).to(dev)
    got = gather.gather_rows(src, idx)
    assert torch.equal(got, gather.gather_rows_plain(src, idx))


def test_gather_rows_empty(dev):
    src = torch.ones(10, 3, device=dev)
    before = gather.launches
    for dtype in (torch.int32, torch.int64):
        got = gather.gather_rows(src, torch.zeros(0, dtype=dtype, device=dev))
        assert got.shape == (0, 3)
    assert gather.launches == before


def test_gather_rows_rejects_float_indices(dev):
    with pytest.raises(ValueError, match="int32 or int64"):
        gather.gather_rows(torch.ones(4, 2, device=dev),
                           torch.zeros(3, device=dev))


def test_flat_rows_exact(dev):
    g = torch.Generator().manual_seed(1)
    src = torch.randn(3, 40, 6, generator=g).to(dev)
    idx = torch.randint(0, 40, (3, 5, 7), generator=g).to(dev)
    got = gather.flat_rows(src, idx)
    want = torch.stack([src[b][idx[b]] for b in range(3)])
    assert torch.equal(got, want)


def _rulebook(g, B, N, K, Q, fill):
    tap_idx = torch.randint(0, N, (B, K, Q), generator=g, dtype=torch.int32)
    found = torch.rand((B, K, Q), generator=g) < fill
    return tap_idx, found


def _conv_case(dev, dtype, B, N, Q, K, C, D, fill, seed=2):
    g = torch.Generator().manual_seed(seed)
    feats = torch.randn(B, N, C, generator=g).to(dtype).to(dev)
    w = (torch.randn(K, C, D, generator=g) / np.sqrt(K * C)).to(dev)
    tap_idx, found = (t.to(dev) for t in _rulebook(g, B, N, K, Q, fill))
    return feats, tap_idx, found, w


def _run_conv(feats, tap_idx, found, w):
    """The kernel against the plain version (fp32 sums of the same
    bf16-rounded products in another order: atol/rtol 1e-4), and the path
    the dtype must take: bf16 the tensor cores, fp32 the CUDA cores."""
    mma, fma = subm.launches_mma, subm.launches_fma
    got = subm.gather_gemm(feats, tap_idx, found, w)
    want = subm.gather_gemm_plain(feats, tap_idx, found, w)
    B, _, _ = feats.shape
    assert got.dtype == torch.float32
    assert got.shape == (B, tap_idx.shape[2], w.shape[2])
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    if feats.dtype == torch.bfloat16:
        assert (subm.launches_mma, subm.launches_fma) == (mma + 1, fma)
    else:
        assert (subm.launches_mma, subm.launches_fma) == (mma, fma + 1)
    return got, want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K,C,D", [(27, 4, 16), (27, 16, 32), (27, 64, 64),
                                   (3, 64, 64), (27, 5, 7)])
def test_gather_gemm_matches_plain(dev, dtype, K, C, D):
    """fp32 sums of the same (bf16-rounded) products in another order:
    atol/rtol 1e-4."""
    g = torch.Generator().manual_seed(2)
    B, N, Q = 2, 300, 333
    feats = torch.randn(B, N, C, generator=g).to(dtype).to(dev)
    w = (torch.randn(K, C, D, generator=g) / np.sqrt(K * C)).to(dev)
    tap_idx, found = (t.to(dev) for t in _rulebook(g, B, N, K, Q, 0.3))
    got = subm.gather_gemm(feats, tap_idx, found, w)
    want = subm.gather_gemm_plain(feats, tap_idx, found, w)
    assert got.dtype == torch.float32 and got.shape == (B, Q, D)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K", [3, 27])
@pytest.mark.parametrize("C", [4, 5, 16, 32, 64])
@pytest.mark.parametrize("D", [7, 16, 32, 64])
def test_gather_gemm_widths(dev, dtype, K, C, D):
    """Every channel width the kernels branch on, at an fhd-like fill (5% of
    the taps found). Q = 400 is a multiple of 16 but not of the 128-row
    tile: tiles inside one example read the found bytes as vectors, the tile
    across examples 0 and 1 and the ragged last tile read them byte by
    byte."""
    _run_conv(*_conv_case(dev, dtype, 3, 350, 400, K, C, D, 0.05))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fill", [0.0, 1.0])
@pytest.mark.parametrize("K,C,D", [(27, 4, 16), (27, 32, 32), (3, 64, 64),
                                   (27, 5, 7), (27, 64, 64)])
def test_gather_gemm_fill(dev, dtype, fill, K, C, D):
    """No tap found (every tap skipped: all zeros out) and every tap found
    (no tap skipped)."""
    got, _ = _run_conv(*_conv_case(dev, dtype, 2, 200, 333, K, C, D, fill))
    if fill == 0.0:
        assert not got.any()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("C", [16, 4, 6])
def test_gather_gemm_unaligned_features(dev, C, dtype):
    """Features that start off the 16-byte grid: the bf16 kernel gathers 8
    bytes a copy, or element by element, instead of 16; the fp32 kernel
    one float a copy."""
    feats, tap_idx, found, w = _conv_case(dev, dtype, 2, 100, 256, 27, C,
                                          16, 0.2)
    buf = torch.empty(feats.numel() + 1, dtype=feats.dtype, device=dev)
    off = torch.as_strided(buf, feats.shape, feats.stride(), 1)
    off.copy_(feats)
    assert off.data_ptr() % 8
    _run_conv(off, tap_idx, found, w)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gather_gemm_tile_spans_examples(dev, dtype):
    """Q = 100: every 128-row tile but the first crosses from one example
    into the next, so rows of one tile index different examples' features."""
    _run_conv(*_conv_case(dev, dtype, 5, 64, 100, 27, 16, 16, 0.3))


# widths past 128: CP a multiple of 64 (200 -> 256 columns, 136 -> 192,
# 384 stays 384; a tap over several stages), outputs split over up to 8
# blocks, [C, D] in up to 64 weight-gradient tiles
ANY_WIDTH = [(256, 256), (200, 136), (136, 200), (512, 64), (64, 512),
             (384, 384)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,D", ANY_WIDTH)
def test_gather_gemm_any_width(dev, dtype, C, D):
    """C and D past 128, the kernels' generic instantiations: the forward,
    dX (the same kernel on a rulebook over the outputs with the weights
    [K, D, C] as a transposed view, D channels in and C out) and the weight
    gradient, each against its plain version (fp32 also against fp64
    within FP32_ERR_RATIO of the fp32 plain version's own error)."""
    args = _conv_case(dev, dtype, 2, 300, 333, 27, C, D, 0.1, seed=C + D)
    got, _ = _run_conv(*args)
    if dtype == torch.float32:
        err, plain_err = _fp64_errors(*args, got)
        assert err <= FP32_ERR_RATIO * plain_err + FP32_ERR_FLOOR
    g = torch.Generator().manual_seed(C * D)
    dout = torch.randn(2, 300, D, generator=g).to(dtype).to(dev)
    inv_idx, inv_found = (t.to(dev) for t in _rulebook(g, 2, 300, 27, 333,
                                                        0.1))
    wt = args[3].transpose(1, 2)
    before = subm.launches_dgrad
    dx = subm.gather_gemm_dgrad(dout, inv_idx, inv_found, wt)
    assert subm.launches_dgrad == before + 1 and dx.shape == (2, 333, C)
    torch.testing.assert_close(dx, subm.gather_gemm_plain(
        dout, inv_idx, inv_found, wt), atol=1e-4, rtol=1e-4)
    if dtype == torch.float32:
        err, plain_err = _fp64_errors(dout, inv_idx, inv_found, wt, dx)
        assert err <= FP32_ERR_RATIO * plain_err + FP32_ERR_FLOOR
    wargs = _wgrad_case(dev, dtype, 2, 300, 333, 27, C, D, 0.1,
                        seed=abs(C - D) + 7)
    dw, _ = _run_wgrad(*wargs)
    if dtype == torch.float32:
        err, plain_err = _fp64_errors(*wargs, dw,
                                      plain_fn=subm.gather_gemm_wgrad_plain)
        assert err <= FP32_ERR_RATIO * plain_err + FP32_ERR_FLOOR


# widths above 64: SpMiddleFHDLarge's deep stages (128 -> 128, 64 -> 128),
# VoxelFeatureExtractor's 128 into a middle's first conv (128 -> 16), and
# widths that pad (96 -> 128 columns of A) or split unevenly
WIDE = [(128, 128), (96, 128), (128, 96), (96, 96), (128, 16), (64, 128),
        (100, 72)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,D", WIDE)
def test_gather_gemm_wide_channels(dev, dtype, C, D):
    """C and D up to 128 against the plain version (the bf16 kernel with a
    tap across two stages at CP = 128 and the output columns split over
    blocks above 64; the fp32 kernel with a quarter of a tap a stage), at
    an fhd-like fill across example boundaries; fp32 also against fp64
    (FP32_ERR_RATIO)."""
    args = _conv_case(dev, dtype, 3, 350, 400, 27, C, D, 0.1, seed=C + D)
    got, _ = _run_conv(*args)
    if dtype == torch.float32:
        err, plain_err = _fp64_errors(*args, got)
        assert err <= FP32_ERR_RATIO * plain_err + FP32_ERR_FLOOR


@pytest.mark.parametrize("K,C,D", [(33, 16, 16), (64, 5, 7), (125, 16, 16),
                                   (125, 64, 64), (125, 256, 40)])
def test_gather_gemm_bf16_more_than_32_taps(dev, K, C, D):
    """bf16 rulebooks of more taps than one vote takes (a 5 x 5 x 5 kernel
    is 125): the kernel walks them in vote groups of 32, its row table
    refilled a group at a time, at narrow and wide widths; the weight
    gradient of the same call."""
    args = _conv_case(dev, torch.bfloat16, 2, 200, 300, K, C, D, 0.1,
                      seed=K)
    _run_conv(*args)
    _run_wgrad(*_wgrad_case(dev, torch.bfloat16, 2, 200, 300, K, C, D,
                            0.1, seed=K + 1))


def _fp64_errors(feats, tap_idx, found, w, got,
                 plain_fn=subm.gather_gemm_plain):
    """(the kernel's error, the fp32 plain version's error) against the
    plain version (`plain_fn`) in fp64 on the same inputs, each the largest
    absolute error over the largest |reference|."""
    want = plain_fn(feats.double(), tap_idx, found, w.double())
    plain = plain_fn(feats, tap_idx, found, w)
    scale = max(want.abs().max().item(), 1e-30)
    return ((got.double() - want).abs().max().item() / scale,
            (plain.double() - want).abs().max().item() / scale)


# the fp32 kernel (3xTF32) against fp64: at most this many times the fp32
# plain version's own error, plus one fp32 unit of the scale (where the
# plain version happens to be exact)
FP32_ERR_RATIO, FP32_ERR_FLOOR = 2.0, 2.0 ** -24


@pytest.mark.parametrize("K", [27, 3])
@pytest.mark.parametrize("C,D", [(4, 16), (16, 16), (16, 32), (32, 32),
                                 (32, 64), (64, 64)])
def test_gather_gemm_fp32_mc_widths_fp32_accurate(dev, K, C, D):
    """The multi-class middle's widths in fp32 at an mc-eval-like fill (15%
    of the taps found): within 1e-4 of the fp32 plain version, and against
    the plain version in fp64 at most FP32_ERR_RATIO times the fp32 plain
    version's own error: fp32-accurate, not TF32-accurate."""
    args = _conv_case(dev, torch.float32, 3, 500, 640, K, C, D, 0.15, seed=3)
    got, _ = _run_conv(*args)
    err, plain_err = _fp64_errors(*args, got)
    assert err <= FP32_ERR_RATIO * plain_err + FP32_ERR_FLOOR


@pytest.mark.parametrize("C,D", [(3, 5), (33, 63), (3, 63), (33, 5),
                                 (64, 1), (1, 64), (33, 40)])
def test_gather_gemm_fp32_odd_widths(dev, C, D):
    """Input widths that are not a multiple of 4 (the kernel copies one
    float at a time) and output widths that are not a multiple of 8 (packed
    with zero columns) or split over two blocks unevenly (D = 40, 63),
    fp32, fp64-referenced."""
    args = _conv_case(dev, torch.float32, 2, 300, 333, 27, C, D, 0.3, seed=4)
    got, _ = _run_conv(*args)
    err, plain_err = _fp64_errors(*args, got)
    assert err <= FP32_ERR_RATIO * plain_err + FP32_ERR_FLOOR


@pytest.mark.parametrize("K", [33, 64])
def test_gather_gemm_fp32_more_than_32_taps(dev, K):
    """fp32 rulebooks of more taps than one vote takes: the kernel walks
    them in groups of 32."""
    args = _conv_case(dev, torch.float32, 2, 200, 300, K, 16, 16, 0.2,
                      seed=6)
    got, _ = _run_conv(*args)
    err, plain_err = _fp64_errors(*args, got)
    assert err <= FP32_ERR_RATIO * plain_err + FP32_ERR_FLOOR


def test_gather_gemm_fp32_dgrad(dev):
    """fp32 dX through `gather_gemm_dgrad` (the transposed rulebook, the
    weights [K, D, C]) against the plain version and fp64: one dX launch on
    the fp32 path."""
    grid = (8, 24, 24)
    coords, feats, valid, keys = _active_set(dev, 2, 800, grid, 24)
    tap_idx, found = sp.subm_rulebook_b(coords, keys, valid, grid)
    g = torch.Generator().manual_seed(25)
    w = (torch.randn(27, 16, 32, generator=g) / 20).to(dev)
    dout = torch.randn(2, tap_idx.shape[2], 32, generator=g).to(dev)
    inv_idx, inv_found = sp.transpose_rulebook_b(tap_idx, found, 800)
    wt = w.transpose(1, 2)
    before = (subm.launches_dgrad, subm.launches_fma)
    got = subm.gather_gemm_dgrad(dout, inv_idx, inv_found, wt)
    assert (subm.launches_dgrad, subm.launches_fma) == \
        (before[0] + 1, before[1] + 1)
    want = subm.gather_gemm_plain(dout, inv_idx, inv_found, wt)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    err, plain_err = _fp64_errors(dout, inv_idx, inv_found, wt, got)
    assert err <= FP32_ERR_RATIO * plain_err + FP32_ERR_FLOOR


def _boxes(g, n):
    return torch.stack([torch.rand(n, generator=g) * 8,
                        torch.rand(n, generator=g) * 8,
                        0.5 + 2.5 * torch.rand(n, generator=g),
                        0.5 + 5.5 * torch.rand(n, generator=g),
                        (torch.rand(n, generator=g) - 0.5) * 2 * np.pi], 1)


@pytest.mark.parametrize("criterion", [-1, 0, 1])
def test_riou_matches_plain(dev, criterion):
    """The same fp32 arithmetic (built without fused multiply-add):
    atol 1e-5."""
    g = torch.Generator().manual_seed(3)
    b1, b2 = _boxes(g, 70).to(dev), _boxes(g, 90).to(dev)
    got = riou.riou_matrix(b1, b2, criterion)
    want = riou.riou_matrix_plain(b1, b2, criterion)
    assert (want > 0).float().mean() > 0.2
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    i = torch.randint(0, 70, (500,), generator=g).to(dev)
    j = torch.randint(0, 90, (500,), generator=g).to(dev)
    torch.testing.assert_close(riou.riou_pairs(b1, b2, i, j, criterion),
                               want[i, j], atol=1e-5, rtol=0)


# ------------------------------------------------------------ rotated NMS


def _nms_boxes(g, B, K):
    """B examples of K BEV boxes over a square whose side grows with
    sqrt(K), so each box has a few standup-overlapping neighbours."""
    side = 3.0 * max(K, 1) ** 0.5
    return torch.stack([torch.rand(B, K, generator=g) * side,
                        torch.rand(B, K, generator=g) * side,
                        0.5 + 2.5 * torch.rand(B, K, generator=g),
                        0.5 + 5.5 * torch.rand(B, K, generator=g),
                        (torch.rand(B, K, generator=g) - 0.5) * 2 * np.pi],
                       -1)


def _nms_valid(g, B, K):
    """80% valid; the second example, where there is one, has no valid
    candidate."""
    valid = torch.rand(B, K, generator=g) > 0.2
    if B > 1:
        valid[1] = False
    return valid


def _check_overlap(cand, valid, thr, max_pairs, cluster=None):
    """The kernel's bitmask against the plain version's: the pair counts
    exact, the bits exact but at pairs whose plain IoU lies within 1e-5
    (the kernel's tolerance against its plain version) of the threshold."""
    before = riou.launches
    got, count = riou.nms_overlap(cand, valid, thr, max_pairs, cluster)
    assert riou.launches == before + 1
    want, want_count = riou.nms_overlap_plain(cand, valid, thr, max_pairs)
    assert torch.equal(count, want_count)
    B, K = valid.shape
    assert got.shape == (B, K, (K + 31) // 32) and got.dtype == torch.int32
    diff = riou.unpack_bits(got, K) != riou.unpack_bits(want, K)
    if diff.any():
        b, i, j = diff.nonzero(as_tuple=True)
        flat = cand.reshape(-1, 5)
        iou = riou.riou_pairs_plain(flat, flat, b * K + i, b * K + j)
        assert ((iou - thr).abs() <= 1e-5).all(), (iou - thr).abs().max()
    return got, count


@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("cap", ["16", "8192", "K*K"])
@pytest.mark.parametrize("K", [1, 31, 32, 33, 1000, 4096, 4097])
def test_nms_overlap_matches_plain(dev, K, cap, B):
    g = torch.Generator().manual_seed(K + B)
    cand = _nms_boxes(g, B, K).to(dev)
    valid = _nms_valid(g, B, K).to(dev)
    max_pairs = K * K if cap == "K*K" else int(cap)
    _, count = _check_overlap(cand, valid, 0.01, max_pairs)
    if B > 1:
        assert int(count[1]) == 0
    if K >= 1000:
        assert int(count[0]) > 16


@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("K,thr", [(33, 0.01), (1000, 0.01), (1000, 0.3),
                                   (4096, 0.01)])
def test_nms_overlap_cluster_sizes(dev, cluster, K, thr):
    """Every cluster shape gives the plain version's bitmask, with the cap
    falling inside the first block's rows (8192 pairs) and past all pairs
    (K * K)."""
    g = torch.Generator().manual_seed(K)
    cand = _nms_boxes(g, 4, K).to(dev)
    valid = _nms_valid(g, 4, K).to(dev)
    for max_pairs in (8192, K * K):
        _check_overlap(cand, valid, thr, max_pairs, cluster)


def test_nms_overlap_crowded_pairs_span_chunks(dev):
    """Crowded boxes: every pair's standup bound passes, so the clipped
    pairs (about 500 000 an example) run through many chunks of the
    blocks' lists."""
    g = torch.Generator().manual_seed(11)
    cand = _nms_boxes(g, 2, 1000).to(dev)
    cand[..., :2] *= 0.02
    valid = torch.ones(2, 1000, dtype=torch.bool, device=dev)
    _, count = _check_overlap(cand, valid, 0.01, 1000 * 1000)
    assert int(count.min()) > 400_000


@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("K", [1, 31, 32, 33, 1000, 4096, 4097])
def test_nms_suppress_matches_plain(dev, K, B):
    """Exact greedy suppression over a random strictly-upper bitmask of
    valid pairs (about 4 overlaps a box), against the plain frontier
    rounds."""
    g = torch.Generator().manual_seed(K * 7 + B)
    valid = _nms_valid(g, B, K)
    over = torch.triu(torch.rand(B, K, K, generator=g) < 4.0 / max(K, 1), 1)
    over &= valid[:, :, None] & valid[:, None, :]
    bits = riou.pack_bits(over).to(dev)
    valid = valid.to(dev)
    before = riou.launches_suppress
    got = riou.nms_suppress(bits, valid)
    assert riou.launches_suppress == before + 1
    want = riou.nms_suppress_plain(bits, valid)
    assert got.dtype == torch.bool and torch.equal(got, want)
    if B > 1:
        assert not got[1].any()
    if K >= 1000:
        assert 0 < int(got[0].sum()) < int(valid[0].sum())


@pytest.mark.parametrize("B", [1, 4, 9])
@pytest.mark.parametrize("kind", ["random", "chain", "invalid"])
@pytest.mark.parametrize("K", [1, 31, 32, 33, 1000, 2048, 4096, 4097])
def test_nms_suppress_walk(dev, K, kind, B):
    """The suppression at the sizes that stage the bitmask in shared memory
    (K up to 1000 here), those that read it in place (2048, 4096) and the
    wide kernel's (4097), with
    batches of 1, 4 and 9: random bitmasks keep what the plain frontier
    rounds keep; a chain (each row overlapping the next, every row valid:
    K / 2 frontier rounds) keeps every other row, as the plain walk mirror
    does; all rows invalid keep nothing. One launch each."""
    g = torch.Generator().manual_seed(K * 3 + B)
    if kind == "chain":
        valid = torch.ones(B, K, dtype=torch.bool)
        over = torch.zeros(B, K, K, dtype=torch.bool)
        i = torch.arange(K - 1)
        over[:, i, i + 1] = True
    else:
        valid = torch.rand(B, K, generator=g) > (0.2 if kind == "random"
                                                 else 1.0)
        over = torch.triu(torch.rand(B, K, K, generator=g) <
                          4.0 / max(K, 1), 1)
        over &= valid[:, :, None] & valid[:, None, :]
    bits = riou.pack_bits(over.to(dev))
    valid = valid.to(dev)
    before = riou.launches_suppress
    got = riou.nms_suppress(bits, valid)
    assert riou.launches_suppress == before + 1
    assert got.dtype == torch.bool and got.shape == (B, K)
    if kind == "chain":
        want = (torch.arange(K, device=dev) % 2 == 0).expand(B, K)
        assert torch.equal(got, want)
        if K <= 1000:
            assert torch.equal(got.cpu(), riou.nms_suppress_walk_plain(
                bits.cpu(), valid.cpu()))
    else:
        assert torch.equal(got, riou.nms_suppress_plain(bits, valid))
    if kind == "invalid":
        assert not got.any()


@pytest.mark.parametrize("K", [4097, 8192])
def test_nms_past_4096_matches_plain(dev, K):
    """Past NMS_MAX_K candidates the kernels take their wide routes: the
    overlap kernel's counts and bits (`_check_overlap`) and the
    suppression's keep against their plain versions, at the 8192-pair cap
    and uncapped, a batch of 4 rows crowded so that the cap binds (some
    4 K pairs pass the bound); the whole rotated `nms` (one launch of each
    kernel) against the CPU's."""
    g = torch.Generator().manual_seed(K)
    cand = _nms_boxes(g, 4, K)
    cand[..., :2] *= 0.4
    cand = cand.to(dev)
    valid = _nms_valid(g, 4, K).to(dev)
    for max_pairs in (8192, K * K):
        got, count = _check_overlap(cand, valid, 0.01, max_pairs)
        assert int(count[0]) > 8192 and int(count[1]) == 0
        keep = riou.nms_suppress(got, valid)
        assert torch.equal(keep, riou.nms_suppress_plain(got, valid))
        assert 0 < int(keep[0].sum()) < int(valid[0].sum())
    scores = torch.rand(4, K, generator=g).to(dev)
    before = (riou.launches, riou.launches_suppress)
    idx, keep = nms.nms(cand, scores, valid, pre_max_size=K,
                        post_max_size=500, iou_threshold=0.01)
    assert (riou.launches, riou.launches_suppress) == \
        (before[0] + 1, before[1] + 1)
    want = nms.nms(cand.cpu(), scores.cpu(), valid.cpu(), pre_max_size=K,
                   post_max_size=500, iou_threshold=0.01)
    assert torch.equal(idx.cpu(), want[0]) and torch.equal(keep.cpu(),
                                                           want[1])


def test_nms_kernels_reject_what_they_cannot_take(dev):
    """Past the kernels' limits the wrappers raise; they never take the
    plain version for a CUDA tensor. The rotated routes stop where JAX's
    int32 pair index does, at K * K >= 2^31 (K = 46 341), before they
    allocate anything."""
    g = torch.Generator().manual_seed(12)
    big = _nms_boxes(g, 1, riou.ROTATED_MAX_K + 1).to(dev)
    big_valid = torch.ones(1, big.shape[1], dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="int32"):
        riou.nms_overlap(big, big_valid, 0.01, 8192)
    with pytest.raises(ValueError, match="int32"):
        nms.nms(big[0], big_valid[0].float(), big_valid[0],
                pre_max_size=big.shape[1], post_max_size=100,
                iou_threshold=0.01)
    with pytest.raises(ValueError, match="int32"):
        nms.soft_nms(big[0], big_valid[0].float(), big_valid[0],
                     pre_max_size=big.shape[1], post_max_size=100)
    cand, valid = big[:, :100].contiguous(), big_valid[:, :100].contiguous()
    for max_pairs in (-1, 2 ** 31):
        with pytest.raises(ValueError, match="max_pairs"):
            riou.nms_overlap(cand, valid, 0.01, max_pairs)
    with pytest.raises(ValueError, match="cluster"):
        riou.nms_overlap(cand, valid, 0.01, 8192, cluster=3)


def _tied_nms_inputs(g, B=3, N=1500):
    """Tied scores (five levels) and tied boxes (200 boxes duplicated, with
    their scores) among the top 1000 of 1500 candidates."""
    boxes = _nms_boxes(g, B, N)
    scores = torch.randint(0, 5, (B, N), generator=g).float() / 4
    boxes[:, 1000:1200] = boxes[:, 0:200]
    scores[:, 1000:1200] = scores[:, 0:200]
    boxes[:, 300:400] = boxes[:, 200:300]
    valid = torch.rand(B, N, generator=g) > 0.1
    return boxes, scores, valid


@pytest.mark.parametrize("max_pairs", [16, 8192])
def test_batched_nms_ties_match_cpu(dev, max_pairs):
    """Equal scores and equal boxes among the top-k, capped and uncapped:
    the batched NMS on the card (kernels) gives the CPU's (plain versions)
    indices and keep mask."""
    g = torch.Generator().manual_seed(13)
    boxes, scores, valid = _tied_nms_inputs(g)
    kw = dict(pre_max_size=1000, post_max_size=100, iou_threshold=0.01,
              max_pairs=max_pairs)
    idx_c, keep_c = nms.nms(boxes.to(dev), scores.to(dev), valid.to(dev),
                            **kw)
    idx_h, keep_h = nms.nms(boxes, scores, valid, **kw)
    assert torch.equal(keep_c.cpu(), keep_h)
    assert torch.equal(idx_c.cpu(), idx_h)
    assert int(keep_h.sum()) > 0
    _, top = nms.top_k(torch.where(valid, scores, float("-inf")), 1000)
    cand = torch.stack([boxes[b][top[b]] for b in range(3)])
    counts = riou.nms_overlap_plain(cand, torch.ones_like(top, dtype=bool),
                                    0.01, max_pairs)[1]
    assert 16 < int(counts.min()) and int(counts.max()) < 8192


def test_batched_nms_runs_without_host_sync(dev):
    """The rotated batched NMS on the card: one launch of each kernel, and
    no synchronising CUDA call (torch's sync debug mode raises on one)."""
    g = torch.Generator().manual_seed(14)
    boxes, scores, valid = (t.to(dev) for t in _tied_nms_inputs(g))
    kw = dict(pre_max_size=1000, post_max_size=100, iou_threshold=0.01)
    nms.nms(boxes, scores, valid, **kw)                 # built and loaded
    before = (riou.launches, riou.launches_suppress)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        idx, keep = nms.nms(boxes, scores, valid, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert (riou.launches, riou.launches_suppress) == \
        (before[0] + 1, before[1] + 1)
    assert idx.shape == (3, 100) and keep.shape == (3, 100)


# ------------------------------------------------- the sparse conv backward


def _wgrad_case(dev, dtype, B, N, Q, K, C, D, fill, seed=20):
    feats, tap_idx, found, _ = _conv_case(dev, dtype, B, N, Q, K, C, D, fill,
                                          seed)
    g = torch.Generator().manual_seed(seed + 1)
    dout = torch.randn(B, Q, D, generator=g).to(dtype).to(dev)
    return feats, tap_idx, found, dout


def _run_wgrad(feats, tap_idx, found, dout):
    """The weight-gradient kernel against its plain version: fp32 sums of
    the same products (exact for bf16 operands) in another order, within
    1e-4 of the largest entry (GRAD_KERNEL_TOL); the path by dtype, one
    counted launch a call, the same bits on a second run (partials summed in
    a fixed order), and the per-tap ticket counters left at 0."""
    counts = (subm.launches_wgrad, subm.launches_wgrad_mma,
              subm.launches_wgrad_fma)
    got = subm.sparse_wgrad(feats, tap_idx, found, dout)
    again = subm.sparse_wgrad(feats, tap_idx, found, dout)
    want = subm.gather_gemm_wgrad_plain(feats, tap_idx, found, dout)
    torch.cuda.synchronize()
    K, C, D = tap_idx.shape[1], feats.shape[2], dout.shape[2]
    assert got.dtype == torch.float32 and got.shape == (K, C, D)
    scale = max(want.abs().max().item(), 1e-6)
    torch.testing.assert_close(got, want, atol=1e-4 * scale, rtol=1e-4)
    assert torch.equal(got, again)
    mma = feats.dtype == torch.bfloat16
    assert (subm.launches_wgrad, subm.launches_wgrad_mma,
            subm.launches_wgrad_fma) == \
        (counts[0] + 2, counts[1] + 2 * mma, counts[2] + 2 * (not mma))
    assert not any(c.any() for c in subm._wgrad_counters.values())
    return got, want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [4, 16, 32, 64])
@pytest.mark.parametrize("D", [4, 16, 32, 64])
def test_sparse_wgrad_matches_plain(dev, dtype, C, D):
    """Every width pair of {4, 16, 32, 64}, at an fhd-like fill (5% of the
    taps found). Q = 400: the blocks' row ranges cross from one example into
    the next."""
    _run_wgrad(*_wgrad_case(dev, dtype, 3, 350, 400, 27, C, D, 0.05))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K,C,D", [(27, 5, 7), (3, 64, 64), (27, 33, 40)])
def test_sparse_wgrad_odd_widths(dev, dtype, K, C, D):
    """Widths off the 16-byte grid (element-by-element gathers, padded
    tiles) and the 3-tap kernel of the last strided conv."""
    _run_wgrad(*_wgrad_case(dev, dtype, 2, 300, 333, K, C, D, 0.2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K", [1, 27])
@pytest.mark.parametrize("C", [1, 4, 16, 17, 32, 64])
@pytest.mark.parametrize("D", [1, 4, 16, 17, 32, 64])
def test_sparse_wgrad_widths_and_taps(dev, dtype, K, C, D):
    """C, D in {1, 4, 16, 17, 32, 64} and K in {1, 27}: every copy width
    (16, 8, 4 bytes, element by element), every channel split of the warps,
    padded tiles. Q = 1001 is no multiple of 16, so the found bytes of an
    example start off the 16-byte grid (the byte-by-byte scan)."""
    _run_wgrad(*_wgrad_case(dev, dtype, 2, 500, 1001, K, C, D, 0.1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,D", WIDE + [(128, 4), (4, 128), (65, 65)])
def test_sparse_wgrad_wide_channels(dev, dtype, C, D):
    """C and D up to 128: [C, D] in 64 x 64 tiles, each with its own
    partials and tickets (four at 128 x 128; edge tiles of 32, 36, 8 and 1
    columns); fp32 also against fp64 within FP32_ERR_RATIO of the fp32
    plain version's own error."""
    args = _wgrad_case(dev, dtype, 3, 350, 400, 27, C, D, 0.1, seed=C * D)
    got, _ = _run_wgrad(*args)
    if dtype == torch.float32:
        err, plain_err = _fp64_errors(*args, got,
                                      plain_fn=subm.gather_gemm_wgrad_plain)
        assert err <= FP32_ERR_RATIO * plain_err + FP32_ERR_FLOOR


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sparse_wgrad_wide_single_chunk(dev, dtype):
    """128 x 128 with one chunk a tile (each tile's block writes its part of
    dW[k] itself, rows of stride D)."""
    _run_wgrad(*_wgrad_case(dev, dtype, 1, 40, 16, 27, 128, 128, 0.5))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sparse_wgrad_scratch_budget(dev, dtype, monkeypatch):
    """A scratch budget (WGRAD_SCRATCH_BYTES) of 2.5 chunks' partials: the
    wrapper gives each tap 2 chunks where the card's SMs would take 63,
    and the sums still match the plain version."""
    K, C, D, B, Q = 3, 64, 64, 2, 4000
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert subm.wgrad_chunks(B * Q, K, sms)[1] > 2
    monkeypatch.setattr(subm, "WGRAD_SCRATCH_BYTES",
                        2.5 * 4 * K * C * D * (1 + 1 / subm.WGRAD_GROUP))
    assert subm.wgrad_max_chunks(K, C, D) == 2
    assert subm.wgrad_chunks(B * Q, K, sms, 2)[1] == 2
    _run_wgrad(*_wgrad_case(dev, dtype, B, 500, Q, K, C, D, 0.1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fill", [0.0, 1e-3, 0.04, 0.15, 1.0])
def test_sparse_wgrad_found_densities(dev, dtype, fill):
    """Found densities from none (every block writes used = 0 and the last
    one writes zeros) through 0.1% (most tiles of a handful of rows) and the
    fhd train step's range to every tap found (full tiles, a whole window
    listed), at the main path's widest conv."""
    feats, tap_idx, found, dout = _wgrad_case(dev, dtype, 4, 3000, 4096, 27,
                                              64, 64, fill)
    got, _ = _run_wgrad(feats, tap_idx, found, dout)
    if fill == 0.0:
        assert not got.any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sparse_wgrad_one_heavy_block(dev, dtype):
    """Every tap found across one block's row range and nowhere else: one
    block of each tap does all the work and the others end at their scan;
    then one tap found everywhere and the other 26 nowhere."""
    B, N, Q, K = 2, 4000, 20_000, 27
    feats, tap_idx, found, dout = _wgrad_case(dev, dtype, B, N, Q, K, 32, 64,
                                              0.0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    chunk_rows, chunks = subm.wgrad_chunks(B * Q, K, sms)
    assert chunks > 4
    flat = found.permute(1, 0, 2).reshape(K, B * Q)
    flat[:, 3 * chunk_rows:4 * chunk_rows] = True
    found = flat.reshape(K, B, Q).permute(1, 0, 2).contiguous()
    got, _ = _run_wgrad(feats, tap_idx, found, dout)
    assert (got.abs().amax((1, 2)) > 0).all()
    found = torch.zeros_like(found)
    found[:, 5] = True
    got, _ = _run_wgrad(feats, tap_idx, found, dout)
    assert got[5].abs().max() > 0
    assert not got[:5].any() and not got[6:].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sparse_wgrad_single_chunk(dev, dtype):
    """So few rows that each tap has one block, which writes dW itself (no
    partials, no ticket)."""
    feats, tap_idx, found, dout = _wgrad_case(dev, dtype, 1, 40, 10, 27, 16,
                                              32, 0.5)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert subm.wgrad_chunks(10, 27, sms)[1] == 1
    _run_wgrad(feats, tap_idx, found, dout)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sparse_wgrad_empty_taps(dev, dtype):
    """No tap found anywhere (every block ends at its scan: zeros), and
    half of the taps never found (their dW rows zero)."""
    feats, tap_idx, found, dout = _wgrad_case(dev, dtype, 2, 200, 300, 27,
                                              16, 32, 0.0)
    got, _ = _run_wgrad(feats, tap_idx, found, dout)
    assert not got.any()
    feats, tap_idx, found, dout = _wgrad_case(dev, dtype, 2, 200, 300, 27,
                                              16, 32, 0.3)
    found[:, ::2] = False
    got, _ = _run_wgrad(feats, tap_idx, found, dout)
    assert not got[::2].any() and got[1::2].abs().max() > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sparse_wgrad_chunks_of_many_stages(dev, dtype, monkeypatch):
    """One wave of one block an SM: each block walks several 2048-row
    windows of its chunk (`wgrad_chunks`), and a chunk and its windows cross
    the example boundary at 19 000."""
    monkeypatch.setattr(subm, "WGRAD_BLOCKS_PER_SM", 1)
    B, Q, K = 2, 19_000, 27
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    chunk_rows, chunks = subm.wgrad_chunks(B * Q, K, sms)
    assert chunk_rows > subm.WGRAD_WINDOW and chunks * chunk_rows >= B * Q
    assert any(c * chunk_rows < Q < (c + 1) * chunk_rows
               for c in range(chunks))
    _run_wgrad(*_wgrad_case(dev, dtype, B, 5000, Q, K, 32, 64, 0.1))


@pytest.mark.parametrize("per_sm", [6, 1])
@pytest.mark.parametrize("fill", [0.15, 1.0])
def test_sparse_wgrad_fp32_accurate(dev, monkeypatch, per_sm, fill):
    """The fp32 weight gradient against the plain version in fp64: at most
    FP32_ERR_RATIO times the fp32 plain version's own error, at the main
    path's widest conv, features >= 0 as a ReLU leaves them (their sums
    drift one way), with the chunks of the card's grid and with one block
    an SM (four chunks a tap on a 132-SM card, 16 384 rows each: a long
    compensated sum of tile sums)."""
    monkeypatch.setattr(subm, "WGRAD_BLOCKS_PER_SM", per_sm)
    feats, tap_idx, found, dout = _wgrad_case(
        dev, torch.float32, 4, 12_000, 16_384, 27, 64, 64, fill, seed=26)
    args = (feats.abs(), tap_idx, found, dout)
    got, _ = _run_wgrad(*args)
    err, plain_err = _fp64_errors(*args, got,
                                  plain_fn=subm.gather_gemm_wgrad_plain)
    assert err <= FP32_ERR_RATIO * plain_err + FP32_ERR_FLOOR


def test_sparse_wgrad_runs_without_host_sync(dev):
    """The weight gradient enqueues its launch and syncs nothing (the train
    step is gated on this): torch's sync debug mode raises on a
    synchronising call."""
    args = _wgrad_case(dev, torch.bfloat16, 4, 2000, 3000, 27, 32, 32, 0.1)
    subm.sparse_wgrad(*args)                 # built, loaded, counters made
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        subm.sparse_wgrad(*args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def _active_set(dev, B, N, grid, seed):
    """Sorted active sets on the card: random distinct sites, 40-90% of the
    capacity valid."""
    g = torch.Generator().manual_seed(seed)
    D, H, W = grid
    coords = torch.zeros(B, N, 3, dtype=torch.int32)
    valid = torch.zeros(B, N, dtype=torch.bool)
    for b in range(B):
        n = int(N * (0.4 + 0.5 * torch.rand(1, generator=g).item()))
        lin = torch.randperm(D * H * W, generator=g)[:n]
        coords[b, :n] = torch.stack([lin // (H * W), (lin // W) % H,
                                     lin % W], 1).int()
        valid[b, :n] = True
    feats = torch.randn(B, N, 16, generator=g)
    return sp.sort_active(coords.to(dev), feats.to(dev), valid.to(dev), grid)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("strided", [False, True])
def test_conv_backward_matches_autograd_of_plain(dev, dtype, strided):
    """A submanifold and a strided (over capacity) conv on the card: dX
    (the gather-GEMM on the transposed rulebook) and dW (the weight-gradient
    kernel) against autograd through `gather_gemm_plain` on the same card
    tensors. fp32: within 1e-4 of the largest entry. bf16: the kernels take
    dOut rounded to bf16 where autograd of the plain version keeps it fp32,
    so within 2^-7 of each entry plus 2^-8 of the largest."""
    grid = (8, 24, 24)
    coords, feats, valid, keys = _active_set(dev, 2, 800, grid, 21)
    g = torch.Generator().manual_seed(22)
    w = (torch.randn(27, 16, 32, generator=g) / 20).to(dev)
    if strided:
        oc, ov, _, _, n_unique = sp.downsample_coords_b(
            coords, valid, grid, (3, 3, 3), (2, 2, 2), (1, 1, 1), 200)
        assert (n_unique > 200).all()
        tap_idx, found = sp.build_rulebook_b(keys, oc * 2 - 1, ov, grid,
                                             (3, 3, 3))
    else:
        tap_idx, found = sp.subm_rulebook_b(coords, keys, valid, grid)
    x = feats.to(dtype)
    cot = torch.randn(2, tap_idx.shape[2], 32, generator=g).to(dev)
    counts = (subm.launches_dgrad, subm.launches_wgrad)
    xa, wa = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    (subm.gather_gemm(xa, tap_idx, found, wa) * cot).sum().backward()
    assert (subm.launches_dgrad, subm.launches_wgrad) == \
        (counts[0] + 1, counts[1] + 1)
    xb, wb = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    (subm.gather_gemm_plain(xb, tap_idx, found, wb) * cot).sum().backward()
    torch.cuda.synchronize()
    for got, want in ((xa.grad.float(), xb.grad.float()), (wa.grad, wb.grad)):
        scale = want.abs().max().item()
        assert scale > 0
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, atol=1e-4 * scale,
                                       rtol=1e-4)
        else:
            bound = 2.0 ** -7 * torch.maximum(got.abs(), want.abs()) + \
                2.0 ** -8 * scale
            assert ((got - want).abs() <= bound).all()


def test_transposed_rulebook_on_the_card(dev):
    """The scatter that transposes a rulebook gives on the card what it
    gives on the CPU (each slot written once: no order to differ in)."""
    grid = (8, 24, 24)
    coords, _, valid, keys = _active_set(dev, 2, 800, grid, 23)
    tap_idx, found = sp.subm_rulebook_b(coords, keys, valid, grid)
    got = sp.transpose_rulebook_b(tap_idx, found, 800)
    want = sp.transpose_rulebook_b(tap_idx.cpu(), found.cpu(), 800)
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])
    assert torch.equal(got[1], found.flip(1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sparse_middle_weights_get_gradients_on_the_card(dev, dtype):
    """R1 on the card: a backward through SpMiddleFHD in training mode
    launches the gather-GEMM 14 times forward and 13 times for dX (the first
    conv's input needs none) and the weight-gradient kernel 14 times, and
    every sparse weight's gradient is finite and not all zero. In fp32 the
    gradients agree with the CPU's plain versions within 1e-3 of each
    tensor's largest entry (sums in another order through 14 convs)."""
    grid = (41, 64, 64)
    g = torch.Generator().manual_seed(24)
    coords, _, valid, _ = _active_set(torch.device("cpu"), 2, 2048, grid, 25)
    feats = torch.randn(2, 2048, 4, generator=g) * valid[..., None]
    proto = SparseMiddleFHD(grid, num_input_features=4,
                            dtype=None if dtype == torch.float32 else dtype)
    for m in proto.modules():
        if isinstance(m, (SubMBlock, DownBlock)):
            K, cin, _ = m.weight.shape
            with torch.no_grad():
                m.weight.copy_(torch.randn(m.weight.shape, generator=g) *
                               (K * cin) ** -0.5)
    cot = None
    grads = {}
    for device in (dev, torch.device("cpu")):
        mid = SparseMiddleFHD(grid, num_input_features=4, dtype=proto.dtype)
        mid.load_state_dict(proto.state_dict())
        mid = mid.to(device).train()
        if device.type == "cuda":
            subm.launches = subm.launches_dgrad = subm.launches_wgrad = 0
            subm.launches_mma = subm.launches_fma = 0
        bev, _ = mid(feats.to(device), coords.to(device), valid.to(device))
        if cot is None:
            cot = torch.randn(bev.shape, generator=g)
        (bev * cot.to(device)).sum().backward()
        if device.type == "cuda":
            torch.cuda.synchronize()
            assert (subm.launches, subm.launches_dgrad,
                    subm.launches_wgrad) == (14, 13, 14)
            path = subm.launches_mma if dtype == torch.bfloat16 else \
                subm.launches_fma
            assert path == 27
        sparse = [m for m in mid.modules()
                  if isinstance(m, (SubMBlock, DownBlock))]
        assert len(sparse) == 14
        for i, m in enumerate(sparse):
            gr = m.weight.grad
            assert gr is not None and torch.isfinite(gr).all(), i
            assert gr.abs().max() > 0, i
        grads[device.type] = [m.weight.grad.cpu() for m in sparse]
        if dtype == torch.bfloat16:
            break
    if dtype == torch.float32:
        for a, b in zip(grads["cuda"], grads["cpu"]):
            torch.testing.assert_close(a, b, rtol=0,
                                       atol=1e-3 * b.abs().max().item())



@pytest.mark.parametrize("width", [128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_backward_wide_matches_autograd_of_plain(dev, dtype, width):
    """A 128 -> 128 and a 256 -> 256 submanifold conv on the card: dX (the
    gather-GEMM with D = width on the transposed rulebook) and dW (four or
    sixteen tiles) against
    autograd through `gather_gemm_plain` on fp32 copies of the values the
    kernels use (the features and the weights rounded to the feature
    dtype; a bf16-exact cotangent), as chip_smoke.py's
    `check_conv_backward` holds them: autograd through bf16 features would
    add each tap's share in bf16. fp32: within 1e-4 of the largest entry;
    bf16: the kernels round their fp32 sums to bf16 once, so within 2^-7
    of each entry plus 1e-6 of the largest."""
    grid = (8, 24, 24)
    coords, _, valid, keys = _active_set(dev, 2, 800, grid, 31)
    g = torch.Generator().manual_seed(32)
    x = torch.randn(2, 800, width, generator=g).to(dev).to(dtype)
    w = (torch.randn(27, width, width, generator=g) / 60).to(dev)
    w = w.to(dtype).float()
    tap_idx, found = sp.subm_rulebook_b(coords, keys, valid, grid)
    cot = torch.randn(2, 800, width, generator=g).bfloat16().float().to(dev)
    xa, wa = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    (subm.gather_gemm(xa, tap_idx, found, wa) * cot).sum().backward()
    xb = x.float().requires_grad_(True)
    wb = w.clone().requires_grad_(True)
    (subm.gather_gemm_plain(xb, tap_idx, found, wb) * cot).sum().backward()
    torch.cuda.synchronize()
    for got, want in ((xa.grad.float(), xb.grad), (wa.grad, wb.grad)):
        scale = want.abs().max().item()
        assert scale > 0
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, atol=1e-4 * scale,
                                       rtol=1e-4)
        else:
            bound = 2.0 ** -7 * torch.maximum(got.abs(), want.abs()) + \
                1e-6 * scale
            assert ((got - want).abs() <= bound).all()


def _pool_case(dev, seed):
    """A sorted active set with many ties (post-ReLU zeros, quarters)."""
    grid = (20, 24, 24)
    coords, _, valid, keys = _active_set(dev, 2, 1200, grid, seed)
    g = torch.Generator().manual_seed(seed)
    feats = torch.clamp(torch.round(torch.randn(2, 1200, 32, generator=g) *
                                    2) / 4, min=0).to(dev)
    return grid, coords, feats * valid[..., None], valid, keys


@pytest.mark.parametrize("cap", [1200, 300])
def test_max_pool_card_matches_cpu(dev, cap):
    """`sparse_max_pool3d_b` (2, 1, 1) on the card against the CPU: sites,
    keys, masks and site counts exact, the pooled features exact (a max
    picks an input), and the gradient (ties shared evenly, scattered back
    by `index_add_`) within 1e-6; the tap gather goes through the row
    gather kernel."""
    grid, coords, feats, valid, keys = _pool_case(dev, 33)
    r = torch.randn(2, cap, 32, generator=torch.Generator().manual_seed(34))
    outs = {}
    for device in (dev, torch.device("cpu")):
        f = feats.to(device).clone().requires_grad_(True)
        before = gather.launches
        got = sp.sparse_max_pool3d_b(f, coords.to(device), keys.to(device),
                                     valid.to(device), grid, (2, 1, 1), cap)
        (got[0] * r.to(device)).sum().backward()
        if device.type == "cuda":
            assert gather.launches > before
        outs[device.type] = [t.cpu() if torch.is_tensor(t) else t
                             for t in got] + [f.grad.cpu()]
    for i, (a, b) in enumerate(zip(outs["cuda"], outs["cpu"])):
        if torch.is_tensor(a) and a.is_floating_point() and i == 6:
            torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
        elif torch.is_tensor(a):
            assert torch.equal(a.detach(), b.detach()), i
        else:
            assert a == b
    assert (outs["cpu"][5] > cap).any() == (cap == 300)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["res", "bottleneck"])
def test_residual_block_card_matches_cpu(dev, kind, dtype):
    """`SparseBasicBlock` (12 -> 16, with its projection) and
    `SparseBottleneck` (12 -> 4 x 8) in train mode on the card against the
    CPU from the same weights: the output and every parameter's gradient.
    fp32 within 1e-4 of each tensor's largest entry; bf16 (the blocks'
    residual matmuls and the first conv in bf16, sums in another order
    through two or three convs and the masked norms) within 2^-6 of it."""
    from second_tpu_torch.models.sparse_middle import (SparseBasicBlock,
                                                      SparseBottleneck)
    grid = (8, 24, 24)
    coords, _, valid, keys = _active_set(torch.device("cpu"), 2, 800, grid,
                                         35)
    g = torch.Generator().manual_seed(36)
    x = torch.randn(2, 800, 12, generator=g) * valid[..., None]
    proto = (SparseBasicBlock(12, 16) if kind == "res"
             else SparseBottleneck(12, 8))
    with torch.no_grad():
        for p in proto.parameters():
            if p.dim() > 1:
                p.copy_(torch.randn(p.shape, generator=g) *
                        np.prod(p.shape[:-1]) ** -0.5)
    cot = None
    res = {}
    for device in (dev, torch.device("cpu")):
        blk = copy.deepcopy(proto).to(device).train()
        c, m, k = coords.to(device), valid.to(device), keys.to(device)
        rb = sp.subm_rulebook_b(c, k, m, grid)
        launches = subm.launches
        out = blk(x.to(device).to(dtype), c, k, m, grid, rb)
        if device.type == "cuda":
            assert subm.launches - launches == (2 if kind == "res" else 1)
        if cot is None:
            cot = torch.randn(out.shape, generator=g)
        (out.float() * cot.to(device)).sum().backward()
        res[device.type] = [out.detach().float().cpu()] + \
            [p.grad.cpu() for p in blk.parameters()]
    tol = 1e-4 if dtype == torch.float32 else 2.0 ** -6
    for a, b in zip(res["cuda"], res["cpu"]):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=tol * b.abs().max().item())


# ---------------------------------------------------------- PointPillars

PP_CONFIG = Path(__file__).resolve().parents[1] / "second_tpu_torch" / \
    "configs" / "pointpillars_car.config"


@pytest.fixture(scope="module")
def pp(dev):
    """The PointPillars config at full width in fp32, its norm statistics
    calibrated on the batch on the CPU, the same weights on the card; two
    LiDAR scans (seeds 0 and 1) prepared for eval with the in-graph mask,
    20 000 points and 12 000 pillars."""
    cfg = load_pipeline_config(PP_CONFIG)
    net_h, spec, info, assigner, _ = build_voxelnet(cfg.model, device="cpu",
                                                    seed=0)
    vg = cfg.model.voxel_generator
    prep = ExamplePrep(assigner, info.feature_map_size, PrepConfig(
        max_points=20000, training=False, anchor_area_threshold=1,
        voxel_size=tuple(vg.voxel_size), pc_range=tuple(vg.point_cloud_range),
        device_anchors_mask=True))
    scans = [lidar_scan_scene(np.random.default_rng(s),
                              pc_range=tuple(vg.point_cloud_range),
                              num_azimuth=512)[0] for s in (0, 1)]
    rng = np.random.default_rng(0)
    batch = prep.collate([prep({"points": p}, rng) for p in scans])
    vspec = VoxelizeSpec.from_config(vg, 12000)
    vox = device_voxelize(vspec, batch["points"], batch["points_mask"], "cpu")
    calibrate_norms_(net_h, vox["voxels"], vox["num_points"],
                     vox["coordinates"], vox["voxel_valid"])
    net_c = build_voxelnet(cfg.model, device=dev, seed=0)[0]
    net_c.load_state_dict(net_h.state_dict())
    return dict(cfg=cfg, spec=spec, vspec=vspec, prep=prep, batch=batch,
                nets={"cpu": net_h, "cuda": net_c},
                mask_info=prep.sat_mask_info())


def test_pointpillars_forward_card_matches_cpu(dev, pp):
    """The PointPillars eval forward, fp32, batch 2, with the in-graph
    anchors mask: voxels and the mask exact card against CPU; the
    predictions within 1e-3 (cuDNN against oneDNN sums through 14 convs);
    predict on the card's predictions through the kernels against the
    plain versions on the CPU: `valid` exact, boxes and scores within
    1e-4."""
    outs = {}
    for d in ("cuda", "cpu"):
        device = dev if d == "cuda" else torch.device("cpu")
        outs[d] = detect(pp["nets"][d], pp["spec"], pp["vspec"],
                         pp["batch"]["points"], pp["batch"]["points_mask"],
                         pp["batch"]["anchors"], device=device,
                         mask_info=pp["mask_info"])
    (det_c, vox_c, preds_c), (det_h, vox_h, preds_h) = outs["cuda"], \
        outs["cpu"]
    for k in ("voxels", "num_points", "coordinates", "voxel_valid"):
        assert torch.equal(vox_c[k].cpu(), vox_h[k]), k
    assert int(vox_h["voxel_overflow"]) == 0
    masks = [anchors_mask_from_coords(v["coordinates"], v["voxel_valid"],
                                      *pp["mask_info"]) for v in (vox_c,
                                                                  vox_h)]
    assert torch.equal(masks[0].cpu(), masks[1])
    for k in ("box_preds", "cls_preds", "dir_cls_preds"):
        torch.testing.assert_close(preds_c[k].cpu(), preds_h[k], rtol=1e-3,
                                   atol=1e-3)
    det_p = predict(pp["spec"], {k: v.cpu() for k, v in preds_c.items()},
                    pp["batch"]["anchors"], masks[1])
    valid = det_c["valid"].cpu()
    assert torch.equal(valid, det_p["valid"]) and valid.any()
    for k in ("boxes", "scores"):
        torch.testing.assert_close(det_c[k].cpu()[valid], det_p[k][valid],
                                   rtol=1e-4, atol=1e-4)


def test_pointpillars_mask_on_the_card_matches_host(dev, pp):
    """The in-graph mask on the card, the corners uploaded once as the
    Trainer does, equals the host's `_compute_anchors_mask` of each raw
    scan where voxel_overflow is 0, and prunes some anchors."""
    vox = device_voxelize(pp["vspec"], pp["batch"]["points"],
                          pp["batch"]["points_mask"], dev)
    assert int(vox["voxel_overflow"]) == 0
    corners, grid_hw, thr = pp["mask_info"]
    got = anchors_mask_from_coords(vox["coordinates"], vox["voxel_valid"],
                                   torch.as_tensor(corners, device=dev),
                                   grid_hw, thr).cpu().numpy()
    for b in range(2):
        pts = pp["batch"]["points"][b][pp["batch"]["points_mask"][b]]
        host = pp["prep"]._compute_anchors_mask(pts)
        np.testing.assert_array_equal(got[b], host)
        assert 0 < host.sum() < host.size


def test_pointpillars_path_launches(dev, pp):
    """One PointPillars eval forward with the in-graph mask launches the row
    gather 6 times (2 in the voxelizer, 4 in predict and NMS), the NMS
    overlap and suppression kernels once each, and no sparse-conv kernel;
    one train step launches the row gather twice (the voxelizer) and no
    other kernel, and gives the encoder and the first RPN conv finite,
    nonzero gradients."""
    counters = [(gather, "launches"), (riou, "launches"),
                (riou, "launches_suppress"), (subm, "launches"),
                (subm, "launches_dgrad"), (subm, "launches_wgrad")]
    for mod, name in counters:
        setattr(mod, name, 0)
    detect(pp["nets"]["cuda"], pp["spec"], pp["vspec"], pp["batch"]["points"],
           pp["batch"]["points_mask"], pp["batch"]["anchors"], device=dev,
           mask_info=pp["mask_info"])
    torch.cuda.synchronize()
    assert [getattr(m, n) for m, n in counters] == [6, 1, 1, 0, 0, 0]

    net = build_voxelnet(pp["cfg"].model, device=dev, seed=0)[0]
    init_train_weights_(net, 0)
    opt, sched = build_optimizer(pp["cfg"].train_config.optimizer,
                                 pp["cfg"].train_config.steps,
                                 net.parameters())
    state = TrainState(net, opt, 0, sched)
    prep = ExamplePrep(pp["prep"]._assigner, (1, 248, 216), PrepConfig(
        max_points=20000, training=True, anchor_area_threshold=1,
        voxel_size=pp["vspec"].voxel_size,
        pc_range=pp["vspec"].point_cloud_range))
    ds = SyntheticDataset(2, seed=1, pc_range=pp["vspec"].point_cloud_range,
                          scan=True)
    rng = np.random.default_rng(0)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in prep.collate(
        [prep(ds[i], rng) for i in range(2)]).items() if k != "image_idx"}
    for mod, name in counters:
        setattr(mod, name, 0)
    grads = {}
    step_opt = opt.step

    def recording_step(count):
        grads.update({n: p.grad.clone() for n, p in net.named_parameters()})
        return step_opt(count)
    opt.step = recording_step
    _, metrics = make_train_step(pp["spec"], VoxelizeSpec.from_config(
        pp["cfg"].model.voxel_generator, 12000, shuffle_overflow=True))(
            state, batch)
    torch.cuda.synchronize()
    assert [getattr(m, n) for m, n in counters] == [2, 0, 0, 0, 0, 0]
    assert torch.isfinite(metrics["loss"])
    for name, g in grads.items():
        assert torch.isfinite(g).all(), name
    for name in ("vfe.layers.0.linear.weight", "rpn.trunk.convs.0.conv.weight"):
        assert grads[name].abs().max() > 0, name


# ------------------------------------------- SECOND multi-class, IoU branch


def _d3_boxes(g, B, N, spread=40.0):
    """Lidar boxes (x, y, z, w, l, h, yaw) crowded enough to overlap."""
    return torch.stack([
        torch.rand(B, N, generator=g) * spread,
        torch.rand(B, N, generator=g) * spread - spread / 2,
        torch.rand(B, N, generator=g) * 2 - 2.5,
        0.4 + 2.0 * torch.rand(B, N, generator=g),
        0.6 + 4.0 * torch.rand(B, N, generator=g),
        1.0 + 1.0 * torch.rand(B, N, generator=g),
        (torch.rand(B, N, generator=g) - 0.5) * 2 * np.pi], -1)


@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("N,K", [(70400, 40), (70400, 1), (1000, 0),
                                 (1000, 40), (333, 1), (1000, 300),
                                 (131, 64), (1, 64), (2, 5)])
def test_d3_iou_matches_plain(dev, B, N, K):
    """The 3-D IoU kernel against its plain version on the card, within
    1e-5, non-finite entries equal: crowded boxes, the gt boxes among the
    anchors (IoU 1), zero-size boxes, and boxes decoded from overflowed
    exps (h = inf at z = -inf, w = inf, a NaN yaw); one row, rows that end
    a tile short (131, 333, 1000 against tiles of 128), more gt boxes than
    a chunk of 64 (300); one launch a call, and its clipped count the pairs
    `d3_cull_plain` keeps."""
    g = torch.Generator().manual_seed(30 + K)
    b1 = _d3_boxes(g, B, N, spread=40.0 if N > 1000 else 10.0)
    b2 = _d3_boxes(g, B, K, spread=40.0 if N > 1000 else 10.0)
    m = min(K, max(0, (N - 3) // 2))          # gt boxes with a counterpart
    if m:
        b1[:, :m] = b2[:, :m]                  # identical pairs
        b1[:, m:2 * m, 3] = 0.0                # zero width
        b2[:, 0, 5] = 0.0                      # a flat gt box
    if N >= 3:
        b1[:, -1, 5], b1[:, -1, 2] = float("inf"), float("-inf")
        b1[:, -2, 3] = float("inf")
        b1[:, -3, 6] = float("nan")
    b1, b2 = b1.to(dev), b2.to(dev)
    before = riou.launches_d3
    got, clipped = riou.d3_iou(b1, b2, count=True)
    want = riou.d3_iou_plain(b1, b2)
    kept = (~riou.d3_cull_plain(b1, b2)).sum((1, 2))
    torch.cuda.synchronize()
    assert riou.launches_d3 == before + (1 if K else 0)
    assert got.shape == (B, N, K)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0, equal_nan=True)
    assert clipped.tolist() == kept.tolist()
    if m > 1:
        # identical boxes: 1 up to the fp32 clip's rounding at 40 m
        diag = got[:, torch.arange(1, m), torch.arange(1, m)]
        torch.testing.assert_close(diag, torch.ones_like(diag), atol=1e-3,
                                   rtol=0)
        assert int((got[:, :-3] > 0).sum()) > B * m
        assert not torch.isfinite(got[:, -1]).any()


@pytest.mark.parametrize("case", D3_CASES)
def test_d3_iou_geometry_matches_plain(dev, case):
    """The kernel on the cull's edge geometries (`d3_case`: touching edges and
    corners, boxes 1 ulp apart, degenerate gt boxes, zero-size, z-stacked,
    padded gt slots, non-finite and huge fields): the plain version within
    1e-5, non-finite entries equal, every pair that `d3_cull_plain` culls
    exactly 0, and its clipped count the pairs that it keeps. A plain value
    above 1 (beyond rounding) is no IoU (the plain clip by a gt point keeps
    the whole row box), and one more than 1e-5 from the fp64 value is
    decided by rounding (a zero-width or zero-length box, or a gt point,
    makes the union a difference of nearly equal volumes): the kernel,
    whose sums run in another order than torch's reductions, lands
    elsewhere there. Only the degenerate and zero-size cases have such
    entries; they are not compared."""
    a, b = d3_case(case, np.random.default_rng(D3_CASES.index(case) + 70),
                   B=3, N=300, K=70)
    a, b = torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)
    got, clipped = riou.d3_iou(a, b, count=True)
    want = riou.d3_iou_plain(a, b)
    want64 = riou.d3_iou_plain(a.double(), b.double())
    cull = riou.d3_cull_plain(a, b)
    torch.cuda.synchronize()
    err64 = (want.double() - want64).abs()
    sound = ((want <= 1 + 1e-5) & (err64 <= 1e-5)) | ~torch.isfinite(want)
    assert sound.all() or case in ("degenerate", "zero_size")
    torch.testing.assert_close(got[sound], want[sound], atol=1e-5, rtol=0,
                               equal_nan=True)
    assert torch.equal(torch.isfinite(got), torch.isfinite(want))
    assert (got[cull] == 0).all() and (want[cull] == 0).all()
    assert clipped.tolist() == (~cull).sum((1, 2)).tolist()


def test_d3_iou_padded_gt_layout(dev):
    """The IoU branch's layout at its real size: [4, 70 400] boxes over the
    fhd anchor area against 64 gt slots, 6 boxes and 58 of padding (zeros)
    an example, and a few boxes decoded to a width beyond D3_TAME (a row
    the cull may not take, so neither its tile's union): the plain version
    within 1e-5, every padding pair of a tame row 0, the clipped count
    `d3_cull_plain`'s (a small share of the pairs)."""
    g = torch.Generator().manual_seed(33)
    B, N = 4, 70400
    b1 = _d3_boxes(g, B, N, spread=70.0)
    b1[..., 3:5] = torch.tensor([1.6, 3.9])
    b1[..., 5], b1[..., 2] = 1.56, -1.78
    huge = torch.tensor([11, 300, 4097, 60000])
    b1[:, huge, 3] = 1e13
    b2 = torch.zeros(B, 64, 7)
    b2[:, :6] = b1[:, torch.arange(6) * 9973]
    b2[:, :6, 3:6] *= 1.2
    b1, b2 = b1.to(dev), b2.to(dev)
    got, clipped = riou.d3_iou(b1, b2, count=True)
    want = riou.d3_iou_plain(b1, b2)
    kept = (~riou.d3_cull_plain(b1, b2)).sum((1, 2))
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    tame = torch.ones(N, dtype=torch.bool)
    tame[huge] = False
    assert (got[:, tame, 6:] == 0).all()
    assert clipped.tolist() == kept.tolist()
    assert 0 < int(kept.sum()) < 0.01 * B * N * 64


def test_d3_iou_rejects_what_it_cannot_take(dev):
    b = torch.zeros(2, 5, 7, device=dev)
    with pytest.raises(ValueError, match="float32"):
        riou.d3_iou(b.double(), b)
    with pytest.raises(ValueError, match="batch"):
        riou.d3_iou(b, b[:1])
    many = torch.zeros(65536, 1, 7, device=dev)
    with pytest.raises(ValueError, match="65535 examples"):
        riou.d3_iou(many, many)
    with pytest.raises(RuntimeError, match="no backward"):
        riou.d3_iou(b.clone().requires_grad_(), b)


def _mc_nms_inputs(g, B=2, N=1500, C=3):
    """Tied boxes and scores (five levels) for C classes, one class of the
    last example below the score threshold."""
    boxes, _, valid = _tied_nms_inputs(g, B, N)
    scores = torch.randint(0, 5, (B, N, C), generator=g).float() / 4
    scores[:, 1000:1200] = scores[:, 0:200]
    scores[-1, :, -1] = 0.1
    return boxes, scores, valid


def test_multiclass_nms_launches_and_ties_match_cpu(dev):
    """Multi-class NMS of 2 examples x 3 classes on the card: one overlap
    and one suppression launch for all six rows, and the CPU's indices,
    keep masks and scores exactly, ties among scores and boxes included."""
    g = torch.Generator().manual_seed(31)
    boxes, scores, valid = _mc_nms_inputs(g)
    kw = dict(num_classes=3, pre_max_size=1000, post_max_size=100,
              iou_threshold=0.01, score_threshold=0.3)
    nms.multiclass_nms(boxes.to(dev), scores.to(dev), valid.to(dev), **kw)
    before = (riou.launches, riou.launches_suppress)
    got = nms.multiclass_nms(boxes.to(dev), scores.to(dev), valid.to(dev),
                             **kw)
    torch.cuda.synchronize()
    assert (riou.launches, riou.launches_suppress) == \
        (before[0] + 1, before[1] + 1)
    want = nms.multiclass_nms(boxes, scores, valid, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    assert not want[1][-1, -1].any() and want[1][0].sum() > 0


def test_multiclass_predict_runs_without_host_sync(dev):
    """`predict` of the published multi-class config (3 classes, 211 200
    anchors an example, per-class rotated NMS) on random predictions at
    batch 2: no synchronising CUDA call, one launch of each NMS kernel for
    all classes and examples, and the CPU's valid mask and labels, boxes
    and scores within 1e-4."""
    cfg = load_pipeline_config(Path(__file__).resolve().parents[1] /
                               "second_tpu_torch" / "configs" /
                               "second_multiclass.config")
    _, spec, info, assigner, _ = build_voxelnet(cfg.model, device="cpu")
    A = info.num_anchors
    anchors = torch.as_tensor(assigner.generate_anchors(
        info.feature_map_size)["anchors"].reshape(1, A, 7)).expand(2, A, 7)
    g = torch.Generator().manual_seed(32)
    preds = {"box_preds": torch.randn(2, A, 7, generator=g) * 0.3,
             "cls_preds": torch.randn(2, A, 3, generator=g) * 1.5 - 2.0,
             "dir_cls_preds": torch.randn(2, A, 2, generator=g)}
    dpreds = {k: v.to(dev) for k, v in preds.items()}
    danchors = anchors.to(dev)
    predict(spec, dpreds, danchors)                     # built and loaded
    before = (riou.launches, riou.launches_suppress)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        det = predict(spec, dpreds, danchors)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert (riou.launches, riou.launches_suppress) == \
        (before[0] + 1, before[1] + 1)
    want = predict(spec, preds, anchors)
    valid = want["valid"]
    assert torch.equal(det["valid"].cpu(), valid) and int(valid.sum()) > 0
    assert torch.equal(det["labels"].cpu(), want["labels"])
    assert set(want["labels"][valid].tolist()) == {0, 1, 2}
    for k in ("boxes", "scores"):
        torch.testing.assert_close(det[k].cpu()[valid], want[k][valid],
                                   atol=1e-4, rtol=1e-4)


# ------------------------------------------------- the two-stage kernels


# the ROI-align kernels against their plain versions: the forward in the
# plain version's order of operations (built with -fmad=false), within
# 1e-6 of the output's scale; the backward sums the same products in
# another order, within 1e-5 of each gradient's scale in fp32 (1e-12 in
# fp64)
ROI_FWD_TOL = {torch.float32: 1e-6, torch.float64: 1e-12}
ROI_BWD_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}


def _rois(g, B, N, H, W, kind):
    """[B, N, 5] rois (cx, cy, w, l, yaw) in pixels over an H x W map:
    random rotated ones, or with `kind` some of each example straddling
    the edges, thousands of pixels off the map, of zero width or length,
    or non-finite."""
    def u(lo, hi):
        return lo + (hi - lo) * torch.rand(B, N, generator=g,
                                           dtype=torch.float64)
    rois = torch.stack([u(0, W), u(0, H), u(1, 12), u(1, 12),
                        u(-np.pi, np.pi)], -1)
    if kind == "edge":
        rois[:, ::2, 0] = u(-3, 3)[:, ::2]
        rois[:, 1::2, 1] = H + u(-3, 3)[:, 1::2]
    elif kind == "far":
        rois[:, ::3, 0] = 5000.0
        rois[:, 1::3, 1] = -7000.5
        rois[:, 2::3, :2] = 3.0e6
    elif kind == "degenerate":
        rois[:, ::2, 2] = 0.0
        rois[:, 1::2, 3] = 0.0
        rois[:, 2::4, 2:4] = 0.0
    elif kind == "nonfinite":
        rois[:, 0, 0] = float("nan")
        rois[:, 1, 1] = float("inf")
    return rois


def _roi_inputs(dev, dtype, kind="random", B=2, C=40, H=30, W=25, N=7,
                out=(14, 14), s=2, seed=40):
    from second_tpu_torch.ops.roi_align_rotated import sample_points
    g = torch.Generator().manual_seed(seed)
    cdt = torch.float64 if dtype == torch.float64 else torch.float32
    feat = torch.randn(B, C, H, W, generator=g).to(dtype).to(dev)
    coords = sample_points(_rois(g, B, N, H, W, kind).to(cdt), out, s)
    return feat, coords.to(dev), s


def _scaled_err(got, want):
    fin = torch.isfinite(want)
    assert torch.equal(fin, torch.isfinite(got))
    err = (got - want)[fin].abs().max().item() if fin.any() else 0.0
    return err / max(want[fin].abs().max().item() if fin.any() else 0.0,
                     1e-30)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float64])
@pytest.mark.parametrize("kind", ["random", "edge", "far", "degenerate",
                                  "nonfinite"])
def test_roi_align_forward_matches_plain(dev, dtype, kind):
    """The forward kernel against the plain vectorised gather on the same
    map and sample points: within ROI_FWD_TOL of the scale, non-finite
    entries where the plain version has them, zeros off the map; one
    launch."""
    from second_tpu_torch.ops.cuda import roi_align as ra
    feat, coords, s = _roi_inputs(dev, dtype, kind)
    before = ra.launches
    got = ra.roi_align(feat, coords, s)
    assert ra.launches == before + 1
    want = ra.roi_align_plain(feat, coords, s)
    assert got.shape == want.shape == (14, 40, 14, 14)
    assert got.dtype == want.dtype == coords.dtype
    tol = ROI_FWD_TOL[coords.dtype]
    assert _scaled_err(got, want) <= tol
    if kind == "far":
        assert (got.view(2, 7, -1)[:, ::3] == 0).all()
        assert (got.view(2, 7, -1)[:, 2::3] == 0).all()


@pytest.mark.parametrize("samples", [1, 2])
@pytest.mark.parametrize("C", [1, 33, 64, 128, 160, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float64])
def test_roi_align_forward_is_plain_bitwise(dev, dtype, C, samples):
    """The forward kernels (the channels-last copy, the crops) give the
    plain version's crops bit for bit, NaNs included: rois half off the
    map (every other one straddling an edge), one far off it, one NaN and
    one whose samples all land in one pixel; one launch."""
    from second_tpu_torch.ops.cuda import roi_align as ra
    from second_tpu_torch.ops.roi_align_rotated import sample_points
    g = torch.Generator().manual_seed(C + 10 * samples)
    B, N, H, W = 2, 9, 30, 25
    cdt = torch.float64 if dtype == torch.float64 else torch.float32
    rois = _rois(g, B, N, H, W, "edge")
    rois[:, 1, :2] = torch.tensor([3.0e6, -7000.5], dtype=rois.dtype)
    rois[:, 3, :4] = torch.tensor([W // 2 + 0.5, H // 2 + 0.5, 0.2, 0.1],
                                  dtype=rois.dtype)
    rois[:, 5, 0] = float("nan")
    feat = torch.randn(B, C, H, W, generator=g).to(dtype).to(dev)
    coords = sample_points(rois.to(cdt), (14, 14), samples).to(dev)
    before = ra.launches
    got = ra.roi_align(feat, coords, samples)
    assert ra.launches == before + 1
    want = ra.roi_align_plain(feat, coords, samples)
    assert got.shape == want.shape == (B * N, C, 14, 14)
    assert got.dtype == want.dtype == cdt
    assert _same_bits(got, want)
    crops = got.reshape(B, N, -1)
    assert torch.isnan(crops[:, 5]).all() and (crops[:, 1] == 0).all()
    assert not torch.isnan(crops[:, 3]).any()


@pytest.mark.parametrize("out,s,C", [((14, 14), 2, 128), ((3, 5), 1, 1),
                                     ((4, 2), 3, 33)])
def test_roi_align_crop_shapes(dev, out, s, C):
    """Other crop sizes, sample counts and channel counts than the
    detector's, fp32."""
    from second_tpu_torch.ops.cuda import roi_align as ra
    feat, coords, s = _roi_inputs(dev, torch.float32, "edge", C=C, out=out,
                                  s=s, seed=41)
    got = ra.roi_align(feat, coords, s)
    want = ra.roi_align_plain(feat, coords, s)
    assert got.shape == (14, C, *out)
    assert _scaled_err(got, want) <= ROI_FWD_TOL[torch.float32]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float64])
@pytest.mark.parametrize("kind", ["random", "edge", "far", "degenerate",
                                  "nonfinite"])
def test_roi_align_backward_matches_autograd_of_plain(dev, dtype, kind):
    """The backward kernels against autograd of the plain version (on an
    fp32 copy of a bf16 map: the kernels sum in fp32): the map's and the
    coordinates' gradients within ROI_BWD_TOL of their scale, non-finite
    entries where the plain version has them, bitwise over two calls, the
    counts of in-map samples and cell runs equal to the plain mirror's,
    zero map gradient where no tap lands."""
    from second_tpu_torch.ops.cuda import roi_align as ra
    feat, coords, s = _roi_inputs(dev, dtype, kind, seed=42)
    g = torch.Generator().manual_seed(43)
    grad = torch.randn(14, 40, 14, 14, generator=g).to(coords.dtype).to(dev)
    _check_bwd(feat, coords, grad, s)
    gf, _ = ra.roi_align_bwd(feat, coords, grad, s)
    wf, _ = ra.roi_align_backward_plain(feat.to(coords.dtype), coords, grad,
                                        s)
    assert torch.equal(gf == 0, wf == 0) or kind != "random"


def test_roi_align_backward_is_deterministic(dev):
    """Two backward calls on the same inputs, with many samples on the same
    pixels (overlapping rois on a small map), give bitwise-equal
    gradients."""
    from second_tpu_torch.ops.cuda import roi_align as ra
    feat, coords, s = _roi_inputs(dev, torch.float32, "random", B=2, C=64,
                                  H=12, W=10, N=64, seed=44)
    g = torch.Generator().manual_seed(45)
    grad = torch.randn(128, 64, 14, 14, generator=g).to(dev)
    a = ra.roi_align_bwd(feat, coords, grad, s)
    b = ra.roi_align_bwd(feat, coords, grad, s)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def _same_bits(a, b):
    """Bitwise equality of two float tensors, NaNs included."""
    ints = {torch.float32: torch.int32, torch.float64: torch.int64}
    return torch.equal(a.view(ints[a.dtype]), b.view(ints[b.dtype]))


def _check_bwd(feat, coords, grad, s, ref64=False):
    """The backward kernels on these inputs: bitwise equal over two calls,
    within ROI_BWD_TOL of autograd of the plain version (on the map in the
    coordinates' dtype; with `ref64`, of the plain version in fp64 on the
    same values), and their counts of in-map samples and cell runs equal to
    the plain mirror's bookkeeping. Returns the counts."""
    from second_tpu_torch.ops.cuda import roi_align as ra
    before = ra.launches_bwd
    gf, gc, counts = ra.roi_align_bwd(feat, coords, grad, s, counts=True)
    again = ra.roi_align_bwd(feat, coords, grad, s)
    assert ra.launches_bwd == before + 2
    assert _same_bits(gf, again[0]) and _same_bits(gc, again[1])
    ref = torch.float64 if ref64 else coords.dtype
    wf, wc = ra.roi_align_backward_plain(feat.to(ref), coords.to(ref),
                                         grad.to(ref), s)
    tol = ROI_BWD_TOL[coords.dtype]
    assert gf.dtype == coords.dtype and gf.shape == feat.shape
    assert _scaled_err(gf, wf) <= tol
    assert _scaled_err(gc, wc) <= tol
    keys, ncells = ra.sample_cells(coords, *feat.shape[2:])
    assert tuple(counts.tolist()) == ra.cell_counts(keys, ncells)
    return tuple(counts.tolist())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float64])
def test_roi_align_backward_pile_crosses_chunks(dev, dtype):
    """Hundreds of zero-sized rois on one point pile 300 x 784 samples on
    one cell, a run across some 1800 chunks of the walk, summed by the
    fix-up; the other rois random, some of their runs crossing chunk edges
    too. Held to the plain version in fp64: the plain version's own fp32
    sum of 235 200 samples on one pixel (atomic adds on the card) lies some
    1e-5 of the scale from it."""
    from second_tpu_torch.ops.roi_align_rotated import sample_points
    g = torch.Generator().manual_seed(48)
    B, N, C, H, W = 2, 400, 40, 30, 25
    rois = _rois(g, B, N, H, W, "random")
    rois[:, :300, :4] = torch.tensor([12.3, 7.6, 0.0, 0.0],
                                     dtype=torch.float64)
    cdt = torch.float64 if dtype == torch.float64 else torch.float32
    feat = torch.randn(B, C, H, W, generator=g).to(dtype).to(dev)
    coords = sample_points(rois.to(cdt)).to(dev)
    grad = torch.randn(B * N, C, 14, 14, generator=g).to(cdt).to(dev)
    n_in, runs = _check_bwd(feat, coords, grad, 2, ref64=True)
    assert n_in >= B * 300 * 784 and runs >= B


def test_roi_align_backward_off_the_map(dev):
    """Rois wholly off the map: no sample counted, the map's gradient all
    zeros, every coordinate's gradient zero."""
    feat, coords, s = _roi_inputs(dev, torch.float32, "far", seed=49)
    g = torch.Generator().manual_seed(50)
    grad = torch.randn(14, 40, 14, 14, generator=g).to(dev)
    assert _check_bwd(feat, coords, grad, s) == (0, 0)
    from second_tpu_torch.ops.cuda import roi_align as ra
    gf, gc = ra.roi_align_bwd(feat, coords, grad, s)
    assert not gf.any() and not gc.any()


@pytest.mark.parametrize("C", [33, 128, 256])
@pytest.mark.parametrize("out,s", [((14, 14), 1), ((4, 5), 3), ((14, 14), 2)])
def test_roi_align_backward_widths_and_samples(dev, C, out, s):
    """Channel counts that fill 64-, 128- and 256-thread walk groups (33
    leaves most of a group idle), one and three samples a bin side, fp32,
    rois straddling the map's edges."""
    feat, coords, s = _roi_inputs(dev, torch.float32, "edge", C=C, out=out,
                                  s=s, seed=51)
    g = torch.Generator().manual_seed(52)
    grad = torch.randn(14, C, *out, generator=g).to(dev)
    _check_bwd(feat, coords, grad, s)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float64])
@pytest.mark.parametrize("kind", ["random", "edge"])
def test_roi_align_backward_256_channels(dev, dtype, kind):
    """The temporal-fusion refine's second crop: 256 channels (the walk's
    slices of 256), the detector's 14 x 14 bins of 2 x 2 samples, 64 rois
    an example over a 40 x 36 map: the backward within ROI_BWD_TOL of
    autograd of the plain version as at 128 channels, bitwise over two
    calls, its counts the plain mirror's; the forward bitwise the plain
    version."""
    from second_tpu_torch.ops.cuda import roi_align as ra
    feat, coords, s = _roi_inputs(dev, dtype, kind, B=2, C=256, H=40, W=36,
                                  N=64, seed=53)
    g = torch.Generator().manual_seed(54)
    grad = torch.randn(128, 256, 14, 14, generator=g).to(coords.dtype)
    _check_bwd(feat, coords, grad.to(dev), s)
    got = ra.roi_align(feat, coords, s)
    assert _same_bits(got, ra.roi_align_plain(feat, coords, s))


def test_projection_winners_card_matches_cpu(dev):
    """The fusion RPN's projection on the card: the winners of 30 000
    points over the fhd BEV grid (200 x 176 cells, many points a cell, a
    third invalid) equal the CPU's, and the canvas of a 256-channel P3 map
    the CPU's bit for bit."""
    from second_tpu_torch.models import fusion
    g = torch.Generator().manual_seed(55)
    B, P = 2, 30000
    bev = torch.stack([torch.randint(0, 200, (B, P), generator=g),
                       torch.randint(0, 176, (B, P), generator=g)], -1)
    pix = torch.stack([torch.randint(0, 48, (B, P), generator=g),
                       torch.randint(0, 156, (B, P), generator=g)], -1)
    valid = torch.rand((B, P), generator=g) < 0.66
    p3 = torch.randn(B, 256, 48, 156, generator=g)
    want = fusion.projection_winners(bev.int(), valid, (200, 176))
    got = fusion.projection_winners(bev.int().to(dev), valid.to(dev),
                                    (200, 176))
    assert torch.equal(got.cpu(), want)
    canvas = fusion.project_image_to_bev(p3.to(dev), pix.int().to(dev),
                                         bev.int().to(dev), valid.to(dev),
                                         (200, 176))
    assert torch.equal(canvas.cpu(), fusion.project_image_to_bev(
        p3, pix.int(), bev.int(), valid, (200, 176)))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_roi_align_autograd_through_the_rois(dev, dtype):
    """`roi_align_batched` under autograd on the card: the map's gradient
    in the map's dtype, and the rois' gradient (through `sample_points`)
    within 1e-5 of the plain version's on the CPU, on an fp32 copy of a
    bf16 map (a bf16 map's gradient within one bf16 unit of it: the kernel
    rounds its fp32 sums once, where autograd of the plain version would
    round and add each tap's share in bf16)."""
    from second_tpu_torch.ops.roi_align_rotated import roi_align_batched
    g = torch.Generator().manual_seed(46)
    feat = torch.randn(2, 16, 20, 22, generator=g).to(dtype)
    rois = _rois(g, 2, 5, 20, 22, "edge").float()
    w = torch.randn(10, 16, 14, 14, generator=g)
    grads = []
    for d in (dev, torch.device("cpu")):
        f = (feat if d.type == "cuda" else feat.float()).to(d)
        f.requires_grad_(True)
        r = rois.to(d).requires_grad_(True)
        (roi_align_batched(f, r) * w.to(d)).sum().backward()
        grads.append((f.grad.cpu(), r.grad.cpu()))
    (gf, gr), (wf, wr) = grads
    assert gf.dtype == dtype
    if dtype == torch.bfloat16:
        assert ((gf.float() - wf).abs() <= 2.0 ** -7 * wf.abs() +
                1e-6 * wf.abs().max()).all()
    else:
        assert _scaled_err(gf, wf) <= 1e-5
    assert _scaled_err(gr, wr) <= 1e-5


def _standup_boxes(g, B, K, dtype):
    """[B, K, 4] xyxy boxes, crowded (a third duplicated from others), some
    invalid, some NaN; and the valid mask."""
    lo = torch.rand(B, K, 2, generator=g, dtype=torch.float64) * 30
    wh = 0.5 + torch.rand(B, K, 2, generator=g, dtype=torch.float64) * 4
    boxes = torch.cat([lo, lo + wh], -1)
    if K > 3:
        src = torch.randint(0, K, (B, K), generator=g)
        dup = torch.rand(B, K, generator=g) < 0.3
        boxes = torch.where(dup[..., None], torch.gather(
            boxes, 1, src[..., None].expand(-1, -1, 4)), boxes)
        boxes[:, 2, 2] = float("nan")
    valid = torch.rand(B, K, generator=g) < 0.85
    return boxes.to(dtype), valid


# K on either side of a word, of the kernel's tile of rows (32) and of its
# columns (8 words, 256), and on either side of the suppression's wide
# kernel (past NMS_MAX_K)
STANDUP_KS = [1, 31, 32, 33, 63, 64, 65, 255, 256, 257, 2048, 4096, 4097]


@pytest.mark.parametrize("K", STANDUP_KS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_standup_overlap_bits_exact(dev, K, dtype):
    """The standup-NMS bitmask kernel against its plain version (the dense
    standup IoU, thresholded, packed): every bit equal, at thresholds 0.7,
    0 and -0.1 (every valid pair a bit, the NaN and zero-area boxes too);
    one launch a call; the NMS keep sets equal."""
    g = torch.Generator().manual_seed(47 + K)
    boxes, valid = _standup_boxes(g, 3, K, dtype)
    if K > 8:
        boxes[:, 3, 2] = boxes[:, 3, 0]     # zero width
        boxes[:, 6, 3] = boxes[:, 6, 1]     # zero height
    cand, v = boxes.to(dev), valid.to(dev)
    pairs = torch.ones(K, K, dtype=torch.bool, device=dev).triu(1) & \
        v[:, :, None] & v[:, None, :]
    for thr in (0.7, 0.0, -0.1):
        before = riou.launches_standup
        got = riou.standup_overlap(cand, v, thr)
        assert riou.launches_standup == before + 1
        want = riou.standup_overlap_plain(cand, v, thr)
        assert torch.equal(got, want)
        assert torch.equal(got.cpu(), riou.standup_overlap_plain(boxes,
                                                                 valid, thr))
        assert torch.equal(riou.nms_suppress(got, v),
                           riou.nms_suppress_plain(got, v))
        if thr < 0:
            assert torch.equal(riou.unpack_bits(got, K), pairs)
        elif thr == 0.0 and K >= 32:
            assert int(riou.unpack_bits(got, K).sum()) > 0


@pytest.mark.parametrize("K", [33, 65, 257, 2048])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_standup_overlap_writes_every_word(dev, K, dtype):
    """The output comes from `torch.empty`: a block the caching allocator
    held filled with -1 and freed is what the kernel gets, and every word
    at or below the diagonal and every word of an invalid row comes back
    0 (the plain version's bits)."""
    g = torch.Generator().manual_seed(49 + K)
    boxes, valid = _standup_boxes(g, 3, K, dtype)
    valid[:, 1::3] = False
    cand, v = boxes.to(dev), valid.to(dev)
    W = (K + 31) // 32
    junk = torch.full((3, K, W), -1, dtype=torch.int32, device=dev)
    ptr = junk.data_ptr()
    del junk
    # the allocator may hand out another free block of the size first:
    # those outputs are held until the filled block comes back
    held = []
    for _ in range(64):
        got = riou.standup_overlap(cand, v, 0.0)
        if got.data_ptr() == ptr:
            break
        held.append(got)
    assert got.data_ptr() == ptr
    bits = riou.unpack_bits(got, K)
    lower = torch.ones(K, K, dtype=torch.bool, device=dev).tril()
    assert not bits[:, lower].any()
    assert (got[~v] == 0).all()
    for out in held + [got]:
        assert torch.equal(out, riou.standup_overlap_plain(cand, v, 0.0))
    assert bits.any()


def test_standup_overlap_rejects_what_it_cannot_take(dev):
    g = torch.Generator().manual_seed(48)
    boxes, valid = _standup_boxes(g, 2, 40, torch.float32)
    with pytest.raises(ValueError):
        riou.standup_overlap(boxes.to(dev).half(), valid.to(dev), 0.5)
    with pytest.raises(ValueError):
        riou.standup_overlap(boxes.to(dev)[..., :3], valid.to(dev), 0.5)
    with pytest.raises(RuntimeError, match="no backward"):
        riou.standup_overlap(boxes.to(dev).requires_grad_(), valid.to(dev),
                             0.5)


def test_two_stage_refine_card_matches_cpu(dev, pp):
    """The two-stage detector on the PointPillars config at full width (64
    proposals an example; stage 1's norm statistics calibrated on the
    batch), the same weights on the card and the CPU: the second stage
    (proposals, crops, refine head) on the card's stage-1 outputs, card
    (kernels) against CPU (plain versions): the proposals' standup NMS on
    the same boxes and scores gives the same indices and valid; one launch
    each of the ROI-align and standup-bitmask kernels; `predict_two_stage` with no host sync and the
    CPU's keep sets on the same predictions. Crops and head on the card's
    proposals: crops within 1e-4 at the same boxes (the sample points'
    sin and cos an ulp apart), the head on the same crops within 1e-4."""
    from second_tpu_torch.models import (build_two_stage_voxelnet,
                                         predict_two_stage, second_stage)
    from second_tpu_torch.ops.cuda import roi_align as ra
    cfg = pp["cfg"]
    net_h, spec = build_two_stage_voxelnet(cfg.model, num_proposals=64,
                                           device="cpu", seed=0)[:2]
    b = pp["batch"]
    vox = device_voxelize(pp["vspec"], b["points"], b["points_mask"], "cpu")
    calibrate_norms_(net_h.stage1, vox["voxels"], vox["num_points"],
                     vox["coordinates"], vox["voxel_valid"])
    net_c = build_two_stage_voxelnet(cfg.model, num_proposals=64,
                                     device=dev, seed=0)[0]
    net_c.load_state_dict(net_h.state_dict())
    anchors = torch.as_tensor(b["anchors"])
    with torch.no_grad():
        vox_c = device_voxelize(pp["vspec"], b["points"], b["points_mask"],
                                dev)
        stage1 = net_c.stage1(vox_c["voxels"], vox_c["num_points"],
                              vox_c["coordinates"], vox_c["voxel_valid"])
        before = (ra.launches, riou.launches_standup)
        seen = []

        def recording_nms(*args, **kwargs):
            seen.append((args, kwargs))
            return nms.nearest_nms(*args, **kwargs)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(second_stage, "nearest_nms", recording_nms)
            pc = net_c.refine(stage1, anchors.to(dev))
        assert (ra.launches, riou.launches_standup) == \
            (before[0] + 1, before[1] + 1)
        (args, kwargs), = seen
        idx_h, keep_h = nms.nearest_nms(*[a.cpu() for a in args], **kwargs)
        crops_c = net_c.crops(stage1["trunk"], pc["proposals"])
        prop = {k: v.cpu() for k, v in pc["proposals"].items()}
        crops_h = net_h.crops(stage1["trunk"].cpu(), prop)
        head_h = net_h.second_rpn(crops_c.cpu())
        anchors_c = anchors.to(dev)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            det_c = predict_two_stage(spec, pc, anchors_c)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        det_h = predict_two_stage(
            spec, {**{k: v.cpu() for k, v in pc.items() if k != "proposals"},
                   "proposals": {k: v.cpu() for k, v in
                                 pc["proposals"].items()}}, anchors)
    assert torch.equal(prop["indices"], idx_h)
    assert torch.equal(prop["valid"], keep_h) and int(keep_h.sum()) > 0
    # at the same proposal boxes; their sample points' sin and cos round an
    # ulp apart on the two devices
    assert _scaled_err(crops_c.cpu(), crops_h) <= 1e-4
    B, N = pc["proposals"]["indices"].shape
    torch.testing.assert_close(
        pc["second_box_preds"].cpu(),
        head_h["box_preds"].view(B, N, -1) + prop["box_enc"], atol=1e-4,
        rtol=1e-4)
    for k in ("cls", "dir"):
        torch.testing.assert_close(pc[f"second_{k}_preds"].cpu(),
                                   head_h[f"{k}_preds"].view(B, N, -1),
                                   atol=1e-4, rtol=1e-4)
    assert torch.equal(det_c["valid"].cpu(), det_h["valid"])


# ------------------------------------------------- the temporal detector

FHD = Path(__file__).resolve().parents[1] / "second_tpu_torch" / "configs" \
    / "second_car_fhd.config"


@pytest.fixture(scope="module")
def tmp_pairs(dev):
    """The temporal detector on second_car_fhd.config at full width (64
    proposals an example, fp32, random weights from seed 0) on the card and
    on the CPU, and two eval pairs of LiDAR scans (seeds 0 and 1 as the
    current frames, 2 and 3 as the previous ones) voxelized on both."""
    from second_tpu_torch.models import build_temporal_voxelnet
    from second_tpu_torch.train.steps_multistage import voxelize_pair
    cfg = load_pipeline_config(FHD)
    net_h, spec, info, assigner, _ = build_temporal_voxelnet(
        cfg.model, 64, device="cpu")
    net_c = build_temporal_voxelnet(cfg.model, 64, device=dev)[0]
    prep = ExamplePrep(assigner, info.feature_map_size,
                       PrepConfig(max_points=30000, training=False))
    pc_range = tuple(cfg.model.voxel_generator.point_cloud_range)

    def scan(seed):
        return lidar_scan_scene(np.random.default_rng(seed),
                                pc_range=pc_range, num_azimuth=512)
    exs = []
    for s in (0, 1):
        p, b, n = scan(s)
        exs.append(prep({"points": p, "p_points": scan(s + 2)[0],
                         "gt_boxes": b, "gt_names": n},
                        np.random.default_rng(s)))
    batch = {k: torch.as_tensor(v) for k, v in prep.collate(exs).items()
             if k != "image_idx"}
    vspec = VoxelizeSpec.from_config(cfg.model.voxel_generator, 40000)
    pair_h = voxelize_pair(vspec, batch, "cpu")[0]
    pair_c = voxelize_pair(vspec, {k: v.to(dev) for k, v in batch.items()},
                           dev)[0]
    return dict(cfg=cfg, spec=spec, net_h=net_h, net_c=net_c, batch=batch,
                pair_h=pair_h, pair_c=pair_c, vspec=vspec)


def test_temporal_forward_card_matches_cpu(dev, tmp_pairs):
    """The temporal forward from the same weights, card (kernels) against
    CPU (plain versions): both frames of both pairs in one backbone call
    (the sparse gather-GEMM 14 launches); stage 1 and the gated BEV map
    within 1e-3; on the card's stage 1, the proposals' standup NMS gives
    the CPU's indices and valid on the same boxes and scores, the crops of
    the fused map at the same boxes within 1e-4 of their scale and the
    head on the same crops within 1e-4; `predict_temporal` with no host
    sync keeps what the CPU keeps on the same predictions."""
    from second_tpu_torch.models import predict_temporal, second_stage
    t = tmp_pairs
    net_c, net_h, spec = t["net_c"], t["net_h"], t["spec"]
    anchors = t["batch"]["anchors"]
    with torch.no_grad():
        before = subm.launches
        s1_c = net_c.stage1(*t["pair_c"])
        torch.cuda.synchronize()
        assert subm.launches - before == 14
        s1_h = net_h.stage1(*t["pair_h"])
        for k in ("box_preds", "cls_preds", "gated_bev_feat"):
            torch.testing.assert_close(s1_c[k].cpu(), s1_h[k], atol=1e-3,
                                       rtol=1e-3)
        seen = []

        def recording_nms(*args, **kwargs):
            seen.append((args, kwargs))
            return nms.nearest_nms(*args, **kwargs)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(second_stage, "nearest_nms", recording_nms)
            pc = net_c.refine(s1_c, anchors.to(dev),
                              crop_map=s1_c["gated_bev_feat"])
        (args, kwargs), = seen
        idx_h, keep_h = nms.nearest_nms(*[a.cpu() for a in args], **kwargs)
        prop = {k: v.cpu() for k, v in pc["proposals"].items()}
        crops_c = net_c.crops(s1_c["gated_bev_feat"], pc["proposals"])
        crops_h = net_h.crops(s1_c["gated_bev_feat"].cpu(), prop)
        head_c = net_c.second_rpn(crops_c)
        head_h = net_h.second_rpn(crops_c.cpu())
        anchors_c = anchors.to(dev)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            det_c = predict_temporal(spec, pc, anchors_c)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        det_h = predict_temporal(
            spec, {**{k: v.cpu() for k, v in pc.items() if k != "proposals"},
                   "proposals": prop}, anchors)
    assert torch.equal(prop["indices"], idx_h)
    assert torch.equal(prop["valid"], keep_h) and int(keep_h.sum()) > 0
    assert crops_c.shape[1] == net_c.middle.out_channels
    assert _scaled_err(crops_c.cpu(), crops_h) <= 1e-4
    for k in head_h:
        torch.testing.assert_close(head_c[k].cpu(), head_h[k], atol=1e-4,
                                   rtol=1e-4)
    assert torch.equal(det_c["valid"].cpu(), det_h["valid"])


def test_temporal_train_step_grads_reach_the_gate(dev, tmp_pairs):
    """One train step of `make_temporal_steps` on the card (fp32, flax's
    initialisers, two synthetic pairs at the config's 16 000 train voxels):
    the loss and every gradient finite, the gate's (`bev_fusion`, which
    only the fused map reaches), the refine head's and the sparse
    middle's nonzero; the sparse gather-GEMM 14 launches in the forward."""
    from second_tpu_torch.data.synthetic import SyntheticPairDataset
    from second_tpu_torch.models import build_temporal_voxelnet
    from second_tpu_torch.train.steps_multistage import make_temporal_steps
    cfg = tmp_pairs["cfg"]
    net, spec, info, assigner, _ = build_temporal_voxelnet(cfg.model, 64,
                                                           device=dev)
    init_train_weights_(net, 0)
    vg = cfg.model.voxel_generator
    prep = ExamplePrep(assigner, info.feature_map_size, PrepConfig(
        max_points=20000, training=True, voxel_size=tuple(vg.voxel_size),
        pc_range=tuple(vg.point_cloud_range)))
    ds = SyntheticPairDataset(2, seed=1, pc_range=tuple(vg.point_cloud_range))
    rng = np.random.default_rng(0)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in prep.collate(
        [prep(ds[i], rng) for i in range(2)]).items() if k != "image_idx"}
    opt, lr_sched = build_optimizer(cfg.train_config.optimizer,
                                    cfg.train_config.steps, net.parameters())
    vspec = VoxelizeSpec.from_config(vg, 16000, shuffle_overflow=True)
    step = make_temporal_steps(spec, vspec)[0]
    before = subm.launches
    state, metrics = step(TrainState(net, opt, 0, lr_sched), batch)
    torch.cuda.synchronize()
    assert subm.launches - before == 14
    assert all(torch.isfinite(v).all() for v in metrics.values())
    params = dict(net.named_parameters())
    for name, p in params.items():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
    for name in ("bev_fusion.conv_gating_bev.weight",
                 "bev_fusion.conv_gating_bev.bias",
                 "second_rpn.conv_cls_second.weight",
                 "middle.subm.0.weight"):
        assert params[name].grad.abs().max() > 0, name


def test_temporal_sequence_matches_pair_model_on_card(dev, tmp_pairs):
    """`TemporalSequenceVoxelNet` on the card, loaded from the pair model's
    state dict, on a T = 3 sequence (the first pair's previous and current
    frames, the second pair's current frame): one backbone call (14
    sparse gather-GEMM launches), its two pairs' outputs equal to the pair
    model's on the same pairs within 1e-4, the proposals exactly."""
    from second_tpu_torch.models import build_temporal_voxelnet
    t = tmp_pairs
    cur, prev = t["pair_c"]
    keys = ("voxels", "num_points", "coordinates", "voxel_valid")
    frames = {k: torch.cat([prev[k][:1], cur[k][:1], cur[k][1:2]])
              for k in keys}
    seq = build_temporal_voxelnet(t["cfg"].model, 64, device=dev,
                                  sequence=True)[0]
    seq.load_state_dict(t["net_c"].state_dict(), strict=True)
    anchors = t["batch"]["anchors"][0].to(dev)
    with torch.no_grad():
        before = subm.launches
        sp = seq(frames, anchors)
        torch.cuda.synchronize()
        assert subm.launches - before == 14
        pp = t["net_c"]({k: v[1:] for k, v in frames.items()},
                        {k: v[:-1] for k, v in frames.items()},
                        anchors[None].expand(2, *anchors.shape))
    for k in ("indices", "valid"):
        assert torch.equal(sp["proposals"][k], pp["proposals"][k]), k
    for k in ("box_preds", "cls_preds", "second_box_preds",
              "second_cls_preds"):
        torch.testing.assert_close(sp[k], pp[k], atol=1e-4, rtol=1e-4)


# ------------------------------------------ serving and joint tracking


def _det_boxes(g, T, D, z=-1.5):
    """[T, D, 7] lidar boxes spread over second_car_fhd.config's range."""
    return torch.cat([torch.rand(T, D, 1, generator=g) * 66 + 2,
                      torch.rand(T, D, 1, generator=g) * 76 - 38,
                      torch.full((T, D, 1), z),
                      1.2 + torch.rand(T, D, 3, generator=g) * 3,
                      (torch.rand(T, D, 1, generator=g) - 0.5) * 6.3], -1)


def test_roi_align_16x16_tracking_crops_card_matches_cpu(dev):
    """The joint model's tracking crops at full width: 16 x 16 crops (2 x 2
    samples a bin) of a [4, 128, 200, 176] fp32 map at 16 boxes a frame
    (`crop_rois` at second_car_fhd.config's geometry), card (the ROI-align
    kernels) against CPU (the plain version): the crops within 1e-4 of
    their scale (the sample points' sin and cos an ulp apart), and under
    autograd the map's and the boxes' gradients within 1e-4 of their
    scale; one forward and one backward launch."""
    from second_tpu_torch.models.second_stage import crop_rois
    from second_tpu_torch.ops.cuda import roi_align
    g = torch.Generator().manual_seed(51)
    feat = torch.randn(4, 128, 200, 176, generator=g)
    boxes = _det_boxes(g, 4, 16)
    w = torch.randn(64, 128, 16, 16, generator=g)
    geo = ((0.0, -40.0, -3.0, 70.4, 40.0, 1.0), (0.05, 0.05, 0.1), 8)
    out = []
    for d in (dev, torch.device("cpu")):
        f = feat.to(d).requires_grad_(True)
        b = boxes.to(d).requires_grad_(True)
        before = (roi_align.launches, roi_align.launches_bwd)
        crops = crop_rois(f, b, *geo, crop_size=16)
        (crops * w.to(d)).sum().backward()
        if d.type == "cuda":
            assert (roi_align.launches, roi_align.launches_bwd) == \
                (before[0] + 1, before[1] + 1)
        out.append((crops.detach().cpu(), f.grad.cpu(), b.grad.cpu()))
    (c, gf, gb), (wc, wf, wb) = out
    assert tuple(c.shape) == (64, 128, 16, 16)
    assert _scaled_err(c, wc) <= 1e-4
    assert _scaled_err(gf, wf) <= 1e-4
    assert _scaled_err(gb, wb) <= 1e-4


def test_match_dets_to_gt_card_matches_cpu(dev):
    """`match_dets_to_gt` of a 4-frame window, 16 dets against 64 padded gt
    slots a frame: one `riou_matrix` launch on the card, det_cls and
    det_id equal to the CPU's (the plain IoU), some matched."""
    from second_tpu_torch.models.joint_track import match_dets_to_gt
    g = torch.Generator().manual_seed(52)
    T, D, G = 4, 16, 64
    gt = _det_boxes(g, T, G)
    src = torch.randint(0, 20, (T, D), generator=g)
    dets = torch.gather(gt, 1, src[..., None].expand(-1, -1, 7)).clone()
    dets[..., :2] += torch.randn(T, D, 2, generator=g) * 0.3
    dets[..., 6] += torch.randn(T, D, generator=g) * 0.2
    det_valid = torch.rand(T, D, generator=g) < 0.9
    gt_valid = torch.arange(G)[None].expand(T, G) < 20
    gt_ids = torch.randint(0, 100, (T, G), generator=g)
    before = riou.launches
    got = match_dets_to_gt(*(a.to(dev) for a in (dets, det_valid, gt,
                                                 gt_ids, gt_valid)))
    assert riou.launches == before + 1
    want = match_dets_to_gt(dets, det_valid, gt, gt_ids, gt_valid)
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])
    assert 0 < int(want[0].sum()) < T * D


def test_inference_context_card_matches_cpu(dev, tmp_path):
    """`InferenceContext` on second_car_fhd.config (fp32, as it builds it)
    from the same random weights (`init_weights_`, seed 0) on the card and
    on the CPU, one fhd bench scan alone and in a batch of two: the same
    keep set and labels, boxes and scores within 1e-3 (cuDNN against
    oneDNN sums through the RPN)."""
    from second_tpu_torch.core.inference_ctx import InferenceContext
    from second_tpu_torch.models import init_weights_
    ctxs = []
    for d in (dev, torch.device("cpu")):
        ctx = InferenceContext(FHD).build(tmp_path / "none",
                                          max_points=30000, device=d)
        init_weights_(ctx.module, 0)
        ctxs.append(ctx)
    cfg = ctxs[0].cfg
    pc_range = tuple(cfg.model.voxel_generator.point_cloud_range)
    clouds = [lidar_scan_scene(np.random.default_rng(s), pc_range=pc_range,
                               num_azimuth=512)[0] for s in (0, 1)]
    for pcs in (clouds[:1], clouds):
        got = ctxs[0].inference_batch(pcs)
        want = ctxs[1].inference_batch(pcs)
        for a, b in zip(got, want):
            assert len(a["scores"]) == len(b["scores"]) > 0
            np.testing.assert_array_equal(a["labels"], b["labels"])
            np.testing.assert_allclose(a["boxes"], b["boxes"], rtol=1e-3,
                                       atol=1e-3)
            np.testing.assert_allclose(a["scores"], b["scores"], rtol=1e-3,
                                       atol=1e-3)


# ------------------------------------------------------------ soft-NMS


def _decay_inputs(g, R, K):
    """R rows of K candidates: a symmetric IoU matrix, 70% zeros; scores
    sorted descending, row 1 all -inf, row 2 with ties, row 3 with an
    invalid tail."""
    iou = torch.rand(R, K, K, generator=g)
    iou = torch.where(torch.rand(R, K, K, generator=g) < 0.7, 0.0, iou)
    iou = torch.maximum(iou, iou.transpose(1, 2))
    scores = torch.rand(R, K, generator=g).sort(1, descending=True)[0]
    if R > 3:
        scores[1] = float("-inf")
        scores[2, K // 4:K // 2] = scores[2, K // 4]
        scores[3, K // 2:] = float("-inf")
    return iou, scores


@pytest.mark.parametrize("rotated", [True, False])
@pytest.mark.parametrize("method", ["gaussian", "linear"])
def test_soft_nms_card_matches_cpu(dev, rotated, method):
    """`soft_nms` on a batch of 3 rows of 300 crowded candidates, the pair
    cap binding, card (the row gather, the pair IoU and the decay kernels:
    the pair-list one rotated, the standup one standup, one launch) against
    CPU (their plain versions): picks and keep exact, scores
    within 1e-5 (the card's and the CPU's sin and cos round the corners an
    ulp apart)."""
    g = torch.Generator().manual_seed(3)
    boxes = torch.stack([_boxes(g, 300) for _ in range(3)])
    if not rotated:
        boxes = torch.cat([boxes[..., :2] - boxes[..., 2:4] / 2,
                           boxes[..., :2] + boxes[..., 2:4] / 2], -1)
    scores = torch.rand(3, 300, generator=g)
    valid = torch.rand(3, 300, generator=g) < 0.9
    kw = dict(pre_max_size=256, post_max_size=100, sigma=0.5,
              iou_threshold=0.3, score_threshold=0.6, method=method,
              rotated=rotated, max_pairs=2048)
    before = (riou.launches_soft_pairs, riou.launches_soft_standup)
    got = nms.soft_nms(boxes.to(dev), scores.to(dev), valid.to(dev), **kw)
    # rotated: the pair-list kernel; standup: the standup kernel
    assert (riou.launches_soft_pairs, riou.launches_soft_standup) == \
        (before[0] + rotated, before[1] + (not rotated))
    want = nms.soft_nms(boxes, scores, valid, **kw)
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[2].cpu(), want[2])
    torch.testing.assert_close(got[1].cpu(), want[1], rtol=1e-5, atol=0)
    assert want[2].any() and not want[2].all()


def _standup_decay_inputs(g, R, K):
    """R rows of K crowded standup candidates (xyxy, some boxes repeated
    exactly), scores sorted descending: row 1 all -inf, row 2 with ties,
    row 3 with an invalid tail; row 0 (and row 4) with non-finite boxes
    (two overlapping infinite ones, NaN and +-inf coordinates, a zero
    width) and NaN and +inf scores, one NaN score among the last K / 8
    boxes, moved far from the others (from K 257: a warp whose scores
    change only through the pick or the sweep of non-finite scores)."""
    side = 8.0 * (K / 300) ** 0.5
    xy = torch.rand(R, K, 2, generator=g) * side
    wl = 0.5 + 3.0 * torch.rand(R, K, 2, generator=g)
    cand = torch.cat([xy, xy + wl], -1)
    cand[:, 1::9] = cand[:, :-1:9][:, :cand[:, 1::9].shape[1]]
    scores = torch.rand(R, K, generator=g).sort(1, descending=True)[0]
    inf, nan = float("inf"), float("nan")
    if K >= 24:
        for r in (0, 4) if R > 4 else (0,):
            cand[r, 3] = cand[r, 20] = torch.tensor([-inf, -inf, inf, inf])
            cand[r, 7, 0], cand[r, 8, 3] = nan, inf
            cand[r, 9, 1], cand[r, 11, 2] = -inf, cand[r, 11, 0]
            scores[r, 12], scores[r, 15] = nan, inf
            scores[r, K - 2] = nan
            if K >= 257:
                cand[r, K - K // 8:] += 1000.0
    if R > 3:
        scores[1] = float("-inf")
        scores[2, K // 4:K // 2] = scores[2, K // 4]
        scores[3, K // 2:] = float("-inf")
    return cand, scores


@pytest.mark.parametrize("method", ["gaussian", "linear"])
@pytest.mark.parametrize("K", [1, 31, 33, 257, 1000, 4096, 4097])
def test_soft_nms_decay_standup_matches_plain(dev, K, method):
    """The standup decay kernel (one block a row, the boxes in shared
    memory and each lane's in registers, the pick's IoU row computed a
    step) against its plain version (the dense standup matrix, the dense
    decay) on the card: picks exact, NaN where NaN, their finite scores
    within 1e-6 relative; 5 rows (one of -inf, one with ties, one with an
    invalid tail, two with non-finite boxes and scores), 100 steps, one
    launch; every span width it picks from K, and past NMS_MAX_K the wide
    kernel."""
    g = torch.Generator().manual_seed(K + 1)
    R = 2 if K >= 4096 else 5
    cand, scores = (t.to(dev) for t in _standup_decay_inputs(g, R, K))
    m = min(K, 100)
    before = riou.launches_soft_standup
    got = riou.soft_nms_decay_standup(cand, scores, m, method, 0.5, 0.3)
    assert riou.launches_soft_standup == before + 1
    want = riou.soft_nms_decay_standup_plain(cand, scores, m, method, 0.5,
                                             0.3)
    _check_pair_decay(got, want)
    if K >= 24:
        assert want[0][0, 0] == 12 and torch.isnan(want[1][0, 0])


@pytest.mark.parametrize("K", [1000, 4096])
def test_soft_nms_decay_standup_every_candidate_picked(dev, K):
    """m = K: every finite candidate picked once, then (the row all -inf)
    index 0; kernel against plain as above."""
    g = torch.Generator().manual_seed(5 * K)
    cand, scores = (t.to(dev) for t in _standup_decay_inputs(g, 1, K))
    got = riou.soft_nms_decay_standup(cand, scores, K, "gaussian", 0.5, 0.3)
    want = riou.soft_nms_decay_standup_plain(cand, scores, K, "gaussian",
                                             0.5, 0.3)
    _check_pair_decay(got, want)
    assert (want[0][0, -3:] == 0).all()


@pytest.mark.parametrize("method", ["gaussian", "linear"])
def test_soft_nms_decay_standup_non_finite_as_the_cpu(dev, method):
    """The standup decay kernel on non-finite boxes and scores against the
    plain version on the CPU: 5 rows of 1000, 200 steps."""
    g = torch.Generator().manual_seed(8)
    cand, scores = _standup_decay_inputs(g, 5, 1000)
    want = riou.soft_nms_decay_standup_plain(cand, scores, 200, method, 0.5,
                                             0.3)
    got = riou.soft_nms_decay_standup(cand.to(dev), scores.to(dev), 200,
                                      method, 0.5, 0.3)
    _check_pair_decay(got, want)
    assert (want[1].isnan().sum() > 2) == (method == "gaussian")


def test_soft_nms_decay_standup_refuses_what_it_cannot_take(dev):
    cand = torch.zeros(1, 8, 4, device=dev)
    scores = torch.zeros(1, 8, device=dev)
    with pytest.raises(ValueError, match="float32"):
        riou.soft_nms_decay_standup(cand.double(), scores, 2)
    with pytest.raises(ValueError, match="one device"):
        riou.soft_nms_decay_standup(cand.cpu(), scores, 2)
    with pytest.raises(ValueError, match="m <= K"):
        riou.soft_nms_decay_standup(cand, scores, 9)
    with pytest.raises(RuntimeError, match="no backward"):
        riou.soft_nms_decay_standup(cand.requires_grad_(), scores, 2)


def _pair_decay_inputs(g, R, K, P):
    """R rows of K candidates and P pair slots a row: distinct pairs
    i < j in row-major order (as `soft_nms_pairs` lists them), their IoU
    in [0, 1) with a tenth 0 and a tenth slightly negative, a tenth of the
    slots not ok and the slots past a row's pairs 0 and not ok; scores
    sorted descending, row 1 all -inf, row 2 with ties, row 3 with an
    invalid tail."""
    plist = torch.zeros(R, P, dtype=torch.int64)
    ok = torch.zeros(R, P, dtype=torch.bool)
    for r in range(R):
        a = torch.randint(0, K, (2, 3 * P), generator=g)
        lo, hi = a.min(0).values, a.max(0).values
        flat = torch.unique((lo * K + hi)[lo < hi])[:P]
        plist[r, :len(flat)] = flat
        ok[r, :len(flat)] = True
    ok &= torch.rand(R, P, generator=g) >= 0.1
    iou = torch.rand(R, P, generator=g)
    u = torch.rand(R, P, generator=g)
    iou = torch.where(u < 0.1, 0.0, torch.where(u < 0.2, -1e-3 * iou, iou))
    scores = torch.rand(R, K, generator=g).sort(1, descending=True)[0]
    scores[1] = float("-inf")
    scores[2, K // 4:K // 2] = scores[2, K // 4]
    scores[3, K // 2:] = float("-inf")
    return plist, ok, iou, scores


def _check_pair_decay(got, want):
    """Picks exact, NaN where the plain version's are NaN, the same
    entries finite, the finite ones within 1e-6 relative."""
    assert torch.equal(got[0].cpu(), want[0].cpu())
    got, want = got[1].cpu(), want[1].cpu()
    assert torch.equal(got.isnan(), want.isnan())
    fin = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), fin)
    assert torch.equal(got[~fin & ~want.isnan()], want[~fin & ~want.isnan()])
    torch.testing.assert_close(got[fin], want[fin], rtol=1e-6, atol=0)


@pytest.mark.parametrize("method", ["gaussian", "linear"])
@pytest.mark.parametrize("K,P", [(1, 8), (33, 64), (257, 2048),
                                 (1000, 8192), (1000, 32768), (4096, 8192),
                                 (4096, 32768), (4097, 8192)])
def test_soft_nms_decay_pairs_matches_plain(dev, K, P, method):
    """The pair-list decay kernel (one block a row, the pairs' adjacency in
    shared memory, or past it in a device scratch: at P = 32768 for K 1000
    and 4096; past NMS_MAX_K the wide route, everything in the scratch)
    against its plain version on the card: picks exact, their scores
    within 1e-6 relative; 4 rows (one of -inf, one with ties, one with an
    invalid tail), 100 steps, one launch."""
    g = torch.Generator().manual_seed(K + P)
    plist, ok, iou, scores = _pair_decay_inputs(g, 4, K, P)
    assert (riou.soft_pairs_scratch(K, P) > 0) == \
        (P == 32768 or K > riou.NMS_MAX_K)
    args = [t.to(dev) for t in (plist, ok, iou, scores)]
    m = min(K, 100)
    before = riou.launches_soft_pairs
    got = riou.soft_nms_decay_pairs(*args, m, method, 0.5, 0.3)
    assert riou.launches_soft_pairs == before + 1
    _check_pair_decay(got, riou.soft_nms_decay_pairs_plain(
        *args, m, method, 0.5, 0.3))


@pytest.mark.parametrize("K,P", [(1000, 8192), (4096, 32768)])
def test_soft_nms_decay_pairs_every_candidate_picked(dev, K, P):
    """m = K: every candidate picked once, then (the row all -inf) index
    0; kernel against plain as above."""
    g = torch.Generator().manual_seed(3 * K)
    args = [t.to(dev) for t in _pair_decay_inputs(g, 4, K, P)]
    got = riou.soft_nms_decay_pairs(*args, K, "gaussian", 0.5, 0.3)
    want = riou.soft_nms_decay_pairs_plain(*args, K, "gaussian", 0.5, 0.3)
    _check_pair_decay(got, want)
    assert torch.equal(want[0][0].sort()[0].cpu(), torch.arange(K))


@pytest.mark.parametrize("method", ["gaussian", "linear"])
def test_soft_nms_decay_pairs_non_finite_as_the_cpu(dev, method):
    """NaN IoU values and NaN and +inf scores: the kernel against the
    plain version on the CPU (torch.argmax's order there: NaN above +inf,
    the first of equals): a NaN neighbour is picked the step after it
    appears and every other non-finite score turns -inf."""
    g = torch.Generator().manual_seed(5)
    plist, ok, iou, scores = _pair_decay_inputs(g, 4, 1000, 8192)
    iou[0, :200:7] = float("nan")
    iou[3, 100:300:5] = float("nan")
    scores[0, 10], scores[0, 500] = float("nan"), float("inf")
    scores[2, 900], scores[2, 901] = float("inf"), float("nan")
    want = riou.soft_nms_decay_pairs_plain(plist, ok, iou, scores, 200,
                                           method, 0.5, 0.3)
    got = riou.soft_nms_decay_pairs(plist.to(dev), ok.to(dev), iou.to(dev),
                                    scores.to(dev), 200, method, 0.5, 0.3)
    _check_pair_decay(got, want)
    # the two NaN scores, and (gaussian) the NaN decays; a NaN IoU decays
    # a linear score by 1 (NaN > thr is false)
    assert (want[1].isnan().sum() > 2) == (method == "gaussian")


def test_soft_nms_decay_pairs_refuses_what_it_cannot_take(dev):
    plist = torch.zeros(1, 4, dtype=torch.int64, device=dev)
    ok = torch.zeros(1, 4, dtype=torch.bool, device=dev)
    iou = torch.zeros(1, 4, device=dev)
    scores = torch.zeros(1, 8, device=dev)
    with pytest.raises(ValueError, match="int64"):
        riou.soft_nms_decay_pairs(plist.int(), ok, iou, scores, 2)
    with pytest.raises(ValueError, match="m <= K"):
        riou.soft_nms_decay_pairs(plist, ok, iou, scores, 9)
    with pytest.raises(ValueError, match="sigma"):
        riou.soft_nms_decay_pairs(plist, ok, iou, scores, 2, "gaussian", 0.0)
    big = torch.zeros(1, riou.ROTATED_MAX_K + 1, device=dev)
    with pytest.raises(ValueError, match="int32"):
        riou.soft_nms_decay_pairs(plist, ok, iou, big, 1)


@pytest.mark.parametrize("K", [4097, 8192])
def test_soft_nms_decays_past_4096_match_plain(dev, K):
    """Both decay kernels past NMS_MAX_K (their wide routes) against their
    plain versions: the standup one on crowded boxes with non-finite ones
    (`_standup_decay_inputs`), the pair one on 8192 pairs
    (`_pair_decay_inputs`), 2 rows, 100 steps, gaussian and linear; and
    the whole `soft_nms`, rotated and standup, card against CPU on K
    crowded candidates (picks and keep exact, scores within 1e-5)."""
    g = torch.Generator().manual_seed(K + 2)
    cand, scores = (t.to(dev) for t in _standup_decay_inputs(g, 2, K))
    args = [t.to(dev) for t in _pair_decay_inputs(g, 4, K, 8192)]
    for method in ("gaussian", "linear"):
        _check_pair_decay(
            riou.soft_nms_decay_standup(cand, scores, 100, method, 0.5, 0.3),
            riou.soft_nms_decay_standup_plain(cand, scores, 100, method,
                                              0.5, 0.3))
        _check_pair_decay(
            riou.soft_nms_decay_pairs(*args, 100, method, 0.5, 0.3),
            riou.soft_nms_decay_pairs_plain(*args, 100, method, 0.5, 0.3))
    boxes = _nms_boxes(g, 1, K)
    sc = torch.rand(1, K, generator=g)
    valid = torch.rand(1, K, generator=g) < 0.9
    for rotated in (True, False):
        b = boxes if rotated else torch.cat(
            [boxes[..., :2] - boxes[..., 2:4] / 2,
             boxes[..., :2] + boxes[..., 2:4] / 2], -1)
        kw = dict(pre_max_size=K, post_max_size=100, rotated=rotated)
        got = nms.soft_nms(b.to(dev), sc.to(dev), valid.to(dev), **kw)
        want = nms.soft_nms(b, sc, valid, **kw)
        assert torch.equal(got[0].cpu(), want[0])
        assert torch.equal(got[2].cpu(), want[2])
        torch.testing.assert_close(got[1].cpu(), want[1], rtol=1e-5, atol=0)
