"""The port's hand-written CUDA kernels against their plain PyTorch versions
on the card. Marked `cuda`: they skip where there is no CUDA card (the CPU
has no nvcc and no kernel), and run on the card with

    python -m pytest -m cuda tests/test_torch_cuda.py -q

The main path's shapes are checked by `chip_smoke.py`; these are small
shapes with the edges (row widths, index types, channel counts, tap counts,
fills, tiles across examples, criteria) the kernels branch on. This file
imports torch and the port only."""

import numpy as np
import pytest
import torch

from second_tpu_torch.ops.cuda import gather, riou, subm

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
                                   (27, 5, 7)])
def test_gather_gemm_fill(dev, dtype, fill, K, C, D):
    """No tap found (every tap skipped: all zeros out) and every tap found
    (no tap skipped)."""
    got, _ = _run_conv(*_conv_case(dev, dtype, 2, 200, 333, K, C, D, fill))
    if fill == 0.0:
        assert not got.any()


@pytest.mark.parametrize("C", [16, 4, 6])
def test_gather_gemm_unaligned_features(dev, C):
    """Features that start off the 16-byte grid: the tensor-core kernel
    gathers 8 bytes a copy, or element by element, instead of 16."""
    feats, tap_idx, found, w = _conv_case(dev, torch.bfloat16, 2, 100, 256,
                                          27, C, 16, 0.2)
    buf = torch.empty(feats.numel() + 1, dtype=feats.dtype, device=dev)
    off = torch.as_strided(buf, feats.shape, feats.stride(), 1)
    off.copy_(feats)
    assert off.data_ptr() % 8
    _run_conv(off, tap_idx, found, w)


def test_gather_gemm_tile_spans_examples(dev):
    """Q = 100: every 128-row tile but the first crosses from one example
    into the next, so rows of one tile index different examples' features."""
    _run_conv(*_conv_case(dev, torch.bfloat16, 5, 64, 100, 27, 16, 16,
                          0.3))


def test_gather_gemm_rejects_wide_channels(dev):
    feats = torch.zeros(1, 4, 65, device=dev)
    idx = torch.zeros(1, 27, 4, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="channels"):
        subm.gather_gemm(feats, idx, idx.bool(), torch.zeros(27, 65, 8,
                                                              device=dev))


def test_gather_gemm_rejects_too_many_taps_in_bf16(dev):
    feats = torch.zeros(1, 4, 8, dtype=torch.bfloat16, device=dev)
    idx = torch.zeros(1, 33, 4, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="taps"):
        subm.gather_gemm(feats, idx, idx.bool(), torch.zeros(33, 8, 8,
                                                              device=dev))


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
