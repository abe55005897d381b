"""The port's hand-written CUDA kernels against their plain PyTorch versions
on the card. Marked `cuda`: they skip where there is no CUDA card (the CPU
has no nvcc and no kernel), and run on the card with

    python -m pytest -m cuda tests/test_torch_cuda.py -q

The main path's shapes are checked by `chip_smoke.py`; these are small
shapes with the edges (row widths, channel counts, tap counts, criteria)
the kernels branch on. This file imports torch and the port only."""

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


def test_gather_gemm_rejects_wide_channels(dev):
    feats = torch.zeros(1, 4, 65, device=dev)
    idx = torch.zeros(1, 27, 4, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="channels"):
        subm.gather_gemm(feats, idx, idx.bool(), torch.zeros(27, 65, 8,
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
