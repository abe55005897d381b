"""Sparse-conv gather-GEMM wrapper — the port of
`second_tpu/ops/pallas/subm.py`.

`gather_gemm(features, tap_idx, found, weights)` applies a per-tap rulebook:
out[b, q] = Σ_k found[b, k, q] · features[b, tap_idx[b, k, q]] @ W[k], fp32
accumulation, before bias and mask. It takes `gather_gemm_plain` for CPU
tensors and launches `csrc/subm.cu` for CUDA tensors: bf16 features go to
the tensor-core kernel (`subm_gather_gemm_mma`, the main path), fp32
features to the CUDA-core kernel (`subm_gather_gemm_fma`). Both the
submanifold and the strided sparse convs (`ops/sparse_conv.py`) apply
through it.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import check, function, stream_ptr

# launches of the CUDA kernels since the last reset (set each to 0 to
# reset): both paths, the tensor-core path (bf16) and the CUDA-core path
# (fp32)
launches = 0
launches_mma = 0
launches_fma = 0

# the tensor-core kernel takes at most this many taps (one vote bit each)
MAX_TAPS_MMA = 32

# feat, tap_idx, found, w, out, B, N, Q, K, C, cp_shift, D, stream
_MMA_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
# feat, tap_idx, found, w, out, B, N, Q, K, C, D, stream
_FMA_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
# the C launch functions, resolved at their first launch
_mma_launch = None
_fma_launch = None


def _resolve_mma():
    global _mma_launch
    _mma_launch = function("subm", "subm_gather_gemm_mma", _MMA_ARGTYPES)
    return _mma_launch


def _resolve_fma():
    global _fma_launch
    _fma_launch = function("subm", "subm_gather_gemm_fma", _FMA_ARGTYPES)
    return _fma_launch


def gather_gemm_plain(features, tap_idx, found, weights):
    """features [B, N, C] (fp32 or bf16), tap_idx [B, K, Q] integer, found
    [B, K, Q] bool, weights [K, C, D] → [B, Q, D] fp32. Weights are rounded
    to the feature dtype first, as the JAX apply does; products and sums are
    fp32."""
    B, N, C = features.shape
    off = (torch.arange(B, device=features.device) * N).view(B, 1, 1)
    rows = (tap_idx.long() + off).reshape(-1)
    taps = features.reshape(B * N, C)[rows].reshape(*tap_idx.shape, C)
    taps = torch.where(found[..., None], taps.float(), 0.0)
    w = weights.to(features.dtype).float()
    return torch.einsum("bkqc,kcd->bqd", taps, w)


def padded_widths(C: int, D: int):
    """(CP, DP): the input channels padded to a power of two from 4 to 64,
    so that 64 / CP taps fill one 64-column stage of the tensor-core kernel
    (k16 steps at CP >= 16, 16 / CP taps a k16 step below), and the output
    channels padded to a multiple of 8 (one mma n-tile)."""
    CP = 4
    while CP < C:
        CP *= 2
    return CP, -(-D // 8) * 8


def pack_weights(weights, CP: int, DP: int):
    """[K, C, D] → [K, CP, DP] with zeros in the padding: viewed as
    [K*CP, DP], the rows of tap k are k*CP .. k*CP + C - 1, the layout the
    tensor-core kernel walks in k16 steps. The tensor itself where no
    padding is needed."""
    K, C, D = weights.shape
    if (C, D) != (CP, DP):
        weights = F.pad(weights, (0, DP - D, 0, CP - C))
    return weights.contiguous()


def gather_gemm(features, tap_idx, found, weights):
    """`gather_gemm_plain` semantics; the CUDA kernels for CUDA tensors."""
    dev = features.device
    if dev.type == "cpu":
        return gather_gemm_plain(features, tap_idx, found, weights)
    if dev.type != "cuda":
        raise ValueError(f"gather_gemm: unsupported device {dev}")
    if features.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"gather_gemm: features must be float32 or "
                         f"bfloat16, got {features.dtype}")
    if features.dim() != 3 or tap_idx.dim() != 3 or weights.dim() != 3:
        raise ValueError("gather_gemm: features [B, N, C], tap_idx "
                         "[B, K, Q], weights [K, C, D] expected")
    B, N, C = features.shape
    _, K, Q = tap_idx.shape
    D = weights.shape[2]
    if (tap_idx.shape[0] != B or found.shape != tap_idx.shape or
            weights.shape[:2] != (K, C)):
        raise ValueError(
            f"gather_gemm: shapes disagree: features {tuple(features.shape)}"
            f", tap_idx {tuple(tap_idx.shape)}, found {tuple(found.shape)}, "
            f"weights {tuple(weights.shape)}")
    if not 1 <= C <= 64 or not 1 <= D <= 64:
        raise ValueError(f"gather_gemm: the kernel takes 1..64 input and "
                         f"output channels, got {C} -> {D}")
    mma = features.dtype == torch.bfloat16
    if mma and K > MAX_TAPS_MMA:
        raise ValueError(f"gather_gemm: the bf16 kernel takes at most "
                         f"{MAX_TAPS_MMA} taps, got {K}")
    if max(B * Q, B * N) >= 2 ** 31:
        raise ValueError("gather_gemm: the kernels index rows with int32")
    if found.dtype != torch.bool:
        raise ValueError("gather_gemm: found must be bool")
    if not (tap_idx.device == found.device == weights.device == dev):
        raise ValueError("gather_gemm: tensors on different devices")
    features = features.contiguous()
    tap_idx = tap_idx.to(torch.int32).contiguous()
    found = found.contiguous()
    weights = weights.to(features.dtype)
    out = torch.empty((B, Q, D), dtype=torch.float32, device=dev)
    if B * Q == 0:
        return out
    if mma:
        CP, DP = padded_widths(C, D)
        w = pack_weights(weights, CP, DP)
        if w.data_ptr() % 16:
            w = w.clone()
        launch = _mma_launch or _resolve_mma()
        widths = (C, CP.bit_length() - 1, D)
    else:
        w = weights.contiguous()
        launch = _fma_launch or _resolve_fma()
        widths = (C, D)
    rc = launch(features.data_ptr(), tap_idx.data_ptr(), found.data_ptr(),
                w.data_ptr(), out.data_ptr(), B, N, Q, K, *widths,
                stream_ptr(dev))
    if rc:
        check("subm", rc)
    global launches, launches_mma, launches_fma
    launches += 1
    if mma:
        launches_mma += 1
    else:
        launches_fma += 1
    return out
