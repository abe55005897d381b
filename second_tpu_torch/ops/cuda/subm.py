"""Sparse-conv gather-GEMM wrapper — the port of
`second_tpu/ops/pallas/subm.py`.

`gather_gemm(features, tap_idx, found, weights)` applies a per-tap rulebook:
out[b, q] = Σ_k found[b, k, q] · features[b, tap_idx[b, k, q]] @ W[k], fp32
accumulation, before bias and mask. It launches `csrc/subm.cu` for CUDA
tensors and takes `gather_gemm_plain` for CPU tensors. Both the submanifold
and the strided sparse convs (`ops/sparse_conv.py`) apply through it.
"""

from __future__ import annotations

import ctypes

import torch

from . import check, function, stream_ptr

# launches of the CUDA kernel since the last reset (set to 0 to reset)
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# feat, tap_idx, found, w, out, B, N, Q, K, C, D, dtype, stream
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


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


def gather_gemm(features, tap_idx, found, weights):
    """`gather_gemm_plain` semantics; the CUDA kernel for CUDA tensors."""
    if features.device.type == "cpu":
        return gather_gemm_plain(features, tap_idx, found, weights)
    if features.device.type != "cuda":
        raise ValueError(f"gather_gemm: unsupported device {features.device}")
    if features.dtype not in _DTYPES:
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
    if found.dtype != torch.bool:
        raise ValueError("gather_gemm: found must be bool")
    if not (tap_idx.device == found.device == weights.device ==
            features.device):
        raise ValueError("gather_gemm: tensors on different devices")
    features = features.contiguous()
    tap_idx = tap_idx.to(torch.int32).contiguous()
    found = found.contiguous()
    weights = weights.to(features.dtype).contiguous()
    out = torch.empty((B, Q, D), dtype=torch.float32, device=features.device)
    if B * Q == 0:
        return out
    rc = function("subm", "subm_gather_gemm", _ARGTYPES)(
        features.data_ptr(), tap_idx.data_ptr(), found.data_ptr(),
        weights.data_ptr(), out.data_ptr(), B, N, Q, K, C, D,
        _DTYPES[features.dtype], stream_ptr(features.device))
    check("subm", rc)
    global launches
    launches += 1
    return out
