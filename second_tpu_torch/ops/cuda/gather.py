"""Row gather — the port of `second_tpu/ops/pallas/gather.py`.

`gather_rows(src, idx)` launches `csrc/gather.cu` for a CUDA tensor and
takes `gather_rows_plain` for a CPU tensor; `flat_rows` is the batch-
flattened form the sparse convs and `predict` use (JAX `flat_rows`,
`ops/sparse_conv.py:257`).
"""

from __future__ import annotations

import ctypes

import torch

from . import check, function, stream_ptr

# launches of the CUDA kernel since the last reset (set to 0 to reset)
launches = 0

# src, idx, out, rows, row_bytes, src_rows, unit, stream
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 3 + \
    [ctypes.c_int, ctypes.c_void_p]


def gather_rows_plain(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[m] = src[idx[m]]: src [R, W] (any dtype), idx [M] integer in
    [0, R). Returns [M, W]."""
    return src[idx.long()]


def gather_rows(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """`gather_rows_plain` semantics; the CUDA kernel for CUDA tensors."""
    if src.device.type == "cpu":
        return gather_rows_plain(src, idx)
    if src.device.type != "cuda":
        raise ValueError(f"gather_rows: unsupported device {src.device}")
    if src.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"gather_rows: src must be [R, W] and idx [M], got "
                         f"{tuple(src.shape)} and {tuple(idx.shape)}")
    if idx.device != src.device:
        raise ValueError("gather_rows: src and idx on different devices")
    if idx.dtype != torch.int32:
        idx = idx.to(torch.int32)
    src = src.contiguous()
    idx = idx.contiguous()
    R, W = src.shape
    if R >= 2 ** 31:
        raise ValueError("gather_rows: the kernel indexes rows with int32")
    M = idx.shape[0]
    out = torch.empty((M, W), dtype=src.dtype, device=src.device)
    row_bytes = W * src.element_size()
    if M == 0 or row_bytes == 0:
        return out
    unit = 16
    while unit > 1 and (row_bytes % unit or src.data_ptr() % unit or
                        out.data_ptr() % unit):
        unit //= 2
    rc = function("gather", "gather_rows", _ARGTYPES)(
        src.data_ptr(), idx.data_ptr(), out.data_ptr(), M, row_bytes, R,
        unit, stream_ptr(src.device))
    check("gather", rc)
    global launches
    launches += 1
    return out


def flat_rows(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """src [B, N, C], idx [B, ...] integer → src[b, idx[b, ...]] through ONE
    gather over the batch-flattened [B*N, C] source."""
    B, N, C = src.shape
    off = (torch.arange(B, device=idx.device, dtype=idx.dtype) * N).reshape(
        (B,) + (1,) * (idx.dim() - 1))
    out = gather_rows(src.reshape(B * N, C), (idx + off).reshape(-1))
    return out.reshape(idx.shape + (C,))
