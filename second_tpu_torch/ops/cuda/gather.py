"""Row gather — the port of `second_tpu/ops/pallas/gather.py`.

`gather_rows(src, idx)` launches `csrc/gather.cu` for a CUDA tensor and
takes `gather_rows_plain` for a CPU tensor; `flat_rows` is the batch-
flattened form the sparse convs and `predict` use (JAX `flat_rows`,
`ops/sparse_conv.py:257`). The kernel reads int32 and int64 index lists as
they are, so callers pass the indices `torch.sort`, `torch.searchsorted`
and top-k give them, without a cast.
"""

from __future__ import annotations

import ctypes

import torch

from . import check, function, refuse_grad, stream_ptr

# launches of the CUDA kernel since the last reset (set to 0 to reset)
launches = 0

# src, idx, out, rows, row_bytes, src_rows, idx_bytes, stream
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 3 + \
    [ctypes.c_int, ctypes.c_void_p]
_INDEX_BYTES = {torch.int32: 4, torch.int64: 8}
_launch = None      # the C launch function, resolved at the first launch


def _resolve():
    global _launch
    _launch = function("gather", "gather_rows", _ARGTYPES)
    return _launch


def gather_rows_plain(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[m] = src[idx[m]]: src [R, W] (any dtype), idx [M] integer in
    [0, R). Returns [M, W]."""
    return src[idx.long()]


def gather_rows(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """`gather_rows_plain` semantics; the CUDA kernel for CUDA tensors, with
    int32 or int64 indices. No gradient flows through it: under grad mode
    a `src` that requires grad raises."""
    refuse_grad("gather_rows", src)
    dev = src.device
    if dev.type == "cpu":
        return gather_rows_plain(src, idx)
    if dev.type != "cuda":
        raise ValueError(f"gather_rows: unsupported device {dev}")
    if src.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"gather_rows: src must be [R, W] and idx [M], got "
                         f"{tuple(src.shape)} and {tuple(idx.shape)}")
    if idx.device != dev:
        raise ValueError("gather_rows: src and idx on different devices")
    idx_bytes = _INDEX_BYTES.get(idx.dtype)
    if idx_bytes is None:
        raise ValueError(f"gather_rows: indices must be int32 or int64, got "
                         f"{idx.dtype}")
    if not src.is_contiguous():
        src = src.contiguous()
    if not idx.is_contiguous():
        idx = idx.contiguous()
    R, W = src.shape
    M = idx.shape[0]
    out = torch.empty((M, W), dtype=src.dtype, device=dev)
    if M == 0 or W == 0:
        return out
    rc = (_launch or _resolve())(
        src.data_ptr(), idx.data_ptr(), out.data_ptr(), M,
        W * src.element_size(), R, idx_bytes, stream_ptr(dev))
    if rc:
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
