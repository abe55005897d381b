"""Sparse-conv gather-GEMM wrappers — the port of
`second_tpu/ops/pallas/subm.py`, with the convolution's backward.

`gather_gemm(features, tap_idx, found, weights)` applies a per-tap rulebook:
out[b, q] = Σ_k found[b, k, q] · features[b, tap_idx[b, k, q]] @ W[k], fp32
accumulation, before bias and mask. It is a `torch.autograd.Function`
(`GatherGemm`) on both devices, so the CPU tests run the same backward as
the card. The forward takes `gather_gemm_plain` for CPU tensors and
launches `csrc/subm.cu` for CUDA tensors: bf16 features go to the bf16
tensor-core kernel (`subm_gather_gemm_mma`, the main path), fp32 features
to the fp32 kernel (`subm_gather_gemm_fma`: each fp32 product as three
TF32 tensor-core products, fp32-accurate). The backward:

  * dX (only where the features require grad): the same gather-GEMM, kernel
    or plain version, applied to dOut with the transposed rulebook
    (`ops/sparse_conv.py` `transpose_rulebook_b`) and the weights
    [K, D, C]. dOut is rounded to the feature dtype first, so on the bf16
    path the tensor-core kernel takes it in bf16; dX leaves in the feature
    dtype, as JAX's dot transpose converts it.
  * dW: `sparse_wgrad`, the weight-gradient kernel of `csrc/subm_grad.cu`
    (plain version `gather_gemm_wgrad_plain`: the gathered taps against
    dOut, fp32), cast to the weights' dtype. The caller casts fp32 weights
    to the feature dtype outside the Function, so on the bf16 path dW is
    rounded to bf16 and back, as the VJP of JAX's cast does.

Both the submanifold and the strided sparse convs (`ops/sparse_conv.py`)
apply through it. JAX differentiates the einsum that applies the rulebook
(`second_tpu/ops/sparse_conv.py:636-639`, `:819-822`) by XLA autodiff; no
Pallas kernel there has a VJP.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ...device import at_least_fp32
from . import check, function, stream_ptr

# launches of the CUDA kernels since the last reset (set each to 0 to
# reset). The gather-GEMM: forward calls (`launches`), input-gradient calls
# (`launches_dgrad`), and all its launches by path, bf16 (`launches_mma`)
# or fp32 (`launches_fma`). The weight-gradient kernel: all its launches,
# and by path.
launches = 0
launches_dgrad = 0
launches_mma = 0
launches_fma = 0
launches_wgrad = 0
launches_wgrad_mma = 0
launches_wgrad_fma = 0

# the weight-gradient kernel's tile of [C, D]
WGRAD_TILE = 64
# the weight-gradient kernel scans a block's rows in windows of this many
WGRAD_WINDOW = 2048
# weight-gradient blocks to aim for, per SM: two waves of the three blocks
# of the tensor-core path that fit on an SM (72 KB of shared memory, 256
# threads). Each block owns (tap, chunk); some taps find many more rows
# than others, so the chunks are small enough that the card's block
# scheduler evens the load, and no smaller: each chunk adds a partial to
# its tap's sum. Measured best on the fhd train step
# (scripts/torch_wgrad_chunks.py)
WGRAD_BLOCKS_PER_SM = 6
# at most this many chunks a tap (the partials a tap's sum reads)
WGRAD_MAX_CHUNKS = 64
# a call's fp32 partials ([K, chunks, C, D] and the groups' [K, groups, C,
# D]) stay within this many bytes: fewer chunks a tap where they would not
# (past 256 x 256 at 27 taps; the repo's configs' calls take at most 13 MB)
WGRAD_SCRATCH_BYTES = 256 * 2 ** 20
# the partials of this many consecutive chunks are summed first, then the
# groups' sums (the kernel's GROUP)
WGRAD_GROUP = 8

# feat, tap_idx, found, w, out, B, N, Q, K, C, CP, D, stream (both
# gather-GEMM entries)
_MMA_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
# mma, feat, tap_idx, found, dout, partial, used, gpartial, gused, counter,
# dw, B, N, Q, K, C, D, chunk_rows, chunks, stream
_WGRAD_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 10 + \
    [ctypes.c_int] * 8 + [ctypes.c_void_p]
# the C launch functions, resolved at their first launch
_mma_launch = None
_fma_launch = None
_wgrad_launch = None
_sm_count: dict = {}
# the weight-gradient kernel's tickets (a group's and a tap's), int32 zeros,
# by (device, stream): the kernel leaves them 0, and calls on one stream
# run in order
_wgrad_counters: dict = {}


def _resolve_mma():
    global _mma_launch
    _mma_launch = function("subm", "subm_gather_gemm_mma", _MMA_ARGTYPES)
    return _mma_launch


def _resolve_fma():
    global _fma_launch
    _fma_launch = function("subm", "subm_gather_gemm_fma", _MMA_ARGTYPES)
    return _fma_launch


def _resolve_wgrad():
    global _wgrad_launch
    _wgrad_launch = function("subm_grad", "subm_wgrad", _WGRAD_ARGTYPES)
    return _wgrad_launch


def gather_gemm_plain(features, tap_idx, found, weights):
    """features [B, N, C] (fp32 or bf16; fp64 for a reference run), tap_idx
    [B, K, Q] integer, found [B, K, Q] bool, weights [K, C, D] → [B, Q, D]
    fp32 (fp64 from fp64). Weights are rounded to the feature dtype first,
    as the JAX apply does; products and sums are fp32 (fp64)."""
    B, N, C = features.shape
    off = (torch.arange(B, device=features.device) * N).view(B, 1, 1)
    rows = (tap_idx.long() + off).reshape(-1)
    taps = features.reshape(B * N, C)[rows].reshape(*tap_idx.shape, C)
    taps = torch.where(found[..., None], at_least_fp32(taps), 0.0)
    w = at_least_fp32(weights.to(features.dtype))
    return torch.einsum("bkqc,kcd->bqd", taps, w)


def padded_widths(C: int, D: int):
    """(CP, DP): the input channels padded to a power of two from 4 to 64,
    and above 64 to a multiple of 64 (320 stays 320), so that a kernel's
    stage of columns (64 in bf16, 32 in fp32) holds whole taps or lies
    within one; the output channels padded to a multiple of 8 (one mma
    n-tile)."""
    if C > 64:
        return -(-C // 64) * 64, -(-D // 8) * 8
    CP = 4
    while CP < C:
        CP *= 2
    return CP, -(-D // 8) * 8


def pack_weights(weights, CP: int, DP: int):
    """[K, C, D] → [K, CP, DP] with zeros in the padding: viewed as
    [K*CP, DP], the rows of tap k are k*CP .. k*CP + C - 1, the layout the
    kernels walk in k16 (bf16) or k8 (fp32) steps. The tensor itself where
    no padding is needed."""
    K, C, D = weights.shape
    if (C, D) != (CP, DP):
        weights = F.pad(weights, (0, DP - D, 0, CP - C))
    return weights.contiguous()


def gather_gemm_wgrad_plain(features, tap_idx, found, grad_out):
    """The weight gradient of `gather_gemm_plain`: features [B, N, C] (fp32
    or bf16), tap_idx/found [B, K, Q], grad_out [B, Q, D] → dW [K, C, D]
    fp32 (fp64 from fp64), dW[k] = Σ_{b, q found} features[b, tap_idx[b,
    k, q]]ᵀ grad_out[b, q], products and sums fp32 (fp64)."""
    B, N, C = features.shape
    off = (torch.arange(B, device=features.device) * N).view(B, 1, 1)
    rows = (tap_idx.long() + off).reshape(-1)
    taps = features.reshape(B * N, C)[rows].reshape(*tap_idx.shape, C)
    taps = torch.where(found[..., None], at_least_fp32(taps), 0.0)
    return torch.einsum("bkqc,bqd->kcd", taps, at_least_fp32(grad_out))


def _check_rulebook(name, features, tap_idx, found, D):
    """Validate a CUDA launch's features [B, N, C] and rulebook [B, K, Q]
    for the kernels' limits; returns (B, N, C, K, Q)."""
    dev = features.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    if features.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: features must be float32 or bfloat16, "
                         f"got {features.dtype}")
    if features.dim() != 3 or tap_idx.dim() != 3:
        raise ValueError(f"{name}: features [B, N, C] and tap_idx [B, K, Q] "
                         f"expected")
    B, N, C = features.shape
    _, K, Q = tap_idx.shape
    if tap_idx.shape[0] != B or found.shape != tap_idx.shape:
        raise ValueError(
            f"{name}: shapes disagree: features {tuple(features.shape)}, "
            f"tap_idx {tuple(tap_idx.shape)}, found {tuple(found.shape)}")
    if C < 1 or D < 1:
        raise ValueError(f"{name}: no channels, {C} -> {D}")
    if max(B * Q, B * N) >= 2 ** 31:
        raise ValueError(f"{name}: the kernels index rows with int32")
    if found.dtype != torch.bool:
        raise ValueError(f"{name}: found must be bool")
    if not (tap_idx.device == found.device == dev):
        raise ValueError(f"{name}: tensors on different devices")
    return B, N, C, K, Q


def _launch_gather_gemm(features, tap_idx, found, weights):
    """One launch of the gather-GEMM kernel on CUDA tensors; weights already
    in the feature dtype. Counts the launch by path."""
    dev = features.device
    if weights.dim() != 3:
        raise ValueError("gather_gemm: weights [K, C, D] expected")
    D = weights.shape[2]
    B, N, C, K, Q = _check_rulebook("gather_gemm", features, tap_idx, found,
                                    D)
    if weights.shape[:2] != (K, C) or weights.device != dev:
        raise ValueError(f"gather_gemm: weights {tuple(weights.shape)} on "
                         f"{weights.device} do not fit [{K}, {C}, D]")
    mma = features.dtype == torch.bfloat16
    features = features.contiguous()
    tap_idx = tap_idx.to(torch.int32).contiguous()
    found = found.contiguous()
    out = torch.empty((B, Q, D), dtype=torch.float32, device=dev)
    if B * Q == 0:
        return out
    CP, DP = padded_widths(C, D)
    w = pack_weights(weights, CP, DP)
    if w.data_ptr() % 16:
        w = w.clone()
    launch = (_mma_launch or _resolve_mma()) if mma else \
        (_fma_launch or _resolve_fma())
    rc = launch(features.data_ptr(), tap_idx.data_ptr(), found.data_ptr(),
                w.data_ptr(), out.data_ptr(), B, N, Q, K, C, CP, D,
                stream_ptr(dev))
    if rc:
        check("subm", rc)
    global launches_mma, launches_fma
    if mma:
        launches_mma += 1
    else:
        launches_fma += 1
    return out


def _apply(features, tap_idx, found, weights):
    """`gather_gemm_plain` on the CPU, the kernel on the card; returns (out,
    whether the kernel launched)."""
    if features.device.type == "cpu":
        return gather_gemm_plain(features, tap_idx, found, weights), False
    return _launch_gather_gemm(features, tap_idx, found,
                               weights.to(features.dtype)), True


class GatherGemm(torch.autograd.Function):
    """out = gather_gemm(features, tap_idx, found, weights), with weights
    already in the feature dtype; see the module docstring for the
    backward."""

    @staticmethod
    def forward(ctx, features, weights, tap_idx, found):
        out, launched = _apply(features, tap_idx, found, weights)
        if launched:
            global launches
            launches += 1
        ctx.save_for_backward(features, weights, tap_idx, found)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        from ..sparse_conv import transpose_rulebook_b
        features, weights, tap_idx, found = ctx.saved_tensors
        g = grad_out.to(features.dtype).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            inv_idx, inv_found = transpose_rulebook_b(tap_idx, found,
                                                      features.shape[1])
            dx = gather_gemm_dgrad(g, inv_idx, inv_found,
                                   weights.transpose(1, 2)
                                   ).to(features.dtype)
        if ctx.needs_input_grad[1]:
            dw = sparse_wgrad(features, tap_idx, found, g).to(weights.dtype)
        return dx, dw, None, None


def gather_gemm_dgrad(grad_out, inv_idx, inv_found, weights_t):
    """The input gradient of a sparse conv: the gather-GEMM (kernel or plain
    version) of grad_out [B, Q, D] (in the feature dtype) over the
    transposed rulebook [B, K, N] with the weights [K, D, C] → [B, N, C]
    fp32. Counted in `launches_dgrad` where the kernel launches."""
    out, launched = _apply(grad_out, inv_idx, inv_found, weights_t)
    if launched:
        global launches_dgrad
        launches_dgrad += 1
    return out


def gather_gemm(features, tap_idx, found, weights):
    """`gather_gemm_plain` semantics, differentiable in the features and
    the weights; the CUDA kernels for CUDA tensors."""
    dev = features.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"gather_gemm: unsupported device {dev}")
    return GatherGemm.apply(features, weights.to(features.dtype), tap_idx,
                            found)


def wgrad_tiles(C: int, D: int) -> int:
    """The weight-gradient kernel's tiles of a tap's [C, D]: WGRAD_TILE x
    WGRAD_TILE blocks, one where C and D are at most 64."""
    return -(-C // WGRAD_TILE) * -(-D // WGRAD_TILE)


def wgrad_max_chunks(K: int, C: int, D: int) -> int:
    """The chunks a tap whose fp32 partials, K chunks [C, D] and the
    groups' sums (one a WGRAD_GROUP chunks), fit WGRAD_SCRATCH_BYTES;
    WGRAD_MAX_CHUNKS where more would fit, and 1 (no partials) where none
    does."""
    per_chunk = 4 * K * C * D * (1 + 1 / WGRAD_GROUP)
    return max(1, min(WGRAD_MAX_CHUNKS,
                      int(WGRAD_SCRATCH_BYTES // per_chunk)))


def wgrad_chunks(M: int, K: int, sms: int, max_chunks=None):
    """(chunk_rows, chunks): each weight-gradient block owns one tap (one
    tile of it: K counts the (tap, tile) pairs) and `chunk_rows` (a
    multiple of 16: the kernel reads found bytes 8 at a time) of the M
    batch-flattened rows, sized so that the K x chunks blocks come to
    WGRAD_BLOCKS_PER_SM on each of the card's SMs, with at most
    `max_chunks` (WGRAD_MAX_CHUNKS by default) chunks a tap. Depends on
    the shapes and the card only, so the sums run in the same order every
    time."""
    want = max(1, min(max_chunks or WGRAD_MAX_CHUNKS,
                      WGRAD_BLOCKS_PER_SM * sms // K))
    rows = -(-max(1, -(-M // want)) // 16) * 16
    return rows, max(1, -(-M // rows))


def wgrad_plan(M: int, K: int, C: int, D: int, sms: int):
    """(chunk_rows, chunks) of a weight-gradient call of M rows, K taps and
    [C, D]. Up to 128 channels the card's blocks are shared over the
    (tap, tile) pairs (`wgrad_chunks` of K x tiles). Past 128 the chunks
    are counted from the taps alone: the tiles' blocks fill the card
    anyway, and the heaviest tap's chunk (a submanifold conv's centre tap
    finds every row) is what the call waits for: at 256 x 256 on the fhd
    scene's stage 0, 2 chunks a tap took 1.69 ms in bf16 and 12.76 in
    fp32, this plan's 29 1.07 and 8.01 (NVIDIA H100 80GB HBM3, 700.00 W;
    scripts/torch_wide_wgrad.py). Within WGRAD_SCRATCH_BYTES either way."""
    wide = C > 128 or D > 128
    return wgrad_chunks(M, K if wide else K * wgrad_tiles(C, D), sms,
                        wgrad_max_chunks(K, C, D))


def _counters(dev, n: int):
    """The ticket counters of the weight-gradient kernel on `dev`'s current
    stream: int32 zeros, at least n of them."""
    key = (dev.index, stream_ptr(dev))
    counter = _wgrad_counters.get(key)
    if counter is None or counter.numel() < n:
        counter = _wgrad_counters[key] = torch.zeros(
            max(n, 1024), dtype=torch.int32, device=dev)
    return counter


def sparse_wgrad(features, tap_idx, found, grad_out):
    """`gather_gemm_wgrad_plain` semantics; `csrc/subm_grad.cu` for CUDA
    tensors, one launch a call: bf16 features with bf16 grad_out on tensor
    cores, fp32 with fp32 on CUDA cores. Each block compacts the found rows
    of its (tap, chunk) and writes a partial sum of its tile of [C, D]
    (`wgrad_tiles`); the last block of each group of WGRAD_GROUP chunks sums
    the group's partials in chunk order, and the last group of each (tap,
    tile) the groups' sums in group order, so the result is the same bits
    on every run."""
    dev = features.device
    if dev.type == "cpu":
        return gather_gemm_wgrad_plain(features, tap_idx, found, grad_out)
    D = grad_out.shape[-1]
    B, N, C, K, Q = _check_rulebook("sparse_wgrad", features, tap_idx, found,
                                    D)
    if grad_out.shape != (B, Q, D) or grad_out.device != dev:
        raise ValueError(f"sparse_wgrad: grad_out {tuple(grad_out.shape)} on "
                         f"{grad_out.device}, expected [{B}, {Q}, D] on {dev}")
    if grad_out.dtype != features.dtype:
        raise ValueError(f"sparse_wgrad: grad_out must be {features.dtype} "
                         f"like the features, got {grad_out.dtype}")
    dw = torch.empty((K, C, D), dtype=torch.float32, device=dev)
    M = B * Q
    if M == 0:
        return dw.zero_()
    sms = _sm_count.get(dev.index)
    if sms is None:
        sms = _sm_count[dev.index] = \
            torch.cuda.get_device_properties(dev).multi_processor_count
    tiles = wgrad_tiles(C, D)
    chunk_rows, chunks = wgrad_plan(M, K, C, D, sms)
    groups = -(-chunks // WGRAD_GROUP)
    # the kernel reads no partials with one chunk a tap, and no groups'
    # sums with one group
    partial = torch.empty((K, chunks, C, D) if chunks > 1 else (0,),
                          dtype=torch.float32, device=dev)
    used = torch.empty((K, tiles, chunks), dtype=torch.int32, device=dev)
    gpartial = torch.empty((K, groups, C, D) if groups > 1 else (0,),
                           dtype=torch.float32, device=dev)
    gused = torch.empty((K, tiles, groups), dtype=torch.int32, device=dev)
    features = features.contiguous()
    grad_out = grad_out.contiguous()
    tap_idx = tap_idx.to(torch.int32).contiguous()
    found = found.contiguous()
    mma = features.dtype == torch.bfloat16
    rc = (_wgrad_launch or _resolve_wgrad())(
        int(mma), features.data_ptr(), tap_idx.data_ptr(), found.data_ptr(),
        grad_out.data_ptr(), partial.data_ptr(), used.data_ptr(),
        gpartial.data_ptr(), gused.data_ptr(),
        _counters(dev, K * tiles * (groups + 1)).data_ptr(), dw.data_ptr(),
        B, N, Q, K, C, D, chunk_rows, chunks, stream_ptr(dev))
    if rc:
        check("subm_grad", rc)
    global launches_wgrad, launches_wgrad_mma, launches_wgrad_fma
    launches_wgrad += 1
    if mma:
        launches_wgrad_mma += 1
    else:
        launches_wgrad_fma += 1
    return dw
