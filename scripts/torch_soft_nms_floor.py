"""The latency floors of the soft-NMS decay kernels' steps, on one card.

    python3 scripts/torch_soft_nms_floor.py [--variant NAME=RIOU_CU ...]

The decay kernels (`second_tpu_torch/csrc/riou.cu`) run `m` steps a row,
each waiting on the last one's pick, so their bytes bounds (chip_smoke.py
`soft_bound`, `soft_standup_bound`, `soft_pairs_bound`) are not what they
can reach.

The standup kernel (`soft_nms_decay_standup_kernel`, standup soft-NMS): a
step is the slot reduction every warp makes itself, the pick's box read
from shared memory, each lane's meet test of its PER candidates held in
registers with the pick and the IoU and decay of those that meet, then
one barrier. Timed, for K = 1000 and K = 4096 standup envelopes of
crowded boxes (the sides of PAIR_ROWS), each warm and after an L2 flush:
- standup slots: K steps of the slot reduction alone (a launch picks
  every candidate once, so that every step decays finite scores, as the
  kernel's steps do), the pick's owner setting its register to -inf and
  recomputing its best (no box, no IoU);
- standup step: K steps of slots, the pick's box, the meet test of every
  candidate and the IoU and gaussian decay of those that meet, in the
  real kernel's code without its output writes: the floor of the real
  kernel's step (a launch's prologue, some 3-6 us, is a K-th of it a
  step);
- standup m = 1, 100, K: `soft_nms_decay_standup` itself, gaussian,
  device-only time from the profiler after an L2 flush (as for the pair
  kernel below), a later step from m = K and m = 1; each `--variant`'s
  standup kernel beside it (checked equal first).

The pair-list kernel (`soft_nms_decay_pairs_kernel`, rotated soft-NMS): a
prologue stages the row's adjacency in shared memory, then a step is a
reduction of the warps' slot maxima that every warp makes itself (two
`__reduce_*_sync`), the walk of the pick's neighbours in shared memory, the
slot recomputed by the warps that changed, and one barrier. Timed, for
K = 1000 with 8192 pairs (the fhd call's rows: 1000 crowded boxes in a
35 m square, the cap binding, as on the fhd call) and K = 4096 with 8192
pairs (crowded boxes as chip_smoke.py's long row), each warm and after
an L2 flush (a 128 MB fill):
- slots: STEPS steps of the slot reduction alone, the pick's owner
  setting it to -inf and recomputing its slot, one barrier a step (the
  real kernel's code; no walk, no read of device memory);
- walk: slots and the walk of each pick's list in shared memory, a
  synthetic adjacency of the same number of entries (candidate b's
  neighbours b + 1 ... b + d mod K, d = 2P / K), each warp decaying the
  neighbours in its span and recomputing its slot where it changed: the
  floor of the real kernel's step;
- pairs m = 1, 100, K: `soft_nms_decay_pairs` itself on the real pair
  list, gaussian, at m = 1 (its prologue and one step), m = COLD_STEPS
  (the fhd call's m) and m = K, device-only time from the profiler
  (chip_smoke.py's `DeviceTimer`: the median of 5 runs, each after an L2
  flush; an event-timed launch this short also times the host's gap
  before it): a later step's time is the difference of m = K and m = 1
  over K - 1.

The floors are timed with CUDA events, REPS launches after one warm-up,
and printed per step (us) with the card's name and power limit. The floor
of a pair-list step is the walk's time.
"""

import argparse
import ctypes
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from second_tpu_torch.ops import cuda as kernels  # noqa: E402
from second_tpu_torch.ops import nms as nms_ops  # noqa: E402
from second_tpu_torch.ops.cuda import riou  # noqa: E402

REPS = 5
STEPS = 10000            # slot and walk steps a launch
COLD_STEPS = 100         # soft_nms's post_max_size on the fhd call
PAIRS = 8192             # soft_nms's max_pairs: the pair-list rows' P
# the pair-list rows: (K, the side of the square of crowded boxes, m)
PAIR_ROWS = ((1000, 35.0), (4096, 75.0))
SOURCE = r"""
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>
#define FULL 0xffffffffu
// the pair-list kernel's slot key, warp reduction and span maximum
// (csrc/riou.cu, its default build)
__device__ __forceinline__ int sp_key(float v) {
  if (v != v) return INT32_MAX;
  if (v == 0.f) return 0;
  const int b = __float_as_int(v);
  return b >= 0 ? b : b ^ 0x7fffffff;
}

__device__ __forceinline__ int2 sp_warp_best(int key, int idx) {
  const int wk = __reduce_max_sync(FULL, key);
  const int wi = __reduce_min_sync(FULL, key == wk ? idx : INT32_MAX);
  return make_int2(wk, wi);
}

template <int PER>
__device__ __forceinline__ int2 sp_span_max(const float* cur, int lo, int hi,
                                            int lane, bool& dirty) {
  const int j0 = lo + lane * PER;
  float v[PER];
  if (j0 + PER <= hi) {
    if (PER == 4)
      *reinterpret_cast<float4*>(v) =
          *reinterpret_cast<const float4*>(cur + j0);
    else if (PER == 2)
      *reinterpret_cast<float2*>(v) =
          *reinterpret_cast<const float2*>(cur + j0);
    else
      v[0] = cur[j0];
  } else {
#pragma unroll
    for (int t = 0; t < PER; ++t) v[t] = j0 + t < hi ? cur[j0 + t] : 0.f;
  }
  int bk = INT32_MIN, bi = INT32_MAX;
  bool odd = false;
#pragma unroll
  for (int t = 0; t < PER; ++t)
    if (j0 + t < hi) {
      const int key = sp_key(v[t]);
      if (key > bk) { bk = key; bi = j0 + t; }
      odd |= !isfinite(v[t]) && v[t] != -CUDART_INF_F;
    }
  dirty = __any_sync(FULL, odd);
  return sp_warp_best(bk, bi);
}

// the pair-list kernel's steps on scores `vals`, without its prologue:
// with WALK, candidate b's d neighbours (b + 1 + t) % k, each with the
// decay 0.6, from a list staged in shared memory, decayed by the warps
// that own them
template <int PER, bool WALK>
__global__ void __launch_bounds__(1024)
    slots_kernel(const float* __restrict__ vals, int k, int d, int steps,
                 int* out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int2 slot[2][32];
  float* cur = reinterpret_cast<float*>(smem);
  float* dec = cur + k;
  uint16_t* nbr = reinterpret_cast<uint16_t*>(dec + (size_t)k * d);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int j = tid; j < k; j += blockDim.x) cur[j] = vals[j];
  if (WALK)
    for (int e = tid; e < k * d; e += blockDim.x) {
      nbr[e] = (uint16_t)((e / d + 1 + e % d) % k);
      dec[e] = 0.6f;
    }
  const int w_lo = min(warp * 32 * PER, k), w_hi = min(w_lo + 32 * PER, k);
  bool dirty;
  __syncthreads();
  int2 mine = sp_span_max<PER>(cur, w_lo, w_hi, lane, dirty);
  if (lane == 0) slot[0][warp] = mine;
  int buf = 0;
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    const int2 sl = lane < nwarps ? slot[buf][lane]
                                  : make_int2(INT32_MIN, INT32_MAX);
    const int b = sp_warp_best(sl.x, sl.y).y;
    const bool own = b >= w_lo && b < w_hi;
    bool hit = false;
    if (WALK)
      for (int e = b * d + lane; e < (b + 1) * d; e += 32) {
        const int j = nbr[e];
        const float dj = dec[e];
        if (j >= w_lo && j < w_hi) {
          const float c = cur[j];
          cur[j] = isfinite(c) ? c * dj : -CUDART_INF_F;
          hit = true;
        }
      }
    if (own && lane == 0) cur[b] = -CUDART_INF_F;
    if (__any_sync(FULL, hit) || own) {
      __syncwarp();
      mine = sp_span_max<PER>(cur, w_lo, w_hi, lane, dirty);
    }
    buf ^= 1;
    if (lane == 0) slot[buf][warp] = mine;
    __syncthreads();
  }
  if (tid == 0) out[0] = mine.y;
}

template <int PER>
int launch_slots(const void* vals, int k, int d, int steps, int walk,
                 void* out, cudaStream_t stream) {
  const int warps = (k + 32 * PER - 1) / (32 * PER);
  const size_t smem = (size_t)k * 4 + (walk ? (size_t)k * d * 6 : 0);
  cudaError_t e = cudaFuncSetAttribute(
      slots_kernel<PER, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      226 * 1024);
  if (e != cudaSuccess) return (int)e;
  if (walk)
    slots_kernel<PER, true><<<1, warps * 32, smem, stream>>>(
        (const float*)vals, k, d, steps, (int*)out);
  else
    slots_kernel<PER, false><<<1, warps * 32, smem, stream>>>(
        (const float*)vals, k, d, steps, (int*)out);
  return (int)cudaGetLastError();
}

// per: scores a lane (the pair kernel takes the least of 1, 2, 4 that
// needs at most 32 warps)
extern "C" int floor_slots(const void* vals, int k, int d, int steps,
                           int walk, int per, void* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (per == 4) return launch_slots<4>(vals, k, d, steps, walk, out, st);
  if (per == 2) return launch_slots<2>(vals, k, d, steps, walk, out, st);
  return launch_slots<1>(vals, k, d, steps, walk, out, st);
}

// the standup kernel's steps (csrc/riou.cu soft_nms_decay_standup_kernel)
// without its output writes: with IOU, the pick's box from shared memory,
// each lane's meet test of its PER candidates and the IoU and gaussian
// decay (sigma a runtime value, as in the kernel) of those that meet;
// without, the slot reduction alone (the pick's owner sets it to -inf);
// a lane's best recomputed only where it changed, a warp's slot only
// where a lane did
template <int PER, bool IOU>
__global__ void __launch_bounds__(1024)
    standup_kernel(const float4* __restrict__ cand,
                   const float* __restrict__ vals, int k, int steps,
                   float sigma, int* out) {
  extern __shared__ float4 box[];
  __shared__ int2 slot[2][32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int j0 = tid * PER;
  float x1[PER], y1[PER], x2[PER], y2[PER], area[PER], cur[PER];
  bool nan[PER];
  int lk = INT32_MIN, li = INT32_MAX;
#pragma unroll
  for (int t = 0; t < PER; ++t) {
    const int j = j0 + t;
    const float4 b = j < k ? cand[j] : make_float4(0.f, 0.f, 0.f, 0.f);
    if (j < k) box[j] = b;
    x1[t] = b.x; y1[t] = b.y; x2[t] = b.z; y2[t] = b.w;
    nan[t] = b.x != b.x || b.y != b.y || b.z != b.z || b.w != b.w;
    area[t] = (b.z - b.x + 0.f) * (b.w - b.y + 0.f);
    cur[t] = j < k ? vals[j] : -CUDART_INF_F;
    if (j < k && sp_key(cur[t]) > lk) { lk = sp_key(cur[t]); li = j; }
  }
  int2 mine = sp_warp_best(lk, li);
  if (lane == 0) slot[0][warp] = mine;
  int buf = 0;
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    const int2 sl = lane < nwarps ? slot[buf][lane]
                                  : make_int2(INT32_MIN, INT32_MAX);
    const int b = sp_warp_best(sl.x, sl.y).y;
    bool changed = false;
    if (IOU) {
      const float4 pb = box[b];
      const bool pnan = pb.x != pb.x || pb.y != pb.y || pb.z != pb.z ||
                        pb.w != pb.w;
#pragma unroll
      for (int t = 0; t < PER; ++t) {
        const int j = j0 + t;
        const float c = cur[t];
        const float wx = fminf(pb.z, x2[t]) - fmaxf(pb.x, x1[t]);
        const float wy = fminf(pb.w, y2[t]) - fmaxf(pb.y, y1[t]);
        const bool meet = wx > 0.f && wy > 0.f && !pnan && !nan[t];
        if (j == b) {
          cur[t] = -CUDART_INF_F;
          changed = true;
        } else if (j < k && isfinite(c)) {
          if (meet) {
            const float ap = (pb.z - pb.x + 0.f) * (pb.w - pb.y + 0.f);
            const float inter = (wx + 0.f) * (wy + 0.f);
            const float r = inter > 0.f ? inter / ((ap + area[t]) - inter)
                                        : 0.f;
            cur[t] = c * expf(-(r * r) / sigma);
            changed = true;
          }
        } else if (j < k && c != -CUDART_INF_F) {
          cur[t] = -CUDART_INF_F;
          changed = true;
        }
      }
    } else {
#pragma unroll
      for (int t = 0; t < PER; ++t)
        if (j0 + t == b) {
          cur[t] = -CUDART_INF_F;
          changed = true;
        }
    }
    if (changed) {
      lk = INT32_MIN;
      li = INT32_MAX;
#pragma unroll
      for (int t = 0; t < PER; ++t) {
        const int key = sp_key(cur[t]);
        if (j0 + t < k && key > lk) { lk = key; li = j0 + t; }
      }
    }
    if (__any_sync(FULL, changed)) mine = sp_warp_best(lk, li);
    buf ^= 1;
    if (lane == 0) slot[buf][warp] = mine;
    __syncthreads();
  }
  if (tid == 0) out[0] = mine.y;
}

template <int PER>
int launch_standup(const void* cand, const void* vals, int k, int steps,
                   int iou, void* out, cudaStream_t stream) {
  const int warps = (k + 32 * PER - 1) / (32 * PER);
  for (auto fn : {standup_kernel<PER, true>, standup_kernel<PER, false>}) {
    cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, 4096 * 16);
    if (e != cudaSuccess) return (int)e;
  }
  if (iou)
    standup_kernel<PER, true><<<1, warps * 32, (size_t)k * 16, stream>>>(
        (const float4*)cand, (const float*)vals, k, steps, 0.5f, (int*)out);
  else
    standup_kernel<PER, false><<<1, warps * 32, (size_t)k * 16, stream>>>(
        (const float4*)cand, (const float*)vals, k, steps, 0.5f, (int*)out);
  return (int)cudaGetLastError();
}

extern "C" int floor_standup(const void* cand, const void* vals, int k,
                             int steps, int iou, int per, void* out,
                             void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (per == 4) return launch_standup<4>(cand, vals, k, steps, iou, out, st);
  if (per == 2) return launch_standup<2>(cand, vals, k, steps, iou, out, st);
  return launch_standup<1>(cand, vals, k, steps, iou, out, st);
}
"""


def build():
    """The floor kernels, built with the port's flags for riou.cu."""
    kernels.BUILD_DIR.mkdir(exist_ok=True)
    src = kernels.BUILD_DIR / "soft_floor.cu"
    src.write_text(SOURCE)
    lib = kernels.build_variant(src, "soft_floor", "riou")[0]
    lib.floor_slots.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 5 + \
        [ctypes.c_void_p, ctypes.c_void_p]
    lib.floor_standup.argtypes = [ctypes.c_void_p] * 2 + \
        [ctypes.c_int] * 4 + [ctypes.c_void_p, ctypes.c_void_p]
    for fn in (lib.floor_slots, lib.floor_standup):
        fn.restype = ctypes.c_int
    return lib


def checked(rc, what):
    if rc:
        sys.exit(f"{what}: CUDA error {rc}")


def event_ms(fn, flush=None):
    """fn's time on the device by CUDA events: one warm-up, then REPS
    launches timed apart, each after `flush()` where one is given."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(REPS):
        a, b = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        if flush is not None:
            flush()
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return out


def crowded_row(K, side, gen, dev):
    """K crowded rotated boxes in a square of `side` m, their scores
    sorted descending, and their pair list at PAIRS (the cap binding):
    (plist, ok, iou, scores), a row each."""
    boxes = torch.stack([torch.rand(K, generator=gen) * side,
                         torch.rand(K, generator=gen) * side,
                         1.4 + 0.4 * torch.rand(K, generator=gen),
                         3.5 + 0.8 * torch.rand(K, generator=gen),
                         (torch.rand(K, generator=gen) - 0.5) * 2 * np.pi],
                        1).to(dev)[None]
    scores = torch.rand(1, K, generator=gen).sort(1, descending=True)[0]
    valid = torch.ones(1, K, dtype=torch.bool, device=dev)
    plist, ok = nms_ops.soft_nms_pairs(boxes, valid, PAIRS)
    if not bool(ok.all()):
        sys.exit(f"K {K}: fewer than {PAIRS} pairs")
    return plist, ok, nms_ops.pair_iou(boxes, plist), scores.to(dev)


def kernel_per(K):
    """Scores a lane in the pair kernel's block: the least of 1, 2, 4 that
    needs at most 32 warps (csrc/riou.cu `soft_nms_decay_pairs`)."""
    per = 1
    while per < 4 and -(-K // (32 * per)) > 32:
        per *= 2
    return per


def variant(name, src):
    """Another version of riou.cu (with the same C entries), built with the
    port's flags for riou.cu: (its pair kernel as a function of
    `soft_nms_decay_pairs`' arguments, its standup kernel as one of
    `soft_nms_decay_standup`'s or None where the source has none)."""
    lib = kernels.build_variant(src, f"riou_{name}", "riou")[0]
    try:
        st = lib.soft_nms_decay_standup
        st.argtypes = riou._SOFT_STANDUP_ARGTYPES
        st.restype = ctypes.c_int
    except AttributeError:
        st = None

    def standup(cand, scores, m, method, sigma, thr):
        R, K = scores.shape
        picks = torch.empty((R, m), dtype=torch.int64, device=scores.device)
        picked = torch.empty((R, m), device=scores.device)
        scratch = torch.empty(R * K, device=scores.device)   # past 4096
        checked(st(cand.data_ptr(), scores.data_ptr(), picks.data_ptr(),
                   picked.data_ptr(), scratch.data_ptr(), R, K, m,
                   int(method == "gaussian"), sigma, thr,
                   kernels.stream_ptr(scores.device)), name)
        return picks, picked

    fn = lib.soft_nms_decay_pairs
    fn.argtypes = riou._SOFT_PAIRS_ARGTYPES
    fn.restype = ctypes.c_int
    size = lib.soft_nms_pairs_scratch
    size.argtypes = [ctypes.c_int, ctypes.c_longlong]
    size.restype = ctypes.c_longlong

    def call(plist, ok, iou, scores, m, method, sigma, thr):
        (R, K), P = scores.shape, plist.shape[1]
        picks = torch.empty((R, m), dtype=torch.int64, device=scores.device)
        picked = torch.empty((R, m), device=scores.device)
        per_row = size(K, P)
        scratch = torch.empty(R * per_row, dtype=torch.uint8,
                              device=scores.device) if per_row else None
        checked(fn(plist.data_ptr(), ok.data_ptr(), iou.data_ptr(),
                   scores.data_ptr(), picks.data_ptr(), picked.data_ptr(),
                   scratch.data_ptr() if per_row else None, R, K, P, m,
                   int(method == "gaussian"), sigma, thr,
                   kernels.stream_ptr(scores.device)), name)
        return picks, picked
    return call, standup if st is not None else None


def pair_floor(lib, dtimer, variants, stream, out, l2, gen, dev):
    """The pair-list kernel's step floor and its times, for each of
    PAIR_ROWS (the module's docstring), with each variant build of
    riou.cu's pair kernel (its picks checked against the default's)."""
    variants = [(name, fn[0]) for name, fn in variants]
    for K, side in PAIR_ROWS:
        plist, ok, iou, scores = crowded_row(K, side, gen, dev)
        d = 2 * PAIRS // K
        vals = scores[0].contiguous()
        kernel = [("pairs", riou.soft_nms_decay_pairs)] + variants
        want = riou.soft_nms_decay_pairs(plist, ok, iou, scores, COLD_STEPS,
                                         "gaussian", 0.5, 0.3)
        for name, fn in variants:
            got = fn(plist, ok, iou, scores, COLD_STEPS, "gaussian", 0.5,
                     0.3)
            if not (torch.equal(got[0], want[0]) and
                    torch.equal(got[1], want[1])):
                sys.exit(f"K {K}: variant {name} differs from the default")
        floors = {}
        for cold in ("", " cold"):
            for lanes in sorted({kernel_per(K), 4}):
                for walk in (0, 1):
                    name = f"{('slots', 'walk')[walk]} per {lanes}{cold}"
                    ms = event_ms(lambda w=walk, n=lanes: checked(
                        lib.floor_slots(vals.data_ptr(), K, d, STEPS, w, n,
                                        out.data_ptr(), stream), "slots"),
                        (lambda: l2.fill_(1)) if cold else None)
                    floors[name] = 1e3 * min(ms) / STEPS
                    print(f"K {K} P {PAIRS} (d {d}) {name}: {STEPS} steps a "
                          f"launch, us a step "
                          f"{', '.join(repr(1e3 * t / STEPS) for t in ms)}")
        # the kernels' own device time (the profiler's, no host gaps),
        # each run after an L2 flush as chip_smoke.py times them
        runs = [(name, m, lambda fn=fn, m=m: fn(plist, ok, iou, scores, m,
                                                "gaussian", 0.5, 0.3))
                for name, fn in kernel for m in (1, COLD_STEPS, K)]
        dev_ms = dtimer([fn for _, _, fn in runs])
        got = {(name, m): t for (name, m, _), t in zip(runs, dev_ms)}
        lanes = kernel_per(K)
        for cold in ("", " cold"):
            print(f"K {K} P {PAIRS}{cold or ' warm'} (least of {REPS}): "
                  f"floor of a step (walk per {lanes}) "
                  f"{floors[f'walk per {lanes}{cold}']!r} us, the slots "
                  f"alone {floors[f'slots per {lanes}{cold}']!r} us")
        floor = floors[f"walk per {lanes} cold"]
        for name, _ in kernel:
            first = got[name, 1]
            later = 1e3 * (got[name, K] - first) / (K - 1)
            print(f"K {K} P {PAIRS} device, after an L2 flush: {name} "
                  f"{got[name, COLD_STEPS]!r} ms for {COLD_STEPS} steps, "
                  f"{got[name, K]!r} for {K}; its prologue and first step "
                  f"{first!r} ms, a later step {later!r} us (from m = {K}), "
                  f"{later / floor!r} x the floor")


def standup_floor(lib, dtimer, variants, stream, out, l2, gen, dev):
    """The standup kernel's step floor and its times, for K = 1000 and 4096
    standup envelopes of crowded boxes (the module's docstring), with each
    variant build's standup kernel (its picks and scores checked against
    the default's)."""
    variants = [(name, fn[1]) for name, fn in variants if fn[1] is not None]
    for K, side in PAIR_ROWS:
        boxes = torch.stack([torch.rand(K, generator=gen) * side,
                             torch.rand(K, generator=gen) * side,
                             1.4 + 0.4 * torch.rand(K, generator=gen),
                             3.5 + 0.8 * torch.rand(K, generator=gen),
                             (torch.rand(K, generator=gen) - 0.5) * 2 *
                             np.pi], 1).to(dev)
        cand = nms_ops.rbbox2d_to_near_bbox(boxes)[None].contiguous()
        scores = torch.rand(1, K, generator=gen).sort(
            1, descending=True)[0].to(dev)
        vals = scores[0].contiguous()
        per = kernel_per(K)
        floors = {}
        for cold in ("", " cold"):
            for iou in (0, 1):
                name = f"standup {('slots', 'step')[iou]} per {per}{cold}"
                ms = event_ms(lambda i=iou: checked(lib.floor_standup(
                    cand.data_ptr(), vals.data_ptr(), K, K, i, per,
                    out.data_ptr(), stream), "standup"),
                    (lambda: l2.fill_(1)) if cold else None)
                floors[name] = 1e3 * min(ms) / K
                print(f"K {K} {name}: {K} steps a launch, us a step "
                      f"{', '.join(repr(1e3 * t / K) for t in ms)}")
        kernel = [("standup", riou.soft_nms_decay_standup)] + variants
        want = riou.soft_nms_decay_standup(cand, scores, K, "gaussian", 0.5,
                                           0.3)
        for name, fn in variants:
            got = fn(cand, scores, K, "gaussian", 0.5, 0.3)
            if not (torch.equal(got[0], want[0]) and
                    torch.equal(got[1], want[1])):
                sys.exit(f"K {K}: standup variant {name} differs from the "
                         f"default")
        runs = [((name, m), lambda fn=fn, m=m: fn(
            cand, scores, m, "gaussian", 0.5, 0.3))
            for name, fn in kernel for m in (1, COLD_STEPS, K)]
        got = dict(zip((key for key, _ in runs),
                       dtimer([fn for _, fn in runs])))
        for cold in ("", " cold"):
            print(f"K {K} standup{cold or ' warm'} (least of {REPS}): floor "
                  f"of a step {floors[f'standup step per {per}{cold}']!r} "
                  f"us, the slots alone "
                  f"{floors[f'standup slots per {per}{cold}']!r} us")
        floor = floors[f"standup step per {per} cold"]
        for name, _ in kernel:
            later = 1e3 * (got[name, K] - got[name, 1]) / (K - 1)
            print(f"K {K} standup device, after an L2 flush: {name} "
                  f"{got[name, COLD_STEPS]!r} ms for {COLD_STEPS} steps, "
                  f"{got[name, K]!r} for {K}; its prologue and first step "
                  f"{got[name, 1]!r} ms, a later step {later!r} us (from "
                  f"m = {K}), {later / floor!r} x the floor")


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--variant", action="append", default=[],
                        metavar="NAME=RIOU_CU",
                        help="also time the pair and standup kernels of "
                             "this version of riou.cu (e.g. a design "
                             "variant, or the parent's), in turns with the "
                             "built ones")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    dev = torch.device("cuda", 0)
    print(cs.card_line())
    lib = build()
    stream = kernels.stream_ptr(dev)
    out = torch.zeros(1, dtype=torch.int32, device=dev)
    l2 = torch.empty(64 << 20, dtype=torch.int16, device=dev)
    gen = torch.Generator().manual_seed(0)
    variants = [(name, variant(name, src)) for name, src in
                (v.split("=", 1) for v in args.variant)]
    standup_floor(lib, cs.DeviceTimer(dev), variants, stream, out, l2, gen,
                  dev)
    pair_floor(lib, cs.DeviceTimer(dev), variants, stream, out, l2, gen,
               dev)


if __name__ == "__main__":
    main()
