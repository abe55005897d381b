"""The latency floor of the soft-NMS decay kernel's step, on one card.

    python3 scripts/torch_soft_nms_floor.py

`soft_nms_decay_kernel` (`second_tpu_torch/csrc/riou.cu`) runs `m` steps a
row, each waiting on the last one's pick, so its bytes bound (chip_smoke.py
`soft_bound`) is not what it can reach: a step cannot be shorter than its
chain of a block-wide argmax (a warp-shuffle reduction, a barrier, one
across the warps, a barrier) and one dependent read of the picked IoU row.
This script times that chain alone, in kernels built with the port's flags
for riou.cu, with the real kernel's block (K / 4 threads rounded up to a
warp, at most 4 scores a thread in registers), for K = 1000 (the fhd call's
rows) and K = 4096 (NMS_MAX_K):

- chase: one thread's dependent loads through a random cycle over one line
  in 32 of a K x K fp32 matrix's bytes, `__ldcg` (the L2's latency where the
  matrix fits it, 4 MB at K = 1000);
- argmax: STEPS block-wide argmaxes, the real kernel's code, each pick set
  to -inf in its thread's registers before the next (no memory read);
- skeleton: argmax and then each thread's read of the picked row at its own
  columns, that row's values its next scores: the step without the decay's
  arithmetic. The matrix's largest entry in row b sits at column pi(b), pi
  one cycle through all K rows, so every step reads a row the last K - 1
  steps did not (the real kernel reads a new row each step too);
- kernel: `soft_nms_decay` itself, gaussian, on one row of the same matrix
  with random scores, m = K steps (every candidate picked once);
- skeleton cold, kernel cold: the same for COLD_STEPS steps (the fhd call's
  m), each launch after the L2 is flushed (a 128 MB fill), as chip_smoke.py
  times the kernel (`DeviceTimer`): the rows come from HBM.

Each is timed with CUDA events, REPS launches after one warm-up, and
printed per step (us) with the card's name and power limit. The floor of a
step is the skeleton's time (warm, or cold to set beside chip_smoke.py's
time); chase + argmax is its parts' sum.
"""

import ctypes
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from second_tpu_torch.ops import cuda as kernels  # noqa: E402
from second_tpu_torch.ops.cuda import riou  # noqa: E402

REPS = 5
STEPS = 10000            # argmax and skeleton steps a launch
COLD_STEPS = 100         # soft_nms's post_max_size on the fhd call
KS = (1000, 4096)
SOURCE = r"""
#include <cuda_runtime.h>
#include <math_constants.h>
#define FULL 0xffffffffu
constexpr int PER = 4;   // SOFT_PER_THREAD

__device__ __forceinline__ void better(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) { v = ov; i = oi; }
}

__global__ void chase_kernel(const int* __restrict__ next, int steps,
                             int* out) {
  int i = 0;
  for (int s = 0; s < steps; ++s) i = __ldcg(next + i);
  out[0] = i;
}

// the real kernel's block-wide argmax; with `mat`, then the read of the
// picked row, whose values become the thread's scores
template <bool READ>
__global__ void __launch_bounds__(1024)
    step_kernel(const float* __restrict__ mat,
                const float* __restrict__ vals, int k, int steps,
                int* out) {
  __shared__ float red_v[32];
  __shared__ int red_i[32];
  __shared__ int best_i;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  float cur[PER];
  float lv = -CUDART_INF_F;
  int li = 0x7fffffff;
#pragma unroll
  for (int e = 0; e < PER; ++e) {
    const int j = tid + e * blockDim.x;
    cur[e] = j < k ? vals[j] : -CUDART_INF_F;
    if (j < k) better(lv, li, cur[e], j);
  }
  for (int s = 0; s < steps; ++s) {
    float v = lv;
    int i = li;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      better(v, i, __shfl_down_sync(FULL, v, off),
             __shfl_down_sync(FULL, i, off));
    if (lane == 0) { red_v[warp] = v; red_i[warp] = i; }
    __syncthreads();
    if (warp == 0) {
      v = lane < nwarps ? red_v[lane] : -CUDART_INF_F;
      i = lane < nwarps ? red_i[lane] : 0x7fffffff;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        better(v, i, __shfl_down_sync(FULL, v, off),
               __shfl_down_sync(FULL, i, off));
      if (lane == 0) best_i = i;
    }
    __syncthreads();
    const int b = best_i;
    const float* __restrict__ row = mat + (long long)b * k;
    lv = -CUDART_INF_F;
    li = 0x7fffffff;
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      const int j = tid + e * blockDim.x;
      if (j < k) {
        if (READ) cur[e] = row[j];
        else if (j == b) cur[e] = -CUDART_INF_F;
        better(lv, li, cur[e], j);
      }
    }
  }
  if (tid == 0) out[0] = li;
}

extern "C" int floor_chase(const void* next, int steps, void* out,
                           void* stream) {
  chase_kernel<<<1, 1, 0, (cudaStream_t)stream>>>((const int*)next, steps,
                                                  (int*)out);
  return (int)cudaGetLastError();
}

extern "C" int floor_step(const void* mat, const void* vals, int k,
                          int steps, int read, void* out, void* stream) {
  int threads = ((k + PER - 1) / PER + 31) / 32 * 32;
  if (read)
    step_kernel<true><<<1, threads, 0, (cudaStream_t)stream>>>(
        (const float*)mat, (const float*)vals, k, steps, (int*)out);
  else
    step_kernel<false><<<1, threads, 0, (cudaStream_t)stream>>>(
        (const float*)mat, (const float*)vals, k, steps, (int*)out);
  return (int)cudaGetLastError();
}
"""


def build():
    """The floor kernels, built with the port's flags for riou.cu."""
    kernels.BUILD_DIR.mkdir(exist_ok=True)
    src = kernels.BUILD_DIR / "soft_floor.cu"
    src.write_text(SOURCE)
    lib = kernels.build_variant(src, "soft_floor", "riou")[0]
    lib.floor_chase.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                ctypes.c_void_p, ctypes.c_void_p]
    lib.floor_step.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                               ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                               ctypes.c_void_p]
    for fn in (lib.floor_chase, lib.floor_step):
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


def cycle_matrix(K, gen, dev):
    """A K x K fp32 matrix of values in [0, 0.5) whose row b has its
    largest entry, 1, at column pi(b), pi one cycle through the K rows."""
    order = torch.randperm(K, generator=gen)
    pi = torch.empty(K, dtype=torch.int64)
    pi[order] = torch.roll(order, -1)
    mat = torch.rand((K, K), generator=gen) * 0.5
    mat[torch.arange(K), pi] = 1.0
    return mat.to(dev)


def chase_array(K, gen, dev):
    """One int in 32 of K * K, each the index of the next in one random
    cycle through all of them (a line of 128 bytes a step)."""
    nodes = torch.randperm(K * K // 32, generator=gen) * 32
    nxt = torch.zeros(K * K, dtype=torch.int32)
    nxt[nodes] = torch.roll(nodes, -1).int()
    return nxt.to(dev), int(nodes.numel())


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    dev = torch.device("cuda", 0)
    print(cs.card_line())
    lib = build()
    stream = kernels.stream_ptr(dev)
    out = torch.zeros(1, dtype=torch.int32, device=dev)
    l2 = torch.empty(64 << 20, dtype=torch.int16, device=dev)
    gen = torch.Generator().manual_seed(0)
    for K in KS:
        mat = cycle_matrix(K, gen, dev)
        vals = torch.rand(K, generator=gen).to(dev)
        nxt, n = chase_array(K, gen, dev)
        threads = ((K + 3) // 4 + 31) // 32 * 32
        per = {
            "chase": (n, lambda: checked(lib.floor_chase(
                nxt.data_ptr(), n, out.data_ptr(), stream), "chase")),
            "argmax": (STEPS, lambda: checked(lib.floor_step(
                mat.data_ptr(), vals.data_ptr(), K, STEPS, 0, out.data_ptr(),
                stream), "argmax")),
            "skeleton": (STEPS, lambda: checked(lib.floor_step(
                mat.data_ptr(), vals.data_ptr(), K, STEPS, 1, out.data_ptr(),
                stream), "skeleton")),
            "kernel": (K, lambda: riou.soft_nms_decay(
                mat[None], vals[None], K, "gaussian", 0.5, 0.3)),
            "skeleton cold": (COLD_STEPS, lambda: checked(lib.floor_step(
                mat.data_ptr(), vals.data_ptr(), K, COLD_STEPS, 1,
                out.data_ptr(), stream), "skeleton")),
            "kernel cold": (COLD_STEPS, lambda: riou.soft_nms_decay(
                mat[None], vals[None], COLD_STEPS, "gaussian", 0.5, 0.3)),
        }
        us = {}
        for name, (steps, fn) in per.items():
            ms = event_ms(fn, (lambda: l2.fill_(1)) if "cold" in name
                          else None)
            us[name] = [1e3 * t / steps for t in ms]
            print(f"K {K} ({threads} threads) {name}: {steps} steps a "
                  f"launch, ms {', '.join(repr(t) for t in ms)}; us a step "
                  f"{', '.join(repr(u) for u in us[name])}")
        best = {name: min(u) for name, u in us.items()}
        print(f"K {K}: floor of a step (skeleton, least of {REPS}) "
              f"{best['skeleton']!r} us; chase + argmax "
              f"{best['chase'] + best['argmax']!r} us; the kernel "
              f"{best['kernel']!r} us a step, "
              f"{best['kernel'] / best['skeleton']!r} x the floor; cold, "
              f"{COLD_STEPS} steps: floor {best['skeleton cold']!r} us, the "
              f"kernel {best['kernel cold']!r} us a step, "
              f"{best['kernel cold'] / best['skeleton cold']!r} x")


if __name__ == "__main__":
    main()
