// Sparse-conv gather-GEMM: out[b, q, :] = sum_k feat[b, tap_idx[b, k, q], :]
// @ W[k] over the taps with found[b, k, q], fp32 accumulation, before bias
// and mask.
//
// Replaces: second_tpu/ops/pallas/subm.py `subm_conv3d_fused_pallas` (kernel
// `_fused_kernel`), the fused sparse-conv apply that every SubMBlock and
// DownBlock of SpMiddleFHD runs (10 submanifold and 4 strided convs per
// forward). It reads the port's per-tap rulebook (tap_idx, found) [B, K, Q]
// instead of the TPU's (dz, dy)-plane window slabs and selection masks.
//
// Bound on the H100: bytes. At the fhd shapes (B = 4, Q up to 40960, K = 27,
// C and D up to 64) one conv must read the [B, K, Q] found mask, the row
// index of each found tap (4-15% of the taps) and each feature row those
// reference, and write the [B, Q, D] fp32 output, which is most of it:
// 16-42 MB, a floor of 5-12 us at 3.35 TB/s. The products the found taps
// need are at most 2.7 GFLOP a conv, under 3 us at the bf16 tensor-core
// rate. This first version computes them with fp32 FMAs on the CUDA cores
// (67 TFLOP/s), for every row of a tile whose tap any row found, so its own
// ceiling is that rate over that padded work; PERF.md has its times.
//
// Design: one block per tile of 64 output rows (batch-flattened, m = b*Q + q).
// For each tap k the block loads the tile's 64 rulebook entries, skips the
// tap if no row of the tile found a neighbour (most taps of empty or edge
// tiles), gathers the 64 neighbour rows into shared memory (converted to
// fp32) next to W[k], and accumulates the [64, C] x [C, D] product in
// registers: each of the 256 threads owns 4 rows x ceil(D/16) columns. The
// [B, K, Q, C] tap stack never exists in device memory; only the features,
// the rulebook, the weights and the [B*Q, D] output are touched.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE_M = 64;
constexpr int THREADS = 256;
constexpr int CMAX = 64;
constexpr int DMAX = 64;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T, int DJ>
__global__ void __launch_bounds__(THREADS)
    gather_gemm_kernel(const T* __restrict__ feat,
                       const int32_t* __restrict__ tap_idx,
                       const uint8_t* __restrict__ found,
                       const T* __restrict__ w, float* __restrict__ out, int B,
                       int N, int Q, int K, int C, int D) {
  __shared__ float s_a[TILE_M][CMAX + 1];
  __shared__ float s_w[CMAX][DMAX];
  __shared__ long long s_row[TILE_M];
  constexpr int RI = TILE_M / 16;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const long long M = (long long)B * Q;
  const long long m0 = (long long)blockIdx.x * TILE_M;

  float acc[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  for (int k = 0; k < K; ++k) {
    int any = 0;
    if (tid < TILE_M) {
      const long long m = m0 + tid;
      long long r = -1;
      if (m < M) {
        const long long b = m / Q, q = m - b * Q;
        const long long o = (b * K + k) * Q + q;
        if (found[o]) r = b * N + tap_idx[o];
      }
      s_row[tid] = r;
      any = r >= 0;
    }
    if (!__syncthreads_or(any)) continue;

    for (int e = tid; e < TILE_M * C; e += THREADS) {
      const int t = e / C, c = e - t * C;
      const long long r = s_row[t];
      s_a[t][c] = r >= 0 ? to_f(feat[r * C + c]) : 0.f;
    }
    const T* wk = w + (long long)k * C * D;
    for (int e = tid; e < C * D; e += THREADS) {
      const int c = e / D, d = e - c * D;
      s_w[c][d] = to_f(wk[e]);
    }
    __syncthreads();

    for (int c = 0; c < C; ++c) {
      float a[RI], bw[DJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) a[i] = s_a[ty + 16 * i][c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const int d = tx + 16 * j;
        bw[j] = d < D ? s_w[c][d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] += a[i] * bw[j];
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const long long m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) out[m * D + d] = acc[i][j];
    }
  }
}

template <typename T>
cudaError_t launch(const void* feat, const void* tap_idx, const void* found,
                   const void* w, void* out, int B, int N, int Q, int K, int C,
                   int D, cudaStream_t stream) {
  const long long M = (long long)B * Q;
  const unsigned blocks = (unsigned)((M + TILE_M - 1) / TILE_M);
  const T* f = static_cast<const T*>(feat);
  const int32_t* ti = static_cast<const int32_t*>(tap_idx);
  const uint8_t* fo = static_cast<const uint8_t*>(found);
  const T* wt = static_cast<const T*>(w);
  float* o = static_cast<float*>(out);
  switch ((D + 15) / 16) {
    case 1:
      gather_gemm_kernel<T, 1><<<blocks, THREADS, 0, stream>>>(
          f, ti, fo, wt, o, B, N, Q, K, C, D);
      break;
    case 2:
      gather_gemm_kernel<T, 2><<<blocks, THREADS, 0, stream>>>(
          f, ti, fo, wt, o, B, N, Q, K, C, D);
      break;
    case 3:
      gather_gemm_kernel<T, 3><<<blocks, THREADS, 0, stream>>>(
          f, ti, fo, wt, o, B, N, Q, K, C, D);
      break;
    default:
      gather_gemm_kernel<T, 4><<<blocks, THREADS, 0, stream>>>(
          f, ti, fo, wt, o, B, N, Q, K, C, D);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32 features and weights, 1 bfloat16.
extern "C" int subm_gather_gemm(const void* feat, const void* tap_idx,
                                const void* found, const void* w, void* out,
                                int B, int N, int Q, int K, int C, int D,
                                int dtype, void* stream) {
  if (C < 1 || C > CMAX || D < 1 || D > DMAX || K < 1)
    return (int)cudaErrorInvalidValue;
  if ((long long)B * Q == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e =
      dtype == 1
          ? launch<__nv_bfloat16>(feat, tap_idx, found, w, out, B, N, Q, K, C,
                                  D, s)
          : launch<float>(feat, tap_idx, found, w, out, B, N, Q, K, C, D, s);
  return (int)e;
}

extern "C" const char* subm_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
