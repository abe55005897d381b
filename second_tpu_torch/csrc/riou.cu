// Rotated BEV IoU of box pairs, fp32, by Sutherland-Hodgman clipping.
//
// Replaces: second_tpu/ops/pallas/riou.py `rotated_iou_matrix_pallas`
// (kernel `_riou_kernel`, helpers `_clip` and `_corners`), and in pair form
// the `quad_intersection_area` pass of `_sparse_rotated_over`
// (second_tpu/ops/nms.py:109) that rotated NMS runs on its candidate pairs.
//
// Bound on the H100: operations, narrowly. Each pair reads two pair indices
// (and its boxes, shared with other pairs) and writes one float, but clips
// a quad against four half-planes: 2 + 7n + 13e fp32 operations a clip of
// n vertices with e crossing edges, plus 117 for the corners, the winding
// and the IoU and 4n + 2 for the shoelace; about 290 a pair on the NMS
// pairs of the fhd path, all on the CUDA cores (no tensor-core form). At
// 8192 pairs per NMS call the launch itself dominates.
//
// Design: one thread per pair, the polygon in 8 register slots (a convex
// quad clipped by four half-planes never has more than 8 vertices). Each
// clip walks the current vertices in order and emits, for vertex i, the
// vertex itself if it is inside and the edge crossing if the edge i -> i+1
// crosses the line: the same interleaved emission order as the Pallas
// kernel's 16 slots followed by its order-preserving compaction, so the
// surviving vertices land in the same slots. The file is built with
// -fmad=false so products and sums round as the plain PyTorch version's
// separate elementwise operations do.
//
// Entry points: `riou_pairs` (pair list (i, j) into two box arrays; NMS) and
// `riou_matrix` (dense [N, K] with the criterion -1 IoU, 0 inter/area1,
// 1 inter/area2).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int S = 8;

__device__ __forceinline__ void corners(const float* __restrict__ b, float* qx,
                                        float* qy) {
  const float x = b[0], y = b[1], w = b[2], l = b[3], yaw = b[4];
  const float c = cosf(yaw), s = sinf(yaw);
  // corner order [(-,-), (-,+), (+,+), (+,-)] of (w, l), rotated by
  // p @ [[c, -s], [s, c]], then shifted to the center
  const float lx[4] = {-0.5f, -0.5f, 0.5f, 0.5f};
  const float ly[4] = {-0.5f, 0.5f, 0.5f, -0.5f};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float px = w * lx[i], py = l * ly[i];
    qx[i] = (px * c + py * s) + x;
    qy[i] = (-px * s + py * c) + y;
  }
}

// Clip the polygon (px, py, cnt) by the half-plane left (sgn > 0) of a -> b.
__device__ __forceinline__ void clip(float* px, float* py, int& cnt, float ax,
                                     float ay, float bx, float by, float sgn) {
  const float ex = bx - ax, ey = by - ay;
  float ox[S], oy[S];
  int n = 0;
  float d[S];
#pragma unroll
  for (int i = 0; i < S; ++i)
    d[i] = sgn * (ex * (py[i] - ay) - ey * (px[i] - ax));
#pragma unroll
  for (int i = 0; i < S; ++i) {
    if (i < cnt) {
      const int j = (i + 1 >= cnt) ? 0 : i + 1;
      const float dc = d[i], dn = d[j];
      const bool in_c = dc >= 0.f, in_n = dn >= 0.f;
      if (in_c && n < S) {
        ox[n] = px[i];
        oy[n] = py[i];
        ++n;
      }
      if (in_c != in_n && n < S) {
        const float denom = dc - dn;
        const float safe = fabsf(denom) < 1e-12f ? 1.f : denom;
        const float t = fminf(fmaxf(dc / safe, 0.f), 1.f);
        ox[n] = px[i] + t * (px[j] - px[i]);
        oy[n] = py[i] + t * (py[j] - py[i]);
        ++n;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < S; ++i) {
    px[i] = i < n ? ox[i] : 0.f;
    py[i] = i < n ? oy[i] : 0.f;
  }
  cnt = n;
}

__device__ float pair_iou(const float* __restrict__ b1,
                          const float* __restrict__ b2, int criterion) {
  float px[S], py[S], qx[4], qy[4];
  corners(b1, px, py);
#pragma unroll
  for (int i = 4; i < S; ++i) px[i] = py[i] = 0.f;
  corners(b2, qx, qy);
  int cnt = 4;
  float sa = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int j = (i + 1) & 3;
    sa += qx[i] * qy[j] - qx[j] * qy[i];
  }
  const float sgn = (0.5f * sa) >= 0.f ? 1.f : -1.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int j = (k + 1) & 3;
    clip(px, py, cnt, qx[k], qy[k], qx[j], qy[j], sgn);
  }
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < S; ++i) {
    if (i < cnt) {
      const int j = (i + 1 >= cnt) ? 0 : i + 1;
      acc += px[i] * py[j] - px[j] * py[i];
    }
  }
  const float inter = cnt >= 3 ? 0.5f * fabsf(acc) : 0.f;
  const float a1 = b1[2] * b1[3], a2 = b2[2] * b2[3];
  float denom;
  if (criterion == -1)
    denom = a1 + a2 - inter;
  else if (criterion == 0)
    denom = a1;
  else
    denom = a2;
  return inter / fmaxf(denom, 1e-12f);
}

__global__ void riou_pairs_kernel(const float* __restrict__ b1,
                                  const float* __restrict__ b2,
                                  const int32_t* __restrict__ pi,
                                  const int32_t* __restrict__ pj,
                                  float* __restrict__ out, long long pairs,
                                  int criterion) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= pairs) return;
  out[t] = pair_iou(b1 + 5LL * pi[t], b2 + 5LL * pj[t], criterion);
}

__global__ void riou_matrix_kernel(const float* __restrict__ b1,
                                   const float* __restrict__ b2,
                                   float* __restrict__ out, long long n1,
                                   long long n2, int criterion) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n1 * n2) return;
  const long long i = t / n2, j = t - i * n2;
  out[t] = pair_iou(b1 + 5 * i, b2 + 5 * j, criterion);
}

}  // namespace

extern "C" int riou_pairs(const void* b1, const void* b2, const void* pi,
                          const void* pj, void* out, long long pairs,
                          int criterion, void* stream) {
  if (pairs == 0) return 0;
  const int threads = 128;
  const long long blocks = (pairs + threads - 1) / threads;
  riou_pairs_kernel<<<(unsigned)blocks, threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(b1), static_cast<const float*>(b2),
      static_cast<const int32_t*>(pi), static_cast<const int32_t*>(pj),
      static_cast<float*>(out), pairs, criterion);
  return (int)cudaGetLastError();
}

extern "C" int riou_matrix(const void* b1, const void* b2, void* out,
                           long long n1, long long n2, int criterion,
                           void* stream) {
  if (n1 * n2 == 0) return 0;
  const int threads = 128;
  const long long blocks = (n1 * n2 + threads - 1) / threads;
  riou_matrix_kernel<<<(unsigned)blocks, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(b1), static_cast<const float*>(b2),
      static_cast<float*>(out), n1, n2, criterion);
  return (int)cudaGetLastError();
}

extern "C" const char* riou_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
