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
// pairs of the fhd path, all on the CUDA cores (no tensor-core form).
//
// `pair_iou`: one thread per pair, the polygon in 8 register slots (a convex
// quad clipped by four half-planes never has more than 8 vertices). Each
// clip walks the current vertices in order and emits, for vertex i, the
// vertex itself if it is inside and the edge crossing if the edge i -> i+1
// crosses the line: the same interleaved emission order as the Pallas
// kernel's 16 slots followed by its order-preserving compaction, so the
// surviving vertices land in the same slots. The file is built with
// -fmad=false so products and sums round as the plain PyTorch version's
// separate elementwise operations do.
//
// Entry points: `riou_pairs` (pair list (i, j) into two box arrays) and
// `riou_matrix` (dense [N, K] with the criterion -1 IoU, 0 inter/area1,
// 1 inter/area2), both off the main path; the two kernels of rotated NMS
// for a whole batch, `nms_overlap` and `nms_suppress` (below); and
// `d3_iou`, the 3-D IoU of lidar boxes (below). A non-finite box gives
// the plain version's non-finite results: the clamps and the winding sign
// pass NaN through, as torch.clamp and torch.sign do.
//
// nms_overlap — replaces the rotated-IoU Pallas kernel where rotated NMS
// runs it, together with what surrounds it in `_sparse_rotated_over`
// (second_tpu/ops/nms.py:71): the standup-envelope bound over the upper
// triangle, the row-major pair list cut at `max_pairs`, the clip of the
// listed pairs and the scatter of `iou > threshold` into an overlap
// matrix, here a bitmask [B, K, ceil(K / 32)] (bit j of row i: the
// higher-ranked box i suppresses box j) and the pair count before the cap.
// Bound on the H100: operations. K(K-1)/2 bound tests an example (14 fp32
// operations each) and about 290 a clipped pair; the bytes (boxes in,
// bitmask out) are a few hundred KB. Design: one thread-block cluster per
// example (its blocks split the upper triangle's rows into equal shares of
// bound tests, so the whole batch spreads over B x cluster SMs, one launch).
// Each block stages the example's standup envelopes, areas and boxes in
// shared memory; a warp owns a row and tests 32 columns at a time into a
// ballot word (kept in the block's shared memory where its rows fit, else
// in a global scratch bitmask) and counts it with popc. An exclusive prefix over the block's row counts, and over
// the blocks' totals through distributed shared memory, gives every pair
// its row-major rank, which decides the cap. The capped pairs are compacted
// by rank into the blocks' shared-memory lists (dealt round-robin over the
// cluster, so the clipping spreads even when the cap falls in the first
// rows), clipped one pair a thread by `pair_iou`, and set with atomicOr in
// the owning block's shared-memory rows of the bitmask (in place in global
// memory where those rows do not fit), which are then written out. The
// bound is computed in the plain version's order of operations (the
// corners as `center_to_corner_box2d` computes them, then
// `inter / max(asum - inter, 1e-12)`), so the maybe-set, and with it the
// cap, is bit-identical to the plain version's.
//
// nms_suppress — replaces the frontier rounds of `_greedy_suppress_over`
// (second_tpu/ops/nms.py:44; no Pallas counterpart): exact greedy NMS from
// the bitmask. Bound: bytes (the bitmask read once), but the walk is a
// serial chain. Design: one block per example stages the bitmask in shared
// memory with 16-byte loads, its rows padded to W + 1 words (it reads it in
// place where it does not fit); one warp walks the rows 32 at a time with
// the removed-mask in registers (lane l holds words l, l + 32, ...): the 32
// rows of a word are decided against the word's diagonal block, by rounds
// of ballots where some row of it suppresses another, then the rows kept
// OR their later words into the removed-mask, one word a lane.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int S = 8;
constexpr unsigned FULL = 0xffffffffu;

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

// Write (x, y) to slot n: every slot is indexed statically, so the
// polygons stay in registers (a dynamic index would put them in local
// memory).
__device__ __forceinline__ void put(float* ox, float* oy, int n, float x,
                                    float y) {
#pragma unroll
  for (int k = 0; k < S; ++k) {
    if (k == n) {
      ox[k] = x;
      oy[k] = y;
    }
  }
}

// Clip the polygon (px, py, cnt) by the half-plane left (sgn > 0) of a -> b.
__device__ __forceinline__ void clip(float* px, float* py, int& cnt, float ax,
                                     float ay, float bx, float by, float sgn) {
  const float ex = bx - ax, ey = by - ay;
  float ox[S], oy[S], d[S];
  int n = 0;
#pragma unroll
  for (int i = 0; i < S; ++i) {
    d[i] = sgn * (ex * (py[i] - ay) - ey * (px[i] - ax));
    ox[i] = oy[i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < S; ++i) {
    if (i < cnt) {
      // the cyclic successor: slot i + 1, or slot 0 after the last vertex
      const bool wrap = i + 1 >= cnt;
      const float dc = d[i], dn = wrap ? d[0] : d[(i + 1) % S];
      const float nx = wrap ? px[0] : px[(i + 1) % S];
      const float ny = wrap ? py[0] : py[(i + 1) % S];
      const bool in_c = dc >= 0.f, in_n = dn >= 0.f;
      if (in_c && n < S) put(ox, oy, n++, px[i], py[i]);
      if (in_c != in_n && n < S) {
        const float denom = dc - dn;
        const float safe = fabsf(denom) < 1e-12f ? 1.f : denom;
        const float q = dc / safe;
        const float t = q < 0.f ? 0.f : (q > 1.f ? 1.f : q);
        put(ox, oy, n++, px[i] + t * (nx - px[i]), py[i] + t * (ny - py[i]));
      }
    }
  }
#pragma unroll
  for (int i = 0; i < S; ++i) {
    px[i] = ox[i];
    py[i] = oy[i];
  }
  cnt = n;
}

// BEV intersection area of two boxes (x, y, w, l, yaw).
__device__ float pair_inter(const float* __restrict__ b1,
                            const float* __restrict__ b2) {
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
  const float half = 0.5f * sa;
  const float sgn = half != half ? half : (half < 0.f ? -1.f : 1.f);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int j = (k + 1) & 3;
    clip(px, py, cnt, qx[k], qy[k], qx[j], qy[j], sgn);
  }
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < S; ++i) {
    if (i < cnt) {
      const bool wrap = i + 1 >= cnt;
      const float nx = wrap ? px[0] : px[(i + 1) % S];
      const float ny = wrap ? py[0] : py[(i + 1) % S];
      acc += px[i] * ny - nx * py[i];
    }
  }
  return cnt >= 3 ? 0.5f * fabsf(acc) : 0.f;
}

__device__ float pair_iou(const float* __restrict__ b1,
                          const float* __restrict__ b2, int criterion) {
  const float inter = pair_inter(b1, b2);
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

// ------------------------------------------------------------ 3-D IoU
//
// d3_iou — replaces the quad clipping of `d3_iou_matrix`
// (second_tpu/ops/rotated_iou.py:204), the Pallas rotated-IoU kernel's
// geometry (second_tpu/ops/pallas/riou.py:85) extended to 3-D: per pair of
// lidar boxes (x, y, z, w, l, h, yaw; z at the bottom) the BEV
// intersection of `pair_inter` times the vertical overlap, over the union
// of the volumes. One thread a pair of a batch [B, N] x [B, K]; the K
// boxes of an example are few (the padded gt boxes) and stay in L1.
// Bound on the H100: operations, as `riou_pairs` (the clip), plus 11 for
// the vertical overlap and the union; the bytes are the [B, N, K] output.

__device__ __forceinline__ float nan_min(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

__global__ void d3_iou_kernel(const float* __restrict__ b1,
                              const float* __restrict__ b2,
                              float* __restrict__ out, long long n1,
                              long long n2, long long total) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const long long per = n1 * n2;
  const long long b = t / per, r = t - b * per;
  const long long i = r / n2, j = r - i * n2;
  const float* p = b1 + 7 * (b * n1 + i);
  const float* q = b2 + 7 * (b * n2 + j);
  const float bev1[5] = {p[0], p[1], p[3], p[4], p[6]};
  const float bev2[5] = {q[0], q[1], q[3], q[4], q[6]};
  const float inter_bev = pair_inter(bev1, bev2);
  const float zo = nan_min(p[2] + p[5], q[2] + q[5]) - nan_max(p[2], q[2]);
  const float inter = inter_bev * (zo < 0.f ? 0.f : zo);
  const float vol1 = p[3] * p[4] * p[5], vol2 = q[3] * q[4] * q[5];
  const float denom = vol1 + vol2 - inter;
  out[t] = inter / (denom < 1e-12f ? 1e-12f : denom);
}

// ------------------------------------------------------------ rotated NMS

constexpr int NMS_THREADS = 1024;
constexpr int NMS_WARPS = NMS_THREADS / 32;
constexpr int NMS_MAX_K = 4096;          // a list entry packs i << 12 | j
constexpr int NMS_MAX_CLUSTER = 16;      // 8 is portable, 16 fits an H100
constexpr int NMS_LIST = 8192;           // pairs a block clips per chunk
constexpr int NMS_SMEM = 226 * 1024;     // dynamic shared memory a block
constexpr int SUP_THREADS = 1024;

// First row of block c of a C-block cluster: the blocks take equal shares
// of the bound-test work, counted as a row's (K - 1 - i) / 32 ballot words
// plus ROW_COST words' worth for the row itself. The share S(r) of rows
// [0, r) is quadratic in r; this solves S(r) = c / C * S(K).
constexpr double ROW_COST = 0.5;
__host__ __device__ inline int split_row(int c, int C, int K) {
  if (c >= C) return K;
  const double b = (2.0 * K - 1.0) / 64.0 + ROW_COST;   // S(r) = r (b - r/64)
  const double target = (double)c / C * K * (b - K / 64.0);
  return (int)ceil(32.0 * (b - sqrt(b * b - target / 16.0)));
}

// Dynamic shared memory of one nms_overlap block: standup envelopes
// (float4) and areas, padded to whole words of 32 columns, boxes (5
// floats), row starts (K + 1), the pair list, the block's rows of the
// bitmask (`over_words`) and of the maybe-words (`maybe_words`; either 0
// where those rows stay in global memory), the cluster's row splits, the
// valid flags (padded).
__host__ __device__ inline size_t overlap_smem(int K, int over_words,
                                               int maybe_words) {
  const size_t Kp = (size_t)((K + 31) >> 5) << 5;
  return Kp * (16 + 4 + 1) + 20 * (size_t)K + 4 * ((size_t)K + 1) +
         4 * NMS_LIST + 4 * ((size_t)over_words + maybe_words) +
         4 * (NMS_MAX_CLUSTER + 1);
}

// In-place exclusive prefix of a[0, n) over the block (a[n] = the total,
// which is returned).
__device__ int block_exclusive_scan(int* a, int n, int* warp_sums) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (n + NMS_THREADS - 1) / NMS_THREADS;
  const int lo = min(tid * per, n), hi = min(lo + per, n);
  int s = 0;
  for (int k = lo; k < hi; ++k) s += a[k];
  int x = s;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int v = lane < NMS_WARPS ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, v, o);
      if (lane >= o) v += y;
    }
    if (lane < NMS_WARPS) warp_sums[lane] = v;
  }
  __syncthreads();
  int base = (warp ? warp_sums[warp - 1] : 0) + x - s;
  for (int k = lo; k < hi; ++k) {
    const int t = a[k];
    a[k] = base;
    base += t;
  }
  const int total = warp_sums[NMS_WARPS - 1];
  if (tid == 0) a[n] = total;
  __syncthreads();
  return total;
}

__global__ void __launch_bounds__(NMS_THREADS, 1)
    nms_overlap_kernel(const float* __restrict__ cand,
                       const uint8_t* __restrict__ valid,
                       uint32_t* __restrict__ over, uint32_t* __restrict__ maybe,
                       int* __restrict__ count, int K, float thr, int cap,
                       int over_words, int maybe_words) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int warp_sums[NMS_WARPS];
  __shared__ int block_total;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / C;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int W = (K + 31) >> 5, Kp = W << 5;

  float4* su = reinterpret_cast<float4*>(smem);
  float* area = reinterpret_cast<float*>(su + Kp);
  float* bx = area + Kp;
  int* start = reinterpret_cast<int*>(bx + 5 * K);
  int* list = start + K + 1;
  uint32_t* ov_s = reinterpret_cast<uint32_t*>(list + NMS_LIST);
  uint32_t* mb_s = ov_s + over_words;
  int* splits = reinterpret_cast<int*>(mb_s + maybe_words);
  uint8_t* vs = reinterpret_cast<uint8_t*>(splits + NMS_MAX_CLUSTER + 1);

  if (tid <= C) splits[tid] = split_row(tid, C, K);
  const int r0 = split_row(rank, C, K), r1 = split_row(rank + 1, C, K);
  const int rows = r1 - r0;
  const float* cb = cand + (size_t)b * K * 5;
  for (int k = tid; k < Kp; k += NMS_THREADS) {
    if (k >= K) {             // padding columns: never valid
      su[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      area[k] = 0.f;
      vs[k] = 0;
      continue;
    }
    float q[5], qx[4], qy[4];
#pragma unroll
    for (int m = 0; m < 5; ++m) bx[5 * k + m] = q[m] = cb[5 * k + m];
    corners(q, qx, qy);
    su[k] = make_float4(fminf(fminf(qx[0], qx[1]), fminf(qx[2], qx[3])),
                        fminf(fminf(qy[0], qy[1]), fminf(qy[2], qy[3])),
                        fmaxf(fmaxf(qx[0], qx[1]), fmaxf(qx[2], qx[3])),
                        fmaxf(fmaxf(qy[0], qy[1]), fmaxf(qy[2], qy[3])));
    area[k] = q[2] * q[3];
    vs[k] = valid[(size_t)b * K + k];
  }
  // this block's rows of the bitmask: in shared memory, or in place
  uint32_t* ov = over_words ? ov_s : over + ((size_t)b * K + r0) * W;
  for (int t = tid; t < rows * W; t += NMS_THREADS) ov[t] = 0u;
  __syncthreads();

  // bound test: a warp a row, 32 columns a ballot word, kept in the
  // block's maybe rows (shared memory, or the global scratch). The quotient
  // q = inter / denom, correctly rounded, exceeds thr exactly when inter
  // exceeds thr * denom, unless the two lie within 4e-7 of each other (or
  // the product is tiny): only then is the division computed.
  uint32_t* mb = maybe_words ? mb_s : maybe + ((size_t)b * K + r0) * W;
  for (int i = r0 + warp; i < r1; i += NMS_WARPS) {
    int cnt = 0;
    if (vs[i]) {
      const float4 si = su[i];
      const float ai = area[i];
      uint32_t upper = ~0u << ((i + 1) & 31);   // first word: columns > i
      for (int w = (i + 1) >> 5; w < W; ++w) {
        const int j = (w << 5) + lane;
        const float4 sj = su[j];
        const float wx = fmaxf(fminf(si.z, sj.z) - fmaxf(si.x, sj.x), 0.f);
        const float wy = fmaxf(fminf(si.w, sj.w) - fmaxf(si.y, sj.y), 0.f);
        const float inter = wx * wy;
        const float denom = fmaxf((ai + area[j]) - inter, 1e-12f);
        const float p = thr * denom;
        const bool sure = fabsf(p) >= 1e-30f;
        bool m = sure && inter > p * 1.0000004f;
        if (!m && !(sure && inter < p * 0.9999996f)) m = inter / denom > thr;
        const uint32_t word = __ballot_sync(FULL, m && vs[j]) & upper;
        upper = ~0u;
        if (lane == 0) mb[(size_t)(i - r0) * W + w] = word;
        cnt += __popc(word);
      }
    }
    if (lane == 0) start[i - r0] = cnt;
  }
  __syncthreads();
  const int total = block_exclusive_scan(start, rows, warp_sums);

  // the blocks' totals, through distributed shared memory
  if (tid == 0) block_total = total;
  cluster.sync();
  int offset = 0, grand = 0;
  for (int q = 0; q < C; ++q) {
    const int v = *cluster.map_shared_rank(&block_total, q);
    offset += q < rank ? v : 0;
    grand += v;
  }
  if (rank == 0 && tid == 0) count[b] = grand;
  const int n_clip = min(cap, grand);
  // no block leaves while another may still read its total: the chunks'
  // barriers see to that, or this one where there is no chunk
  if (n_clip == 0) cluster.sync();

  // the capped pairs in chunks of C lists: global rank r of the chunk
  // [c0, c1) goes to block (r - c0) % C, slot (r - c0) / C
  for (int c0 = 0; c0 < n_clip; c0 += NMS_LIST * C) {
    const int c1 = min(c0 + NMS_LIST * C, n_clip);
    for (int i = r0 + warp; i < r1; i += NMS_WARPS) {
      const int rs = offset + start[i - r0];
      const int re = offset + start[i - r0 + 1];
      if (rs == re || re <= c0 || rs >= c1) continue;
      int base = rs;
      for (int w0 = (i + 1) >> 5; w0 < W && base < c1; w0 += 32) {
        const int w = w0 + lane;
        uint32_t word = w < W ? mb[(size_t)(i - r0) * W + w] : 0u;
        const int p = __popc(word);
        int incl = p;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(FULL, incl, o);
          if (lane >= o) incl += y;
        }
        int r = base + incl - p;
        while (word && r < c1) {
          const int j = (w << 5) + __ffs(word) - 1;
          word &= word - 1;
          if (r >= c0) {
            const int g = r - c0;
            *(cluster.map_shared_rank(list, g % C) + g / C) = (i << 12) | j;
          }
          ++r;
        }
        base += __shfl_sync(FULL, incl, 31);
      }
    }
    cluster.sync();
    const int mine = (c1 - c0 - rank + C - 1) / C;
    for (int p = tid; p < mine; p += NMS_THREADS) {
      const int e = list[p], i = e >> 12, j = e & 4095;
      if (pair_iou(bx + 5 * i, bx + 5 * j, -1) > thr) {
        uint32_t* word;
        if (over_words) {
          int q = 0;
          while (i >= splits[q + 1]) ++q;
          word = cluster.map_shared_rank(ov_s, q) +
                 (size_t)(i - splits[q]) * W + (j >> 5);
        } else {
          word = over + ((size_t)b * K + i) * W + (j >> 5);
        }
        atomicOr(word, 1u << (j & 31));
      }
    }
    cluster.sync();
  }
  if (over_words) {
    uint32_t* dst = over + ((size_t)b * K + r0) * W;
    for (int t = tid; t < rows * W; t += NMS_THREADS) dst[t] = ov_s[t];
  }
}

__global__ void __launch_bounds__(SUP_THREADS)
    nms_suppress_kernel(const uint32_t* __restrict__ over,
                        const uint8_t* __restrict__ valid,
                        uint8_t* __restrict__ keep, int K, int staged) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint32_t vbits_s[NMS_MAX_K / 32];
  const int W = (K + 31) >> 5, b = blockIdx.x, lane = threadIdx.x & 31;
  const uint32_t* ov = over + (size_t)b * K * W;
  const uint8_t* vb = valid + (size_t)b * K;
  // the valid flags as words, a warp a word
  for (int g = threadIdx.x >> 5; g < W; g += SUP_THREADS / 32) {
    const int row = (g << 5) + lane;
    const uint32_t v = __ballot_sync(FULL, row < K && vb[row]);
    if (lane == 0) vbits_s[g] = v;
  }
  // staged rows are W + 1 words apart, so the walk's column reads of the
  // diagonal words fall in distinct banks
  int stride = W;
  if (staged) {
    uint32_t* dst = reinterpret_cast<uint32_t*>(smem);
    const int n = K * W;
    int t0 = 0;
    if ((reinterpret_cast<uintptr_t>(ov) & 15) == 0 && (W & 3) == 0) {
      const uint4* src4 = reinterpret_cast<const uint4*>(ov);
#pragma unroll 4
      for (int t = threadIdx.x; t < n / 4; t += SUP_THREADS) {
        const uint4 v = src4[t];
        uint32_t* d = dst + (4 * t / W) * (W + 1) + 4 * t % W;
        d[0] = v.x;
        d[1] = v.y;
        d[2] = v.z;
        d[3] = v.w;
      }
      t0 = n;
    }
    for (int t = t0 + threadIdx.x; t < n; t += SUP_THREADS)
      dst[t / W * (W + 1) + t % W] = ov[t];
    ov = dst;
    stride = W + 1;
  }
  __syncthreads();
  if (threadIdx.x >= 32) return;
  uint8_t* kb = keep + (size_t)b * K;
  // the removed-mask: lane l holds words l, l + 32, l + 64, l + 96
  uint32_t rem0 = 0, rem1 = 0, rem2 = 0, rem3 = 0;
  for (int g = 0; g < W; ++g) {
    const int row = (g << 5) + lane;
    const uint32_t diag = row < K ? ov[(size_t)row * stride + g] : 0u;
    const int q = g >> 5;
    const uint32_t mine = q == 0 ? rem0 : q == 1 ? rem1 : q == 2 ? rem2 : rem3;
    const uint32_t cur = __shfl_sync(FULL, mine, g & 31);
    uint32_t open = vbits_s[g] & ~cur, kept = 0;  // rows still undecided
    if (__any_sync(FULL, diag & open)) {
      // the word's rows that suppress this lane's row, by a transpose of
      // the 32 x 32 diagonal block; then rounds: a row is removed once a
      // kept row suppresses it, kept once no row before it is undecided
      // and none kept suppresses it
      uint32_t pred = 0;
#pragma unroll
      for (int t = 0; t < 32; ++t) {
        const uint32_t c = __ballot_sync(FULL, (diag >> t) & 1u);
        if (lane == t) pred = c & ((1u << t) - 1u);
      }
      while (open) {
        const bool mine_open = (open >> lane) & 1u;
        const uint32_t newk =
            __ballot_sync(FULL, mine_open && !(pred & (kept | open)));
        const uint32_t gone = __ballot_sync(FULL, mine_open && (pred & kept));
        kept |= newk;
        open &= ~(newk | gone);
      }
    } else {
      kept = open;
    }
    if (row < K) kb[row] = (kept >> lane) & 1u;
    // the kept rows' later words into the removed-mask, four rows of loads
    // in flight
    for (uint32_t m = kept; m;) {
      int r[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        r[u] = m ? (g << 5) + __ffs(m) - 1 : -1;
        m &= m - 1;
      }
      uint32_t x[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int qq = 0; qq < 4; ++qq) {
        const int w = lane + 32 * qq;
        if (w > g && w < W) {
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (r[u] >= 0) x[qq] |= ov[(size_t)r[u] * stride + w];
        }
      }
      rem0 |= x[0];
      rem1 |= x[1];
      rem2 |= x[2];
      rem3 |= x[3];
    }
  }
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

// b1 [B, N1, 7], b2 [B, N2, 7] fp32 → out [B, N1, N2] fp32.
extern "C" int d3_iou(const void* b1, const void* b2, void* out, int batch,
                      long long n1, long long n2, void* stream) {
  const long long total = (long long)batch * n1 * n2;
  if (total == 0) return 0;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  d3_iou_kernel<<<(unsigned)blocks, threads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(b1), static_cast<const float*>(b2),
      static_cast<float*>(out), n1, n2, total);
  return (int)cudaGetLastError();
}

// cand [B, K, 5] fp32, valid [B, K] bytes; writes over [B, K, W] and uses
// maybe [B, K, W] (words, W = ceil(K / 32)) as scratch, count [B] int32.
// cap: the pairs clipped, first in row-major order; cluster: blocks an
// example (1, 2, 4, 8 or 16).
extern "C" int nms_overlap(const void* cand, const void* valid, void* over,
                           void* maybe, void* count, int batch, int k,
                           float thr, int cap, int cluster, void* stream) {
  if (batch == 0 || k == 0) return 0;
  if (k < 0 || k > NMS_MAX_K || cap < 0 || cluster < 1 ||
      cluster > NMS_MAX_CLUSTER || (cluster & (cluster - 1)))
    return (int)cudaErrorInvalidValue;
  static bool sized = false;
  if (!sized) {
    cudaError_t e = cudaFuncSetAttribute(
        nms_overlap_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        NMS_SMEM);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(nms_overlap_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  const int W = (k + 31) >> 5;
  int rows_max = 0;
  for (int c = 0; c < cluster; ++c) {
    const int rows = split_row(c + 1, cluster, k) - split_row(c, cluster, k);
    rows_max = rows > rows_max ? rows : rows_max;
  }
  // the block's maybe rows in shared memory where they fit, then its
  // bitmask rows
  const int rows_words = rows_max * W;
  const int maybe_words =
      overlap_smem(k, 0, rows_words) <= NMS_SMEM ? rows_words : 0;
  const int over_words =
      overlap_smem(k, rows_words, maybe_words) <= NMS_SMEM ? rows_words : 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(batch * cluster));
  cfg.blockDim = dim3(NMS_THREADS);
  cfg.dynamicSmemBytes = overlap_smem(k, over_words, maybe_words);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, nms_overlap_kernel, static_cast<const float*>(cand),
      static_cast<const uint8_t*>(valid), static_cast<uint32_t*>(over),
      static_cast<uint32_t*>(maybe), static_cast<int*>(count), k, thr, cap,
      over_words, maybe_words);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// over [B, K, W] words, valid [B, K] bytes → keep [B, K] bytes (0 / 1).
extern "C" int nms_suppress(const void* over, const void* valid, void* keep,
                            int batch, int k, void* stream) {
  if (batch == 0 || k == 0) return 0;
  if (k < 0 || k > NMS_MAX_K) return (int)cudaErrorInvalidValue;
  static bool sized = false;
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        nms_suppress_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        NMS_SMEM);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  // the bitmask staged with rows of W + 1 words, where it fits
  const size_t bytes = (size_t)k * (((k + 31) >> 5) + 1) * 4;
  const int staged = bytes <= (size_t)NMS_SMEM;
  nms_suppress_kernel<<<(unsigned)batch, SUP_THREADS, staged ? bytes : 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(over), static_cast<const uint8_t*>(valid),
      static_cast<uint8_t*>(keep), k, staged);
  return (int)cudaGetLastError();
}

extern "C" const char* riou_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
