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
// for a whole batch, `nms_overlap` and `nms_suppress` (below);
// `d3_iou`, the 3-D IoU of lidar boxes (below); and `standup_overlap`,
// the bitmask of standup NMS (below). A non-finite box gives
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

// Winding sign of a clip quad: +1 counter-clockwise (or degenerate), -1
// clockwise, NaN for a non-finite quad (as torch.sign passes it).
__device__ __forceinline__ float winding(const float* qx, const float* qy) {
  float sa = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int j = (i + 1) & 3;
    sa += qx[i] * qy[j] - qx[j] * qy[i];
  }
  const float half = 0.5f * sa;
  return half != half ? half : (half < 0.f ? -1.f : 1.f);
}

// Intersection area of the quad in slots 0-3 of (px, py) (slots 4-7 zero)
// and the quad (qx, qy) of winding sign sgn.
__device__ __forceinline__ float quad_inter(float* px, float* py,
                                           const float* qx, const float* qy,
                                           float sgn) {
  int cnt = 4;
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

// BEV intersection area of two boxes (x, y, w, l, yaw).
__device__ float pair_inter(const float* __restrict__ b1,
                            const float* __restrict__ b2) {
  float px[S], py[S], qx[4], qy[4];
  corners(b1, px, py);
#pragma unroll
  for (int i = 4; i < S; ++i) px[i] = py[i] = 0.f;
  corners(b2, qx, qy);
  return quad_inter(px, py, qx, qy, winding(qx, qy));
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
// lidar boxes (x, y, z, w, l, h, yaw; z at the bottom) of a batch
// [B, N, 7] x [B, K, 7] the BEV intersection of `quad_inter` times the
// vertical overlap, over the union of the volumes.
//
// Bound on the H100: bytes. The boxes are read once and the [B, N, K] fp32
// output written once (80.0 MB on the IoU branch's [4, 70 400] x [4, 64]
// call, 0.024 ms at 3.35 TB/s). The operations are what the data needs:
// each box's corners, envelope, z range and flags once, a cull test a
// pair, and the clip only for the pairs the test keeps (0.1% of that
// call's pairs: the anchors' boxes meet few of the 5-10 gt boxes an
// example, and the zero-size padded gt slots none), about 0.4 G.
//
// Design: a block takes a tile of D3_ROWS rows (one thread a row;
// blockIdx.x) of one example (blockIdx.y) and walks the example's K gt boxes
// in chunks of D3_KC. The rows' 7-float records come in coalesced through
// shared memory; each thread derives its row's corners, standup envelope, z
// range, volume and flags once, into shared memory, and the block the tile's
// union of them (the envelopes' hull, the lowest bottom, the highest top,
// the AND of the flags). Each chunk's gt boxes are derived the same way
// (plus their winding sign) by one thread a box, and each lane keeps the
// envelopes, z ranges and flags of gt boxes lane, lane + 32 in registers.
// The cull: a pair is culled when both boxes are tame (every field finite
// and at most D3_TAME in magnitude, so no product of the clip can overflow)
// and their vertical overlap is at most 0, or both are also solid (`D3Box`)
// and their envelopes are strictly apart on x or on y. A vertical overlap at
// most 0 gives inter = inter_bev * 0 exactly; strictly separated envelopes
// give an empty clip in exact arithmetic, and in fp32 at most a rounding
// sliver near a corner, which a solid pair's union keeps far below 1e-6 (the
// plain clip of a segment or a point is no bound: it can keep a whole box).
// A NaN in a comparison reads as "not culled". A gt box that the cull takes
// against the tile's union it takes against every row of the tile (min, max
// and the rounded difference are monotone), so where that holds for a warp's
// 32 gt boxes their rows' zeros go out untested; the other groups a warp
// tests one row at a time. A culled pair's 0 is stored at once: the 32 lanes
// write 128 contiguous bytes of the row, with a streaming hint (__stcs: the
// output's next reader is a single pass, which need not find it in L2), so
// the output leaves as whole lines with no tile held in shared memory, and a
// block needs 29 KB of it (7 blocks an SM). The ballot's survivors are
// appended to a shared-memory list (a shared counter a ballot: the order of
// the list changes no value), which the block then clips densely, one pair a
// thread, by the same arithmetic as `pair_inter` on the staged corners and
// sign, storing each value: a clipped pair's value is bit-identical to
// clipping it from the boxes. Every output entry is written once. Optionally
// the kernel adds the pairs it clipped to `clipped[b]`.

__device__ __forceinline__ float nan_min(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

constexpr int D3_ROWS = 128;      // rows (threads) a block: 128 and 256 measure
                                  // the same; at most 256 (list entries)
constexpr int D3_KC = 64;         // gt boxes a chunk (list entries r << 8 | c)
constexpr float D3_TAME = 1e12f;  // the largest field magnitude culled

// A lidar box's BEV corners, standup envelope (lo x, lo y, hi x, hi y),
// bottom, top and volume, and what the cull may do with it: bit 0, tame
// (every field finite and at most D3_TAME in magnitude); bit 1, solid
// (width and length positive and at least 1/256 of its reach
// |x| + |y| + |w| + |l|: its corners are a quad, not a rounding of a
// segment or a point, whose half-planes would not bound it).
struct D3Box {
  float qx[4], qy[4], env[4], zb, zt, vol;
  int flags;
};

__device__ __forceinline__ D3Box d3_box(const float* p) {
  D3Box o;
  const float bev[5] = {p[0], p[1], p[3], p[4], p[6]};
  corners(bev, o.qx, o.qy);
  o.env[0] = fminf(fminf(o.qx[0], o.qx[1]), fminf(o.qx[2], o.qx[3]));
  o.env[1] = fminf(fminf(o.qy[0], o.qy[1]), fminf(o.qy[2], o.qy[3]));
  o.env[2] = fmaxf(fmaxf(o.qx[0], o.qx[1]), fmaxf(o.qx[2], o.qx[3]));
  o.env[3] = fmaxf(fmaxf(o.qy[0], o.qy[1]), fmaxf(o.qy[2], o.qy[3]));
  o.zb = p[2];
  o.zt = p[2] + p[5];
  o.vol = p[3] * p[4] * p[5];
  bool tame = true;
#pragma unroll
  for (int m = 0; m < 7; ++m) tame = tame && fabsf(p[m]) <= D3_TAME;
  const float reach = fabsf(p[0]) + fabsf(p[1]) + fabsf(p[3]) + fabsf(p[4]);
  const bool solid = p[3] > 0.f && p[4] > 0.f && 256.f * p[3] >= reach &&
                     256.f * p[4] >= reach;
  o.flags = (int)tame | (int)solid << 1;
  return o;
}

// Dynamic shared memory of a block: the rows' 4 + 4 corner coordinates,
// envelope, bottom, top, volume and flags; the chunk's the same and its
// winding sign; the pair list (16-bit entries, also the rows' staging).
constexpr size_t D3_SMEM =
    4 * 16 * D3_ROWS + 4 * 17 * D3_KC + 2 * D3_ROWS * D3_KC;

__global__ void __launch_bounds__(D3_ROWS)
    d3_iou_kernel(const float* __restrict__ b1, const float* __restrict__ b2,
                  float* __restrict__ out, int* __restrict__ clipped, int n1,
                  int n2) {
  constexpr int R = D3_ROWS, WARPS = R / 32, H = D3_KC / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int n_list;
  // the tile's union envelope, lowest bottom and highest top, and the AND
  // of its rows' flags: by warp, then for the block
  __shared__ float wunion[WARPS][6], tunion[6];
  __shared__ int wflags[WARPS], tflags;
  float* rx = reinterpret_cast<float*>(smem);   // [4][R] corner x, [4][R] y
  float* ry = rx + 4 * R;
  float* renv = ry + 4 * R;                     // [4][R]
  float* rz = renv + 4 * R;                     // [3][R] bottom, top, volume
  int* rflags = reinterpret_cast<int*>(rz + 3 * R);
  float* gx = reinterpret_cast<float*>(rflags + R);  // [4][D3_KC] each
  float* gy = gx + 4 * D3_KC;
  float* genv = gy + 4 * D3_KC;
  float* gz = genv + 4 * D3_KC;                 // [3][D3_KC]
  float* gsgn = gz + 3 * D3_KC;
  int* gflags = reinterpret_cast<int*>(gsgn + D3_KC);
  uint16_t* list = reinterpret_cast<uint16_t*>(gflags + D3_KC);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y, r0 = blockIdx.x * R;
  const int rows = min(R, n1 - r0);

  // the rows' records, coalesced, staged in the list's space
  float* stage = reinterpret_cast<float*>(list);
  const float* src = b1 + ((size_t)b * n1 + r0) * 7;
  for (int e = tid; e < rows * 7; e += R) stage[e] = src[e];
  __syncthreads();
  {
    float u[6] = {INFINITY, INFINITY, -INFINITY, -INFINITY, INFINITY,
                  -INFINITY};
    int uf = 3;
    if (tid < rows) {
      const D3Box o = d3_box(stage + 7 * tid);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        rx[i * R + tid] = o.qx[i];
        ry[i * R + tid] = o.qy[i];
        renv[i * R + tid] = o.env[i];
      }
      rz[tid] = o.zb;
      rz[R + tid] = o.zt;
      rz[2 * R + tid] = o.vol;
      rflags[tid] = o.flags;
      u[0] = o.env[0];
      u[1] = o.env[1];
      u[2] = o.env[2];
      u[3] = o.env[3];
      u[4] = o.zb;
      u[5] = o.zt;
      uf = o.flags;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        const float v = __shfl_xor_sync(FULL, u[i], o);
        const bool lo = i == 0 || i == 1 || i == 4;
        u[i] = lo ? fminf(u[i], v) : fmaxf(u[i], v);
      }
      uf &= __shfl_xor_sync(FULL, uf, o);
    }
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < 6; ++i) wunion[warp][i] = u[i];
      wflags[warp] = uf;
    }
  }

  float* const gout = out + ((size_t)b * n1 + r0) * n2;
  for (int k0 = 0; k0 < n2; k0 += D3_KC) {
    const int kc = min(D3_KC, n2 - k0);
    // (the previous chunk's barrier, or the rows' staging above, comes
    // first: the list and the chunk's space are free)
    __syncthreads();
    if (tid < kc) {
      const float* q = b2 + ((size_t)b * n2 + k0 + tid) * 7;
      float p[7];
#pragma unroll
      for (int m = 0; m < 7; ++m) p[m] = q[m];
      const D3Box o = d3_box(p);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        gx[i * D3_KC + tid] = o.qx[i];
        gy[i * D3_KC + tid] = o.qy[i];
        genv[i * D3_KC + tid] = o.env[i];
      }
      gz[tid] = o.zb;
      gz[D3_KC + tid] = o.zt;
      gz[2 * D3_KC + tid] = o.vol;
      gsgn[tid] = winding(o.qx, o.qy);
      gflags[tid] = o.flags;
    }
    if (tid == 0) n_list = 0;
    if (tid == R - 1) {
      float u[6];
      int uf = wflags[0];
#pragma unroll
      for (int i = 0; i < 6; ++i) u[i] = wunion[0][i];
      for (int w = 1; w < WARPS; ++w) {
        u[0] = fminf(u[0], wunion[w][0]);
        u[1] = fminf(u[1], wunion[w][1]);
        u[2] = fmaxf(u[2], wunion[w][2]);
        u[3] = fmaxf(u[3], wunion[w][3]);
        u[4] = fminf(u[4], wunion[w][4]);
        u[5] = fmaxf(u[5], wunion[w][5]);
        uf &= wflags[w];
      }
#pragma unroll
      for (int i = 0; i < 6; ++i) tunion[i] = u[i];
      tflags = uf;
    }
    __syncthreads();

    // the cull: lane l tests gt boxes l, l + 32, ... (held in registers)
    // against the warp's rows, one row a step; a culled pair's 0 goes
    // straight out (a warp's 32 lanes write 128 contiguous bytes), the
    // others go to the list. A gt box that the cull would take against
    // the tile's union (its envelope, z range and flags) is culled against
    // each row, by the monotony of min, max and the difference: where that
    // holds for the warp's 32 gt boxes, their rows' zeros go out untested.
    float ge[H][4], gb[H], gtop[H];
    int gf[H];
    bool skip[H];
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const int c = 32 * h + lane;
      const bool in = c < kc;
#pragma unroll
      for (int i = 0; i < 4; ++i) ge[h][i] = in ? genv[i * D3_KC + c] : 0.f;
      gb[h] = in ? gz[c] : 0.f;
      gtop[h] = in ? gz[D3_KC + c] : 0.f;
      gf[h] = in ? gflags[c] : 0;
      const float wx =
          fminf(tunion[2], ge[h][2]) - fmaxf(tunion[0], ge[h][0]);
      const float wy =
          fminf(tunion[3], ge[h][3]) - fmaxf(tunion[1], ge[h][1]);
      const float zo = fminf(tunion[5], gtop[h]) - fmaxf(tunion[4], gb[h]);
      const int f = tflags & gf[h];
      const bool apart = (f & 2) && (wx < 0.f || wy < 0.f);
      skip[h] = __all_sync(FULL, !in || ((f & 1) && (zo <= 0.f || apart)));
    }
    bool all = true;
#pragma unroll
    for (int h = 0; h < H; ++h) all = all && skip[h];
    for (int r = warp; r < rows; r += WARPS) {
      float* const dst = gout + (size_t)r * n2 + k0;
      if (all) {
#pragma unroll
        for (int h = 0; h < H; ++h)
          if (32 * h + lane < kc) __stcs(dst + 32 * h + lane, 0.f);
        continue;
      }
      const float lx = renv[r], ly = renv[R + r];
      const float hx = renv[2 * R + r], hy = renv[3 * R + r];
      const float zb = rz[r], zt = rz[R + r];
      const int fr = rflags[r];
#pragma unroll
      for (int h = 0; h < H; ++h) {
        if (32 * h >= kc) break;
        const int c = 32 * h + lane;
        if (skip[h]) {
          if (c < kc) __stcs(dst + c, 0.f);
          continue;
        }
        const float wx = fminf(hx, ge[h][2]) - fmaxf(lx, ge[h][0]);
        const float wy = fminf(hy, ge[h][3]) - fmaxf(ly, ge[h][1]);
        const float zo = fminf(zt, gtop[h]) - fmaxf(zb, gb[h]);
        const int f = fr & gf[h];
        const bool apart = (f & 2) && (wx < 0.f || wy < 0.f);
        const bool keep = c < kc && !((f & 1) && (zo <= 0.f || apart));
        if (c < kc && !keep) __stcs(dst + c, 0.f);
        const unsigned m = __ballot_sync(FULL, keep);
        if (m) {
          int base = 0;
          if (lane == 0) base = atomicAdd(&n_list, __popc(m));
          base = __shfl_sync(FULL, base, 0);
          if (keep)
            list[base + __popc(m & ((1u << lane) - 1u))] =
                (uint16_t)((r << 8) | c);
        }
      }
    }
    __syncthreads();

    // the kept pairs, densely, one a thread
    const int n = n_list;
    for (int p = tid; p < n; p += R) {
      const int e = list[p], r = e >> 8, c = e & 255;
      float px[S], py[S], qx[4], qy[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        px[i] = rx[i * R + r];
        py[i] = ry[i * R + r];
        qx[i] = gx[i * D3_KC + c];
        qy[i] = gy[i * D3_KC + c];
      }
#pragma unroll
      for (int i = 4; i < S; ++i) px[i] = py[i] = 0.f;
      const float inter_bev = quad_inter(px, py, qx, qy, gsgn[c]);
      const float zo =
          nan_min(rz[R + r], gz[D3_KC + c]) - nan_max(rz[r], gz[c]);
      const float inter = inter_bev * (zo < 0.f ? 0.f : zo);
      const float denom = rz[2 * R + r] + gz[2 * D3_KC + c] - inter;
      __stcs(gout + (size_t)r * n2 + k0 + c,
             inter / (denom < 1e-12f ? 1e-12f : denom));
    }
    if (clipped != nullptr && tid == 0 && n) atomicAdd(clipped + b, n);
  }
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


// standup_overlap — replaces the standup branch of `nms`
// (second_tpu/ops/nms.py:183): the dense standup IoU matrix of the
// candidates (`standup_iou_matrix`) thresholded, here written directly as
// the strictly-upper bitmask of valid pairs [B, K, ceil(K / 32)] that
// `nms_suppress` reads. Bound on the H100: operations. K(K-1)/2 pair tests
// an example (STANDUP_TEST_OPS, below) against a bitmask of K²/8 bytes
// (2 MB for the proposals' NMS, batch 4 of K = 2048). Design: a block of
// 32 x 8 threads makes 8 rows by 32 words; it stages the 1024 boxes of its
// words' columns, their areas and valid flags in shared memory, each
// thread holds its row's box in registers and tests 32 columns into one
// word, so a warp writes 32 consecutive words of a row. The IoU is
// computed in `standup_iou_matrix`'s order of operations (`eps` 0 adds
// nothing a comparison could see), so the bits equal the plain version's.
// torch.maximum / torch.minimum: NaN if either operand is NaN
template <typename S>
__device__ __forceinline__ S nan_max(S a, S b) {
  return a != a ? a : (b != b ? b : (a > b ? a : b));
}
template <typename S>
__device__ __forceinline__ S nan_min(S a, S b) {
  return a != a ? a : (b != b ? b : (a < b ? a : b));
}

template <typename S>
__global__ void __launch_bounds__(256)
    standup_overlap_kernel(const S* __restrict__ cand,
                           const uint8_t* __restrict__ valid,
                           uint32_t* __restrict__ over, int k, S thr) {
  __shared__ S sbox[1024][4];
  __shared__ S sarea[1024];
  __shared__ uint8_t sok[1024];
  const int b = blockIdx.z;
  const int W = (k + 31) >> 5;
  const int j0 = blockIdx.x * 1024;
  const S* bc = cand + (long long)b * k * 4;
  const uint8_t* bv = valid + (long long)b * k;
  const int tid = threadIdx.y * 32 + threadIdx.x;
  for (int t = tid; t < 1024; t += 256) {
    const int j = j0 + t;
    S x1 = 0, y1 = 0, x2 = 0, y2 = 0;
    uint8_t ok = 0;
    if (j < k) {
      x1 = bc[4 * j];
      y1 = bc[4 * j + 1];
      x2 = bc[4 * j + 2];
      y2 = bc[4 * j + 3];
      ok = bv[j];
    }
    sbox[t][0] = x1;
    sbox[t][1] = y1;
    sbox[t][2] = x2;
    sbox[t][3] = y2;
    sarea[t] = (x2 - x1) * (y2 - y1);
    sok[t] = ok;
  }
  __syncthreads();
  const int i = blockIdx.y * 8 + threadIdx.y;
  const int w = blockIdx.x * 32 + threadIdx.x;
  if (i >= k || w >= W) return;
  const S x1 = bc[4 * i], y1 = bc[4 * i + 1];
  const S x2 = bc[4 * i + 2], y2 = bc[4 * i + 3];
  const S a1 = (x2 - x1) * (y2 - y1);
  const bool vi = bv[i] != 0;
  uint32_t word = 0;
  if (vi) {
    for (int t = 0; t < 32; ++t) {
      const int j = w * 32 + t;
      const int sj = threadIdx.x * 32 + t;
      if (j >= k) break;
      if (j <= i || !sok[sj]) continue;
      const S wx = nan_min(x2, sbox[sj][2]) - nan_max(x1, sbox[sj][0]);
      const S wy = nan_min(y2, sbox[sj][3]) - nan_max(y1, sbox[sj][1]);
      const S inter = (wx > S(0) && wy > S(0)) ? wx * wy : S(0);
      const S iou = inter > S(0) ? inter / (a1 + sarea[sj] - inter) : S(0);
      if (iou > thr) word |= 1u << t;
    }
  }
  over[((long long)b * k + i) * W + w] = word;
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

// b1 [B, N1, 7], b2 [B, N2, 7] fp32 → out [B, N1, N2] fp32; clipped: null,
// or [B] int32 to which each example's clipped pairs are added.
extern "C" int d3_iou(const void* b1, const void* b2, void* out,
                      void* clipped, int batch, int n1, int n2,
                      void* stream) {
  if (batch < 0 || batch > 65535 || n1 < 0 || n2 < 0)
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || n1 == 0 || n2 == 0) return 0;
  static bool sized = false;
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        d3_iou_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)D3_SMEM);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  const dim3 grid((unsigned)((n1 + D3_ROWS - 1) / D3_ROWS), (unsigned)batch);
  d3_iou_kernel<<<grid, D3_ROWS, D3_SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(b1), static_cast<const float*>(b2),
      static_cast<float*>(out), static_cast<int*>(clipped), n1, n2);
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

// cand [B, K, 4] xyxy (fp32, or fp64 with is_double), valid [B, K] bytes →
// over [B, K, ceil(K / 32)] words: bit j of row i set where i < j, both
// valid and their standup IoU exceeds thr (in the boxes' dtype).
extern "C" int standup_overlap(const void* cand, const void* valid,
                               void* over, int batch, int k, double thr,
                               int is_double, void* stream) {
  if (batch == 0 || k == 0) return 0;
  if (batch < 0 || batch > 65535 || k < 0) return (int)cudaErrorInvalidValue;
  const int W = (k + 31) >> 5;
  const dim3 grid((unsigned)((W + 31) / 32), (unsigned)((k + 7) / 8),
                  (unsigned)batch);
  const dim3 block(32, 8);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_double)
    standup_overlap_kernel<double><<<grid, block, 0, st>>>(
        static_cast<const double*>(cand), static_cast<const uint8_t*>(valid),
        static_cast<uint32_t*>(over), k, thr);
  else
    standup_overlap_kernel<float><<<grid, block, 0, st>>>(
        static_cast<const float*>(cand), static_cast<const uint8_t*>(valid),
        static_cast<uint32_t*>(over), k, (float)thr);
  return (int)cudaGetLastError();
}

extern "C" const char* riou_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
