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
// the bitmask of standup NMS (below); and the decay steps of soft-NMS
// (below): `soft_nms_decay_standup` over standup candidates' boxes
// (standup soft-NMS) and `soft_nms_decay_pairs` over the capped pair list
// of rotated soft-NMS. Past NMS_MAX_K candidates an example, where one
// block's shared memory no longer holds them, the NMS and soft-NMS entries
// take a wide route of their own (each described where it is defined),
// with the same results. A non-finite box gives
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
// the bitmask. Bound: bytes (the bitmask read once), but the walk over the
// W = ceil(K / 32) words is a serial chain, so what the card can reach is
// a launch's latency plus that chain. Design: one block of 32 warps per
// example stages the bitmask in shared memory with 16-byte loads, its rows
// padded to W + 1 words (it reads it in place where it does not fit), and
// transposes every word's 32 x 32 diagonal block in parallel, a warp a
// word (32 ballots), into pred_s: for each row, the earlier rows of its
// word that suppress it. Then warp 0 walks the words, and each step only
// settles its word's 32 rows against the rows removed so far, by rounds
// of ballots over pred, then ORs the kept rows' next two words (two
// column reads, prefetched a step ahead, and two OR-reduces). The other
// 31 warps run ahead of the walk: each owns some later words and, as each
// word is decided, ORs that word's kept rows into the removed mask of
// each word it owns three or more words ahead (a column read over the
// word's rows, one OR-reduce), publishing the mask and how many words it
// covers as one 64-bit word in shared memory, as the walk publishes each
// word's kept rows with a flag: no fence on either side. The walk waits
// on that count, so the helpers' handoff, not the settling, paces it;
// fewer helpers, each owning more words, were slower. A walk alone,
// reading each row's earlier suppressors from a bitmask transposed up
// front, was slower still, in its transpose and in the walk.

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
// the largest K of the routes that hold an example in one block's shared
// memory (a list entry packs i << 12 | j); past it the wide routes
constexpr int NMS_MAX_K = 4096;
// the largest K of rotated NMS and soft-NMS: JAX indexes their candidate
// pairs as int32 `arange(K * K)` (second_tpu/ops/nms.py:100, :142), so
// K * K < 2^31
constexpr int NMS_ROTATED_MAX_K = 46340;
constexpr int NMS_MAX_CLUSTER = 16;      // 8 is portable, 16 fits an H100
constexpr int NMS_LIST = 8192;           // pairs a block clips per chunk
constexpr int NMS_SMEM = 226 * 1024;     // dynamic shared memory a block
constexpr int SUP_THREADS = 1024;
constexpr int SUP_WARPS = SUP_THREADS / 32;
// the suppression's helper warps, and the words each owns at most (words
// 3 on: the walk itself covers each word's next two)
constexpr int SUP_HELPERS = SUP_WARPS - 1;
constexpr int SUP_OWN = (NMS_MAX_K / 32 - 3 + SUP_HELPERS - 1) / SUP_HELPERS;
// its staged bitmask, beside some 18 KB of static shared memory
constexpr int SUP_SMEM = 200 * 1024;

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

// A box's standup envelope (min x, min y, max x, max y of its corners)
// and its area w * l, in the plain version's order of operations.
__device__ __forceinline__ void standup_envelope(const float* __restrict__ q,
                                                 float4& env, float& area) {
  float qx[4], qy[4];
  corners(q, qx, qy);
  env = make_float4(fminf(fminf(qx[0], qx[1]), fminf(qx[2], qx[3])),
                    fminf(fminf(qy[0], qy[1]), fminf(qy[2], qy[3])),
                    fmaxf(fmaxf(qx[0], qx[1]), fmaxf(qx[2], qx[3])),
                    fmaxf(fmaxf(qy[0], qy[1]), fmaxf(qy[2], qy[3])));
  area = q[2] * q[3];
}

// Whether a pair's standup bound, inter / max(a_i + a_j - inter, 1e-12),
// exceeds thr. The quotient q = inter / denom, correctly rounded, exceeds
// thr exactly when inter exceeds thr * denom, unless the two lie within
// 4e-7 of each other (or the product is tiny): only then is the division
// computed.
__device__ __forceinline__ bool bound_over(float4 si, float ai, float4 sj,
                                           float aj, float thr) {
  const float wx = fmaxf(fminf(si.z, sj.z) - fmaxf(si.x, sj.x), 0.f);
  const float wy = fmaxf(fminf(si.w, sj.w) - fmaxf(si.y, sj.y), 0.f);
  const float inter = wx * wy;
  const float denom = fmaxf((ai + aj) - inter, 1e-12f);
  const float p = thr * denom;
  const bool sure = fabsf(p) >= 1e-30f;
  bool m = sure && inter > p * 1.0000004f;
  if (!m && !(sure && inter < p * 0.9999996f)) m = inter / denom > thr;
  return m;
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
    float q[5];
#pragma unroll
    for (int m = 0; m < 5; ++m) bx[5 * k + m] = q[m] = cb[5 * k + m];
    standup_envelope(q, su[k], area[k]);
    vs[k] = valid[(size_t)b * K + k];
  }
  // this block's rows of the bitmask: in shared memory, or in place
  uint32_t* ov = over_words ? ov_s : over + ((size_t)b * K + r0) * W;
  for (int t = tid; t < rows * W; t += NMS_THREADS) ov[t] = 0u;
  __syncthreads();

  // bound test (`bound_over`): a warp a row, 32 columns a ballot word,
  // kept in the block's maybe rows (shared memory, or the global scratch)
  uint32_t* mb = maybe_words ? mb_s : maybe + ((size_t)b * K + r0) * W;
  for (int i = r0 + warp; i < r1; i += NMS_WARPS) {
    int cnt = 0;
    if (vs[i]) {
      const float4 si = su[i];
      const float ai = area[i];
      uint32_t upper = ~0u << ((i + 1) & 31);   // first word: columns > i
      for (int w = (i + 1) >> 5; w < W; ++w) {
        const int j = (w << 5) + lane;
        const bool m = bound_over(si, ai, su[j], area[j], thr);
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

// nms_overlap past NMS_MAX_K candidates (the wide route): the same
// bitmask and counts, for K up to NMS_ROTATED_MAX_K, from four kernels over
// global memory, where one block's shared memory no longer holds an
// example. Bound on the H100: operations, as above (K(K-1)/2 bound tests
// an example); a simple design, right first:
// 1. `nms_wide_prep_kernel`, a thread a box: its standup envelope and area
//    into a scratch (float4 and float [B, K]; 0.9 MB at K 46 340, which
//    stays in L2).
// 2. `nms_wide_bound_kernel`, a block of 32 rows (a warp a row), the
//    columns from the block's first row on staged in shared memory
//    NMS_WIDE_COLS at a time (envelope, area, valid flag): each warp tests
//    its row against the staged columns above its diagonal, 32 at a time
//    into a ballot word of the maybe bitmask (global [B, K, W]), and
//    counts the row's pairs.
// 3. `nms_wide_scan_kernel`, a block an example: the exclusive prefix of
//    its row counts in place (`block_exclusive_scan`) and its pair count.
// 4. `nms_wide_clip_kernel`, a warp a row: a row's pairs take row-major
//    ranks from its start and a prefix of popcounts over its words, a word
//    a lane; the lane clips (`pair_iou`) its word's pairs ranked below the
//    cap and writes the word of the bitmask, every word of every row (0
//    where no pair is set), so nothing needs a zero fill or an atomic.
constexpr int NMS_WIDE_COLS = 1024;   // columns a bound block stages at once

__global__ void nms_wide_prep_kernel(const float* __restrict__ cand,
                                     float4* __restrict__ env,
                                     float* __restrict__ area, long long n) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  float q[5];
#pragma unroll
  for (int m = 0; m < 5; ++m) q[m] = cand[5 * t + m];
  standup_envelope(q, env[t], area[t]);
}

__global__ void __launch_bounds__(NMS_THREADS)
    nms_wide_bound_kernel(const float4* __restrict__ env,
                          const float* __restrict__ area,
                          const uint8_t* __restrict__ valid,
                          uint32_t* __restrict__ maybe,
                          int* __restrict__ start, int K, float thr) {
  __shared__ float4 su[NMS_WIDE_COLS];
  __shared__ float sa[NMS_WIDE_COLS];
  __shared__ uint8_t sv[NMS_WIDE_COLS];
  const int W = (K + 31) >> 5;
  const int blocks = (K + NMS_WARPS - 1) / NMS_WARPS;   // row blocks
  const int b = blockIdx.x / blocks;
  const int r0 = (blockIdx.x - b * blocks) * NMS_WARPS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i = r0 + warp;
  const long long base = (long long)b * K;
  const bool row_ok = i < K && valid[base + i];
  float4 si = make_float4(0.f, 0.f, 0.f, 0.f);
  float ai = 0.f;
  if (row_ok) {
    si = env[base + i];
    ai = area[base + i];
  }
  uint32_t* mb = maybe + (base + i) * W;
  int cnt = 0;
  // the staged chunks start at the word of the block's first row + 1
  for (int c0 = ((r0 + 1) >> 5) << 5; c0 < (W << 5); c0 += NMS_WIDE_COLS) {
    __syncthreads();
    for (int c = tid; c < NMS_WIDE_COLS; c += NMS_THREADS) {
      const int j = c0 + c;
      const bool in = j < K;
      su[c] = in ? env[base + j] : make_float4(0.f, 0.f, 0.f, 0.f);
      sa[c] = in ? area[base + j] : 0.f;
      sv[c] = in ? valid[base + j] : 0;
    }
    __syncthreads();
    if (!row_ok) continue;
    const int w_end = min(W, (c0 + NMS_WIDE_COLS) >> 5);
    for (int w = max((i + 1) >> 5, c0 >> 5); w < w_end; ++w) {
      const int c = (w << 5) - c0 + lane;
      const bool m = bound_over(si, ai, su[c], sa[c], thr);
      uint32_t word = __ballot_sync(FULL, m && sv[c]);
      if (w == (i + 1) >> 5) word &= ~0u << ((i + 1) & 31);  // columns > i
      if (lane == 0) mb[w] = word;
      cnt += __popc(word);
    }
  }
  if (i < K && lane == 0) start[b * (K + 1LL) + i] = cnt;
}

__global__ void __launch_bounds__(NMS_THREADS)
    nms_wide_scan_kernel(int* __restrict__ start, int* __restrict__ count,
                         int K) {
  __shared__ int warp_sums[NMS_WARPS];
  const int b = blockIdx.x;
  const int total = block_exclusive_scan(start + b * (K + 1LL), K,
                                         warp_sums);
  if (threadIdx.x == 0) count[b] = total;
}

__global__ void nms_wide_clip_kernel(const float* __restrict__ cand,
                                     const uint32_t* __restrict__ maybe,
                                     const int* __restrict__ start,
                                     uint32_t* __restrict__ over, int batch,
                                     int K, float thr, int cap) {
  const int lane = threadIdx.x & 31;
  const long long r = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (r >= (long long)batch * K) return;
  const int b = (int)(r / K), i = (int)(r - (long long)b * K);
  const int W = (K + 31) >> 5;
  const int* st = start + b * (K + 1LL);
  const int rs = st[i], re = st[i + 1];
  const uint32_t* mb = maybe + r * W;
  uint32_t* ov = over + r * W;
  const float* cb = cand + (long long)b * K * 5;
  const int first = (i + 1) >> 5;
  int base = rs;
  for (int w0 = 0; w0 < W; w0 += 32) {
    const int w = w0 + lane;
    // a row with no pair below the cap reads no maybe word
    uint32_t word = rs < re && rs < cap && w < W && w >= first ? mb[w] : 0u;
    const int p = __popc(word);
    int incl = p;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += y;
    }
    int rank = base + incl - p;
    uint32_t out = 0u;
    while (word && rank < cap) {
      const int bit = __ffs(word) - 1;
      word &= word - 1;
      if (pair_iou(cb + 5 * i, cb + 5 * ((w << 5) + bit), -1) > thr)
        out |= 1u << bit;
      ++rank;
    }
    if (w < W) ov[w] = out;
    base += __shfl_sync(FULL, incl, 31);
  }
}

__global__ void __launch_bounds__(SUP_THREADS)
    nms_suppress_kernel(const uint32_t* __restrict__ over,
                        const uint8_t* __restrict__ valid,
                        uint8_t* __restrict__ keep, int K, int staged) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint32_t vbits_s[NMS_MAX_K / 32];
  // row i's earlier rows in its word that suppress it (the word's diagonal
  // block transposed)
  __shared__ uint32_t pred_s[NMS_MAX_K];
  // the walk's progress, each a 64-bit word written whole (so a reader
  // sees its two halves together, and no fence is needed): word g's kept
  // rows with 1 in the high half once it is decided (0 before); for word
  // w, the rows removed by the kept rows of the words its helper has
  // covered, with their count in the high half
  __shared__ unsigned long long kept_s[NMS_MAX_K / 32];
  __shared__ unsigned long long rem_s[NMS_MAX_K / 32];
  const int W = (K + 31) >> 5, b = blockIdx.x, lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const uint32_t* ov = over + (size_t)b * K * W;
  const uint8_t* vb = valid + (size_t)b * K;
  // the valid flags as words, a warp a word
  for (int g = warp; g < W; g += SUP_WARPS) {
    const int row = (g << 5) + lane;
    const uint32_t v = __ballot_sync(FULL, row < K && vb[row]);
    if (lane == 0) {
      vbits_s[g] = v;
      kept_s[g] = 0ull;
      rem_s[g] = 0ull;
    }
  }
  // staged rows are W + 1 words apart, so the column reads of one word
  // over a word's 32 rows fall in distinct banks
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
  // every word's diagonal block transposed, a warp a word, off the walk
  for (int g = warp; g < W; g += SUP_WARPS) {
    const int row = (g << 5) + lane;
    const uint32_t diag = row < K ? ov[(size_t)row * stride + g] : 0u;
    uint32_t pred = 0;
    if (__any_sync(FULL, diag)) {
#pragma unroll
      for (int t = 0; t < 32; ++t) {
        const uint32_t c = __ballot_sync(FULL, (diag >> t) & 1u);
        if (lane == t) pred = c & ((1u << t) - 1u);
      }
    }
    pred_s[row] = pred;
  }
  __syncthreads();
#ifdef NMS_SUPPRESS_STAGE_ONLY
  // a measurement build (scripts/torch_nms_suppress.py): the staging and
  // the transposes alone
  if (threadIdx.x < K)
    keep[(size_t)b * K + threadIdx.x] = pred_s[threadIdx.x] & 1u;
  return;
#endif
  volatile unsigned long long* kept_v = kept_s;
  volatile unsigned long long* rem = rem_s;
  if (warp == 0) {
    // the walk: word g's rows against the rows removed before it (the
    // helpers' rem_s[g], from words up to g - 3, and `near`, from words
    // g - 2 and g - 1), settled in rounds of ballots: a row is removed
    // once a kept row suppresses it, kept once no row before it is
    // undecided and none kept suppresses it
    uint8_t* kb = keep + (size_t)b * K;
    uint32_t near = 0u, far = 0u;
    // columns g + 1 and g + 2 of word g's rows, loaded a step ahead
    uint32_t c1 = W > 1 && lane < K ? ov[(size_t)lane * stride + 1] : 0u;
    uint32_t c2 = W > 2 && lane < K ? ov[(size_t)lane * stride + 2] : 0u;
    for (int g = 0; g < W; ++g) {
      const int row = (g << 5) + lane;
      const uint32_t pred = pred_s[row];
      const bool ahead = row + 32 < K;
      const uint32_t n1 = g + 2 < W && ahead
          ? ov[(size_t)(row + 32) * stride + g + 2] : 0u;
      const uint32_t n2 = g + 3 < W && ahead
          ? ov[(size_t)(row + 32) * stride + g + 3] : 0u;
      uint32_t cur = near;
      if (g >= 3) {
        unsigned long long r;
        do {
          r = rem[g];
        } while ((int)(r >> 32) < g - 2);
        cur |= (uint32_t)r;
      }
      uint32_t open = vbits_s[g] & ~cur, kept = 0;
      if (__any_sync(FULL, pred & open)) {
        while (open) {
          const bool mine_open = (open >> lane) & 1u;
          const uint32_t newk =
              __ballot_sync(FULL, mine_open && !(pred & (kept | open)));
          const uint32_t gone =
              __ballot_sync(FULL, mine_open && (pred & kept));
          kept |= newk;
          open &= ~(newk | gone);
        }
      } else {
        kept = open;
      }
      if (lane == 0) kept_v[g] = 1ull << 32 | kept;
      if (row < K) kb[row] = (kept >> lane) & 1u;
      const bool mine = (kept >> lane) & 1u;
      near = far | __reduce_or_sync(FULL, mine ? c1 : 0u);
      far = __reduce_or_sync(FULL, mine ? c2 : 0u);
      c1 = n1;
      c2 = n2;
    }
    return;
  }
  // the helpers: warp h + 1 owns words w = 3 + h + j * SUP_HELPERS and,
  // as each word d is decided, ORs the column w of d's kept rows into
  // rem_s[w] for every w >= d + 3 (words d + 1 and d + 2 are the walk's)
  const int first = 2 + warp;
  if (first >= W) return;
  const int last = first + (W - 1 - first) / SUP_HELPERS * SUP_HELPERS;
  uint32_t acc[SUP_OWN], colv[SUP_OWN];
#pragma unroll
  for (int j = 0; j < SUP_OWN; ++j) {
    const int w = first + j * SUP_HELPERS;
    acc[j] = 0u;
    colv[j] = w < W && lane < K ? ov[(size_t)lane * stride + w] : 0u;
  }
  for (int d = 0; d + 3 <= last; ++d) {
    // the next word's columns, loaded while this one waits
    const int r1 = ((d + 1) << 5) + lane;
    uint32_t nxt[SUP_OWN];
#pragma unroll
    for (int j = 0; j < SUP_OWN; ++j) {
      const int w = first + j * SUP_HELPERS;
      nxt[j] = w < W && w >= d + 4 && r1 < K
          ? ov[(size_t)r1 * stride + w] : 0u;
    }
    unsigned long long kd;
    do {
      kd = kept_v[d];
    } while (!(kd >> 32));
    const bool mine = (kd >> lane) & 1u;
#pragma unroll
    for (int j = 0; j < SUP_OWN; ++j) {
      const int w = first + j * SUP_HELPERS;
      if (w < W && w >= d + 3) {
        acc[j] |= __reduce_or_sync(FULL, mine ? colv[j] : 0u);
        if (lane == 0) rem[w] = (unsigned long long)(d + 1) << 32 | acc[j];
      }
      colv[j] = nxt[j];
    }
  }
}


// nms_suppress past NMS_MAX_K candidates (the wide route; rotated NMS up to
// NMS_ROTATED_MAX_K, standup NMS at any K whose bitmask the card holds):
// the same keep set. Bound: bytes (the bitmask read once), a serial walk
// over the W words. A simple design, right first: one block an example;
// the rows removed so far, W words, in dynamic shared memory (5.8 KB at
// K 46 340). Warp 0 settles word g as the kernel above does (its diagonal
// block transposed by 32 ballots, then rounds of ballots over the open
// rows) and publishes its kept rows; then the whole block ORs each kept
// row's words past g into the removed mask, a thread a word (the kept
// rows read in place, coalesced). Two barriers a word.
__global__ void __launch_bounds__(SUP_THREADS)
    nms_suppress_wide_kernel(const uint32_t* __restrict__ over,
                             const uint8_t* __restrict__ valid,
                             uint8_t* __restrict__ keep, int K) {
  extern __shared__ uint32_t removed[];
  __shared__ uint32_t kept_word;
  const int W = (K + 31) >> 5, lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long b = blockIdx.x;
  const uint32_t* ov = over + b * K * W;
  const uint8_t* vb = valid + b * K;
  uint8_t* kb = keep + b * K;
  for (int w = threadIdx.x; w < W; w += SUP_THREADS) removed[w] = 0u;
  __syncthreads();
  for (int g = 0; g < W; ++g) {
    if (warp == 0) {
      const int row = (g << 5) + lane;
      const bool in = row < K;
      const uint32_t v = __ballot_sync(FULL, in && vb[row]);
      const uint32_t diag = in ? ov[(size_t)row * W + g] : 0u;
      // row lane's earlier rows of its word that suppress it
      uint32_t pred = 0;
      if (__any_sync(FULL, diag)) {
#pragma unroll
        for (int t = 0; t < 32; ++t) {
          const uint32_t c = __ballot_sync(FULL, (diag >> t) & 1u);
          if (lane == t) pred = c & ((1u << t) - 1u);
        }
      }
      uint32_t open = v & ~removed[g], kept = 0;
      if (__any_sync(FULL, pred & open)) {
        while (open) {
          const bool mine_open = (open >> lane) & 1u;
          const uint32_t newk =
              __ballot_sync(FULL, mine_open && !(pred & (kept | open)));
          const uint32_t gone =
              __ballot_sync(FULL, mine_open && (pred & kept));
          kept |= newk;
          open &= ~(newk | gone);
        }
      } else {
        kept = open;
      }
      if (in) kb[row] = (kept >> lane) & 1u;
      if (lane == 0) kept_word = kept;
    }
    __syncthreads();
    const uint32_t kw = kept_word;
    if (kw) {
      for (int w = g + 1 + threadIdx.x; w < W; w += SUP_THREADS) {
        uint32_t acc = 0u;
        for (uint32_t k = kw; k; k &= k - 1)
          acc |= ov[(size_t)((g << 5) + __ffs(k) - 1) * W + w];
        removed[w] |= acc;
      }
    }
    __syncthreads();
  }
}

// standup_overlap — replaces the standup branch of `nms`
// (second_tpu/ops/nms.py:183): the dense standup IoU matrix of the
// candidates (`standup_iou_matrix`) thresholded, here written directly as
// the strictly-upper bitmask of valid pairs [B, K, ceil(K / 32)] that
// `nms_suppress` reads. Bound on the H100: operations. K(K-1)/2 pair tests
// an example (STANDUP_TEST_OPS in chip_smoke.py) against 16 K bytes of
// boxes and a bitmask of K²/8 bytes (2 MB for the proposals' NMS, batch 4
// of K = 2048). Most pairs do not meet (1.8% do on that call), so the
// design keeps such a pair to four compares and a vote.
// Design: a block of SU_WORDS warps makes a tile of SU_ROWS rows by
// SU_WORDS words. The grid holds the tiles that can set a bit first,
// spread evenly over the SMs, then a block a row tile that writes the
// zeros of the tiles wholly at or below the diagonal, with no load and no
// test. Warp 0 stages a tile's valid rows in shared memory, compacted (an
// invalid row tests nothing and its words stay 0); every lane reads a row
// at one address. Each warp owns one word, a lane one column, whose box
// and area it keeps in registers, and walks the valid rows before its
// word's last column: a row's meet test is `j > i` and four compares of
// the boxes' sides, one vote. Only the lanes whose boxes meet take the
// widths, product, union and quotient (a lane dividing 0 would take the
// IEEE division's slow path); the ballot of `iou > thr` is the row's word,
// kept by the lane of the row's rank. The words go through a shared tile
// and leave as each row's run of SU_WORDS words.
// A box with a NaN, or empty in x or y, meets no box: it is staged as the
// empty box (+inf, +inf, -inf, -inf), and so is an invalid column. For
// the others `min(x2) - max(x1) > 0` holds exactly where both boxes' x2
// lie after both x1 (a difference of floats rounds to 0 only when they
// are equal), and the same in y, so the four compares decide the premise
// of `inter > 0`. The IoU is computed in `standup_iou_matrix`'s order of
// operations (`eps` 0 adds nothing a comparison could see), so the bits
// equal the plain version's. A threshold below 0 also sets the valid
// pairs that do not meet (their IoU is 0).
constexpr int SU_ROWS = 32;   // rows a tile, a lane's each
constexpr int SU_WORDS = 8;   // words a tile, a warp each
constexpr int SU_THREADS = 32 * SU_WORDS;

template <typename S>
struct alignas(16) SuBox {
  S x1, y1, x2, y2;
};

// The live row tiles of word tile tx: those whose first row lies before
// the tile's last column (a tile at or below the diagonal sets no bit).
__host__ __device__ __forceinline__ int su_live_rows(int tx, int k) {
  const int end = 32 * SU_WORDS * (tx + 1);
  const int last = (end < k ? end : k) - 1;
  return (last + SU_ROWS - 1) / SU_ROWS;
}

template <typename S>
__device__ __forceinline__ SuBox<S> standup_box(const S* __restrict__ c) {
  SuBox<S> b{c[0], c[1], c[2], c[3]};
  if (!(b.x2 > b.x1 && b.y2 > b.y1))  // NaN, or empty in x or y
    b = SuBox<S>{S(INFINITY), S(INFINITY), S(-INFINITY), S(-INFINITY)};
  return b;
}

// Block `id` of the grid: the live tiles of every example first (word tile
// by word tile, each's row tiles in order), so that they spread evenly
// over the SMs; then a block a row tile, which writes the words of the
// tiles at or below the diagonal, those before its first live tile.
__device__ __forceinline__ void su_tile(int id, int batch, int k,
                                        int live_tiles, int& b, int& tx,
                                        int& ty, bool& live) {
  const int rows = (k + SU_ROWS - 1) / SU_ROWS;
  const int all_live = batch * live_tiles;
  live = id < all_live;
  if (live) {
    b = id / live_tiles;
    int t = id - b * live_tiles;
    for (tx = 0;; ++tx) {
      const int n = su_live_rows(tx, k);
      if (t < n) break;
      t -= n;
    }
    ty = t;
  } else {
    id -= all_live;
    b = id / rows;
    ty = id - b * rows;
    const int words = (((k + 31) >> 5) + SU_WORDS - 1) / SU_WORDS;
    tx = 0;
    while (tx < words && su_live_rows(tx, k) <= ty) ++tx;
  }
}

template <typename S>
__global__ void __launch_bounds__(SU_THREADS)
    standup_overlap_kernel(const S* __restrict__ cand,
                           const uint8_t* __restrict__ valid,
                           uint32_t* __restrict__ over, int batch, int k,
                           int live_tiles, S thr) {
  __shared__ SuBox<S> srow_box[SU_ROWS];  // the valid rows, in order
  __shared__ S srow_area[SU_ROWS];
  __shared__ int srow_i[SU_ROWS];
  __shared__ uint32_t svalid;
  __shared__ uint32_t sword[SU_ROWS][SU_WORDS];
  int b, tx, ty;
  bool live;
  su_tile(blockIdx.x, batch, k, live_tiles, b, tx, ty, live);
  const int W = (k + 31) >> 5;
  const int r0 = ty * SU_ROWS, w0 = tx * SU_WORDS;
  const long long base = (long long)b * k;
  const int tid = threadIdx.x, warp = tid >> 5;
  int lane = tid & 31;
  if (live) {
    for (int t = tid; t < SU_ROWS * SU_WORDS; t += SU_THREADS)
      (&sword[0][0])[t] = 0u;
    if (warp == 0) {
      const int i = r0 + lane;
      SuBox<S> a;
      bool ok = false;
      if (i < k) {
        a = standup_box(cand + (base + i) * 4);
        ok = valid[base + i] != 0;
      }
      const uint32_t m = __ballot_sync(FULL, ok);
      if (ok) {
        const int pos = __popc(m & ((1u << lane) - 1u));
        srow_box[pos] = a;
        srow_area[pos] = (a.x2 - a.x1) * (a.y2 - a.y1);
        srow_i[pos] = i;
      }
      if (lane == 0) svalid = m;
    }
    const int w = w0 + warp;
    int j = 32 * w + lane;
    SuBox<S> c{S(INFINITY), S(INFINITY), S(-INFINITY), S(-INFINITY)};
    bool okc = false;
    if (j < k) {
      c = standup_box(cand + (base + j) * 4);
      okc = valid[base + j] != 0;
      if (!okc) c = SuBox<S>{S(INFINITY), S(INFINITY), S(-INFINITY),
                             S(-INFINITY)};
    }
    const S ac = (c.x2 - c.x1) * (c.y2 - c.y1);
    // kept in registers through the loop, not recomputed in it
    asm volatile("" : "+r"(j), "+r"(lane));
    __syncthreads();
    // this warp's rows: the valid ones before its word's last column
    const int before = 32 * w + 31 - r0;
    const int rows = __popc(
        before >= 32 ? svalid
                     : (before <= 0 ? 0u : svalid & ((1u << before) - 1u)));
    const bool zero_hit = S(0) > thr;  // iou 0: no intersection
    uint32_t mine = 0u;  // lane n keeps the word of row n
    if (w < W) {
#pragma unroll 4
      for (int n = 0; n < rows; ++n) {
        const SuBox<S> a = srow_box[n];
        const int i = srow_i[n];
        const bool meet = j > i && a.x1 < c.x2 && c.x1 < a.x2 &&
                          a.y1 < c.y2 && c.y1 < a.y2;
        uint32_t word = 0u;
        // the widths, product, union and quotient only where a lane's
        // boxes meet (a quotient of 0 would take the division's slow path)
        if (__any_sync(FULL, meet)) {
          bool hit = false;
          if (meet) {
            const S wx = fmin(a.x2, c.x2) - fmax(a.x1, c.x1);
            const S wy = fmin(a.y2, c.y2) - fmax(a.y1, c.y1);
            const S inter = wx * wy;
            hit = zero_hit;
            if (inter > S(0))
              hit = inter / (srow_area[n] + ac - inter) > thr;
          }
          word = __ballot_sync(FULL, hit);
        }
        if (zero_hit) word |= __ballot_sync(FULL, okc && j > i && !meet);
        mine = lane == n ? word : mine;
      }
    }
    if (lane < rows) sword[srow_i[lane] - r0][warp] = mine;
    __syncthreads();
    for (int t = tid; t < SU_ROWS * SU_WORDS; t += SU_THREADS) {
      const int r = t / SU_WORDS, c = t % SU_WORDS;
      const int i = r0 + r, w = w0 + c;
      if (i < k && w < W) over[(base + i) * W + w] = sword[r][c];
    }
  } else {
    // the row tile's words before its first live tile (w0)
    const int zw = w0 < W ? w0 : W;
    for (int r = warp; r < SU_ROWS && r0 + r < k; r += SU_WORDS)
      for (int w = lane; w < zw; w += 32)
        over[(base + r0 + r) * W + w] = 0u;
  }
}

// ------------------------------------------------------------ soft-NMS
//
// The decay steps of soft-NMS — they replace the decay `lax.scan` of
// `soft_nms` (second_tpu/ops/nms.py:230-244; no Pallas counterpart): over a
// row's K candidates, sorted by descending score, `m` steps each pick the
// highest current score (torch.argmax's and jnp.argmax's order: NaN above
// +inf, -0 equal to +0, ties to the lowest index; a row of -inf picks 0),
// record it, multiply every finite score by the decay of its IoU with the
// pick (exp(-iou^2 / sigma), or 1 - iou above the threshold), turn every
// score that was not finite to -inf, and set the pick to -inf. The m steps
// are a chain, each waiting on the last one's pick. Two kernels, each with
// the IoU it needs folded in, so no [R, K, K] matrix is read:
// `soft_nms_decay_standup_kernel` (standup soft-NMS, from the boxes) and
// `soft_nms_decay_pairs_kernel` (rotated soft-NMS, over the capped pair
// list); past NMS_MAX_K candidates each takes a wide route (below).

// a score's key: int order is torch.argmax's order of the scores (NaN
// above +inf, -0 equal to +0)
__device__ __forceinline__ int sp_key(float v) {
  if (v != v) return INT32_MAX;
  if (v == 0.f) return 0;
  const int b = __float_as_int(v);
  return b >= 0 ? b : b ^ 0x7fffffff;
}

// The best (key, index) of a warp: the largest key, and the lowest index
// at that key ((INT32_MIN, INT32_MAX) from a lane that holds no score).
__device__ __forceinline__ int2 sp_warp_best(int key, int idx) {
  const int wk = __reduce_max_sync(FULL, key);
  const int wi = __reduce_min_sync(FULL, key == wk ? idx : INT32_MAX);
  return make_int2(wk, wi);
}

// A standup decay step of one candidate that is not the pick: its current
// score c, its box q (area aq, qnan: a coordinate is NaN) against the
// pick's box pb (pnan); all: the decay of a 0 IoU is not 1. Returns the new
// score: -inf where c is not finite, c times the decay of their standup
// IoU where they meet (or all), else c. Both standup kernels take it, so
// their steps stay bit for bit one another's.
__device__ __forceinline__ float su_decay(float c, float4 q, float aq,
                                          bool qnan, float4 pb, bool pnan,
                                          bool all, int gaussian,
                                          float sigma, float thr) {
  if (!isfinite(c)) return -INFINITY;
  const float wx = fminf(pb.z, q.z) - fmaxf(pb.x, q.x);
  const float wy = fminf(pb.w, q.w) - fmaxf(pb.y, q.y);
  const bool meet = wx > 0.f && wy > 0.f && !pnan && !qnan;
  if (!meet && !all) return c;
  const float ap = (pb.z - pb.x + 0.f) * (pb.w - pb.y + 0.f);
  const float inter = meet ? (wx + 0.f) * (wy + 0.f) : 0.f;
  const float r = inter > 0.f ? inter / ((ap + aq) - inter) : 0.f;
  const float d = gaussian ? expf(-(r * r) / sigma)
                           : (r > thr ? 1.f - r : 1.f);
  return c * d;
}

__device__ __forceinline__ bool has_nan(float4 b) {
  return b.x != b.x || b.y != b.y || b.z != b.z || b.w != b.w;
}

// soft_nms_decay_standup_kernel — the same decay steps (it replaces the
// same `lax.scan`, second_tpu/ops/nms.py:230-244) where standup soft-NMS
// runs them, with the IoU matrix they read (`standup_iou_matrix`,
// second_tpu/ops/rotated_iou.py:191-201, built densely at nms.py:225-227)
// folded in: its input is the candidates' xyxy boxes [R, K, 4], not an
// [R, K, K] matrix, and a step computes the pick's row of that matrix.
// Bound on the H100: bytes, the boxes and scores read once (20 B a
// candidate), the picks and their scores written once (12 B a step), some
// 85 KB on the fhd call; but the m steps are a chain, each waiting on the
// last one's pick, so what the card reaches is a prologue plus m times a
// step's latency. Design: one block a row.
// - Prologue: the row's boxes staged in shared memory (16 B each, 64 KB at
//   K 4096); each lane holds PER consecutive candidates (PER 1, 2 or 4 as
//   K needs, at most 32 warps; a warp a span of 32 x PER consecutive ones,
//   as in the pair kernel): their coordinates, areas, whether a coordinate
//   is NaN, and scores in registers, each area computed once in the plain
//   version's order, (x2 - x1 + 0) * (y2 - y1 + 0); the decay of a 0 IoU,
//   d0, computed once by the same expression as any other.
// - A step: every warp reduces the warps' double-buffered (key, index)
//   slots itself (`sp_warp_best`; no barrier broadcasts the pick) and
//   reads the pick's box from shared memory. The IoU of the pick (as
//   `boxes1`) with a candidate, in `standup_iou_matrix`'s order: lt and rb
//   by max and min, wh = rb - lt + 0, inter = wx * wy where both are > 0,
//   iou = inter / ((a_pick + a_j) - inter) where inter > 0, else 0: the
//   dense matrix's entry bit for bit (no fused multiply-adds in this
//   file). A NaN coordinate in either box makes a width NaN and the IoU 0
//   (as `(wh > 0).all(-1)` does), so the widths are taken with fminf and
//   fmaxf and the pair meets only where neither box holds a NaN: where
//   both do not, fminf and fmaxf are torch.minimum and torch.maximum; the
//   + 0 changes no width that is > 0. A pair that does not meet has IoU 0
//   and decays by d0, which is 1 unless sigma is 0 or NaN: so each lane
//   decays (fp32, `expf`, an IEEE division) only its finite candidates
//   that meet the pick, or all of them where d0 is not 1; turns a NaN or
//   +inf score to -inf; sets the pick to -inf (its owner writes it and its
//   score out); and recomputes its best (key, index) only where one of its
//   candidates changed, the warp its slot only where a lane did, into the
//   other slot buffer. One barrier a step.
template <int PER>
__global__ void __launch_bounds__(1024)
    soft_nms_decay_standup_kernel(const float4* __restrict__ cand,
                                  const float* __restrict__ scores,
                                  long long* __restrict__ picks,
                                  float* __restrict__ pick_scores, int k,
                                  int m, int gaussian, float sigma,
                                  float thr) {
  extern __shared__ float4 ss_box[];
  __shared__ int2 slot[2][32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const long long row = blockIdx.x;
  const int j0 = tid * PER;
  cand += row * k;
  scores += row * k;
  float4 box[PER];
  float area[PER], cur[PER];
  bool nan[PER];
  int lk = INT32_MIN, li = INT32_MAX;
#pragma unroll
  for (int t = 0; t < PER; ++t) {
    const int j = j0 + t;
    const float4 b = j < k ? cand[j] : make_float4(0.f, 0.f, 0.f, 0.f);
    if (j < k) ss_box[j] = b;
    box[t] = b;
    nan[t] = has_nan(b);
    area[t] = (b.z - b.x + 0.f) * (b.w - b.y + 0.f);
    cur[t] = j < k ? scores[j] : -INFINITY;
    if (j < k && sp_key(cur[t]) > lk) {
      lk = sp_key(cur[t]);
      li = j;
    }
  }
  const float r0 = 0.f;
  const float d0 = gaussian ? expf(-(r0 * r0) / sigma)
                            : (r0 > thr ? 1.f - r0 : 1.f);
  const bool all = d0 != 1.f;
  int2 mine = sp_warp_best(lk, li);
  if (lane == 0) slot[0][warp] = mine;
  int buf = 0;
  __syncthreads();
  for (int s = 0; s < m; ++s) {
    const int2 sl = lane < nwarps ? slot[buf][lane]
                                  : make_int2(INT32_MIN, INT32_MAX);
    const int b = sp_warp_best(sl.x, sl.y).y;
    const float4 pb = ss_box[b];
    const bool pnan = has_nan(pb);
    bool changed = false;
#pragma unroll
    for (int t = 0; t < PER; ++t) {
      const int j = j0 + t;
      const float c = cur[t];
      if (j == b) {
        picks[row * m + s] = b;
        pick_scores[row * m + s] = c;
        cur[t] = -INFINITY;
        changed = true;
      } else if (j < k) {
        const float nc = su_decay(c, box[t], area[t], nan[t], pb, pnan, all,
                                  gaussian, sigma, thr);
        if (nc != c) {                  // NaN != NaN: rewritten too
          cur[t] = nc;
          changed = true;
        }
      }
    }
    if (changed) {
      lk = INT32_MIN;
      li = INT32_MAX;
#pragma unroll
      for (int t = 0; t < PER; ++t) {
        const int key = sp_key(cur[t]);
        if (j0 + t < k && key > lk) {
          lk = key;
          li = j0 + t;
        }
      }
    }
    if (__any_sync(FULL, changed)) mine = sp_warp_best(lk, li);
    buf ^= 1;
    if (lane == 0) slot[buf][warp] = mine;
    __syncthreads();
  }
}

// soft_nms_decay_standup_wide_kernel — the standup kernel's steps past
// NMS_MAX_K candidates a row, where a lane's registers and the block's
// shared memory no longer hold them: each lane owns `per` consecutive
// candidates (per = ceil(K / 1024)), whose boxes it reads from the input
// (L2-resident) and whose current scores live in a device scratch [R, K];
// every step it walks them all through the same step (`su_decay`, so the
// same bits), and its best (key, index) over them. One barrier a step; a
// simple design, right first.
__global__ void __launch_bounds__(1024)
    soft_nms_decay_standup_wide_kernel(const float4* __restrict__ cand,
                                       const float* __restrict__ scores,
                                       long long* __restrict__ picks,
                                       float* __restrict__ pick_scores,
                                       float* __restrict__ cur, int k, int m,
                                       int per, int gaussian, float sigma,
                                       float thr) {
  __shared__ int2 slot[2][32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const long long row = blockIdx.x;
  const int j0 = tid * per, j1 = min(j0 + per, k);
  cand += row * k;
  scores += row * k;
  cur += row * k;
  int lk = INT32_MIN, li = INT32_MAX;
  for (int j = j0; j < j1; ++j) {
    const float c = scores[j];
    cur[j] = c;
    if (sp_key(c) > lk) {
      lk = sp_key(c);
      li = j;
    }
  }
  const float r0 = 0.f;
  const float d0 = gaussian ? expf(-(r0 * r0) / sigma)
                            : (r0 > thr ? 1.f - r0 : 1.f);
  const bool all = d0 != 1.f;
  int2 mine = sp_warp_best(lk, li);
  if (lane == 0) slot[0][warp] = mine;
  int buf = 0;
  __syncthreads();
  for (int s = 0; s < m; ++s) {
    const int2 sl = lane < nwarps ? slot[buf][lane]
                                  : make_int2(INT32_MIN, INT32_MAX);
    const int b = sp_warp_best(sl.x, sl.y).y;
    const float4 pb = cand[b];
    const bool pnan = has_nan(pb);
    lk = INT32_MIN;
    li = INT32_MAX;
    for (int j = j0; j < j1; ++j) {
      const float c = cur[j];
      float nc = -INFINITY;
      if (j == b) {
        picks[row * m + s] = b;
        pick_scores[row * m + s] = c;
      } else if (isfinite(c)) {
        const float4 q = cand[j];
        nc = su_decay(c, q, (q.z - q.x + 0.f) * (q.w - q.y + 0.f),
                      has_nan(q), pb, pnan, all, gaussian, sigma, thr);
      }
      if (j == b || nc != c) cur[j] = nc;   // NaN != NaN: rewritten too
      const int key = sp_key(nc);
      if (key > lk) {
        lk = key;
        li = j;
      }
    }
    mine = sp_warp_best(lk, li);
    buf ^= 1;
    if (lane == 0) slot[buf][warp] = mine;
    __syncthreads();
  }
}

// soft_nms_decay_pairs_kernel — the same decay steps (it replaces the same
// `lax.scan`, second_tpu/ops/nms.py:230-244) where rotated soft-NMS runs
// them: over the capped pair list it clips, not a dense IoU matrix. Its
// inputs are plist [R, P] (i * K + j, i < j), ok [R, P] and the pairs' IoU
// [R, P]. A pair's value is what the dense matrix (`torch.maximum(out,
// out.T)`, JAX `jnp.maximum(out, out.T)`) holds at (i, j) and at (j, i):
// max(iou, 0), NaN kept as NaN; a slot that is not ok adds nothing. Every
// other entry of that matrix is 0, and a 0 decays nothing (exp(-0 / sigma)
// and 1 - 0 are 1), so a step changes only the pick and its neighbours.
// Bound on the H100: bytes (the pair list, the scores, the picks), a few
// hundred KB a call; but the m steps are a chain, each waiting on the last
// one's pick, so what the card reaches is a prologue plus m times a step's
// latency. Design: one block a row.
// - Prologue: the row's adjacency in both directions, in shared memory: a
//   count per candidate (shared atomics), a block prefix sum, a fill. An
//   entry is a 16-bit neighbour and the fp32 decay its pair's value gives
//   (expf, an IEEE division, no FMA: the plain version's operations, done
//   once a pair and not once a step), 6 bytes; the order inside a
//   candidate's list is the atomics' and does not matter, since a step
//   changes each neighbour once. Where the 2P entries do not fit beside
//   the K scores and K + 1 offsets (SP_SMEM), the same kernel (its
//   template argument) keeps them in a global scratch, where they stay in
//   L2: no row is refused for its P.
// - The scores stay in shared memory, each warp owning a span of 32 x PER
//   consecutive ones (PER 1, 2 or 4 as K needs, at most 32 warps), PER
//   consecutive a lane (one vector load), so that a warp's lanes, and the
//   warps, hold their scores in index order. A step: every warp loads the
//   warps' (key, index) maxima, written the step before into one of two
//   slot buffers, and reduces them itself: `__reduce_max_sync` over an int
//   key ordered as torch.argmax ranks the scores (NaN above +inf, -0 equal
//   to +0), then `__reduce_min_sync` over the indices at that key (ties to
//   the lowest index; a row of -inf picks 0): no barrier broadcasts the
//   pick. The pick's owner writes it out and sets it to
//   -inf; every warp walks the pick's list and multiplies the neighbours
//   in its own span by their decays (-inf stays -inf); only a warp whose
//   span changed recomputes its slot, the others carry it over into the
//   other buffer. One barrier a step, and no read of device memory where
//   the adjacency fits.
// - The plain version turns every non-finite score to -inf at each step.
//   Here a NaN or +inf (in the scores, or from a decay) marks its warp,
//   which sweeps its span to -inf at its next step, after the pick: the
//   same scores.
// - Past NMS_MAX_K candidates (up to NMS_ROTATED_MAX_K; PER = 0, the wide
//   route): a lane holds `per` consecutive scores, a multiple of 4 (so a
//   span of 32 x per still leaves at most 32 warps), and the scores, the
//   offsets and the adjacency all live in the device scratch (8K + 12P
//   bytes a row, 16-aligned), where they stay in L2; the steps are the
//   same. A simple route, right first.
constexpr int SP_MAX_WARPS = 32;
constexpr int SP_SMEM = 226 * 1024;      // dynamic shared memory a block
constexpr int SP_UNROLL = 8;             // slots a thread loads at once

// The warp's best (key, index) over cur[lo, hi), PER consecutive scores a
// lane ((INT32_MIN, INT32_MAX) for an empty span), and whether the span
// holds a NaN or +inf.
template <int PER>
__device__ __forceinline__ int2 sp_span_max(const float* cur, int lo, int hi,
                                            int lane, bool& dirty) {
  const int j0 = lo + lane * PER;
  float v[PER];
  if (j0 + PER <= hi) {
    if (PER == 4)
      *reinterpret_cast<float4*>(v) = *reinterpret_cast<const float4*>(
          cur + j0);
    else if (PER == 2)
      *reinterpret_cast<float2*>(v) = *reinterpret_cast<const float2*>(
          cur + j0);
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
      if (key > bk) {
        bk = key;
        bi = j0 + t;
      }
      odd |= !isfinite(v[t]) && v[t] != -INFINITY;
    }
  dirty = __any_sync(FULL, odd);
  return sp_warp_best(bk, bi);
}

// sp_span_max's wide form: `per` (a multiple of 4) consecutive scores a
// lane, read 4 at a time, in index order.
__device__ __forceinline__ int2 sp_span_max_wide(const float* cur, int lo,
                                                 int hi, int lane, int per,
                                                 bool& dirty) {
  const int j0 = lo + lane * per, j1 = min(j0 + per, hi);
  int bk = INT32_MIN, bi = INT32_MAX;
  bool odd = false;
  for (int j = j0; j < j1; j += 4) {
    float v[4];
    if (j + 4 <= j1) {
      *reinterpret_cast<float4*>(v) =
          *reinterpret_cast<const float4*>(cur + j);
    } else {
#pragma unroll
      for (int t = 0; t < 4; ++t) v[t] = j + t < j1 ? cur[j + t] : 0.f;
    }
#pragma unroll
    for (int t = 0; t < 4; ++t)
      if (j + t < j1) {
        const int key = sp_key(v[t]);
        if (key > bk) {
          bk = key;
          bi = j + t;
        }
        odd |= !isfinite(v[t]) && v[t] != -INFINITY;
      }
  }
  dirty = __any_sync(FULL, odd);
  return sp_warp_best(bk, bi);
}

// The wide route's lane count and scratch layout: per (a multiple of 4)
// scores a lane for at most 32 warps; a row's scores and K + 1 offsets,
// then (16-aligned) its 2P adjacency entries, the row 16-aligned.
__host__ __device__ inline int sp_wide_per(int k) {
  return ((k + 1023) / 1024 + 3) & ~3;
}
__host__ __device__ inline long long sp_wide_adj_offset(int k) {
  return (8LL * k + 4 + 15) & ~15LL;
}
__host__ __device__ inline long long sp_wide_row_bytes(int k, long long p) {
  return (sp_wide_adj_offset(k) + 12 * p + 15) & ~15LL;
}

// PER 1, 2 or 4 (K up to NMS_MAX_K; the adjacency in shared memory with
// SMEM_ADJ, else in the scratch), or 0: the wide route (everything in the
// scratch, SMEM_ADJ false)
template <int PER, bool SMEM_ADJ>
__global__ void __launch_bounds__(1024)
    soft_nms_decay_pairs_kernel(const long long* __restrict__ plist,
                                const uint8_t* __restrict__ ok,
                                const float* __restrict__ iou,
                                const float* __restrict__ scores,
                                long long* __restrict__ picks,
                                float* __restrict__ pick_scores,
                                unsigned char* __restrict__ scratch, int k,
                                int p, int m, int gaussian, float sigma,
                                float thr) {
  extern __shared__ __align__(16) unsigned char sp_smem[];
  __shared__ int2 slot[2][SP_MAX_WARPS];
  __shared__ int warp_sum[SP_MAX_WARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nt = blockDim.x, nwarps = nt >> 5;
  const long long row = blockIdx.x;
  constexpr bool WIDE = PER == 0;
  const int per = WIDE ? sp_wide_per(k) : PER;
  unsigned char* wrow = scratch + (WIDE ? row * sp_wide_row_bytes(k, p) : 0);
  float* cur = reinterpret_cast<float*>(WIDE ? wrow : sp_smem);
  int* beg = reinterpret_cast<int*>(cur + k);
  // an entry: the neighbour, and the decay its pair's value gives
  float* dec = WIDE ? reinterpret_cast<float*>(wrow + sp_wide_adj_offset(k))
               : SMEM_ADJ ? reinterpret_cast<float*>(beg + k + 1)
                          : reinterpret_cast<float*>(scratch + row * 12LL * p);
  uint16_t* nbr = reinterpret_cast<uint16_t*>(dec + 2LL * p);
  plist += row * p;
  ok += row * p;
  iou += row * p;

  // the count of each candidate's neighbours; each thread's loads of
  // SP_UNROLL slots issued together, not one dependent load at a time
  for (int j = tid; j < k; j += nt) {
    cur[j] = scores[row * k + j];
    beg[j] = 0;
  }
  __syncthreads();
  for (int q0 = tid; q0 < p; q0 += nt * SP_UNROLL) {
    bool o[SP_UNROLL];
    int pq[SP_UNROLL];
#pragma unroll
    for (int u = 0; u < SP_UNROLL; ++u) {
      const int q = q0 + u * nt;
      o[u] = q < p && ok[q];
      pq[u] = q < p ? (int)plist[q] : 0;
    }
#pragma unroll
    for (int u = 0; u < SP_UNROLL; ++u)
      if (o[u]) {
        atomicAdd(&beg[pq[u] / k], 1);
        atomicAdd(&beg[pq[u] % k], 1);
      }
  }
  __syncthreads();
  // their inclusive prefix sum in place, a run of consecutive counts a
  // thread
  const int run = (k + nt - 1) / nt;
  const int lo = min(tid * run, k), hi = min(lo + run, k);
  int sum = 0;
  for (int j = lo; j < hi; ++j) sum += beg[j];
  int incl = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(FULL, incl, off);
    if (lane >= off) incl += o;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nwarps ? warp_sum[lane] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(FULL, w, off);
      if (lane >= off) w += o;
    }
    if (lane < nwarps) warp_sum[lane] = w;
  }
  __syncthreads();
  int acc = incl - sum + (warp ? warp_sum[warp - 1] : 0);
  for (int j = lo; j < hi; ++j) {
    acc += beg[j];
    beg[j] = acc;
  }
  if (tid == 0) beg[k] = warp_sum[nwarps - 1];
  __syncthreads();
  // the fill: each slot's two entries taken from the top of the two
  // candidates' ranges, so that beg[i] ends at i's first entry; the decay
  // in the plain version's operations (expf, an IEEE division)
  for (int q0 = tid; q0 < p; q0 += nt * SP_UNROLL) {
    bool o[SP_UNROLL];
    int pq[SP_UNROLL];
    float v[SP_UNROLL];
#pragma unroll
    for (int u = 0; u < SP_UNROLL; ++u) {
      const int q = q0 + u * nt;
      o[u] = q < p && ok[q];
      pq[u] = q < p ? (int)plist[q] : 0;
      v[u] = q < p ? iou[q] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < SP_UNROLL; ++u)
      if (o[u]) {
        const int i = pq[u] / k, j = pq[u] % k;
        const float x = v[u] > 0.f ? v[u] : (v[u] != v[u] ? v[u] : 0.f);
        const float d = gaussian ? expf(-(x * x) / sigma)
                                 : (x > thr ? 1.f - x : 1.f);
        int e = atomicSub(&beg[i], 1) - 1;
        nbr[e] = (uint16_t)j;
        dec[e] = d;
        e = atomicSub(&beg[j], 1) - 1;
        nbr[e] = (uint16_t)i;
        dec[e] = d;
      }
  }

  const int w_lo = min(warp * 32 * per, k), w_hi = min(w_lo + 32 * per, k);
  bool dirty;
  auto span_max = [&]() {
    if constexpr (WIDE)
      return sp_span_max_wide(cur, w_lo, w_hi, lane, per, dirty);
    else
      return sp_span_max<PER>(cur, w_lo, w_hi, lane, dirty);
  };
  __syncthreads();
  int2 mine = span_max();
  if (lane == 0) slot[0][warp] = mine;
  int buf = 0;
  __syncthreads();
  for (int s = 0; s < m; ++s) {
    const int2 sl = lane < nwarps ? slot[buf][lane]
                                  : make_int2(INT32_MIN, INT32_MAX);
    const int b = sp_warp_best(sl.x, sl.y).y;
    const bool own = b >= w_lo && b < w_hi;
    if (own && lane == 0) {
      picks[row * m + s] = b;
      pick_scores[row * m + s] = cur[b];
    }
    const bool changed = own || dirty;
    if (dirty) {
      __syncwarp();
      for (int j = w_lo + lane; j < w_hi; j += 32)
        if (!isfinite(cur[j])) cur[j] = -INFINITY;
      __syncwarp();
    }
    const int e1 = beg[b + 1];
    bool hit = false;
    for (int e = beg[b] + lane; e < e1; e += 32) {
      const int j = nbr[e];
      const float d = dec[e];
      if (j >= w_lo && j < w_hi) {
        const float c = cur[j];
        cur[j] = isfinite(c) ? c * d : -INFINITY;
        hit = true;
      }
    }
    if (own && lane == 0) cur[b] = -INFINITY;
    if (__any_sync(FULL, hit) || changed) {
      __syncwarp();
      mine = span_max();
    }
    buf ^= 1;
    if (lane == 0) slot[buf][warp] = mine;
    __syncthreads();
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

// Bytes of device scratch `nms_overlap` takes: 0 up to NMS_MAX_K
// candidates, else (the wide route) a standup envelope (float4) and an area
// a box, then each example's K + 1 row starts.
extern "C" long long nms_overlap_scratch(int batch, int k) {
  return k > NMS_MAX_K ? 20LL * batch * k + 4LL * batch * (k + 1LL) : 0;
}

// The wide route of nms_overlap past NMS_MAX_K candidates (up to
// NMS_ROTATED_MAX_K), whatever the cluster: its prep, bound, scan and clip
// kernels.
static int nms_overlap_wide(const void* cand, const void* valid, void* over,
                            void* maybe, void* count, void* scratch,
                            int batch, int k, float thr, int cap,
                            void* stream) {
  if ((long long)batch * ((k + NMS_WARPS - 1) / NMS_WARPS) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long n = (long long)batch * k;
  float4* env = static_cast<float4*>(scratch);
  float* area = reinterpret_cast<float*>(env + n);
  int* start = reinterpret_cast<int*>(area + n);
  nms_wide_prep_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(cand), env, area, n);
  nms_wide_bound_kernel<<<(unsigned)(batch * ((k + NMS_WARPS - 1) /
                                              NMS_WARPS)),
                          NMS_THREADS, 0, st>>>(
      env, area, static_cast<const uint8_t*>(valid),
      static_cast<uint32_t*>(maybe), start, k, thr);
  nms_wide_scan_kernel<<<(unsigned)batch, NMS_THREADS, 0, st>>>(
      start, static_cast<int*>(count), k);
  nms_wide_clip_kernel<<<(unsigned)((n * 32 + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(cand), static_cast<const uint32_t*>(maybe),
      start, static_cast<uint32_t*>(over), batch, k, thr, cap);
  return (int)cudaGetLastError();
}

// cand [B, K, 5] fp32, valid [B, K] bytes; writes over [B, K, W] and uses
// maybe [B, K, W] (words, W = ceil(K / 32)) as scratch, count [B] int32.
// cap: the pairs clipped, first in row-major order; cluster: blocks an
// example (1, 2, 4, 8 or 16) up to NMS_MAX_K candidates; past it (up to
// NMS_ROTATED_MAX_K) the wide route, whatever the cluster. scratch holds
// nms_overlap_scratch(batch, k) bytes (null where that is 0).
extern "C" int nms_overlap(const void* cand, const void* valid, void* over,
                           void* maybe, void* count, void* scratch,
                           int batch, int k, float thr, int cap, int cluster,
                           void* stream) {
  if (batch == 0 || k == 0) return 0;
  if (batch < 0 || k < 0 || k > NMS_ROTATED_MAX_K || cap < 0 ||
      cluster < 1 || cluster > NMS_MAX_CLUSTER || (cluster & (cluster - 1)))
    return (int)cudaErrorInvalidValue;
  if (k > NMS_MAX_K) {
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    return nms_overlap_wide(cand, valid, over, maybe, count, scratch, batch,
                            k, thr, cap, stream);
  }
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

// Whether nms_suppress stages a bitmask of K rows in shared memory (1) or
// reads it in place (0): its rows padded to W + 1 words fit SUP_SMEM.
extern "C" int nms_suppress_staged(int k) {
  return (size_t)k * (((k + 31) >> 5) + 1) * 4 <= (size_t)SUP_SMEM;
}

// over [B, K, W] words, valid [B, K] bytes → keep [B, K] bytes (0 / 1);
// past NMS_MAX_K candidates the wide kernel (its removed mask of W words
// in shared memory: K up to 32 * SUP_SMEM / 4).
extern "C" int nms_suppress(const void* over, const void* valid, void* keep,
                            int batch, int k, void* stream) {
  if (batch == 0 || k == 0) return 0;
  const int W = (k + 31) >> 5;
  if (batch < 0 || k < 0 || (size_t)W * 4 > (size_t)SUP_SMEM)
    return (int)cudaErrorInvalidValue;
  static bool sized = false;
  if (!sized) {
    cudaError_t e = cudaFuncSetAttribute(
        nms_suppress_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SUP_SMEM);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(nms_suppress_wide_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SUP_SMEM);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  if (k > NMS_MAX_K) {
    nms_suppress_wide_kernel<<<(unsigned)batch, SUP_THREADS, (size_t)W * 4,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(over),
        static_cast<const uint8_t*>(valid), static_cast<uint8_t*>(keep), k);
    return (int)cudaGetLastError();
  }
  const int staged = nms_suppress_staged(k);
  nms_suppress_kernel<<<(unsigned)batch, SUP_THREADS,
                        staged ? (size_t)k * (((k + 31) >> 5) + 1) * 4 : 0,
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
  const int rows = (k + SU_ROWS - 1) / SU_ROWS;
  const int words = (((k + 31) >> 5) + SU_WORDS - 1) / SU_WORDS;
  long long live_tiles = 0;
  for (int tx = 0; tx < words; ++tx) live_tiles += su_live_rows(tx, k);
  const long long blocks = batch * (live_tiles + rows);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_double)
    standup_overlap_kernel<double><<<(unsigned)blocks, SU_THREADS, 0, st>>>(
        static_cast<const double*>(cand), static_cast<const uint8_t*>(valid),
        static_cast<uint32_t*>(over), batch, k, (int)live_tiles, thr);
  else
    standup_overlap_kernel<float><<<(unsigned)blocks, SU_THREADS, 0, st>>>(
        static_cast<const float*>(cand), static_cast<const uint8_t*>(valid),
        static_cast<uint32_t*>(over), batch, k, (int)live_tiles,
        (float)thr);
  return (int)cudaGetLastError();
}

// Bytes of device scratch a row of `soft_nms_decay_standup` needs: 0 up
// to NMS_MAX_K candidates, else its K current scores (the wide kernel).
extern "C" long long soft_nms_standup_scratch(int k) {
  return k > NMS_MAX_K ? 4LL * k : 0;
}

// cand [R, K, 4] xyxy fp32, scores [R, K] fp32 (each row sorted by
// descending score; -inf an invalid candidate) → picks [R, m] int64 and
// their scores [R, m] fp32, the decay steps over the candidates' standup
// IoU matrix, computed a row a step; scratch holds R *
// soft_nms_standup_scratch(K) bytes (null where that is 0).
extern "C" int soft_nms_decay_standup(const void* cand, const void* scores,
                                      void* picks, void* pick_scores,
                                      void* scratch, int rows, int k, int m,
                                      int gaussian, float sigma, float thr,
                                      void* stream) {
  if (rows < 0 || k < 0 || m < 0 || m > k)
    return (int)cudaErrorInvalidValue;
  if (rows == 0 || k == 0 || m == 0) return 0;
  if (k > NMS_MAX_K) {
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    const int per = (k + 1023) / 1024;
    const int threads = ((k + per - 1) / per + 31) / 32 * 32;
    soft_nms_decay_standup_wide_kernel<<<(unsigned)rows, threads, 0,
                                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(cand), static_cast<const float*>(scores),
        static_cast<long long*>(picks), static_cast<float*>(pick_scores),
        static_cast<float*>(scratch), k, m, per, gaussian, sigma, thr);
    return (int)cudaGetLastError();
  }
  using Kernel = void (*)(const float4*, const float*, long long*, float*,
                          int, int, int, float, float);
  // [scores a lane: 1, 2, 4]
  static const Kernel kernels[3] = {soft_nms_decay_standup_kernel<1>,
                                    soft_nms_decay_standup_kernel<2>,
                                    soft_nms_decay_standup_kernel<4>};
  static bool sized = false;
  if (!sized) {
    for (int i = 0; i < 3; ++i) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernels[i], cudaFuncAttributeMaxDynamicSharedMemorySize,
          NMS_MAX_K * 16);
      if (e != cudaSuccess) return (int)e;
    }
    sized = true;
  }
  // a lane per consecutive candidates, at most 32 warps
  int per = 1, log_per = 0;
  while (per < 4 && (k + 32 * per - 1) / (32 * per) > 32) {
    per *= 2;
    ++log_per;
  }
  const int warps = (k + 32 * per - 1) / (32 * per);
  kernels[log_per]<<<(unsigned)rows, warps * 32, (size_t)k * 16,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(cand), static_cast<const float*>(scores),
      static_cast<long long*>(picks), static_cast<float*>(pick_scores), k, m,
      gaussian, sigma, thr);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of the pair kernel's block: the K scores, the K + 1
// offsets and, with `adj`, the 2P adjacency entries of 6 bytes.
static size_t soft_pairs_smem(int k, long long p, bool adj) {
  return (size_t)k * 4 + (size_t)(k + 1) * 4 + (adj ? (size_t)p * 12 : 0);
}

// Bytes of global scratch a row of `soft_nms_decay_pairs` needs: 0 where
// its adjacency fits in shared memory, else its 2P entries; past
// NMS_MAX_K candidates, the wide route's row (`sp_wide_row_bytes`).
extern "C" long long soft_nms_pairs_scratch(int k, long long p) {
  if (k > NMS_MAX_K) return sp_wide_row_bytes(k, p);
  return soft_pairs_smem(k, p, true) <= (size_t)SP_SMEM ? 0 : 12 * p;
}

// plist [R, P] int64 (i * K + j, i < j), ok [R, P] bytes, iou [R, P] fp32,
// scores [R, K] fp32 (each row sorted by descending score; -inf an invalid
// candidate) → picks [R, m] int64 and their scores [R, m] fp32, the decay
// steps over the matrix the pairs make; scratch holds R *
// soft_nms_pairs_scratch(K, P) bytes (null where that is 0).
extern "C" int soft_nms_decay_pairs(const void* plist, const void* ok,
                                    const void* iou, const void* scores,
                                    void* picks, void* pick_scores,
                                    void* scratch, int rows, int k,
                                    long long p, int m, int gaussian,
                                    float sigma, float thr, void* stream) {
  if (rows < 0 || k < 0 || m < 0 || p < 0 || k > NMS_ROTATED_MAX_K ||
      m > k || p > (1LL << 28))
    return (int)cudaErrorInvalidValue;
  if (rows == 0 || k == 0 || m == 0) return 0;
  const bool staged = soft_nms_pairs_scratch(k, p) == 0;
  if (!staged && scratch == nullptr) return (int)cudaErrorInvalidValue;
  if (k > NMS_MAX_K) {
    soft_nms_decay_pairs_kernel<0, false><<<
        (unsigned)rows, (k + 32 * sp_wide_per(k) - 1) / (32 * sp_wide_per(k))
                            * 32, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const long long*>(plist),
        static_cast<const uint8_t*>(ok), static_cast<const float*>(iou),
        static_cast<const float*>(scores), static_cast<long long*>(picks),
        static_cast<float*>(pick_scores),
        static_cast<unsigned char*>(scratch), k, (int)p, m, gaussian, sigma,
        thr);
    return (int)cudaGetLastError();
  }
  using Kernel = void (*)(const long long*, const uint8_t*, const float*,
                          const float*, long long*, float*, unsigned char*,
                          int, int, int, int, float, float);
  // [scores a lane: 1, 2, 4][adjacency in shared memory]
  static const Kernel kernels[3][2] = {
      {soft_nms_decay_pairs_kernel<1, false>,
       soft_nms_decay_pairs_kernel<1, true>},
      {soft_nms_decay_pairs_kernel<2, false>,
       soft_nms_decay_pairs_kernel<2, true>},
      {soft_nms_decay_pairs_kernel<4, false>,
       soft_nms_decay_pairs_kernel<4, true>}};
  static bool sized = false;
  if (!sized) {
    for (int i = 0; i < 3; ++i) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernels[i][1], cudaFuncAttributeMaxDynamicSharedMemorySize,
          SP_SMEM);
      if (e != cudaSuccess) return (int)e;
    }
    sized = true;
  }
  // a warp a span of 32 x per scores, at most SP_MAX_WARPS warps
  int per = 1, log_per = 0;
  while (per < 4 && (k + 32 * per - 1) / (32 * per) > SP_MAX_WARPS) {
    per *= 2;
    ++log_per;
  }
  const int warps = (k + 32 * per - 1) / (32 * per);
  kernels[log_per][staged]<<<(unsigned)rows, warps * 32,
                             soft_pairs_smem(k, p, staged),
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(plist), static_cast<const uint8_t*>(ok),
      static_cast<const float*>(iou), static_cast<const float*>(scores),
      static_cast<long long*>(picks), static_cast<float*>(pick_scores),
      static_cast<unsigned char*>(scratch), k, (int)p, m, gaussian, sigma,
      thr);
  return (int)cudaGetLastError();
}

extern "C" const char* riou_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
