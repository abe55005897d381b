// Rotated ROI-align of a batch of BEV feature maps, forward and backward.
//
// Replaces: second_tpu/ops/roi_align_rotated.py `bilinear_sample` and
// `roi_align_rotated` (:21-71) as the two-stage detector runs them through
// `crop_rois` (second_tpu/models/second_stage.py:129): XLA gathers of the
// four bilinear taps of every (roi, bin, sample) point, all channels at
// once, and XLA's autodiff of them. Neither is a Pallas kernel.
//
// The sample points come in as coordinates, coords [B, N, SH, SW, 2]
// (x = column, y = row, in pixels of the map), computed by differentiable
// PyTorch from the rois (`ops/roi_align_rotated.py` `sample_points`), so
// autograd carries the coordinates' gradient back to the proposal boxes.
// The map is feat [B, C, H, W] (NCHW, the RPN trunk as it comes; bf16,
// fp32 or fp64); the output is out [B * N, C, SH / s, SW / s] in the
// coordinates' dtype (fp32 or fp64), the layout the refine head's first
// conv takes. Each bin averages its s x s samples; each sample sums its
// four taps (y0, x0), (y0, x0 + 1), (y0 + 1, x0), (y0 + 1, x0 + 1) with
// weights (1 - wx)(1 - wy), wx (1 - wy), (1 - wx) wy, wx wy, in that order,
// and a tap outside the map adds 0 * w. Whether a tap lies inside is
// decided on the floats (floor(x) against [0, W - 1]) before any integer
// conversion, so a proposal far off the map reads nothing. The file is
// built with -fmad=false, so the products and sums round as the plain
// PyTorch version's separate operations do.
//
// Bound on the H100: bytes. The forward writes 4 B (fp32) for every
// (roi, channel, bin) and reads each map pixel that some tap touches once;
// at the fhd two-stage shapes (2048 rois, 128 channels, 14 x 14 bins) the
// 205 MB output is most of it. The backward reads the crops' gradient
// (as large as the output) and writes the map's gradient, fp32, in full.
// Its work per pixel is uneven: tiny proposals pile thousands of samples
// on one pixel, so a thread that walked one pixel's samples would set the
// kernel's time by the longest pile.
//
// Forward design. A thread an output reading its 16 taps from one NCHW
// channel plane, a warp's lanes on 32 bins, issues 16 scattered 4-byte
// loads an output and is bound by load issue, not bytes. So:
//  * `roi_align_transpose_kernel` copies the map channels-last, [B, H, W,
//    ldc] (ldc: C rounded up to a whole vector), so a pixel's channels are
//    one row;
//  * `roi_align_fwd_kernel` takes a roi a block, its bins in groups. Its
//    threads turn a group's samples into taps once, one sample a thread:
//    the cell's base offset, a 4-bit inside mask and the 4 weights, in
//    shared memory. Then a warp makes a bin with its lanes on channels,
//    VEC each (a float4 of fp32, 4 bf16, a double2 of fp64): each of a
//    sample's taps is one coalesced read of a pixel's row (512 bytes at
//    C = 128 in fp32), and a sample in the same cell as the one before it
//    reads nothing. The bin's outputs go to a tile [bins of the group,
//    channels] in shared memory, written out transposed, each channel's
//    bins contiguous, so the [R, C, oh, ow] output is written coalesced.
//    Channels past 32 VEC are further slices of the same staged taps.
//    A roi's rows are read many times over, from L1 where they stay, so
//    the kernel keeps its shared memory small and asks for a carve-out
//    that leaves the rest of the SM's memory to L1.
// Each output sums its samples in order, (((v0 + v1) + v2) + v3) a
// sample, v the tap's value (0 outside) times its weight, then divides by
// s^2: the plain version's operations, bit for bit under -fmad=false.
//
// Backward design, deterministic (no floating-point atomics), and
// balanced however many samples fall on one cell. A sample's four taps are
// the corners of its cell (b, y0, x0), y0 in [-1, H - 1], x0 in [-1, W - 1]:
//  * `roi_align_keys` gives each sample its cell, or a sentinel past the
//    last cell where no tap lies inside; the caller sorts these keys with a
//    stable sort (so a cell's samples stay in ascending order, and the
//    sentinels go last), 4 times fewer keys than one a tap;
//  * `roi_align_transpose_kernel` lays the crops' gradient out as [B * N,
//    oh * ow, C], a bin's channels side by side (a tiled transpose through
//    shared memory, both sides coalesced). The walk reads a sample's row
//    of it once; read in place from the NCHW gradient instead (a lane's
//    channels 784 bytes apart), the walk took 1.36 ms where the copy and
//    the walk take 0.19 + 0.49 (scripts/torch_roi_align_bwd.py on the 2st
//    train call);
//  * `roi_align_walk_kernel` cuts the sorted samples into chunks of CHUNK,
//    one to a warp, each lane VEC channels (lane + 32 u: 4 at C = 128), so
//    a sample's own work (its key, weights, the butterfly below) is paid
//    once a warp, not once per 32 channels. Each in-map sample's gradient
//    row is read once (coalesced; PF rows in flight a lane, 4 at VEC = 4
//    and 2 at 8: with 8 at VEC = 4 the rows took so many registers that
//    one block fit an SM, and the walk ran far longer), times 1 / s^2
//    and each corner's weight, into four sums, one per corner of its
//    cell, over each run of one cell in order. (A thread a channel in 64-
//    to 256-thread groups, 4 warps a sample at C = 128, issued 4 times the
//    per-sample instructions and was slower.)
//    A run inside the chunk goes to part [cell, corner, C] and marks its
//    cell; the chunk's first and last runs (which may go on in the
//    neighbouring chunks) go to head / tail for the fix-up. The same walk
//    makes the coordinates' gradient: the run's four pixels are read once
//    at its start from the NCHW map in place (0 outside the map; a
//    channels-last copy of the map cost 0.05 ms and saved the walk only
//    0.03), each sample's channel terms
//    g / s^2 ((v01 - v00)(1 - wy) + (v11 - v10) wy) for x and
//    g / s^2 ((v10 - v00)(1 - wx) + (v11 - v01) wx) for y (floor has no
//    derivative) are summed over a lane's channels in order, then over the
//    lanes by a fixed butterfly. Sentinel samples read nothing: their
//    gradient is 0 (1 - wy) + 0 wy, 0 (1 - wx) + 0 wx;
//  * `roi_align_fixup_kernel` adds the runs that touch a chunk's edge over
//    the chunks they span, in chunk order (a pile of a thousand samples on
//    one cell costs a few chunks, not a serial walk);
//  * `roi_align_pixel_kernel` writes every element of the map's gradient:
//    pixel (y, x) sums, in this order, corner 0 of cell (y, x), corner 1 of
//    (y, x - 1), corner 2 of (y - 1, x), corner 3 of (y - 1, x - 1) where
//    those cells have samples (through shared memory: the partials read
//    channel-contiguous, the NCHW gradient written pixel-contiguous).
// The walk counts the in-map samples and the cell runs (integer atomics)
// for the wrapper to check. The map's gradient comes out fp32 (fp64 for
// fp64).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int FWD_WARPS = 8;                   // the forward's warps a block
constexpr int FWD_THREADS = 32 * FWD_WARPS;
// The forward's blocks an SM: a block is a roi, whose taps read the rows of
// a few dozen pixels (some 30 KB at C = 128 in fp32) many times over, from
// L1 where they stay. The kernel asks for a shared-memory carve-out of
// FWD_BLOCKS blocks, each staging the taps and holding the outputs of at
// most FWD_GROUP bins (the 2st crops' 196 in 7 groups of 28: 17.5 KB in
// fp32), so the rest of the SM's 256 KB stays L1.
constexpr int FWD_BLOCKS = 6;
constexpr int FWD_GROUP_MAX = 28;
constexpr size_t FWD_SMEM_LIMIT = 227 * 1024;
constexpr size_t SM_SMEM_MAX = 228 * 1024;     // the largest carve-out

__device__ __forceinline__ float load(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ float load(const float* p, long long i) {
  return __ldg(p + i);
}
__device__ __forceinline__ double load(const double* p, long long i) {
  return __ldg(p + i);
}

// The map elements a forward lane loads at once from a channels-last row:
// 16 bytes of fp32 or fp64, 8 of bf16, so a warp covers 128 channels of an
// fp32 or bf16 map and 64 of an fp64 one.
template <typename T> struct FwdVec;
template <> struct FwdVec<float> { static constexpr int n = 4; };
template <> struct FwdVec<__nv_bfloat16> { static constexpr int n = 4; };
template <> struct FwdVec<double> { static constexpr int n = 2; };

__device__ __forceinline__ void load_vec(const float* p, float v[4]) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float v[4]) {
  // bf16 → fp32 exactly: the 16 bits are the float's high half
  const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
  v[0] = __uint_as_float(q.x << 16);
  v[1] = __uint_as_float(q.x & 0xffff0000u);
  v[2] = __uint_as_float(q.y << 16);
  v[3] = __uint_as_float(q.y & 0xffff0000u);
}
__device__ __forceinline__ void load_vec(const double* p, double v[2]) {
  const double2 q = __ldg(reinterpret_cast<const double2*>(p));
  v[0] = q.x;
  v[1] = q.y;
}
// a sample's four staged weights, 16-byte aligned
__device__ __forceinline__ void load_w(const float* p, float w[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  w[0] = q.x;
  w[1] = q.y;
  w[2] = q.z;
  w[3] = q.w;
}
__device__ __forceinline__ void load_w(const double* p, double w[4]) {
  const double2 a = *reinterpret_cast<const double2*>(p);
  const double2 b = *reinterpret_cast<const double2*>(p + 2);
  w[0] = a.x;
  w[1] = a.y;
  w[2] = b.x;
  w[3] = b.y;
}
__device__ __forceinline__ void store_vec(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_vec(double* p, const double v[2]) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
}

// The cell of a sample at (x, y) and its four taps: `base`, the offset of
// tap 0 (y0, x0) in an H x W plane (y0 or x0 may be -1), taps 1-3 at base
// + 1, base + W, base + W + 1; `mask`, bit t set where tap t lies inside;
// and the taps' bilinear weights. Inside is decided on the floats before
// any integer conversion: NaN and far-off values fail every test.
template <typename S>
__device__ __forceinline__ void cell_taps(S x, S y, int H, int W, int& base,
                                          int& mask, S w[4]) {
  const S x0 = floor(x);
  const S y0 = floor(y);
  const S wx = x - x0;
  const S wy = y - y0;
  const S one = S(1);
  w[0] = (one - wx) * (one - wy);
  w[1] = wx * (one - wy);
  w[2] = (one - wx) * wy;
  w[3] = wx * wy;
  const bool xa = x0 >= S(0) && x0 <= S(W - 1);
  const bool xb = x0 >= S(-1) && x0 <= S(W - 2);
  const bool ya = y0 >= S(0) && y0 <= S(H - 1);
  const bool yb = y0 >= S(-1) && y0 <= S(H - 2);
  const int xi = (xa || xb) ? (int)x0 : 0;
  const int yi = (ya || yb) ? (int)y0 : 0;
  base = yi * W + xi;
  mask = (int)(ya && xa) | (int)(ya && xb) << 1 | (int)(yb && xa) << 2 |
         (int)(yb && xb) << 3;
}

// bytes of a forward block's staged taps for `n` samples: 4 weights each,
// then a (base, mask) pair each, rounded up to 16
__host__ __device__ inline size_t fwd_taps_bytes(int n, size_t s_bytes) {
  return ((size_t)n * (4 * s_bytes + sizeof(int2)) + 15) & ~(size_t)15;
}

// Stages the taps of bins [g0, g0 + gn) of roi coords rc: sample q of the
// group (bin g0 + q / s^2, its sample q % s^2 in row-major order) at q.
template <typename S>
__device__ __forceinline__ void stage_taps(const S* __restrict__ rc, S* sw,
                                           int2* scell, int g0, int gn,
                                           int s, int ow, int H, int W) {
  const int ss = s * s, SW = ow * s;
  for (int q = threadIdx.x; q < gn * ss; q += FWD_THREADS) {
    const int bin = g0 + q / ss, sub = q - (q / ss) * ss;
    const int i = bin / ow, j = bin - (bin / ow) * ow;
    const int p = (i * s + sub / s) * SW + j * s + sub - (sub / s) * s;
    int base, mask;
    S w[4];
    cell_taps<S>(rc[2 * p], rc[2 * p + 1], H, W, base, mask, w);
#pragma unroll
    for (int t = 0; t < 4; ++t) sw[4 * q + t] = w[t];
    scell[q] = make_int2(base, mask);
  }
}

// out[r, c, bin] of roi r from fhwc, the map channels-last [B, H, W, ldc].
// The roi's bins go in groups of `group`: the block stages a group's taps
// (while it writes out the group before), then for each slice of 32 * VEC
// channels warp w makes bins w, w + 8, ... of the group, lane l channels
// c0 + l VEC .. + VEC - 1 of each: a tap is one coalesced read of the
// pixel's row, and a sample in the cell of the sample before it reuses
// that sample's four rows. A bin's outputs go to the tile [group, ROW] in
// shared memory (ROW: the slice plus 16 bytes, so the reads below hit 32
// banks), which the block then writes out channel by channel, 8 bins by 4
// channels a warp store, warp w channels 4w .. 4w + 3, 4w + 32, ... .
template <typename T, typename S, int SS>
__global__ void __launch_bounds__(FWD_THREADS)
    roi_align_fwd_kernel(const T* __restrict__ fhwc,
                         const S* __restrict__ coords, S* __restrict__ out,
                         int C, int ldc, int H, int W, int N, int oh, int ow,
                         int s_arg, int group) {
  // SS: the samples a bin side where fixed at compile time (2, the
  // detector's: the bin's 16 tap reads unrolled), 0 where given at run time
  const int s = SS ? SS : s_arg;
  constexpr int VEC = FwdVec<T>::n;
  constexpr int SLICE = 32 * VEC;
  constexpr int ROW = SLICE + 16 / (int)sizeof(S);
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ss = s * s;
  const int bins = oh * ow;
  S* sw = reinterpret_cast<S*>(smem);
  int2* scell = reinterpret_cast<int2*>(sw + 4 * (size_t)group * ss);
  S* tile = reinterpret_cast<S*>(smem + fwd_taps_bytes(group * ss,
                                                        sizeof(S)));
  const long long r = blockIdx.x;
  const S* rc = coords + r * bins * ss * 2;
  stage_taps<S>(rc, sw, scell, 0, min(group, bins), s, ow, H, W);
  __syncthreads();
#ifdef ROI_ALIGN_FWD_STAGE_ONLY
  // a measurement build (scripts/torch_roi_align_fwd.py): the copy and
  // the staging alone
  for (int g0 = group; g0 < bins; g0 += group) {
    __syncthreads();
    stage_taps<S>(rc, sw, scell, g0, min(group, bins - g0), s, ow, H, W);
  }
  if (threadIdx.x == 0) out[r] = sw[0] + (S)scell[0].x;
  return;
#endif
  const T* f = fhwc + (long long)(r / N) * H * W * ldc;
  const S n = S(ss);
  for (int g0 = 0; g0 < bins; g0 += group) {
    const int gn = min(group, bins - g0);
    for (int c0 = 0; c0 < C; c0 += SLICE) {
      const int c = c0 + lane * VEC;
      const bool active = c < C;
      const int cs = min(SLICE, C - c0);
      for (int k = warp; k < gn; k += FWD_WARPS) {
        S acc[VEC] = {};
        S v[4][VEC];
        int2 last = make_int2(0, 0);
#pragma unroll
        for (int sub = 0; sub < (SS ? SS * SS : ss); ++sub) {
          const int q = k * ss + sub;
          const int2 cm = scell[q];
          // the cell of the sample before: its four rows again
          if (sub == 0 || cm.x != last.x || cm.y != last.y) {
#pragma unroll
            for (int t = 0; t < 4; ++t) {
              if (active && ((cm.y >> t) & 1)) {
                const long long o = cm.x + (t >> 1) * W + (t & 1);
                load_vec(f + o * ldc + c, v[t]);
              } else {
#pragma unroll
                for (int u = 0; u < VEC; ++u) v[t][u] = S(0);
              }
            }
            last = cm;
          }
          S w[4];
          load_w(sw + 4 * q, w);
#pragma unroll
          for (int u = 0; u < VEC; ++u) {
            const S val = ((v[0][u] * w[0] + v[1][u] * w[1]) +
                           v[2][u] * w[2]) + v[3][u] * w[3];
            acc[u] = sub == 0 ? val : acc[u] + val;
          }
        }
#pragma unroll
        for (int u = 0; u < VEC; ++u) acc[u] = acc[u] / n;
        store_vec(tile + k * ROW + lane * VEC, acc);
      }
      __syncthreads();
      for (int cc = 4 * warp + (lane >> 3); cc - (lane >> 3) < cs;
           cc += 4 * FWD_WARPS) {
        S* dst = out + (r * C + c0 + cc) * bins + g0;
        for (int k = lane & 7; k - (lane & 7) < gn; k += 8)
          if (cc < cs && k < gn) dst[k] = tile[k * ROW + cc];
      }
      // the next group's taps, while the tile goes out
      if (c0 + SLICE >= C && g0 + group < bins)
        stage_taps<S>(rc, sw, scell, g0 + group,
                      min(group, bins - g0 - group), s, ow, H, W);
      __syncthreads();
    }
  }
}

// ------------------------------------------------------------- backward

constexpr int CHUNK = 128;            // sorted samples a walk group takes
constexpr int PF = 8;                 // gradient rows a walk thread prefetches

// keys[q] of sample q = (b * N + roi) * nsamp + p: its cell, (b * (H + 1)
// + y0 + 1) * (W + 1) + x0 + 1, or `ncells` (B * (H + 1) * (W + 1)) where
// none of its taps lies inside.
template <typename S>
__global__ void roi_align_keys_kernel(const S* __restrict__ coords,
                                      int* __restrict__ keys, long long n,
                                      int nsamp, int N, int H, int W,
                                      int ncells) {
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= n) return;
  const S x0 = floor(coords[2 * q]);
  const S y0 = floor(coords[2 * q + 1]);
  // the bounds on the floats: NaN and far-off values fail every test
  const bool inside = x0 >= S(-1) && x0 <= S(W - 1) && y0 >= S(-1) &&
                      y0 <= S(H - 1);
  const int b = (int)(q / nsamp / N);
  keys[q] = inside ? (b * (H + 1) + (int)y0 + 1) * (W + 1) + (int)x0 + 1
                   : ncells;
}

// dst [R, L, ldc] = src [R, C, L] transposed (channels C .. ldc - 1 of
// dst left as they are), 32 x 32 tiles through shared memory (both sides
// coalesced): the crops' gradient with a bin's channels side by side, and
// the map channels-last for the forward.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    roi_align_transpose_kernel(const T* __restrict__ src, T* __restrict__ dst,
                               int C, int L, int ldc) {
  __shared__ T tile[32][33];
  const long long r = blockIdx.x;
  const int c0 = blockIdx.y * 32, l0 = blockIdx.z * 32;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const T* in = src + r * C * L;
  for (int i = ty; i < 32; i += THREADS / 32) {
    const int c = c0 + i, l = l0 + tx;
    if (c < C && l < L) tile[i][tx] = in[(long long)c * L + l];
  }
  __syncthreads();
  T* out = dst + r * L * ldc;
  for (int i = ty; i < 32; i += THREADS / 32) {
    const int l = l0 + i, c = c0 + tx;
    if (l < L && c < C) out[(long long)l * ldc + c] = tile[tx][i];
  }
}

template <typename T>
void transpose(const T* src, T* dst, long long R, int C, int L, int ldc,
               cudaStream_t stream) {
  roi_align_transpose_kernel<T>
      <<<dim3((unsigned)R, (C + 31) / 32, (L + 31) / 32), THREADS, 0,
         stream>>>(src, dst, C, L, ldc);
}

// The walk: chunk e of the sorted samples to warp e % GROUPS of block
// e / GROUPS; lane l holds channels c0 + l + 32 u, u < VEC, of each slice
// of 32 VEC channels. sorted / perm: the keys in ascending order and their
// sample indices; gt: the crops' gradient as [R, bins, C]; feat: the map,
// [B, C, H, W]; part [ncells, 4, C] and flags [ncells]
// (zeroed; counts[0], counts[1]: in-map samples and runs): the runs inside
// a chunk; head / tail [chunks, 4, C] and head_key / tail_key [chunks]
// (-1: none; a chunk of one run has no tail): the chunk's first and last
// runs.
template <typename T, typename S, int VEC>
__global__ void __launch_bounds__(THREADS)
    roi_align_walk_kernel(const int* __restrict__ sorted,
                          const long long* __restrict__ perm,
                          const S* __restrict__ coords,
                          const S* __restrict__ gt, const T* __restrict__ feat,
                          S* __restrict__ part, int* __restrict__ flags,
                          int* __restrict__ counts, S* __restrict__ head,
                          S* __restrict__ tail, int* __restrict__ head_key,
                          int* __restrict__ tail_key,
                          S* __restrict__ grad_coords, long long n, int C,
                          int H, int W, int oh, int ow, int s, int ncells) {
  constexpr int GROUPS = THREADS / 32;          // a warp a chunk
  // rows in flight a lane: as many as the registers hold
  constexpr int PFV = VEC > 4 ? 2 : VEC > 2 ? 4 : PF;
  __shared__ int skey[GROUPS][CHUNK];
  __shared__ S swx[GROUPS][CHUNK];
  __shared__ S swy[GROUPS][CHUNK];
  __shared__ long long sgoff[GROUPS][CHUNK];
  __shared__ S sdx[GROUPS][CHUNK];
  __shared__ S sdy[GROUPS][CHUNK];
  const int grp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long chunk = (long long)blockIdx.x * GROUPS + grp;
  const long long e0 = chunk * CHUNK;
  if (e0 >= n) return;
  const int len = (int)min((long long)CHUNK, n - e0);
  const int SW = ow * s;
  const int nsamp = oh * s * SW;
  const int bins = oh * ow;
  const S one = S(1), zero = S(0), rns = one / S(s * s);
  int runs = 0;
  for (int i = lane; i < len; i += 32) {
    const int k = sorted[e0 + i];
    const long long q = perm[e0 + i];
    const S x = coords[2 * q];
    const S y = coords[2 * q + 1];
    const S wx = x - floor(x);
    const S wy = y - floor(y);
    skey[grp][i] = k;
    swx[grp][i] = wx;
    swy[grp][i] = wy;
    const long long r = q / nsamp;
    const int p = (int)(q - r * nsamp);
    const int row = p / SW;
    const int bin = (row / s) * ow + (p - row * SW) / s;
    sgoff[grp][i] = (r * bins + bin) * C;
    if (k >= ncells) {
      grad_coords[2 * q] = zero * (one - wy) + zero * wy;
      grad_coords[2 * q + 1] = zero * (one - wx) + zero * wx;
    } else if (i > 0 ? sorted[e0 + i - 1] != k
                     : (e0 == 0 || sorted[e0 - 1] != k)) {
      ++runs;
    }
  }
  runs = __reduce_add_sync(0xffffffffu, runs);
  __syncwarp();
  int m = len;
  if (lane == 0) {
    int lo = 0, hi = len;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (skey[grp][mid] < ncells) lo = mid + 1; else hi = mid;
    }
    m = lo;
    head_key[chunk] = m ? skey[grp][0] : -1;
    tail_key[chunk] =
        m && skey[grp][m - 1] != skey[grp][0] ? skey[grp][m - 1] : -1;
    if (m) atomicAdd(counts, m);
    if (runs) atomicAdd(counts + 1, runs);
  }
  m = __shfl_sync(0xffffffffu, m, 0);
  const int cells_b = (H + 1) * (W + 1);
  const long long plane = (long long)H * W;
  for (int c0 = 0; c0 < C; c0 += 32 * VEC) {
    S gb[PFV][VEC];
#pragma unroll
    for (int j = 0; j < PFV; ++j)
#pragma unroll
      for (int u = 0; u < VEC; ++u) {
        const int c = c0 + lane + 32 * u;
        gb[j][u] = (c < C && j < m) ? gt[sgoff[grp][j] + c] : zero;
      }
    S acc[4][VEC], v[4][VEC];
    int start = 0;
    for (int i0 = 0; i0 < m; i0 += PFV) {
#pragma unroll
      for (int j = 0; j < PFV; ++j) {
        const int i = i0 + j;
        if (i >= m) break;
        S g[VEC];
        const int nx = i + PFV;
#pragma unroll
        for (int u = 0; u < VEC; ++u) {
          const int c = c0 + lane + 32 * u;
          g[u] = gb[j][u];
          gb[j][u] = (c < C && nx < m) ? gt[sgoff[grp][nx] + c] : zero;
        }
        const int k = skey[grp][i];
        if (i == start) {
          const int b = k / cells_b;
          const int yc = (k - b * cells_b) / (W + 1);
          const int xc = k - b * cells_b - yc * (W + 1);
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const int y = yc - 1 + (t >> 1), x = xc - 1 + (t & 1);
            const bool in = y >= 0 && y < H && x >= 0 && x < W;
            const long long px = (long long)b * C * plane + y * W + x;
#pragma unroll
            for (int u = 0; u < VEC; ++u) {
              const int c = c0 + lane + 32 * u;
              v[t][u] = (in && c < C) ? (S)load(feat, px + c * plane) : zero;
              acc[t][u] = zero;
            }
          }
        }
        const S wx = swx[grp][i], wy = swy[grp][i];
        const S w0 = (one - wx) * (one - wy), w1 = wx * (one - wy);
        const S w2 = (one - wx) * wy, w3 = wx * wy;
        S dx = zero, dy = zero;
#pragma unroll
        for (int u = 0; u < VEC; ++u) {
          const S gc = g[u] * rns;
          acc[0][u] = acc[0][u] + gc * w0;
          acc[1][u] = acc[1][u] + gc * w1;
          acc[2][u] = acc[2][u] + gc * w2;
          acc[3][u] = acc[3][u] + gc * w3;
          dx = dx + gc * ((v[1][u] - v[0][u]) * (one - wy) +
                          (v[3][u] - v[2][u]) * wy);
          dy = dy + gc * ((v[2][u] - v[0][u]) * (one - wx) +
                          (v[3][u] - v[1][u]) * wx);
        }
#pragma unroll
        for (int o = 16; o; o >>= 1) {
          dx = dx + __shfl_xor_sync(0xffffffffu, dx, o);
          dy = dy + __shfl_xor_sync(0xffffffffu, dy, o);
        }
        if (lane == 0) {
          sdx[grp][i] = c0 == 0 ? dx : sdx[grp][i] + dx;
          sdy[grp][i] = c0 == 0 ? dy : sdy[grp][i] + dy;
        }
        if (i == m - 1 || skey[grp][i + 1] != k) {
          S* dst = start == 0   ? head + chunk * 4 * C
                   : i == m - 1 ? tail + chunk * 4 * C
                                : part + (long long)k * 4 * C;
#pragma unroll
          for (int u = 0; u < VEC; ++u) {
            const int c = c0 + lane + 32 * u;
            if (c < C) {
#pragma unroll
              for (int t = 0; t < 4; ++t) dst[t * C + c] = acc[t][u];
            }
          }
          if (start != 0 && i != m - 1 && lane == 0 && c0 == 0) flags[k] = 1;
          start = i + 1;
        }
      }
    }
  }
  __syncwarp();
  for (int i = lane; i < m; i += 32) {
    const long long q = perm[e0 + i];
    grad_coords[2 * q] = sdx[grp][i];
    grad_coords[2 * q + 1] = sdy[grp][i];
  }
}

// The runs that touch a chunk's edge: one thread a (chunk, corner x
// channel) sums, in chunk order, each run that starts in its chunk (as the
// chunk's tail, or as its head where the chunk before ends with another
// cell) over the chunks it goes on into, writes it to part and marks its
// cell. C4 = 4 C.
template <typename S>
__global__ void roi_align_fixup_kernel(const S* __restrict__ head,
                                       const S* __restrict__ tail,
                                       const int* __restrict__ head_key,
                                       const int* __restrict__ tail_key,
                                       S* __restrict__ part,
                                       int* __restrict__ flags,
                                       long long chunks, int C4) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= chunks * C4) return;
  const long long k = idx / C4;
  const int j = (int)(idx - k * C4);
  for (int side = 0; side < 2; ++side) {
    int key;
    S acc;
    if (side == 0) {
      key = head_key[k];
      if (key < 0) continue;
      if (k > 0) {
        const int before = tail_key[k - 1] >= 0 ? tail_key[k - 1]
                                                : head_key[k - 1];
        if (before == key) continue;   // a run begun in an earlier chunk
      }
      acc = head[k * C4 + j];
      if (tail_key[k] >= 0) {          // it ended inside chunk k
        part[(long long)key * C4 + j] = acc;
        if (j == 0) flags[key] = 1;
        continue;
      }
    } else {
      key = tail_key[k];
      if (key < 0) continue;
      acc = tail[k * C4 + j];
    }
    for (long long jj = k + 1; jj < chunks && head_key[jj] == key; ++jj) {
      acc = acc + head[jj * C4 + j];
      if (tail_key[jj] >= 0) break;    // the run ended inside chunk jj
    }
    part[(long long)key * C4 + j] = acc;
    if (j == 0) flags[key] = 1;
  }
}

// grad_feat [B, C, H, W]: every element, from the partials of the (up to)
// four cells whose corner the pixel is, in a fixed order. A block makes 32
// pixels of one row by 32 channels.
template <typename S>
__global__ void __launch_bounds__(THREADS)
    roi_align_pixel_kernel(const S* __restrict__ part,
                           const int* __restrict__ flags,
                           S* __restrict__ grad_feat, int C, int H, int W) {
  __shared__ S tile[32][33];
  const int x0 = blockIdx.x * 32, y = blockIdx.y;
  const int ctiles = (C + 31) / 32;
  const int b = blockIdx.z / ctiles, c0 = (blockIdx.z - b * ctiles) * 32;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int Wc = W + 1;
  const long long base = (long long)b * (H + 1) * Wc;
  for (int i = ty; i < 32; i += THREADS / 32) {
    const int x = x0 + i, c = c0 + tx;
    S v = S(0);
    if (x < W && c < C) {
      const long long cell[4] = {base + (y + 1) * Wc + x + 1,
                                 base + (y + 1) * Wc + x,
                                 base + y * Wc + x + 1, base + y * Wc + x};
#pragma unroll
      for (int t = 0; t < 4; ++t)
        if (flags[cell[t]]) v = v + part[(cell[t] * 4 + t) * C + c];
    }
    tile[i][tx] = v;
  }
  __syncthreads();
  for (int j = ty; j < 32; j += THREADS / 32) {
    const int c = c0 + j, x = x0 + tx;
    if (c < C && x < W)
      grad_feat[(((long long)b * C + c) * H + y) * W + x] = tile[tx][j];
  }
}

// the channels-last map's row stride: C rounded up to a whole load
template <typename T>
int fwd_ldc(int C) {
  constexpr int VEC = FwdVec<T>::n;
  return (C + VEC - 1) / VEC * VEC;
}

// The forward: the map copied channels-last into fhwc [B, H, W, ldc], then
// a block a roi, its bins in balanced groups of at most FWD_GROUP_MAX.
template <typename T, typename S, int SS>
cudaError_t launch_crops(const T* f, const S* coords, S* out, int B, int C,
                         int ldc, int H, int W, int N, int oh, int ow, int s,
                         cudaStream_t stream) {
  constexpr int ROW = 32 * FwdVec<T>::n + 16 / (int)sizeof(S);
  const int bins = oh * ow;
  // a bin's staged taps and its tile row
  const size_t per_bin = fwd_taps_bytes(s * s, sizeof(S)) + ROW * sizeof(S);
  if (per_bin > FWD_SMEM_LIMIT) return cudaErrorInvalidValue;
  int most = (int)(FWD_SMEM_LIMIT / per_bin);
  most = most < FWD_GROUP_MAX ? most : FWD_GROUP_MAX;
  most = most < bins ? most : bins;
  const int groups = (bins + most - 1) / most;
  const int group = (bins + groups - 1) / groups;
  const size_t smem = fwd_taps_bytes(group * s * s, sizeof(S)) +
                      group * ROW * sizeof(S);
  // the carve-out for FWD_BLOCKS blocks (each also reserves 1 KB), as a
  // share of the largest
  const size_t want = FWD_BLOCKS * (smem + 1024);
  const int carveout =
      want >= SM_SMEM_MAX ? 100 : (int)((want * 100 + SM_SMEM_MAX - 1) /
                                        SM_SMEM_MAX);
  auto kernel = roi_align_fwd_kernel<T, S, SS>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)FWD_SMEM_LIMIT);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout, carveout);
  if (e != cudaSuccess) return e;
  kernel<<<(unsigned)((long long)B * N), FWD_THREADS, smem, stream>>>(
      f, coords, out, C, ldc, H, W, N, oh, ow, s, group);
  return cudaGetLastError();
}

template <typename T, typename S>
cudaError_t launch_fwd(const void* feat, const void* coords, void* fhwc,
                       void* out, int B, int C, int H, int W, int N, int oh,
                       int ow, int s, cudaStream_t stream) {
  if (((long long)H * W + 31) / 32 > 65535) return cudaErrorInvalidValue;
  const int ldc = fwd_ldc<T>(C);
  T* f = static_cast<T*>(fhwc);
  transpose<T>(static_cast<const T*>(feat), f, B, C, H * W, ldc, stream);
  const S* co = static_cast<const S*>(coords);
  S* o = static_cast<S*>(out);
  return s == 2 ? launch_crops<T, S, 2>(f, co, o, B, C, ldc, H, W, N, oh, ow,
                                        s, stream)
                : launch_crops<T, S, 0>(f, co, o, B, C, ldc, H, W, N, oh, ow,
                                        s, stream);
}

template <typename T, typename S, int VEC>
void launch_walk(const int* sorted, const long long* perm, const S* coords,
                 const S* gt, const T* feat, S* part, int* flags, S* head,
                 S* tail, int* head_key, int* tail_key, S* grad_coords,
                 long long n, long long chunks, int C, int H, int W, int oh,
                 int ow, int s, int ncells, cudaStream_t stream) {
  constexpr int GROUPS = THREADS / 32;
  roi_align_walk_kernel<T, S, VEC>
      <<<(unsigned)((chunks + GROUPS - 1) / GROUPS), THREADS, 0, stream>>>(
          sorted, perm, coords, gt, feat, part, flags, flags + ncells, head,
          tail, head_key, tail_key, grad_coords, n, C, H, W, oh, ow, s,
          ncells);
}

template <typename T, typename S>
cudaError_t launch_bwd(const void* feat, const void* coords, const void* grad,
                       const void* sorted, const void* perm, void* gt,
                       void* part, void* flags, void* head,
                       void* keys, void* grad_feat, void* grad_coords, int B,
                       int C, int H, int W, int N, int oh, int ow, int s,
                       cudaStream_t stream) {
  const long long R = (long long)B * N;
  const long long n = R * oh * s * ow * s;
  const long long chunks = (n + CHUNK - 1) / CHUNK;
  const int ncells = B * (H + 1) * (W + 1);
  S* g = static_cast<S*>(gt);
  const T* f = static_cast<const T*>(feat);
  S* pt = static_cast<S*>(part);
  S* hd = static_cast<S*>(head);
  S* tl = hd + chunks * 4 * C;
  int* fl = static_cast<int*>(flags);
  int* head_key = static_cast<int*>(keys);
  int* tail_key = head_key + chunks;
  transpose<S>(static_cast<const S*>(grad), g, R, C, oh * ow, C, stream);
  const int* so = static_cast<const int*>(sorted);
  const long long* pm = static_cast<const long long*>(perm);
  const S* co = static_cast<const S*>(coords);
  S* gc = static_cast<S*>(grad_coords);
  // channels a lane holds: C up to 32, 64, 128, or slices of 256
  if (C <= 32)
    launch_walk<T, S, 1>(so, pm, co, g, f, pt, fl, hd, tl, head_key,
                         tail_key, gc, n, chunks, C, H, W, oh, ow, s,
                         ncells, stream);
  else if (C <= 64)
    launch_walk<T, S, 2>(so, pm, co, g, f, pt, fl, hd, tl, head_key,
                         tail_key, gc, n, chunks, C, H, W, oh, ow, s,
                         ncells, stream);
  else if (C <= 128)
    launch_walk<T, S, 4>(so, pm, co, g, f, pt, fl, hd, tl, head_key,
                         tail_key, gc, n, chunks, C, H, W, oh, ow, s,
                         ncells, stream);
  else
    launch_walk<T, S, 8>(so, pm, co, g, f, pt, fl, hd, tl, head_key,
                         tail_key, gc, n, chunks, C, H, W, oh, ow, s,
                         ncells, stream);
  roi_align_fixup_kernel<S>
      <<<(unsigned)((chunks * 4 * C + THREADS - 1) / THREADS), THREADS, 0,
         stream>>>(hd, tl, head_key, tail_key, pt, fl, chunks, 4 * C);
  roi_align_pixel_kernel<S>
      <<<dim3((W + 31) / 32, H, B * ((C + 31) / 32)), THREADS, 0, stream>>>(
          pt, fl, static_cast<S*>(grad_feat), C, H, W);
  return cudaGetLastError();
}

bool shapes_ok(int B, int C, int H, int W, int N, int oh, int ow, int s) {
  if (B <= 0 || C <= 0 || H <= 0 || W <= 0 || N <= 0 || oh <= 0 || ow <= 0 ||
      s <= 0)
    return false;
  const long long taps = 4LL * B * N * oh * s * ow * s;
  return taps < (1LL << 31) &&
         (long long)B * (H + 1) * (W + 1) < (1LL << 31) &&
         (long long)B * N < (1LL << 31);
}

}  // namespace

// feat_type: 0 bf16 map with fp32 coordinates, 1 fp32 with fp32, 2 fp64
// with fp64. The row stride of the forward's channels-last copy of a map
// of C channels (its scratch takes B * H * W * ldc map elements).
extern "C" int roi_align_fwd_ldc(int feat_type, int C) {
  switch (feat_type) {
    case 0: return fwd_ldc<__nv_bfloat16>(C);
    case 1: return fwd_ldc<float>(C);
    case 2: return fwd_ldc<double>(C);
  }
  return -1;
}

// feat [B, C, H, W], coords [B, N, oh * s, ow * s, 2], fhwc scratch (see
// roi_align_fwd_ldc) → out [B * N, C, oh, ow] in the coordinates' dtype.
extern "C" int roi_align_fwd(const void* feat, const void* coords,
                             void* fhwc, void* out, int feat_type, int B,
                             int C, int H, int W, int N, int oh, int ow,
                             int s, void* stream) {
  if (!shapes_ok(B, C, H, W, N, oh, ow, s)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (feat_type) {
    case 0:
      return (int)launch_fwd<__nv_bfloat16, float>(feat, coords, fhwc, out, B,
                                                   C, H, W, N, oh, ow, s, st);
    case 1:
      return (int)launch_fwd<float, float>(feat, coords, fhwc, out, B, C, H,
                                           W, N, oh, ow, s, st);
    case 2:
      return (int)launch_fwd<double, double>(feat, coords, fhwc, out, B, C, H,
                                             W, N, oh, ow, s, st);
  }
  return (int)cudaErrorInvalidValue;
}

// keys [B * N * oh * s * ow * s] int32, the cell of each sample (or the
// sentinel B * (H + 1) * (W + 1)), from the coordinates (fp32, or fp64 with
// coord_double).
extern "C" int roi_align_keys(const void* coords, void* keys, int coord_double,
                              int B, int H, int W, int N, int oh, int ow,
                              int s, void* stream) {
  if (!shapes_ok(B, 1, H, W, N, oh, ow, s)) return (int)cudaErrorInvalidValue;
  const int nsamp = oh * s * ow * s;
  const long long n = (long long)B * N * nsamp;
  const int ncells = B * (H + 1) * (W + 1);
  const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (coord_double)
    roi_align_keys_kernel<double><<<blocks, THREADS, 0, st>>>(
        static_cast<const double*>(coords), static_cast<int*>(keys), n, nsamp,
        N, H, W, ncells);
  else
    roi_align_keys_kernel<float><<<blocks, THREADS, 0, st>>>(
        static_cast<const float*>(coords), static_cast<int*>(keys), n, nsamp,
        N, H, W, ncells);
  return (int)cudaGetLastError();
}

// The chunks of the sorted samples a backward takes, CHUNK samples each:
// head takes [2, chunks, 4, C] of the coordinates' dtype (heads, then
// tails), keys 2 * chunks int32.
extern "C" long long roi_align_chunks(long long samples) {
  return (samples + CHUNK - 1) / CHUNK;
}

// sorted: the sample keys in ascending order, perm (int64) their sample
// indices, ties in ascending order; grad: the crops' gradient [B * N, C,
// oh, ow] in the coordinates' dtype; scratch: gt [B * N, oh * ow, C] and
// part [B * (H + 1) * (W + 1), 4, C] of that dtype, flags [B * (H + 1) *
// (W + 1) + 2] int32 zeroed (its last two: the in-map samples and the cell
// runs, counted), head and keys (`roi_align_chunks`). grad_feat [B, C, H,
// W] (every element written) and grad_coords [B, N, oh * s, ow * s, 2], in
// the coordinates' dtype.
extern "C" int roi_align_bwd(const void* feat, const void* coords,
                             const void* grad, const void* sorted,
                             const void* perm, void* gt, void* part,
                             void* flags, void* head, void* keys,
                             void* grad_feat, void* grad_coords, int feat_type,
                             int B, int C, int H, int W, int N, int oh, int ow,
                             int s, void* stream) {
  if (!shapes_ok(B, C, H, W, N, oh, ow, s)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (feat_type) {
    case 0:
      return (int)launch_bwd<__nv_bfloat16, float>(
          feat, coords, grad, sorted, perm, gt, part, flags, head,
          keys, grad_feat, grad_coords, B, C, H, W, N, oh, ow, s, st);
    case 1:
      return (int)launch_bwd<float, float>(
          feat, coords, grad, sorted, perm, gt, part, flags, head,
          keys, grad_feat, grad_coords, B, C, H, W, N, oh, ow, s, st);
    case 2:
      return (int)launch_bwd<double, double>(
          feat, coords, grad, sorted, perm, gt, part, flags, head,
          keys, grad_feat, grad_coords, B, C, H, W, N, oh, ow, s, st);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* roi_align_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
