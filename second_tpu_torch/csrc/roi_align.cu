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
// Forward design: one block per (roi, 32-channel chunk). The block first
// turns the roi's SH * SW sample points into four tap offsets (-1 outside)
// and four weights each, in shared memory; then each thread makes outputs
// with the bin index fastest, so a warp reads 32 nearby sample windows of
// one channel plane (a proposal covers a few dozen pixels, so those reads
// hit the same lines) and writes 32 consecutive floats of the output. The
// map is read as NCHW, in place: no channels-last copy is made.
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
constexpr int CHANNELS = 32;          // channels a forward block makes
constexpr int SMEM_MAX = 48 * 1024;   // the forward's staged sample taps

__device__ __forceinline__ float load(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ float load(const float* p, long long i) {
  return __ldg(p + i);
}
__device__ __forceinline__ double load(const double* p, long long i) {
  return __ldg(p + i);
}

// The four taps of a sample at (x, y): offsets into an H x W plane (-1
// where the tap lies outside) and their bilinear weights.
template <typename S>
__device__ __forceinline__ void taps(S x, S y, int H, int W, int off[4],
                                     S w[4]) {
  const S x0 = floor(x);
  const S y0 = floor(y);
  const S wx = x - x0;
  const S wy = y - y0;
  const S one = S(1);
  w[0] = (one - wx) * (one - wy);
  w[1] = wx * (one - wy);
  w[2] = (one - wx) * wy;
  w[3] = wx * wy;
  // the bounds on the floats: NaN and far-off values fail every test
  const bool xa = x0 >= S(0) && x0 <= S(W - 1);
  const bool xb = x0 >= S(-1) && x0 <= S(W - 2);
  const bool ya = y0 >= S(0) && y0 <= S(H - 1);
  const bool yb = y0 >= S(-1) && y0 <= S(H - 2);
  const int xi = (xa || xb) ? (int)x0 : 0;
  const int yi = (ya || yb) ? (int)y0 : 0;
  off[0] = (ya && xa) ? yi * W + xi : -1;
  off[1] = (ya && xb) ? yi * W + xi + 1 : -1;
  off[2] = (yb && xa) ? (yi + 1) * W + xi : -1;
  off[3] = (yb && xb) ? (yi + 1) * W + xi + 1 : -1;
}

// out[r, c, bin] for rois r, channels c of the block's chunk. smem: the
// roi's nsamp * 4 tap offsets, then nsamp * 4 weights.
template <typename T, typename S>
__global__ void __launch_bounds__(THREADS)
    roi_align_fwd_kernel(const T* __restrict__ feat,
                         const S* __restrict__ coords, S* __restrict__ out,
                         int C, int H, int W, int N, int oh, int ow, int s) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int SW = ow * s;
  const int nsamp = oh * s * SW;
  int* soff = reinterpret_cast<int*>(smem);
  S* sw = reinterpret_cast<S*>(smem + (((size_t)nsamp * 16 + 15) & ~15));
  const long long r = blockIdx.x;
  const int b = (int)(r / N);
  const S* rc = coords + r * nsamp * 2;
  for (int p = threadIdx.x; p < nsamp; p += THREADS) {
    int off[4];
    S w[4];
    taps<S>(rc[2 * p], rc[2 * p + 1], H, W, off, w);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      soff[4 * p + t] = off[t];
      sw[4 * p + t] = w[t];
    }
  }
  __syncthreads();
  const int bins = oh * ow;
  const int c0 = blockIdx.y * CHANNELS;
  const int nc = C - c0 < CHANNELS ? C - c0 : CHANNELS;
  const long long plane = (long long)H * W;
  const S n = S(s * s);
  for (int e = threadIdx.x; e < nc * bins; e += THREADS) {
    const int c = c0 + e / bins;
    const int bin = e - (e / bins) * bins;
    const int i = bin / ow;
    const int j = bin - i * ow;
    const T* f = feat + ((long long)b * C + c) * plane;
    S acc = S(0);
    for (int sy = 0; sy < s; ++sy) {
      for (int sx = 0; sx < s; ++sx) {
        const int p = (i * s + sy) * SW + j * s + sx;
        S v[4];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int o = soff[4 * p + t];
          v[t] = (o >= 0 ? (S)load(f, o) : S(0)) * sw[4 * p + t];
        }
        acc = acc + (((v[0] + v[1]) + v[2]) + v[3]);
      }
    }
    out[(r * C + c) * bins + bin] = acc / n;
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

// dst [R, L, C] = src [R, C, L] transposed, 32 x 32 tiles through shared
// memory (both sides coalesced): the crops' gradient with a bin's channels
// side by side.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    roi_align_transpose_kernel(const T* __restrict__ src, T* __restrict__ dst,
                               int C, int L) {
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
  T* out = dst + r * L * C;
  for (int i = ty; i < 32; i += THREADS / 32) {
    const int l = l0 + i, c = c0 + tx;
    if (l < L && c < C) out[(long long)l * C + c] = tile[tx][i];
  }
}

template <typename T>
void transpose(const T* src, T* dst, long long R, int C, int L,
               cudaStream_t stream) {
  roi_align_transpose_kernel<T>
      <<<dim3((unsigned)R, (C + 31) / 32, (L + 31) / 32), THREADS, 0,
         stream>>>(src, dst, C, L);
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

size_t fwd_smem(int nsamp, size_t s_bytes) {
  return (((size_t)nsamp * 16 + 15) & ~(size_t)15) + (size_t)nsamp * 4 * s_bytes;
}

template <typename T, typename S>
cudaError_t launch_fwd(const void* feat, const void* coords, void* out, int B,
                       int C, int H, int W, int N, int oh, int ow, int s,
                       cudaStream_t stream) {
  const int nsamp = oh * s * ow * s;
  const size_t smem = fwd_smem(nsamp, sizeof(S));
  if (smem > (size_t)SMEM_MAX) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)((long long)B * N),
                  (unsigned)((C + CHANNELS - 1) / CHANNELS));
  roi_align_fwd_kernel<T, S><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(feat), static_cast<const S*>(coords),
      static_cast<S*>(out), C, H, W, N, oh, ow, s);
  return cudaGetLastError();
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
  transpose<S>(static_cast<const S*>(grad), g, R, C, oh * ow, stream);
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
// with fp64. feat [B, C, H, W], coords [B, N, oh * s, ow * s, 2] →
// out [B * N, C, oh, ow] in the coordinates' dtype.
extern "C" int roi_align_fwd(const void* feat, const void* coords, void* out,
                             int feat_type, int B, int C, int H, int W, int N,
                             int oh, int ow, int s, void* stream) {
  if (!shapes_ok(B, C, H, W, N, oh, ow, s)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (feat_type) {
    case 0:
      return (int)launch_fwd<__nv_bfloat16, float>(feat, coords, out, B, C, H,
                                                   W, N, oh, ow, s, st);
    case 1:
      return (int)launch_fwd<float, float>(feat, coords, out, B, C, H, W, N,
                                           oh, ow, s, st);
    case 2:
      return (int)launch_fwd<double, double>(feat, coords, out, B, C, H, W, N,
                                             oh, ow, s, st);
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
