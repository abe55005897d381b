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
// balanced however many samples fall on one pixel:
//  * `roi_align_keys` gives each of a sample's four taps the map pixel it
//    lands on, or a sentinel past the end where it lies outside; the
//    caller sorts these keys with a stable sort (so the taps of one pixel
//    stay in ascending order) and lays the crops' gradient out as
//    [B * N, oh, ow, C], a channel's values of a bin side by side;
//  * `roi_align_bwd` cuts the sorted taps into chunks of CHUNK. A block a
//    chunk stages each tap's pixel, gradient row and weight, and a thread
//    a channel sums g / (s * s) * w over each run of one pixel in order:
//    runs inside the chunk go straight to the map's gradient, the chunk's
//    first and last runs to partial sums, which a second kernel adds in
//    chunk order. A pixel under a thousand proposals costs a few chunks,
//    not a serial walk of its samples;
//  * the coordinates' gradient, one thread a sample, sums over the
//    channels in order g / (s * s) times the bilinear weights' derivative
//    (floor has none): dx = (v01 - v00)(1 - wy) + (v11 - v10) wy and
//    dy = (v10 - v00)(1 - wx) + (v11 - v01) wx, with v = 0 outside.
// The map's gradient comes out fp32 (fp64 for fp64).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int CHANNELS = 32;          // channels a forward block makes
constexpr int CHUNK = 128;            // sorted taps a backward block sums
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

// keys[4 q + t] for tap t of sample q = r * nsamp + p: the map pixel it
// lands on, b * H * W + y * W + x, or `sentinel` (B * H * W) where it lies
// outside.
template <typename S>
__global__ void roi_align_keys_kernel(const S* __restrict__ coords,
                                      int* __restrict__ keys, long long n,
                                      int nsamp, int N, int H, int W,
                                      int sentinel) {
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= n) return;
  int off[4];
  S w[4];
  taps<S>(coords[2 * q], coords[2 * q + 1], H, W, off, w);
  const int base = (int)(q / nsamp / N) * H * W;
#pragma unroll
  for (int t = 0; t < 4; ++t) keys[4 * q + t] = off[t] >= 0 ? base + off[t]
                                                            : sentinel;
}

// One block per CHUNK consecutive entries of the sorted taps (gt: the
// crops' gradient as [B * N, oh * ow, C]). The block stages each entry's
// pixel, gradient row and bilinear weight; a thread a channel walks them
// in order and sums each run of one pixel. A run inside the chunk is
// written to grad_feat; the chunk's first run and its last (which may go
// on in the neighbouring chunks) go to head / tail [chunk, C], their
// pixels to head_key / tail_key (-1: none; a chunk of one run has no
// tail), for `roi_align_fixup_kernel`.
template <typename S>
__global__ void __launch_bounds__(THREADS)
    roi_align_chunk_kernel(const int* __restrict__ sorted,
                           const long long* __restrict__ perm,
                           const S* __restrict__ coords,
                           const S* __restrict__ gt, S* __restrict__ grad_feat,
                           S* __restrict__ head, S* __restrict__ tail,
                           int* __restrict__ head_key,
                           int* __restrict__ tail_key, long long n4, int C,
                           int HW, int oh, int ow, int s, int sentinel) {
  __shared__ int skey[CHUNK];
  __shared__ long long sgoff[CHUNK];
  __shared__ S sw[CHUNK];
  const long long e0 = (long long)blockIdx.x * CHUNK;
  const int len = n4 - e0 < CHUNK ? (int)(n4 - e0) : CHUNK;
  const int SW = ow * s;
  const int nsamp = oh * s * SW;
  const int bins = oh * ow;
  const S one = S(1);
  for (int i = threadIdx.x; i < len; i += THREADS) {
    const int k = sorted[e0 + i];
    skey[i] = k;
    if (k < sentinel) {
      const long long e = perm[e0 + i];
      const long long q = e >> 2;
      const int t = (int)(e & 3);
      const long long r = q / nsamp;
      const int p = (int)(q - r * nsamp);
      const S xs = coords[2 * q];
      const S ys = coords[2 * q + 1];
      const S wx = xs - floor(xs);
      const S wy = ys - floor(ys);
      sw[i] = ((t & 1) ? wx : one - wx) * ((t >> 1) ? wy : one - wy);
      const int row = p / SW;
      const int bin = (row / s) * ow + (p - row * SW) / s;
      sgoff[i] = (r * bins + bin) * C;
    }
  }
  __syncthreads();
  const int first = skey[0];
  const int last = skey[len - 1];
  if (threadIdx.x == 0) {
    head_key[blockIdx.x] = first < sentinel ? first : -1;
    tail_key[blockIdx.x] = (last < sentinel && last != first) ? last : -1;
  }
  const S n = S(s * s);
  for (int c = threadIdx.x; c < C; c += THREADS) {
    S acc = S(0);
    int start = 0;
    for (int i = 0; i < len; ++i) {
      const int k = skey[i];
      if (k >= sentinel) break;        // only sentinels follow
      acc = acc + gt[sgoff[i] + c] / n * sw[i];
      if (i == len - 1 || skey[i + 1] != k) {
        if (start == 0) {
          head[(long long)blockIdx.x * C + c] = acc;
        } else if (i == len - 1) {
          tail[(long long)blockIdx.x * C + c] = acc;
        } else {
          const int b = k / HW;
          grad_feat[((long long)b * C + c) * HW + (k - b * HW)] = acc;
        }
        acc = S(0);
        start = i + 1;
      }
    }
  }
}

// The runs that touch a chunk's edge: one thread a (chunk, channel) sums,
// in chunk order, each run that starts in its chunk (as the chunk's tail,
// or as its head where the chunk before ends with another pixel) over the
// chunks it goes on into, and writes it to grad_feat.
template <typename S>
__global__ void roi_align_fixup_kernel(const S* __restrict__ head,
                                       const S* __restrict__ tail,
                                       const int* __restrict__ head_key,
                                       const int* __restrict__ tail_key,
                                       S* __restrict__ grad_feat,
                                       long long chunks, int C, int HW) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= chunks * C) return;
  const long long k = idx / C;
  const int c = (int)(idx - k * C);
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
      acc = head[k * C + c];
      if (tail_key[k] >= 0) {          // it ended inside chunk k
        const int b = key / HW;
        grad_feat[((long long)b * C + c) * HW + (key - b * HW)] = acc;
        continue;
      }
    } else {
      key = tail_key[k];
      if (key < 0) continue;
      acc = tail[k * C + c];
    }
    for (long long j = k + 1; j < chunks && head_key[j] == key; ++j) {
      acc = acc + head[j * C + c];
      if (tail_key[j] >= 0) break;     // the run ended inside chunk j
    }
    const int b = key / HW;
    grad_feat[((long long)b * C + c) * HW + (key - b * HW)] = acc;
  }
}

// grad_coords[q] = (d/dx, d/dy) of sample q, summed over the channels in
// order (gt: the crops' gradient as [B * N, oh * ow, C]).
template <typename T, typename S>
__global__ void __launch_bounds__(THREADS)
    roi_align_grad_coords_kernel(const T* __restrict__ feat,
                                 const S* __restrict__ coords,
                                 const S* __restrict__ gt,
                                 S* __restrict__ grad_coords, long long n,
                                 int C, int H, int W, int N, int oh, int ow,
                                 int s) {
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= n) return;
  const int SW = ow * s;
  const int nsamp = oh * s * SW;
  const int bins = oh * ow;
  const long long r = q / nsamp;
  const int p = (int)(q - r * nsamp);
  const int b = (int)(r / N);
  const int row = p / SW;
  const int bin = (row / s) * ow + (p - row * SW) / s;
  const S xs = coords[2 * q];
  const S ys = coords[2 * q + 1];
  int off[4];
  S w[4];
  taps<S>(xs, ys, H, W, off, w);
  const S wx = xs - floor(xs);
  const S wy = ys - floor(ys);
  const S one = S(1);
  const S ns = S(s * s);
  const long long plane = (long long)H * W;
  const S* g = gt + (r * bins + bin) * C;
  S dx = S(0), dy = S(0);
  for (int c = 0; c < C; ++c) {
    const T* f = feat + ((long long)b * C + c) * plane;
    S v[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) v[t] = off[t] >= 0 ? (S)load(f, off[t]) : S(0);
    const S gc = g[c] / ns;
    dx = dx + gc * ((v[1] - v[0]) * (one - wy) + (v[3] - v[2]) * wy);
    dy = dy + gc * ((v[2] - v[0]) * (one - wx) + (v[3] - v[1]) * wx);
  }
  grad_coords[2 * q] = dx;
  grad_coords[2 * q + 1] = dy;
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

template <typename T, typename S>
cudaError_t launch_bwd(const void* feat, const void* coords, const void* gt,
                       const void* sorted, const void* perm, void* head,
                       void* tail, void* keys, void* grad_feat,
                       void* grad_coords, int B, int C, int H, int W, int N,
                       int oh, int ow, int s, cudaStream_t stream) {
  const long long n = (long long)B * N * oh * s * ow * s;
  const long long chunks = (4 * n + CHUNK - 1) / CHUNK;
  const int sentinel = B * H * W;
  int* head_key = static_cast<int*>(keys);
  int* tail_key = head_key + chunks;
  roi_align_chunk_kernel<S><<<(unsigned)chunks, THREADS, 0, stream>>>(
      static_cast<const int*>(sorted), static_cast<const long long*>(perm),
      static_cast<const S*>(coords), static_cast<const S*>(gt),
      static_cast<S*>(grad_feat), static_cast<S*>(head),
      static_cast<S*>(tail), head_key, tail_key, 4 * n, C, H * W, oh, ow, s,
      sentinel);
  roi_align_fixup_kernel<S>
      <<<(unsigned)((chunks * C + THREADS - 1) / THREADS), THREADS, 0,
         stream>>>(static_cast<const S*>(head), static_cast<const S*>(tail),
                   head_key, tail_key, static_cast<S*>(grad_feat), chunks, C,
                   H * W);
  roi_align_grad_coords_kernel<T, S>
      <<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0, stream>>>(
          static_cast<const T*>(feat), static_cast<const S*>(coords),
          static_cast<const S*>(gt), static_cast<S*>(grad_coords), n, C, H, W,
          N, oh, ow, s);
  return cudaGetLastError();
}

bool shapes_ok(int B, int C, int H, int W, int N, int oh, int ow, int s) {
  if (B <= 0 || C <= 0 || H <= 0 || W <= 0 || N <= 0 || oh <= 0 || ow <= 0 ||
      s <= 0)
    return false;
  const long long taps = 4LL * B * N * oh * s * ow * s;
  return taps < (1LL << 31) && (long long)B * H * W < (1LL << 31) &&
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

// keys [4 * B * N * oh * s * ow * s] int32, the map pixel of each tap,
// from the coordinates (fp32, or fp64 with coord_double).
extern "C" int roi_align_keys(const void* coords, void* keys, int coord_double,
                              int B, int H, int W, int N, int oh, int ow,
                              int s, void* stream) {
  if (!shapes_ok(B, 1, H, W, N, oh, ow, s)) return (int)cudaErrorInvalidValue;
  const int nsamp = oh * s * ow * s;
  const long long n = (long long)B * N * nsamp;
  const int sentinel = B * H * W;
  const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (coord_double)
    roi_align_keys_kernel<double><<<blocks, THREADS, 0, st>>>(
        static_cast<const double*>(coords), static_cast<int*>(keys), n, nsamp,
        N, H, W, sentinel);
  else
    roi_align_keys_kernel<float><<<blocks, THREADS, 0, st>>>(
        static_cast<const float*>(coords), static_cast<int*>(keys), n, nsamp,
        N, H, W, sentinel);
  return (int)cudaGetLastError();
}

// The chunks of the sorted taps a backward takes, CHUNK taps each: head
// and tail take [chunks, C] of the coordinates' dtype, keys 2 * chunks
// int32.
extern "C" long long roi_align_chunks(long long taps) {
  return (taps + CHUNK - 1) / CHUNK;
}

// sorted: the tap keys in ascending order, perm (int64) their tap indices
// 4 q + t, ties in ascending order; gt: the crops' gradient as
// [B * N, oh, ow, C] in the coordinates' dtype; head, tail, keys: scratch
// (`roi_align_chunks`). grad_feat [B, C, H, W] (zeroed by the caller) and
// grad_coords [B, N, oh * s, ow * s, 2], in the coordinates' dtype.
extern "C" int roi_align_bwd(const void* feat, const void* coords,
                             const void* gt, const void* sorted,
                             const void* perm, void* head, void* tail,
                             void* keys, void* grad_feat, void* grad_coords,
                             int feat_type, int B, int C, int H, int W, int N,
                             int oh, int ow, int s, void* stream) {
  if (!shapes_ok(B, C, H, W, N, oh, ow, s)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (feat_type) {
    case 0:
      return (int)launch_bwd<__nv_bfloat16, float>(
          feat, coords, gt, sorted, perm, head, tail, keys, grad_feat,
          grad_coords, B, C, H, W, N, oh, ow, s, st);
    case 1:
      return (int)launch_bwd<float, float>(
          feat, coords, gt, sorted, perm, head, tail, keys, grad_feat,
          grad_coords, B, C, H, W, N, oh, ow, s, st);
    case 2:
      return (int)launch_bwd<double, double>(
          feat, coords, gt, sorted, perm, head, tail, keys, grad_feat,
          grad_coords, B, C, H, W, N, oh, ow, s, st);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* roi_align_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
