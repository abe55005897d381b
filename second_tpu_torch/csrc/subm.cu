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
// 16-42 MB, a floor of 5-12 us at 3.35 TB/s. Even the padded products (every
// row of a tile, every tap any row of it found) are about 105 GFLOP over the
// 14 convs, 0.1 ms at the bf16 tensor-core rate.
//
// Two entries:
//
// subm_gather_gemm_mma (bf16 features and weights; the main path). Tensor
// cores: bf16 mma.sync.m16n8k16 with fp32 accumulators. A block owns a tile of
// MT = 128 output rows (batch-flattened, m = b*Q + q; a tile may span two
// examples) and walks the tap-concatenated [MT, K*C] row block that the
// Pallas kernel builds (pallas/subm.py:64-76) in stages of KS = 64 columns
// against W viewed as [K*CP, DP] (CP, DP: C and D padded, see below), k16 at
// a time. A stage holds 64/CP taps: 16 at C = 4, 4 at C = 16, 1 at C = 64.
//  1. Rulebook: the tile's found bytes of each tap are contiguous in
//     [B, K, Q], so they are read as 16-byte vectors (bytes where the tile
//     spans two examples or Q is not a multiple of 16); one vote per tap
//     (lane shuffles, then a shared atomicOr) marks the taps some row found,
//     and only those taps are walked. A tile that found none (most tiles
//     past an example's last active site) writes its zeros and ends. Each
//     thread then owns one row and loads its tap_idx only where found, eight
//     taps' loads in flight together, into a [K, MT] table of feature rows
//     (-1 where not found).
//  2. Pipeline: a ring of STAGES = 2 shared-memory stages holds the gathered
//     A rows ([MT, 64] bf16) and the matching W slices ([64, DP] bf16). Both
//     come in by cp.async (16 bytes a copy where C is a multiple of 8, 8
//     bytes at C = 4; element by element otherwise), unfound rows and padded
//     channels zero-filled (src-size 0), so the gathers of the next stage
//     overlap the mma of this one. A tile waits on three dependent memory
//     latencies (its found bytes, then its tap_idx, then its feature rows),
//     so the ring is kept at two stages, 74 KB of shared memory a block at
//     D = 64: three blocks on an SM hide more of that wait than two blocks
//     with a third stage did. Each of 4 warps owns 32 rows: per k16 it
//     loads two A fragments (ldmatrix) and every B fragment once
//     (ldmatrix.trans) and issues 2 x DP/8 mma. Row strides are padded by 16
//     bytes so ldmatrix reads no bank twice.
//  3. Epilogue: the fp32 [MT, D] accumulators go through shared memory (a
//     row stride padded so each half-warp's float2 stores hit 32 banks) and
//     leave as one contiguous run of float4 stores (the tile's output rows
//     are contiguous in [B*Q, D]), full 128-byte lines.
// W is taken packed as [K, CP, DP] (the wrapper pads C to CP in {4, 8, 16,
// 32, 64} and D to a multiple of 8 with zeros; at the main path's widths it is
// the weight tensor as it is). bf16 x bf16 products are exact in fp32 and
// the sums stay fp32, so only the order of the sums differs from the plain
// version.
//
// subm_gather_gemm_fma (fp32; the card-vs-CPU reference), on the CUDA
// cores: one block per tile of 64 output rows; for each tap k the block
// loads the tile's 64 rulebook entries, skips the tap if no row of the tile
// found a neighbour, gathers the 64 neighbour rows into shared memory next
// to W[k], and accumulates the [64, C] x [C, D] product with fp32 FMAs in
// registers: each of the 256 threads owns 4 rows x ceil(D/16) columns.
//
// In both, the [B, K, Q, C] tap stack never exists in device memory; only
// the features, the rulebook, the weights and the [B*Q, D] output are
// touched.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------- fp32 FMA

constexpr int TILE_M = 64;
constexpr int THREADS = 256;
constexpr int CMAX = 64;
constexpr int DMAX = 64;

__device__ __forceinline__ float to_f(float v) { return v; }

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

// ------------------------------------------------------ bf16 tensor cores

constexpr int MT = 128;             // output rows per tile (one block)
constexpr int MMA_THREADS = 128;    // 4 warps x 32 rows; thread t owns row t
constexpr int KS = 64;              // A columns (bf16) per pipeline stage
constexpr int STAGES = 2;           // 74 KB a block at D = 64: 3 on an SM
constexpr int KMAX = 32;            // taps: one bit each in the vote mask
constexpr int A_LD = KS + 8;        // A row stride, elements (144 bytes)
constexpr int FOUND_VECS = MT / 16; // 16-byte vectors of found bytes a tap

enum AMode { A_CP16 = 0, A_CP8 = 1, A_ELEM = 2 };

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 8 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p))
      : "memory");
}

// d += a (16x16, row) @ b (16x8, col); bf16 inputs, fp32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int NT>
__host__ __device__ constexpr int w_ld() {   // W row stride, elements
  return NT * 8 + 8;                          // DP + 16 bytes of pad
}

template <int NT>
__host__ __device__ constexpr int out_ld() {  // epilogue row stride, floats:
  return NT * 8 + (NT & 1 ? 16 : 8);          // 8 or 24 mod 32, so a
}                                             // half-warp's float2 stores
                                              // hit 32 distinct banks

template <int NT>
__host__ __device__ constexpr size_t mma_smem_bytes() {
  return (size_t)STAGES * (MT * A_LD + KS * w_ld<NT>()) * 2;
}

static_assert(KMAX * MT <= STAGES * MT * A_LD * 2,
              "the found bytes live in the ring before the pipeline");

// NT: n-tiles of 8 output columns, DP = 8 * NT. cp_shift = log2(CP).
template <int NT>
__global__ void __launch_bounds__(MMA_THREADS, 3)
    gather_gemm_mma_kernel(const __nv_bfloat16* __restrict__ feat,
                           const int32_t* __restrict__ tap_idx,
                           const uint8_t* __restrict__ found,
                           const __nv_bfloat16* __restrict__ w,
                           float* __restrict__ out, int B, int N, int Q, int K,
                           int C, int cp_shift, int D, int a_mode) {
  constexpr int DP = NT * 8;
  constexpr int W_LD = w_ld<NT>();
  constexpr int O_LD = out_ld<NT>();
  static_assert(MT * O_LD * 4 <= mma_smem_bytes<NT>(),
                "the epilogue tile fits the ring");
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* s_a = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* s_w = s_a + STAGES * MT * A_LD;
  // [KMAX][MT] found bytes; the ring is not in use before the pipeline
  uint8_t* s_found = smem;
  __shared__ int32_t s_row[KMAX][MT];           // feature row, -1: not found
  __shared__ long long s_off[MT];               // b*K*Q + q, -1 past the end
  __shared__ int32_t s_boff[MT];                // b*N
  __shared__ int s_list[KMAX];                  // the taps some row found
  __shared__ unsigned s_mask;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int M = B * Q;
  const int m0 = blockIdx.x * MT;
  const int CP = 1 << cp_shift;
  const int rows = min(MT, M - m0);
  float* o = out + (long long)m0 * D;     // 16-byte aligned: m0 % 128 == 0

  // 0. where each row's rulebook entries start
  if (tid == 0) s_mask = 0;
  {
    const int m = m0 + tid;
    if (m < M) {
      const int b = m / Q;
      s_off[tid] = (long long)b * K * Q + (m - b * Q);
      s_boff[tid] = b * N;
    } else {
      s_off[tid] = -1;
      s_boff[tid] = 0;
    }
  }
  __syncthreads();

  // 1a. found bytes of the tile, tap by tap, and one vote per tap
  const int b0 = m0 / Q;
  const bool vec = (Q & 15) == 0 && rows == MT &&
                   (m0 + MT - 1) / Q == b0 &&
                   ((uintptr_t)found & 15) == 0;
  const long long q0 = m0 - (long long)b0 * Q;
  for (int v0 = 0; v0 < K * FOUND_VECS; v0 += MMA_THREADS) {
    const int v = v0 + tid;              // lanes 8j..8j+7 share one tap
    const int k = v / FOUND_VECS, c = v % FOUND_VECS;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (v < K * FOUND_VECS) {
      if (vec) {
        val = __ldg(reinterpret_cast<const uint4*>(
            found + ((long long)b0 * K + k) * Q + q0 + c * 16));
      } else {
        uint32_t word[4] = {0, 0, 0, 0};
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const long long off = s_off[c * 16 + j];
          if (off >= 0 && found[off + (long long)k * Q])
            word[j >> 2] |= 1u << (8 * (j & 3));
        }
        val = make_uint4(word[0], word[1], word[2], word[3]);
      }
      *reinterpret_cast<uint4*>(s_found + k * MT + c * 16) = val;
    }
    unsigned any = (val.x | val.y | val.z | val.w) != 0;
    any |= __shfl_xor_sync(0xffffffffu, any, 1);
    any |= __shfl_xor_sync(0xffffffffu, any, 2);
    any |= __shfl_xor_sync(0xffffffffu, any, 4);
    if (v < K * FOUND_VECS && c == 0 && any) atomicOr(&s_mask, 1u << k);
  }
  __syncthreads();

  const unsigned mask = s_mask;
  const int nact = __popc(mask);
  if (nact == 0) {                       // no tap found: zeros, no pipeline
    const int n4 = (rows * D) >> 2;
    for (int i = tid; i < n4; i += MMA_THREADS)
      reinterpret_cast<float4*>(o)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i = (n4 << 2) + tid; i < rows * D; i += MMA_THREADS) o[i] = 0.f;
    return;
  }

  // 1b. the list of voted taps, and each row's feature row per tap
  if (warp == 0 && lane < K && ((mask >> lane) & 1))
    s_list[__popc(mask & ((1u << lane) - 1))] = lane;
  {
    const long long off = s_off[tid];
    const int boff = s_boff[tid];
    for (int k0 = 0; k0 < K; k0 += 8) {
      int t[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int k = k0 + j;
        t[j] = (k < K && s_found[k * MT + tid])
                   ? __ldg(tap_idx + off + (long long)k * Q)
                   : -1;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int k = k0 + j;
        if (k >= K) break;
        const bool f = s_found[k * MT + tid] != 0;
        if (f && (t[j] < 0 || t[j] >= N)) __trap();
        s_row[k][tid] = f ? boff + t[j] : -1;
      }
    }
  }
  __syncthreads();

  // 2. the pipeline over stages of 64 A columns (64 / CP voted taps each)
  const int tps = KS >> cp_shift;
  const int nst = (nact + tps - 1) / tps;

  auto load = [&](int s, int buf) {
    __nv_bfloat16* as = s_a + buf * MT * A_LD;
    __nv_bfloat16* ws = s_w + buf * KS * W_LD;
    const int a0 = s * tps;
    if (a_mode == A_CP16) {          // 8 units of 16 bytes a row
#pragma unroll
      for (int i = 0; i < MT * 8 / MMA_THREADS; ++i) {
        const int u = tid + i * MMA_THREADS;
        const int r = u >> 3, col = (u & 7) * 8;
        const int a = a0 + (col >> cp_shift), c = col & (CP - 1);
        const int row = (a < nact && c < C) ? s_row[s_list[a]][r] : -1;
        cp_async16(as + r * A_LD + col,
                   row >= 0 ? feat + (long long)row * C + c : feat, row >= 0);
      }
    } else if (a_mode == A_CP8) {    // 16 units of 8 bytes a row
#pragma unroll
      for (int i = 0; i < MT * 16 / MMA_THREADS; ++i) {
        const int u = tid + i * MMA_THREADS;
        const int r = u >> 4, col = (u & 15) * 4;
        const int a = a0 + (col >> cp_shift), c = col & (CP - 1);
        const int row = (a < nact && c < C) ? s_row[s_list[a]][r] : -1;
        cp_async8(as + r * A_LD + col,
                  row >= 0 ? feat + (long long)row * C + c : feat, row >= 0);
      }
    } else {                         // element by element
      for (int e = tid; e < MT * KS; e += MMA_THREADS) {
        const int r = e / KS, col = e % KS;
        const int a = a0 + (col >> cp_shift), c = col & (CP - 1);
        const int row = (a < nact && c < C) ? s_row[s_list[a]][r] : -1;
        as[r * A_LD + col] = row >= 0 ? feat[(long long)row * C + c]
                                      : __float2bfloat16(0.f);
      }
    }
    // W: 64 rows (slot j, channel kk) of DP columns, NT units of 16 bytes
    for (int u = tid; u < KS * NT; u += MMA_THREADS) {
      const int kr = u / NT, cu = u - kr * NT;
      const int a = a0 + (kr >> cp_shift), kk = kr & (CP - 1);
      const bool ok = a < nact;
      cp_async16(ws + kr * W_LD + cu * 8,
                 ok ? w + ((long long)s_list[a] * CP + kk) * DP + cu * 8 : w,
                 ok);
    }
  };

  float acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nst) load(s, s);
    cp_async_commit();
  }
  for (int s = 0; s < nst; ++s) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();                 // stage s landed; s - 1 is consumed
    if (s + STAGES - 1 < nst) load(s + STAGES - 1, (s + STAGES - 1) % STAGES);
    cp_async_commit();

    const int buf = s % STAGES;
    const __nv_bfloat16* as = s_a + buf * MT * A_LD;
    const __nv_bfloat16* ws = s_w + buf * KS * W_LD;
    const int used = min(tps, nact - s * tps);
    const int ksteps = ((used << cp_shift) + 15) >> 4;
#pragma unroll
    for (int ks = 0; ks < KS / 16; ++ks) {
      if (ks >= ksteps) break;
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldmatrix_x4(a[mt], as + (warp * 32 + mt * 16 + (lane & 15)) * A_LD +
                               ks * 16 + (lane >> 4) * 8);
      const __nv_bfloat16* wrow = ws + (ks * 16 + (lane & 15)) * W_LD;
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, wrow + np * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(acc[mt][2 * np], a[mt], b[0], b[1]);
          mma_bf16(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
        }
      }
      if (NT & 1) {
        uint32_t b[2];
        ldmatrix_x2_trans(b, wrow + (NT - 1) * 8);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          mma_bf16(acc[mt][NT - 1], a[mt], b[0], b[1]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // 3. epilogue: fragments -> shared [MT, O_LD] fp32 (float2 stores, no
  // bank conflicts) -> the tile's contiguous run of output rows
  float* so = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int r = warp * 32 + mt * 16 + (lane >> 2);
      const int c = nt * 8 + (lane & 3) * 2;
      *reinterpret_cast<float2*>(so + r * O_LD + c) =
          make_float2(acc[mt][nt][0], acc[mt][nt][1]);
      *reinterpret_cast<float2*>(so + (r + 8) * O_LD + c) =
          make_float2(acc[mt][nt][2], acc[mt][nt][3]);
    }
  __syncthreads();
  if (D == DP) {                     // rows of DP / 4 float4
    for (int i = tid; i < rows * (DP / 4); i += MMA_THREADS) {
      const int r = i / (DP / 4), c = i - r * (DP / 4);
      reinterpret_cast<float4*>(o)[i] =
          *reinterpret_cast<const float4*>(so + r * O_LD + c * 4);
    }
  } else {
    for (int i = tid; i < rows * D; i += MMA_THREADS) {
      const int r = i / D;
      o[i] = so[r * O_LD + (i - r * D)];
    }
  }
}

template <int NT>
cudaError_t launch_mma(const void* feat, const void* tap_idx,
                       const void* found, const void* w, void* out, int B,
                       int N, int Q, int K, int C, int cp_shift, int D,
                       int a_mode, cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<NT>();
  static bool configured = false;
  if (!configured) {
    // above 48 KB only on request; all of the SM's memory to shared, so
    // three blocks fit on each SM
    cudaError_t e = cudaFuncSetAttribute(
        gather_gemm_mma_kernel<NT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(gather_gemm_mma_kernel<NT>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const unsigned blocks = (unsigned)(((long long)B * Q + MT - 1) / MT);
  gather_gemm_mma_kernel<NT><<<blocks, MMA_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(feat),
      static_cast<const int32_t*>(tap_idx),
      static_cast<const uint8_t*>(found),
      static_cast<const __nv_bfloat16*>(w), static_cast<float*>(out), B, N, Q,
      K, C, cp_shift, D, a_mode);
  return cudaGetLastError();
}

}  // namespace

// bf16 features [B, N, C] and packed weights [K, CP, DP] (CP = 1 << cp_shift
// in 4..64, at least C; DP = D rounded up to 8), tensor cores.
extern "C" int subm_gather_gemm_mma(const void* feat, const void* tap_idx,
                                    const void* found, const void* w,
                                    void* out, int B, int N, int Q, int K,
                                    int C, int cp_shift, int D, void* stream) {
  if (C < 1 || C > 64 || D < 1 || D > 64 || K < 1 || K > KMAX ||
      cp_shift < 2 || cp_shift > 6 || (1 << cp_shift) < C ||
      (long long)B * Q >= (1LL << 31) || (long long)B * N >= (1LL << 31) ||
      ((uintptr_t)w & 15) || ((uintptr_t)out & 15))
    return (int)cudaErrorInvalidValue;
  if ((long long)B * Q == 0) return 0;
  const uintptr_t fa = (uintptr_t)feat;
  const int a_mode = (C % 8 == 0 && !(fa & 15)) ? A_CP16
                     : (C % 4 == 0 && !(fa & 7)) ? A_CP8
                                                 : A_ELEM;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch ((D + 7) / 8) {
#define SUBM_MMA_CASE(nt)                                                    \
  case nt:                                                                   \
    e = launch_mma<nt>(feat, tap_idx, found, w, out, B, N, Q, K, C, cp_shift, \
                       D, a_mode, s);                                        \
    break;
    SUBM_MMA_CASE(1)
    SUBM_MMA_CASE(2)
    SUBM_MMA_CASE(3)
    SUBM_MMA_CASE(4)
    SUBM_MMA_CASE(5)
    SUBM_MMA_CASE(6)
    SUBM_MMA_CASE(7)
    SUBM_MMA_CASE(8)
#undef SUBM_MMA_CASE
    default: e = cudaErrorInvalidValue;
  }
  return (int)e;
}

// fp32 features [B, N, C] and weights [K, C, D], CUDA-core FMAs.
extern "C" int subm_gather_gemm_fma(const void* feat, const void* tap_idx,
                                    const void* found, const void* w,
                                    void* out, int B, int N, int Q, int K,
                                    int C, int D, void* stream) {
  if (C < 1 || C > CMAX || D < 1 || D > DMAX || K < 1)
    return (int)cudaErrorInvalidValue;
  if ((long long)B * Q == 0) return 0;
  return (int)launch<float>(feat, tap_idx, found, w, out, B, N, Q, K, C, D,
                            static_cast<cudaStream_t>(stream));
}

extern "C" const char* subm_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
