// Sparse-conv gather-GEMM: out[b, q, :] = sum_k feat[b, tap_idx[b, k, q], :]
// @ W[k] over the taps with found[b, k, q], fp32 accumulation, before bias
// and mask.
//
// Replaces: second_tpu/ops/pallas/subm.py `subm_conv3d_fused_pallas` (kernel
// `_fused_kernel`), the fused sparse-conv apply that every SubMBlock and
// DownBlock of SpMiddleFHD runs (10 submanifold and 4 strided convs per
// forward), in bf16 where the config asks for mixed precision and in fp32
// where it does not (second_multiclass.config). It reads the port's per-tap
// rulebook (tap_idx, found) [B, K, Q] instead of the TPU's (dz, dy)-plane
// window slabs and selection masks.
//
// Bound on the H100: bytes in bf16 (operations in fp32, below). At the fhd
// shapes (B = 4, Q up to 40960, K = 27, C and D up to 64) one conv must
// read the [B, K, Q] found mask, the row index of each found tap (4-15% of
// the taps) and each feature row those reference, and write the [B, Q, D]
// fp32 output, which is most of it: 16-42 MB, a floor of 5-12 us at 3.35
// TB/s. Even the padded products (every row of a tile, every tap any row
// of it found) are about 105 GFLOP over the 14 convs, 0.1 ms at the bf16
// tensor-core rate.
//
// Both entries share one tile walk. A block owns a tile of MT = 128 output
// rows (batch-flattened, m = b*Q + q; a tile may span two examples) and
// walks the tap-concatenated [MT, K*CP] row block that the Pallas kernel
// builds (pallas/subm.py:64-76) in stages of columns against W viewed as
// [K*CP, DP] (CP, DP: C and D padded, see below).
//  1. Rulebook: the tile's found bytes of each tap are contiguous in
//     [B, K, Q], so they are read as 16-byte vectors (bytes where the tile
//     spans two examples or Q is not a multiple of 16); one vote per tap
//     (lane shuffles, then a shared atomicOr) marks the taps some row found,
//     and only those taps are walked. A tile that found none (most tiles
//     past an example's last active site) writes its zeros and ends. Each
//     thread then owns one row and loads its tap_idx only where found, eight
//     taps' loads in flight together, into a [KMAX, MT] table of feature
//     rows (-1 where not found). Taps are voted in groups of KMAX = 32.
//  2. Pipeline: a ring of shared-memory stages holds the gathered A rows
//     and the matching W slices. Both come in by cp.async, unfound rows
//     and padded channels zero-filled (src-size 0), so the gathers of the
//     next stages overlap the products of this one. A tile waits on three
//     dependent memory latencies (its found bytes, then its tap_idx, then
//     its feature rows). bf16: STAGES = 2 and three blocks an SM hid more of
//     that wait than two blocks with a third stage did. fp32: F_STAGES = 3
//     and two blocks an SM (faster than two stages before the column split
//     below, as fast after it). Each of 4 warps owns 32 rows.
//  3. Epilogue: the fp32 [MT, D] accumulators go through shared memory (a
//     row stride padded so each half-warp's float2 stores hit 32 banks) and
//     leave as one contiguous run of float4 stores (the tile's output rows
//     are contiguous in [B*Q, D]), full 128-byte lines.
// W is taken packed as [K, CP, DP] (the wrapper pads C to CP in {4, 8, 16,
// 32, 64} and D to a multiple of 8 with zeros; at the main path's widths it
// is the weight tensor as it is).
//
// subm_gather_gemm_mma (bf16 features and weights): stages of KS = 64
// columns, 64 / CP taps a stage (16 at C = 4, 4 at C = 16, 1 at C = 64), A
// [MT, 64] bf16 by 16-byte copies where C is a multiple of 8 (8 bytes at C =
// 4, element by element otherwise); per k16 each warp loads two A fragments
// (ldmatrix) and every B fragment once (ldmatrix.trans) and issues 2 x DP/8
// mma.sync.m16n8k16 bf16 with fp32 accumulators. bf16 x bf16 products are
// exact in fp32 and the sums stay fp32, so only the order of the sums
// differs from the plain version. Row strides are padded by 16 bytes so
// ldmatrix reads no bank twice. At most KMAX taps.
//
// subm_gather_gemm_fma (fp32 features and weights, any number of taps):
// the port of the same Pallas kernel on an fp32 config, where it is the
// largest item of the mc eval forward. Bound on the H100 by bytes in mc
// eval (0.099 ms: features, rulebook, weights and output once), over the
// operations of its 12.2 GFLOP of found taps as 3xTF32 at 495 TF/s (0.074
// ms; 0.18 ms as fp32 at the CUDA cores' 67 TF/s); in practice by the
// densest tiles' chain of stages. Stages of F_KS = 32 fp32 columns (a stage may hold part of a
// tap at C > 32), A [MT, 32] fp32 by 16-byte copies where C is a multiple
// of 4 (4-byte copies otherwise). The product is fp32-accurate on the TF32
// tensor cores: each operand x splits into a TF32 part big = rna(x) and a
// TF32 residual small = rna(x - big), which together carry x to 2^-22 of
// its value, and each k8 step of mma.sync.m16n8k8 TF32 takes small·big +
// big·small + big·big (small terms first; small·small, below 2^-22 of the
// product, is dropped) into fresh fp32 registers: the tensor cores sum
// inside an instruction and truncate, so a chain across the whole
// reduction would drift by up to an ulp of the running sum a step. The
// steps are added to the accumulators with compensation (Kahan: each
// addition's rounding is carried into the next), so the long outer sum
// adds next to no error of its own. Against the plain version in fp64
// (scripts/torch_subm_fp32.py): 0.1-0.8 times the fp32 plain version's
// error on mc eval's convs, at most 1.96 times on short random sums where
// cuBLAS's fp32 GEMM lands within a few ulps (the exact-fp32 FMA kernel
// this one replaced: up to 7.3 times there; without the compensation,
// faster but past twice there). chip_smoke.py and the card tests hold it
// to at most twice. Fragments are read from shared memory as 32-bit
// words at strides that give the 32 lanes of a warp 32 distinct
// banks (A: 36 floats, 4 g + t; W: 8 mod 32, 8 t + g). A block makes at
// most F_NT = 4 n-tiles (32 output columns); wider outputs split a tile's
// columns over blocks (blockIdx.y), each gathering the same rows: the
// densest tiles walk all 27 taps, 54 stages at C = 64, one after another,
// and set the kernel's time (a conv of half the tiles took as long), so
// two blocks a tile halve that chain. (Eight warps a block, the columns
// split between its warps instead, were slower.)
//
// In both, the [B, K, Q, C] tap stack never exists in device memory; only
// the features, the rulebook, the weights and the [B*Q, D] output are
// touched.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MT = 128;             // output rows per tile (one block)
constexpr int MMA_THREADS = 128;    // 4 warps x 32 rows; thread t owns row t
constexpr int STAGES = 2;           // 3 blocks an SM
constexpr int KMAX = 32;            // taps a vote: one bit each in the mask
constexpr int FOUND_VECS = MT / 16; // 16-byte vectors of found bytes a tap
constexpr int KS = 64;              // bf16 A columns per pipeline stage
constexpr int A_LD = KS + 8;        // bf16 A row stride, elements (144 bytes)
constexpr int F_KS = 32;            // fp32 A columns per pipeline stage
constexpr int F_A_LD = F_KS + 4;    // fp32 A row stride, floats (144 bytes)
constexpr int F_STAGES = 3;         // fp32 ring: 2 blocks an SM
constexpr int F_NT = 4;             // fp32: at most 32 output columns a block

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

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0)
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

// d += a (16x8, row) @ b (8x8, col); TF32 inputs, fp32 accumulators
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = big + small, both TF32 (round to nearest, ties away): x to 2^-22
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n"
      : "=r"(small)
      : "f"(x - __uint_as_float(big)));
}

template <int NT>
__host__ __device__ constexpr int w_ld() {   // bf16 W row stride, elements
  return NT * 8 + 8;                          // DP + 16 bytes of pad
}

template <int NT>
__host__ __device__ constexpr int f_w_ld() {  // fp32 W row stride, floats:
  return (NT * 8 + 23) / 32 * 32 + 8;         // 8 mod 32, so lanes 8 t + g
}                                             // hit 32 distinct banks

template <int NT>
__host__ __device__ constexpr int out_ld() {  // epilogue row stride, floats:
  return NT * 8 + (NT & 1 ? 16 : 8);          // 8 or 24 mod 32, so a
}                                             // half-warp's float2 stores
                                              // hit 32 distinct banks

template <int NT>
__host__ __device__ constexpr size_t mma_smem_bytes() {
  return (size_t)STAGES * (MT * A_LD + KS * w_ld<NT>()) * 2;
}

template <int NT>
__host__ __device__ constexpr size_t tf32_smem_bytes() {
  return (size_t)F_STAGES * (MT * F_A_LD + F_KS * f_w_ld<NT>()) * 4;
}

static_assert(KMAX * MT <= STAGES * MT * A_LD * 2 &&
                  KMAX * MT <= F_STAGES * MT * F_A_LD * 4,
              "the found bytes live in the ring before the pipeline");

// ------------------------------------------------------ the tile's rulebook

// 0. Where each of the tile's rows starts in [B, K, Q] (b*K*Q + q, -1 past
// the end) and its example's first feature row (b*N).
__device__ __forceinline__ void tile_rows(int m0, int M, int N, int Q, int K,
                                          long long* s_off, int32_t* s_boff) {
  const int tid = threadIdx.x;
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

// 1a. The found bytes of taps k0 .. k0 + nk - 1 (nk <= KMAX) of the tile
// into s_found [nk][MT], and one vote a tap (bit k - k0 of *s_mask, which
// the caller zeroed) where some row found it.
__device__ __forceinline__ void vote_taps(const uint8_t* __restrict__ found,
                                          int Q, int K, int k0, int nk,
                                          int m0, int rows,
                                          const long long* s_off,
                                          uint8_t* s_found, unsigned* s_mask) {
  const int tid = threadIdx.x;
  const int b0 = m0 / Q;
  const bool vec = (Q & 15) == 0 && rows == MT &&
                   (m0 + MT - 1) / Q == b0 &&
                   ((uintptr_t)found & 15) == 0;
  const long long q0 = m0 - (long long)b0 * Q;
  for (int v0 = 0; v0 < nk * FOUND_VECS; v0 += MMA_THREADS) {
    const int v = v0 + tid;              // lanes 8j..8j+7 share one tap
    const int k = v / FOUND_VECS, c = v % FOUND_VECS;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (v < nk * FOUND_VECS) {
      if (vec) {
        val = __ldg(reinterpret_cast<const uint4*>(
            found + ((long long)b0 * K + k0 + k) * Q + q0 + c * 16));
      } else {
        uint32_t word[4] = {0, 0, 0, 0};
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const long long off = s_off[c * 16 + j];
          if (off >= 0 && found[off + (long long)(k0 + k) * Q])
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
    if (v < nk * FOUND_VECS && c == 0 && any) atomicOr(s_mask, 1u << k);
  }
}

// 1b. The list of voted taps (s_list, ascending, relative to k0) and each
// row's feature row for each tap of the group (s_row [nk][MT], -1 where
// not found).
__device__ __forceinline__ void tap_rows(const int32_t* __restrict__ tap_idx,
                                         int N, int Q, int k0, int nk,
                                         unsigned mask, const long long* s_off,
                                         const int32_t* s_boff,
                                         const uint8_t* s_found,
                                         int32_t (*s_row)[MT], int* s_list) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (warp == 0 && lane < nk && ((mask >> lane) & 1))
    s_list[__popc(mask & ((1u << lane) - 1))] = lane;
  const long long off = s_off[tid];
  const int boff = s_boff[tid];
  for (int k1 = 0; k1 < nk; k1 += 8) {
    int t[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int k = k1 + j;
      t[j] = (k < nk && s_found[k * MT + tid])
                 ? __ldg(tap_idx + off + (long long)(k0 + k) * Q)
                 : -1;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int k = k1 + j;
      if (k >= nk) break;
      const bool f = s_found[k * MT + tid] != 0;
      if (f && (t[j] < 0 || t[j] >= N)) __trap();
      s_row[k][tid] = f ? boff + t[j] : -1;
    }
  }
}

// A tile that found no tap: zeros in `cols` columns of each of its rows
// (row stride ld; o 16-byte aligned).
__device__ __forceinline__ void zero_tile(float* o, int rows, int ld,
                                          int cols) {
  const int tid = threadIdx.x;
  if (cols == ld) {                  // one contiguous run
    const int n4 = (rows * cols) >> 2;
    for (int i = tid; i < n4; i += MMA_THREADS)
      reinterpret_cast<float4*>(o)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i = (n4 << 2) + tid; i < rows * cols; i += MMA_THREADS)
      o[i] = 0.f;
  } else {
    for (int i = tid; i < rows * cols; i += MMA_THREADS) {
      const int r = i / cols;
      o[(long long)r * ld + (i - r * cols)] = 0.f;
    }
  }
}

// 3. Epilogue: the m16n8 accumulator fragments of 4 warps x 32 rows ->
// shared [MT, O_LD] fp32 (float2 stores, no bank conflicts) -> `cols`
// output columns of each row (row stride ld; a contiguous run where cols
// == ld). The caller has synchronised the ring.
template <int NT>
__device__ __forceinline__ void store_tile(const float (&acc)[2][NT][4],
                                           float* so, float* o, int rows,
                                           int ld, int cols) {
  constexpr int DP = NT * 8;
  constexpr int O_LD = out_ld<NT>();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
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
  if (cols == DP && ld % 4 == 0) {   // rows of DP / 4 float4
    for (int i = tid; i < rows * (DP / 4); i += MMA_THREADS) {
      const int r = i / (DP / 4), c = i - r * (DP / 4);
      *reinterpret_cast<float4*>(o + (long long)r * ld + c * 4) =
          *reinterpret_cast<const float4*>(so + r * O_LD + c * 4);
    }
  } else {
    for (int i = tid; i < rows * cols; i += MMA_THREADS) {
      const int r = i / cols, c = i - r * cols;
      o[(long long)r * ld + c] = so[r * O_LD + c];
    }
  }
}

// ------------------------------------------------------ bf16 tensor cores

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
  static_assert(MT * out_ld<NT>() * 4 <= mma_smem_bytes<NT>(),
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

  // 0-1. the tile's rulebook: one group of K <= KMAX taps
  if (tid == 0) s_mask = 0;
  tile_rows(m0, M, N, Q, K, s_off, s_boff);
  __syncthreads();
  vote_taps(found, Q, K, 0, K, m0, rows, s_off, s_found, &s_mask);
  __syncthreads();
  const unsigned mask = s_mask;
  const int nact = __popc(mask);
  if (nact == 0) {                       // no tap found: zeros, no pipeline
    zero_tile(o, rows, D, D);
    return;
  }
  tap_rows(tap_idx, N, Q, 0, K, mask, s_off, s_boff, s_found, s_row, s_list);
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
  store_tile<NT>(acc, reinterpret_cast<float*>(smem), o, rows, D, D);
}

// --------------------------------------- fp32 on TF32 tensor cores (3xTF32)

// NT: n-tiles of 8 output columns a block; the block makes columns d0 ..
// d0 + 8 NT - 1 (d0 = 8 NT blockIdx.y) of the DP packed ones (DP a multiple
// of 8). cp_shift = log2(CP).
template <int NT>
__global__ void __launch_bounds__(MMA_THREADS, F_STAGES > 2 ? 2 : 3)
    gather_gemm_tf32_kernel(const float* __restrict__ feat,
                            const int32_t* __restrict__ tap_idx,
                            const uint8_t* __restrict__ found,
                            const float* __restrict__ w,
                            float* __restrict__ out, int B, int N, int Q,
                            int K, int C, int cp_shift, int D, int DP,
                            int a_mode) {
  constexpr int W_LD = f_w_ld<NT>();
  static_assert(MT * out_ld<NT>() * 4 <= tf32_smem_bytes<NT>(),
                "the epilogue tile fits the ring");
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_a = reinterpret_cast<float*>(smem);
  float* s_w = s_a + F_STAGES * MT * F_A_LD;
  // [KMAX][MT] found bytes of a tap group; the ring is free between groups
  uint8_t* s_found = smem;
  __shared__ int32_t s_row[KMAX][MT];           // feature row, -1: not found
  __shared__ long long s_off[MT];               // b*K*Q + q, -1 past the end
  __shared__ int32_t s_boff[MT];                // b*N
  __shared__ int s_list[KMAX];                  // the group's voted taps
  __shared__ unsigned s_mask;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;        // the mma fragments' lanes
  const int M = B * Q;
  const int m0 = blockIdx.x * MT;
  const int CP = 1 << cp_shift;
  const int rows = min(MT, M - m0);
  const int d0 = blockIdx.y * NT * 8;
  const int cols = min(NT * 8, D - d0);
  // 16-byte aligned: m0 % 128 == 0 and d0 % 8 == 0
  float* o = out + (long long)m0 * D + d0;
  tile_rows(m0, M, N, Q, K, s_off, s_boff);

  float acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  float cmp[2][NT][4];                          // the sums' lost low parts
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) cmp[mt][nt][i] = 0.f;

  bool any = false;                             // block-uniform
  for (int kg = 0; kg < K; kg += KMAX) {
    // 1. the group's rulebook. The mask is zeroed before the barrier that
    // precedes the votes; every thread read the last group's mask before
    // the barriers of that group's pipeline (a group without votes leaves
    // it 0)
    const int nk = min(KMAX, K - kg);
    if (tid == 0) s_mask = 0;
    __syncthreads();
    vote_taps(found, Q, K, kg, nk, m0, rows, s_off, s_found, &s_mask);
    __syncthreads();
    const unsigned mask = s_mask;
    const int nact = __popc(mask);
    if (nact == 0) continue;
    any = true;
    tap_rows(tap_idx, N, Q, kg, nk, mask, s_off, s_boff, s_found, s_row,
             s_list);
    __syncthreads();

    // 2. the pipeline over stages of 32 A columns of the voted taps
    // concatenated: column j is channel j % CP of voted tap j / CP
    const int acols = nact << cp_shift;
    const int nst = (acols + F_KS - 1) / F_KS;
    auto load = [&](int s, int buf) {
      float* as = s_a + buf * MT * F_A_LD;
      float* ws = s_w + buf * F_KS * W_LD;
      const int j0 = s * F_KS;
      if (a_mode == A_CP16) {        // 8 units of 4 floats a row
#pragma unroll
        for (int i = 0; i < MT * 8 / MMA_THREADS; ++i) {
          const int u = tid + i * MMA_THREADS;
          const int r = u >> 3, col = (u & 7) * 4;
          const int j = j0 + col;
          const int a = j >> cp_shift, c = j & (CP - 1);
          const int row = (a < nact && c < C) ? s_row[s_list[a]][r] : -1;
          cp_async16(as + r * F_A_LD + col,
                     row >= 0 ? feat + (long long)row * C + c : feat,
                     row >= 0);
        }
      } else {                       // one float a copy
        for (int e = tid; e < MT * F_KS; e += MMA_THREADS) {
          const int r = e / F_KS, col = e % F_KS;
          const int j = j0 + col;
          const int a = j >> cp_shift, c = j & (CP - 1);
          const int row = (a < nact && c < C) ? s_row[s_list[a]][r] : -1;
          cp_async4(as + r * F_A_LD + col,
                    row >= 0 ? feat + (long long)row * C + c : feat,
                    row >= 0);
        }
      }
      // W: 32 rows (column j of A: tap kg + s_list[j / CP], channel j % CP)
      // of the block's 8 NT columns, 2 NT units of 16 bytes (zeros past DP)
      for (int u = tid; u < F_KS * 2 * NT; u += MMA_THREADS) {
        const int kr = u / (2 * NT), cu = u - kr * (2 * NT);
        const int j = j0 + kr;
        const int a = j >> cp_shift, kk = j & (CP - 1);
        const bool ok = a < nact && d0 + cu * 4 < DP;
        cp_async16(ws + kr * W_LD + cu * 4,
                   ok ? w + ((long long)(kg + s_list[a]) * CP + kk) * DP +
                            d0 + cu * 4
                      : w,
                   ok);
      }
    };

#pragma unroll
    for (int s = 0; s < F_STAGES - 1; ++s) {
      if (s < nst) load(s, s);
      cp_async_commit();
    }
    for (int s = 0; s < nst; ++s) {
      cp_async_wait<F_STAGES - 2>();
      __syncthreads();               // stage s landed; s - 1 is consumed
      if (s + F_STAGES - 1 < nst)
        load(s + F_STAGES - 1, (s + F_STAGES - 1) % F_STAGES);
      cp_async_commit();

      const int buf = s % F_STAGES;
      const float* as = s_a + buf * MT * F_A_LD;
      const float* ws = s_w + buf * F_KS * W_LD;
      const int ksteps = (min(F_KS, acols - s * F_KS) + 7) >> 3;
#pragma unroll
      for (int ks = 0; ks < F_KS / 8; ++ks) {
        if (ks >= ksteps) break;
        uint32_t ab[2][4], asm_[2][4];       // A's big and small parts
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const float* ar =
              as + (warp * 32 + mt * 16 + g) * F_A_LD + ks * 8 + t;
          split_tf32(ar[0], ab[mt][0], asm_[mt][0]);
          split_tf32(ar[8 * F_A_LD], ab[mt][1], asm_[mt][1]);
          split_tf32(ar[4], ab[mt][2], asm_[mt][2]);
          split_tf32(ar[8 * F_A_LD + 4], ab[mt][3], asm_[mt][3]);
        }
        const float* wr = ws + (ks * 8 + t) * W_LD + g;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          uint32_t bb[2], bs[2];
          split_tf32(wr[nt * 8], bb[0], bs[0]);
          split_tf32(wr[4 * W_LD + nt * 8], bb[1], bs[1]);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            float p[4] = {0.f, 0.f, 0.f, 0.f};
            mma_tf32(p, asm_[mt], bb[0], bb[1]);
            mma_tf32(p, ab[mt], bs[0], bs[1]);
            mma_tf32(p, ab[mt], bb[0], bb[1]);
            // compensated sum over the k8 steps (Kahan): the rounding of
            // acc + p is carried to the next step
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float y = p[i] - cmp[mt][nt][i];
              const float tt = acc[mt][nt][i] + y;
              cmp[mt][nt][i] = (tt - acc[mt][nt][i]) - y;
              acc[mt][nt][i] = tt;
            }
          }
        }
      }
    }
    cp_async_wait<0>();
  }
  if (!any) {                            // no tap found: zeros
    zero_tile(o, rows, D, cols);
    return;
  }
  __syncthreads();                       // the last stage is consumed
  store_tile<NT>(acc, reinterpret_cast<float*>(smem), o, rows, D, cols);
}

// Allows `kernel` the dynamic shared memory it asks for, all of the SM's
// memory to shared, once per instantiation.
template <typename Kernel>
cudaError_t configure(Kernel kernel, size_t smem, bool& configured) {
  if (configured) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess) configured = true;
  return e;
}

template <int NT>
cudaError_t launch_mma(const void* feat, const void* tap_idx,
                       const void* found, const void* w, void* out, int B,
                       int N, int Q, int K, int C, int cp_shift, int D,
                       int a_mode, cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<NT>();
  static bool configured = false;
  cudaError_t e = configure(gather_gemm_mma_kernel<NT>, smem, configured);
  if (e != cudaSuccess) return e;
  const unsigned blocks = (unsigned)(((long long)B * Q + MT - 1) / MT);
  gather_gemm_mma_kernel<NT><<<blocks, MMA_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(feat),
      static_cast<const int32_t*>(tap_idx),
      static_cast<const uint8_t*>(found),
      static_cast<const __nv_bfloat16*>(w), static_cast<float*>(out), B, N, Q,
      K, C, cp_shift, D, a_mode);
  return cudaGetLastError();
}

// NT n-tiles a block, DP / (8 NT) blocks across the columns of a tile.
template <int NT>
cudaError_t launch_tf32(const void* feat, const void* tap_idx,
                        const void* found, const void* w, void* out, int B,
                        int N, int Q, int K, int C, int cp_shift, int D,
                        int DP, int a_mode, cudaStream_t stream) {
  constexpr size_t smem = tf32_smem_bytes<NT>();
  static bool configured = false;
  cudaError_t e = configure(gather_gemm_tf32_kernel<NT>, smem, configured);
  if (e != cudaSuccess) return e;
  const dim3 blocks((unsigned)(((long long)B * Q + MT - 1) / MT),
                    (unsigned)((DP + NT * 8 - 1) / (NT * 8)));
  gather_gemm_tf32_kernel<NT><<<blocks, MMA_THREADS, smem, stream>>>(
      static_cast<const float*>(feat), static_cast<const int32_t*>(tap_idx),
      static_cast<const uint8_t*>(found), static_cast<const float*>(w),
      static_cast<float*>(out), B, N, Q, K, C, cp_shift, D, DP, a_mode);
  return cudaGetLastError();
}

bool widths_ok(const void* w, const void* out, int B, int N, int Q, int K,
               int C, int cp_shift, int D) {
  return C >= 1 && C <= 64 && D >= 1 && D <= 64 && K >= 1 && cp_shift >= 2 &&
         cp_shift <= 6 && (1 << cp_shift) >= C &&
         (long long)B * Q < (1LL << 31) && (long long)B * N < (1LL << 31) &&
         !((uintptr_t)w & 15) && !((uintptr_t)out & 15);
}

}  // namespace

// bf16 features [B, N, C] and packed weights [K, CP, DP] (CP = 1 << cp_shift
// in 4..64, at least C; DP = D rounded up to 8), K <= 32, tensor cores.
extern "C" int subm_gather_gemm_mma(const void* feat, const void* tap_idx,
                                    const void* found, const void* w,
                                    void* out, int B, int N, int Q, int K,
                                    int C, int cp_shift, int D, void* stream) {
  if (!widths_ok(w, out, B, N, Q, K, C, cp_shift, D) || K > KMAX)
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

// fp32 features [B, N, C] and packed fp32 weights [K, CP, DP] as for the
// bf16 entry, any number of taps; 3xTF32 on the tensor cores.
extern "C" int subm_gather_gemm_fma(const void* feat, const void* tap_idx,
                                    const void* found, const void* w,
                                    void* out, int B, int N, int Q, int K,
                                    int C, int cp_shift, int D, void* stream) {
  if (!widths_ok(w, out, B, N, Q, K, C, cp_shift, D))
    return (int)cudaErrorInvalidValue;
  if ((long long)B * Q == 0) return 0;
  const int a_mode =
      (C % 4 == 0 && !((uintptr_t)feat & 15)) ? A_CP16 : A_ELEM;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nt = (D + 7) / 8, DP = 8 * nt;
  // up to F_NT n-tiles a block; wider outputs split over blocks
  switch (nt < F_NT ? nt : F_NT) {
#define SUBM_TF32_CASE(n)                                                    \
  case n:                                                                    \
    return (int)launch_tf32<n>(feat, tap_idx, found, w, out, B, N, Q, K, C, \
                               cp_shift, D, DP, a_mode, s);
    SUBM_TF32_CASE(1)
    SUBM_TF32_CASE(2)
    SUBM_TF32_CASE(3)
    SUBM_TF32_CASE(4)
#undef SUBM_TF32_CASE
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* subm_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
