// Sparse-conv weight gradient: dW[k] = sum over (b, q) with found[b, k, q] of
// feat[b, tap_idx[b, k, q], :]^T dout[b, q, :], a [C, D] product per tap,
// fp32 sums.
//
// Replaces: nothing written by hand on the TPU. The JAX package's sparse
// convs apply the rulebook with an einsum (second_tpu/ops/sparse_conv.py
// :636-639 in subm_conv3d_b, :819-822 in sparse_conv3d_b) and XLA's autodiff
// of it gives the weight gradient; the Pallas apply
// (second_tpu/ops/pallas/subm.py `subm_conv3d_fused_pallas`) has no VJP. Its
// input gradient needs no kernel of its own: it is the forward gather-GEMM
// (csrc/subm.cu) applied to dout with the transposed rulebook.
//
// Bound on the H100: bytes. A train step of the fhd config (B = 4, Q up to
// 16 384, K = 27, C and D up to 64) must read, per conv, the [B, K, Q] found
// mask, the row index of each found tap, the feature rows and the dout rows
// those reference (4-15% of the taps are found) and write [K, C, D]: a few
// MB, about a microsecond at 3.35 TB/s. The products, 2 C D per found tap,
// are some 10 GFLOP over the 14 convs of a step, 10 us on the tensor cores.
//
// Design. A block owns one tap k and a chunk of the batch-flattened rows
// m = b*Q + q (a chunk may span examples), and walks the chunk in stages of
// 128 rows:
//  1. vote: each thread reads one row's found byte, and a stage where no row
//     found tap k is skipped at once (__syncthreads_or); a block whose every
//     stage was empty writes only its `used` flag 0 and ends;
//  2. gather: each thread copies its row's feature row and dout row into
//     shared memory by cp.async, zero-filled (src-size 0) where the row did
//     not find the tap and in the padded channels;
//  3. product: the stage's [C, 128] x [128, D] product is accumulated in
//     registers, fp32.
// Each block writes its [C, D] sum to partial[k, chunk] and sets used[k,
// chunk]; a second launch sums each tap's used partials in chunk order. The
// chunking depends only on the shapes and the card, and no sum uses atomics,
// so two runs give the same bits.
//
// Two paths, as the forward has:
//  * bf16 features and bf16 dout (the wrapper rounds dout to bf16, as the
//    input gradient's tensor-core path does): mma.sync.m16n8k16 bf16 with
//    fp32 accumulators. The A operand is the features transposed, read from
//    their [row][channel] tile by ldmatrix.trans; B is dout [row][d], read as
//    the forward reads W. Each of the 4 warps takes 32 rows of a stage (a
//    split of the reduction), and the warps' tiles are summed in warp order
//    through shared memory at the end. bf16 rather than tf32 m16n8k8: the
//    features are bf16 already, ldmatrix feeds bf16 fragments directly, and
//    rounding dout to bf16 is the rounding XLA's default precision makes of
//    an fp32 operand of a bf16 matrix product on the TPU; the weight
//    gradient of the bf16 path is rounded to bf16 afterwards anyway (the VJP
//    of the weights' cast).
//  * fp32 features and dout (the card-vs-CPU reference), on the CUDA cores:
//    stages of 64 rows in shared memory, each of 256 threads owning up to 16
//    of the C*D outputs.
// A simple design: one stage in flight (no ring), no wgmma or TMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int STAGE = 128;          // rows a stage (mma path; host's unit)
constexpr int MMA_THREADS = 128;    // 4 warps; thread t gathers row t
constexpr int FMA_STAGE = 64;
constexpr int FMA_THREADS = 256;
constexpr int FMA_OUT = 16;         // outputs a thread: 16 x 256 >= 64 x 64

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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
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

// d += a (16x16, row) @ b (16x8, col); bf16 inputs, fp32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The feature row of batch-flattened row m at tap k, or -1 where the row is
// past the chunk or did not find the tap.
__device__ __forceinline__ int tap_row(const int32_t* __restrict__ tap_idx,
                                       const uint8_t* __restrict__ found,
                                       int m, int m_end, int k, int N, int Q,
                                       int K) {
  if (m >= m_end) return -1;
  const int b = m / Q;
  const long long o = ((long long)b * K + k) * Q + (m - b * Q);
  if (!found[o]) return -1;
  const int t = __ldg(tap_idx + o);
  if (t < 0 || t >= N) __trap();
  return b * N + t;
}

// ------------------------------------------------------ bf16 tensor cores

// MTC: 16-channel tiles of C (CP = 16 MTC); NT: 8-column tiles of D, even
// (DP = 8 NT). Row strides padded by 16 bytes so ldmatrix reads no bank twice.
template <int MTC, int NT>
__global__ void __launch_bounds__(MMA_THREADS)
    wgrad_mma_kernel(const __nv_bfloat16* __restrict__ feat,
                     const int32_t* __restrict__ tap_idx,
                     const uint8_t* __restrict__ found,
                     const __nv_bfloat16* __restrict__ dout,
                     float* __restrict__ partial, uint8_t* __restrict__ used,
                     int B, int N, int Q, int K, int C, int D, int chunk_rows,
                     int f_vec, int g_vec) {
  constexpr int CP = MTC * 16, DP = NT * 8;
  constexpr int F_LD = CP + 8, G_LD = DP + 8, R_LD = DP + 4;
  constexpr int F_BYTES = STAGE * F_LD * 2, G_BYTES = STAGE * G_LD * 2;
  static_assert(CP * R_LD * 4 <= F_BYTES + G_BYTES,
                "the warps' sum fits where the stage was");
  __shared__ __align__(16) unsigned char smem[F_BYTES + G_BYTES];
  __nv_bfloat16* s_f = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* s_g = reinterpret_cast<__nv_bfloat16*>(smem + F_BYTES);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int k = blockIdx.y, chunk = blockIdx.x, chunks = gridDim.x;
  const int M = B * Q;
  const int m_begin = chunk * chunk_rows;
  const int m_end = min(M, m_begin + chunk_rows);

  float acc[MTC][NT][4];
#pragma unroll
  for (int i = 0; i < MTC; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  bool any_stage = false;
  for (int m0 = m_begin; m0 < m_end; m0 += STAGE) {
    const int m = m0 + tid;
    const int row = tap_row(tap_idx, found, m, m_end, k, N, Q, K);
    if (!__syncthreads_or(row >= 0)) continue;   // no row found tap k
    any_stage = true;

    // gather this thread's row: features [C] and dout [D], zero elsewhere
    __nv_bfloat16* fr = s_f + tid * F_LD;
    __nv_bfloat16* gr = s_g + tid * G_LD;
    if (f_vec) {
#pragma unroll
      for (int u = 0; u < CP / 8; ++u) {
        const bool ok = row >= 0 && u * 8 < C;
        cp_async16(fr + u * 8, ok ? feat + (long long)row * C + u * 8 : feat,
                   ok);
      }
    } else {
      for (int c = 0; c < CP; ++c)
        fr[c] = (row >= 0 && c < C) ? feat[(long long)row * C + c]
                                    : __float2bfloat16(0.f);
    }
    if (g_vec) {
#pragma unroll
      for (int u = 0; u < NT; ++u) {
        const bool ok = row >= 0 && u * 8 < D;
        cp_async16(gr + u * 8, ok ? dout + (long long)m * D + u * 8 : dout,
                   ok);
      }
    } else {
      for (int d = 0; d < DP; ++d)
        gr[d] = (row >= 0 && d < D) ? dout[(long long)m * D + d]
                                    : __float2bfloat16(0.f);
    }
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();

    // warp w reduces rows 32w .. 32w + 31, two k16 steps
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const int r0 = warp * 32 + ks * 16;
      uint32_t a[MTC][4];
#pragma unroll
      for (int ct = 0; ct < MTC; ++ct)   // A = features^T: [c][r] from [r][c]
        ldmatrix_x4_trans(a[ct], s_f + (r0 + ((lane >> 4) & 1) * 8 +
                                        (lane & 7)) * F_LD +
                                     ct * 16 + ((lane >> 3) & 1) * 8);
      const __nv_bfloat16* grow = s_g + (r0 + (lane & 15)) * G_LD;
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, grow + np * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int ct = 0; ct < MTC; ++ct) {
          mma_bf16(acc[ct][2 * np], a[ct], b[0], b[1]);
          mma_bf16(acc[ct][2 * np + 1], a[ct], b[2], b[3]);
        }
      }
    }
    __syncthreads();                      // the stage is consumed
  }

  const long long slot = (long long)k * chunks + chunk;
  if (!any_stage) {                       // uniform: every stage was empty
    if (tid == 0) used[slot] = 0;
    return;
  }
  // the 4 warps' [CP, DP] tiles summed in warp order, in shared memory
  float* s_r = reinterpret_cast<float*>(smem);
  for (int w = 0; w < 4; ++w) {
    if (warp == w) {
#pragma unroll
      for (int ct = 0; ct < MTC; ++ct)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int c = ct * 16 + (lane >> 2), d = nt * 8 + (lane & 3) * 2;
          float* p0 = s_r + c * R_LD + d;
          float* p1 = s_r + (c + 8) * R_LD + d;
          if (w == 0) {
            p0[0] = acc[ct][nt][0];
            p0[1] = acc[ct][nt][1];
            p1[0] = acc[ct][nt][2];
            p1[1] = acc[ct][nt][3];
          } else {
            p0[0] += acc[ct][nt][0];
            p0[1] += acc[ct][nt][1];
            p1[0] += acc[ct][nt][2];
            p1[1] += acc[ct][nt][3];
          }
        }
    }
    __syncthreads();
  }
  float* out = partial + slot * C * D;
  for (int i = tid; i < C * D; i += MMA_THREADS) {
    const int c = i / D;
    out[i] = s_r[c * R_LD + (i - c * D)];
  }
  if (tid == 0) used[slot] = 1;
}

// --------------------------------------------------------- fp32 CUDA cores

__global__ void __launch_bounds__(FMA_THREADS)
    wgrad_fma_kernel(const float* __restrict__ feat,
                     const int32_t* __restrict__ tap_idx,
                     const uint8_t* __restrict__ found,
                     const float* __restrict__ dout,
                     float* __restrict__ partial, uint8_t* __restrict__ used,
                     int B, int N, int Q, int K, int C, int D,
                     int chunk_rows) {
  __shared__ float s_f[FMA_STAGE][65];
  __shared__ float s_g[FMA_STAGE][64];
  __shared__ int s_row[FMA_STAGE];
  const int tid = threadIdx.x;
  const int k = blockIdx.y, chunk = blockIdx.x, chunks = gridDim.x;
  const int M = B * Q;
  const int m_begin = chunk * chunk_rows;
  const int m_end = min(M, m_begin + chunk_rows);
  const int CD = C * D;

  float acc[FMA_OUT];
  int oc[FMA_OUT], od[FMA_OUT];
#pragma unroll
  for (int j = 0; j < FMA_OUT; ++j) {
    const int e = min(tid + j * FMA_THREADS, CD - 1);
    oc[j] = e / D;
    od[j] = e - oc[j] * D;
    acc[j] = 0.f;
  }

  bool any_stage = false;
  for (int m0 = m_begin; m0 < m_end; m0 += FMA_STAGE) {
    int row = -1;
    if (tid < FMA_STAGE) {
      row = tap_row(tap_idx, found, m0 + tid, m_end, k, N, Q, K);
      s_row[tid] = row;
    }
    if (!__syncthreads_or(row >= 0)) continue;
    any_stage = true;
    for (int e = tid; e < FMA_STAGE * C; e += FMA_THREADS) {
      const int t = e / C, c = e - t * C;
      const int r = s_row[t];
      s_f[t][c] = r >= 0 ? feat[(long long)r * C + c] : 0.f;
    }
    for (int e = tid; e < FMA_STAGE * D; e += FMA_THREADS) {
      const int t = e / D, d = e - t * D;
      s_g[t][d] = s_row[t] >= 0 ? dout[(long long)(m0 + t) * D + d] : 0.f;
    }
    __syncthreads();
    for (int t = 0; t < FMA_STAGE; ++t) {
#pragma unroll
      for (int j = 0; j < FMA_OUT; ++j)
        acc[j] = fmaf(s_f[t][oc[j]], s_g[t][od[j]], acc[j]);
    }
    __syncthreads();
  }

  const long long slot = (long long)k * chunks + chunk;
  if (!any_stage) {
    if (tid == 0) used[slot] = 0;
    return;
  }
  float* out = partial + slot * CD;
#pragma unroll
  for (int j = 0; j < FMA_OUT; ++j) {
    const int e = tid + j * FMA_THREADS;
    if (e < CD) out[e] = acc[j];
  }
  if (tid == 0) used[slot] = 1;
}

// ------------------------------------------------- the fixed-order sum

__global__ void wgrad_sum_kernel(const float* __restrict__ partial,
                                 const uint8_t* __restrict__ used,
                                 float* __restrict__ dw, int K, int chunks,
                                 int CD) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)K * CD) return;
  const int k = (int)(i / CD);
  const int e = (int)(i - (long long)k * CD);
  float s = 0.f;
  for (int c = 0; c < chunks; ++c)
    if (used[(long long)k * chunks + c])
      s += partial[((long long)k * chunks + c) * CD + e];
  dw[i] = s;
}

template <int MTC, int NT>
cudaError_t launch_mma(dim3 grid, const void* feat, const void* tap_idx,
                       const void* found, const void* dout, void* partial,
                       void* used, int B, int N, int Q, int K, int C, int D,
                       int chunk_rows, int f_vec, int g_vec,
                       cudaStream_t stream) {
  wgrad_mma_kernel<MTC, NT><<<grid, MMA_THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(feat),
      static_cast<const int32_t*>(tap_idx),
      static_cast<const uint8_t*>(found),
      static_cast<const __nv_bfloat16*>(dout), static_cast<float*>(partial),
      static_cast<uint8_t*>(used), B, N, Q, K, C, D, chunk_rows, f_vec,
      g_vec);
  return cudaGetLastError();
}

template <int MTC>
cudaError_t launch_mma_nt(int nt, dim3 grid, const void* feat,
                          const void* tap_idx, const void* found,
                          const void* dout, void* partial, void* used, int B,
                          int N, int Q, int K, int C, int D, int chunk_rows,
                          int f_vec, int g_vec, cudaStream_t stream) {
  switch (nt) {
#define WGRAD_NT_CASE(n)                                                     \
  case n:                                                                    \
    return launch_mma<MTC, n>(grid, feat, tap_idx, found, dout, partial,     \
                              used, B, N, Q, K, C, D, chunk_rows, f_vec,     \
                              g_vec, stream);
    WGRAD_NT_CASE(2)
    WGRAD_NT_CASE(4)
    WGRAD_NT_CASE(6)
    WGRAD_NT_CASE(8)
#undef WGRAD_NT_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dW [K, C, D] fp32 of features [B, N, C] and dout [B, Q, D], both bf16
// (mma = 1, tensor cores) or both fp32 (mma = 0, CUDA cores), over the
// rulebook tap_idx/found [B, K, Q]. partial [K, chunks, C, D] fp32 and used
// [K, chunks] bytes are scratch; chunk_rows (a multiple of 128) rows a
// block, chunks * chunk_rows >= B * Q.
extern "C" int subm_wgrad(int mma, const void* feat, const void* tap_idx,
                          const void* found, const void* dout, void* partial,
                          void* used, void* dw, int B, int N, int Q, int K,
                          int C, int D, int chunk_rows, int chunks,
                          void* stream) {
  const long long M = (long long)B * Q;
  if (C < 1 || C > 64 || D < 1 || D > 64 || K < 1 || K > 65535 ||
      chunk_rows < STAGE || chunk_rows % STAGE || chunks < 1 ||
      (long long)chunks * chunk_rows < M || M >= (1LL << 31) ||
      (long long)B * N >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(chunks, K);
  cudaError_t e;
  if (mma) {
    // 16-byte copies where the rows are whole 16-byte units and aligned
    const int f_vec = C % 8 == 0 && !((uintptr_t)feat & 15);
    const int g_vec = D % 8 == 0 && !((uintptr_t)dout & 15);
    const int nt = (D + 15) / 16 * 2;
    const int mtc = (C + 15) / 16;
    if (mtc == 1)
      e = launch_mma_nt<1>(nt, grid, feat, tap_idx, found, dout, partial,
                           used, B, N, Q, K, C, D, chunk_rows, f_vec, g_vec,
                           s);
    else if (mtc == 2)
      e = launch_mma_nt<2>(nt, grid, feat, tap_idx, found, dout, partial,
                           used, B, N, Q, K, C, D, chunk_rows, f_vec, g_vec,
                           s);
    else
      e = launch_mma_nt<4>(nt, grid, feat, tap_idx, found, dout, partial,
                           used, B, N, Q, K, C, D, chunk_rows, f_vec, g_vec,
                           s);
  } else {
    wgrad_fma_kernel<<<grid, FMA_THREADS, 0, s>>>(
        static_cast<const float*>(feat), static_cast<const int32_t*>(tap_idx),
        static_cast<const uint8_t*>(found), static_cast<const float*>(dout),
        static_cast<float*>(partial), static_cast<uint8_t*>(used), B, N, Q, K,
        C, D, chunk_rows);
    e = cudaGetLastError();
  }
  if (e != cudaSuccess) return (int)e;
  const long long total = (long long)K * C * D;
  wgrad_sum_kernel<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(partial), static_cast<const uint8_t*>(used),
      static_cast<float*>(dw), K, chunks, C * D);
  return (int)cudaGetLastError();
}

extern "C" const char* subm_grad_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
