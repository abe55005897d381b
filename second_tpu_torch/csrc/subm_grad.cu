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
// Bound on the H100: bytes, and in practice the rate of gathered rows. A
// train step of the fhd config (B = 4, Q up to 16 384, K = 27, C and D up to
// 64) must read, per conv, the [B, K, Q] found mask, the row index of each
// found tap, the feature and dout rows those reference and write [K, C, D]:
// a few MB, about a microsecond at 3.35 TB/s. The products, 2 C D per found
// tap, are some 10 GFLOP over the 14 convs of a step, 10 us on the tensor
// cores. But a block that owns one tap gathers one feature row and one dout
// row for every found (tap, row) pair: 8-35% of the pairs are found in a
// train step, 0.56 GB of 32- to 128-byte rows a step, mostly from L2, and
// rows that narrow reach shared memory at 1.1-2.5 TB/s on this card
// (scripts/torch_gather_smem.py), whatever the copy: 16-byte cp.async, one
// cp.async.bulk a row, or vector loads.
//
// Design (one launch a call). A block owns one tap k and a chunk of the
// batch-flattened rows m = b*Q + q (a chunk may span examples). The
// chunking depends on the shapes and the card only (ops/cuda/subm.py
// wgrad_chunks): about two waves of three 256-thread blocks an SM, so
// that the card's block scheduler evens out taps that find many more rows
// than others. The grid's rows take the taps centre out (the centre tap of
// a submanifold conv finds every active row, its face neighbours the most
// after it) and its columns the chunks, so the heaviest blocks are
// dispatched first and the lighter ones fill in behind them.
//  1. Compaction: each scan step covers WIN = 2048 rows, 8 a thread, whose
//     found bytes come by one 8-byte load where they are aligned and within
//     one example (byte by byte at the ragged ends: the segment
//     found[b, k, :] starts 8-byte aligned only where Q is a multiple of 8),
//     two steps ahead of their use. A block-wide prefix of the per-thread
//     counts (warp shuffles, then the warps' totals) appends the step's
//     found rows to a list in shared memory, in row order, and each thread
//     at once starts a 4-byte cp.async of tap_idx for the rows it listed,
//     so tap_idx is read for found rows only and its latency overlaps the
//     next steps. Steps are appended until the list (2048 rows) would
//     overflow; then the list is multiplied (2.) and the step is taken
//     again. A block whose chunk found nothing writes only its `used` flag 0.
//  2. Ring: the listed rows go to the tensor cores in dense tiles of 64
//     rows (128 where C <= 16), not in fixed row ranges that are mostly
//     zero fill. A ring of 3 or 4 stages in dynamic shared memory ([tile,
//     CP] features and [tile, DP] dout a stage, 4 stages where they fit in
//     56 KB) is filled by cp.async (16 bytes a copy where the rows allow, 8
//     or 4 otherwise, element by element for odd bf16 widths); the copies
//     of the next stages - 1 tiles are in flight while a tile is multiplied
//     (cp.async.wait_group stages - 2). Hopper's TMA cannot gather rows, and
//     a bulk copy a row gathers no faster, so cp.async is the tool here.
//     Rows past the list's end are zero-filled (src-size 0); padded channels
//     are zeroed once when the block starts. About 72 KB of shared memory
//     and 80 registers a thread: three blocks an SM.
//  3. Product, two paths as the forward has:
//     * bf16 features and bf16 dout (the wrapper rounds dout to bf16, as the
//       input gradient's tensor-core path does): mma.sync.m16n8k16 bf16
//       with fp32 accumulators. A = features^T, read from the [row][channel]
//       tile by ldmatrix.trans; B = dout [row][d], by ldmatrix.trans. Each of
//       the 8 warps owns one 16-channel tile of C and a share of the tile's
//       rows (at most 32 accumulators a thread); the row shares' [C, D]
//       tiles are summed in warp order at the end. mma.sync rather than
//       wgmma: wgmma's tile has M = 64 output rows, which the 16- and
//       32-channel convs would pad, and the products are a small share of
//       the time. Row strides are padded by 16 bytes so ldmatrix reads no
//       bank twice. bf16 rather than tf32: the features are bf16 already,
//       and rounding dout to bf16 is the rounding XLA's default precision
//       makes of an fp32 operand of a bf16 product on the TPU; the gradient
//       of the bf16 path is rounded to bf16 afterwards anyway (the VJP of the
//       weights' cast).
//     * fp32 features and dout (the card-vs-CPU reference): the same
//       compaction and ring, then fp32 FMAs on the CUDA cores, each thread
//       owning up to 16 of the C*D outputs.
//  4. The sum over chunks, in the same launch and without atomics in any
//     sum: each block writes its [C, D] sum to partial[k, chunk] and its
//     used flag, fences, and takes a ticket from its group's counter (groups
//     of 8 consecutive chunks); the block that takes the group's last ticket
//     sums the group's used partials in chunk order, then takes a ticket
//     from the tap's counter; the last group sums the groups' sums in group
//     order into dW[k]. Each summing block resets its counter to 0 for the
//     next call. Which block sums may change from run to run, the order of
//     the sums does not, so two runs give the same bits. With one chunk a
//     tap the block writes dW[k] itself.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdlib.h>

namespace {

constexpr int THREADS = 256;               // 8 warps, both paths
constexpr int WARPS = THREADS / 32;
constexpr int SCAN_ROWS = 8;               // found bytes a thread scans
constexpr int WIN = THREADS * SCAN_ROWS;   // rows a window: 2048
constexpr int RING_BYTES = 56 * 1024;      // 4 stages where they fit, else 3
constexpr int MAX_CHUNKS = WIN;            // the last block lists the used flags
constexpr int GROUP = 8;                   // chunks a group of the sum
constexpr int MAX_ORDERED_TAPS = 64;       // taps the grid can reorder

struct Args {
  const void* feat;
  const int32_t* tap_idx;
  const uint8_t* found;
  const void* dout;
  float* partial;      // [K, chunks, C, D] scratch
  int32_t* used;       // [K, chunks] scratch
  float* gpartial;     // [K, groups, C, D] scratch
  int32_t* gused;      // [K, groups] scratch
  int32_t* counter;    // [K, groups + 1] tickets, 0 between calls
  float* dw;           // [K, C, D]
  int B, N, Q, K, C, D;
  int chunk_rows, stages;
  int tap_order[MAX_ORDERED_TAPS];  // the tap of each grid row, K <= 64
  int f_unit, g_unit;  // bytes a copy of a feature / dout row: 16, 8, 4, 2
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// copies `unit` bytes (16, 8 or 4) global -> shared, zeros where !ok
__device__ __forceinline__ void cp_async(void* dst, const void* src, int unit,
                                         bool ok) {
  const uint32_t d = smem_addr(dst);
  const int n = ok ? unit : 0;
  if (unit == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(n)
                 : "memory");
  else if (unit == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
                 "l"(src), "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(n)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

template <class T>
__device__ __forceinline__ T zero_of();
template <>
__device__ __forceinline__ float zero_of<float>() {
  return 0.f;
}
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// ------------------------------------------------------------ compaction

// The found bytes of tap k for the batch-flattened rows m .. m + 7, 0 from
// m_end on: one 8-byte load where they are aligned and within one example
// (the load stays in flight until the bytes are used), byte by byte at the
// ragged ends (found[b, k, :] starts 8-byte aligned only where Q is a
// multiple of 8).
__device__ __forceinline__ uint2 load_found(const uint8_t* __restrict__ found,
                                            int m, int m_end, int k, int Q,
                                            int K) {
  if (m >= m_end) return make_uint2(0, 0);
  int b = m / Q, q = m - b * Q;
  const uint8_t* p = found + ((long long)b * K + k) * Q + q;
  if (m + SCAN_ROWS <= m_end && q + SCAN_ROWS <= Q &&
      !(reinterpret_cast<uintptr_t>(p) & 7))
    return __ldg(reinterpret_cast<const uint2*>(p));
  uint32_t w[2] = {0, 0};
  const int n = min(SCAN_ROWS, m_end - m);
  for (int i = 0; i < n; ++i) {
    if (__ldg(p)) w[i >> 2] |= 1u << (8 * (i & 3));
    if (++q == Q) {
      q = 0;
      ++b;
      p = found + ((long long)b * K + k) * Q;
    } else {
      ++p;
    }
  }
  return make_uint2(w[0], w[1]);
}

// bit i set where byte i of the 8 is nonzero
__device__ __forceinline__ uint32_t found_bits(uint2 v) {
  const uint32_t w[2] = {v.x, v.y};
  uint32_t bits = 0;
#pragma unroll
  for (int i = 0; i < SCAN_ROWS; ++i)
    if ((w[i >> 2] >> (8 * (i & 3))) & 0xffu) bits |= 1u << i;
  return bits;
}

// Block-wide exclusive prefix of the threads' counts: this thread's offset
// and the total (the same in every thread); one barrier.
__device__ __forceinline__ void block_prefix(int cnt, int* s_warp, int& pos,
                                             int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = cnt;                            // inclusive prefix in the warp
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  pos = x - cnt;
  total = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const int v = s_warp[w];
    if (w < warp) pos += v;
    total += v;
  }
}

// Copies the rows idx[i0 .. i0 + TILE) (zeros from i = n on) of src [*,
// width] into a [TILE, ld_bytes] stage.
template <int TILE, class T>
__device__ __forceinline__ void issue_rows(unsigned char* dst, int ld_bytes,
                                           const T* __restrict__ src,
                                           int width, int unit,
                                           const int* idx, int i0, int n) {
  const int row_bytes = width * (int)sizeof(T);
  if (unit >= 4) {
    const int per = row_bytes / unit;
    for (int w = threadIdx.x; w < TILE * per; w += THREADS) {
      const int r = w / per, u = w - r * per;
      const bool ok = i0 + r < n;
      const char* s = reinterpret_cast<const char*>(src) +
                      (ok ? (long long)idx[i0 + r] * row_bytes + u * unit : 0);
      cp_async(dst + r * ld_bytes + u * unit, s, unit, ok);
    }
  } else {
    T* d = reinterpret_cast<T*>(dst);
    const int ld = ld_bytes / (int)sizeof(T);
    for (int w = threadIdx.x; w < TILE * width; w += THREADS) {
      const int r = w / width, c = w - r * width;
      d[r * ld + c] = i0 + r < n ? src[(long long)idx[i0 + r] * width + c]
                                 : zero_of<T>();
    }
  }
}

// ------------------------------------------------------- bf16 tensor cores

// MTC: 16-channel tiles of C (CP = 16 MTC, MTC in {1, 2, 4}); NT: 8-column
// tiles of D, even (DP = 8 NT). Each of the 8 warps owns one channel tile
// and a share of the tile's rows: 4 x 2 warps at MTC = 4 (32 rows a warp),
// 2 x 4 at MTC = 2 (16 rows), 1 x 8 at MTC = 1 with 128-row tiles (16 rows).
template <int MTC, int NT>
struct MmaPath {
  using T = __nv_bfloat16;
  static constexpr int MIN_BLOCKS = 3;
  static constexpr bool ZERO_RING = true;       // padded channels read as 0
  static constexpr int TILE = MTC == 1 ? 128 : 64;   // found rows a tile
  static constexpr int CP = MTC * 16, DP = NT * 8;
  static constexpr int F_LD = CP + 8, G_LD = DP + 8, R_LD = DP + 4;
  static constexpr int WK = WARPS / MTC;        // warps across rows
  static constexpr int RW = TILE / WK;          // rows a warp, a tile
  static_assert(RW % 16 == 0, "warp split");
  static_assert(CP * R_LD * 4 <= 3 * TILE * (F_LD + G_LD) * 2,
                "the warps' sum fits in the ring");

  __host__ __device__ static int f_ld_bytes(int) { return F_LD * 2; }
  __host__ __device__ static int g_ld_bytes(int) { return G_LD * 2; }
  __host__ __device__ static int stage_bytes(int C, int D) {
    return TILE * (f_ld_bytes(C) + g_ld_bytes(D));
  }

  float acc[NT][4];

  __device__ void init(int, int) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  }

  // the product of one stage, whose rows from `rows` on are zero
  __device__ void compute(const unsigned char* stage, int rows) {
    const T* sf = reinterpret_cast<const T*>(stage);
    const T* sg = sf + TILE * F_LD;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int ct = warp % MTC, wk = warp / MTC;
#pragma unroll
    for (int ks = 0; ks < RW / 16; ++ks) {
      const int r0 = wk * RW + ks * 16;
      if (r0 >= rows) break;               // uniform in the warp
      uint32_t a[4];                       // A = features^T from [r][c]
      ldmatrix_x4_trans(a, sf + (r0 + ((lane >> 4) & 1) * 8 + (lane & 7)) *
                                    F_LD +
                               ct * 16 + ((lane >> 3) & 1) * 8);
      const T* grow = sg + (r0 + (lane & 15)) * G_LD;
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, grow + np * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * np], a, b[0], b[1]);
        mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
      }
    }
  }

  // the block's [C, D] sum to dst: the row shares' tiles summed in warp
  // order through shared memory (the ring, drained)
  __device__ void finish(unsigned char* smem, float* dst, int C, int D) {
    float* s_r = reinterpret_cast<float*>(smem);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int ct = warp % MTC, wk = warp / MTC;
    for (int w = 0; w < WK; ++w) {
      if (wk == w) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int c = ct * 16 + (lane >> 2);
          const int d = nt * 8 + (lane & 3) * 2;
          float* p0 = s_r + c * R_LD + d;
          float* p1 = p0 + 8 * R_LD;
          if (w == 0) {
            p0[0] = acc[nt][0];
            p0[1] = acc[nt][1];
            p1[0] = acc[nt][2];
            p1[1] = acc[nt][3];
          } else {
            p0[0] += acc[nt][0];
            p0[1] += acc[nt][1];
            p1[0] += acc[nt][2];
            p1[1] += acc[nt][3];
          }
        }
      }
      __syncthreads();
    }
    for (int e = threadIdx.x; e < C * D; e += THREADS) {
      const int c = e / D;
      dst[e] = s_r[c * R_LD + (e - c * D)];
    }
  }
};

// --------------------------------------------------------- fp32 CUDA cores

struct FmaPath {
  using T = float;
  static constexpr int MIN_BLOCKS = 2;
  static constexpr bool ZERO_RING = false;  // only the real rows are read
  static constexpr int TILE = 64;           // found rows a tile
  static constexpr int J = 64 * 64 / THREADS;   // outputs a thread

  __host__ __device__ static int f_ld_bytes(int C) { return (C + 3) / 4 * 16; }
  __host__ __device__ static int g_ld_bytes(int D) { return (D + 3) / 4 * 16; }
  __host__ __device__ static int stage_bytes(int C, int D) {
    return TILE * (f_ld_bytes(C) + g_ld_bytes(D));
  }

  float acc[J];
  int of[J], og[J];     // the outputs' channel c and column d
  int fl, gl;           // row strides of the stage, floats

  __device__ void init(int C, int D) {
    fl = f_ld_bytes(C) / 4;
    gl = g_ld_bytes(D) / 4;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int e = min((int)threadIdx.x + j * THREADS, C * D - 1);
      of[j] = e / D;
      og[j] = e - of[j] * D;
      acc[j] = 0.f;
    }
  }

  __device__ void compute(const unsigned char* stage, int rows) {
    const float* sf = reinterpret_cast<const float*>(stage);
    const float* sg = sf + TILE * fl;
    for (int r = 0; r < rows; ++r) {
#pragma unroll
      for (int j = 0; j < J; ++j)
        acc[j] = fmaf(sf[r * fl + of[j]], sg[r * gl + og[j]], acc[j]);
    }
  }

  __device__ void finish(unsigned char*, float* dst, int C, int D) {
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int e = threadIdx.x + j * THREADS;
      if (e < C * D) dst[e] = acc[j];
    }
  }
};

// --------------------------------------------------- the sum over chunks

__device__ __forceinline__ void add(float& s, float x) { s += x; }
__device__ __forceinline__ void add(float4& s, const float4& x) {
  s.x += x.x;
  s.y += x.y;
  s.z += x.z;
  s.w += x.w;
}

template <class V>
__device__ __forceinline__ V vzero();
template <>
__device__ __forceinline__ float vzero<float>() {
  return 0.f;
}
template <>
__device__ __forceinline__ float4 vzero<float4>() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

// out[i] = the sum over the used chunks c of base[c * n + i], in an order
// fixed by n and chunks: where n < THREADS the block's threads form G groups
// that each sum a run of consecutive chunks in chunk order, and the groups'
// sums are added in group order (s_part holds them); else one group, J
// columns a thread. UNROLL chunks' loads are in flight at a time.
template <class V, int J, int UNROLL>
__device__ __forceinline__ void sum_chunks(const V* base, V* out, int n,
                                           int chunks, const int* s_used,
                                           V* s_part) {
  const int span = min(n, THREADS);       // threads a group
  const int G = max(1, min(THREADS / span, chunks));
  const int g = threadIdx.x / span, col = threadIdx.x - g * span;
  const int per = (chunks + G - 1) / G;
  const int c0 = g * per, c1 = min(chunks, c0 + per);
  V s[J];
#pragma unroll
  for (int j = 0; j < J; ++j) s[j] = vzero<V>();
  if (g < G) {
    for (int c = c0; c < c1; c += UNROLL) {
      V x[UNROLL][J];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const bool ok = c + u < c1 && s_used[c + u];
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int i = col + j * span;
          x[u][j] = ok && i < n ? __ldcg(base + (long long)(c + u) * n + i)
                                : vzero<V>();
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        if (c + u < c1 && s_used[c + u])
#pragma unroll
          for (int j = 0; j < J; ++j) add(s[j], x[u][j]);
    }
  }
  if (G == 1) {
    if (g == 0)
#pragma unroll
      for (int j = 0; j < J; ++j)
        if (col + j * span < n) out[col + j * span] = s[j];
    return;
  }
  if (g < G) s_part[g * n + col] = s[0];   // n < THREADS: one column
  __syncthreads();
  if (g == 0) {
    V t = s_part[col];
    for (int h = 1; h < G; ++h) add(t, s_part[h * n + col]);
    out[col] = t;
  }
}

// Whether this block is the last of `count` to take a ticket from `ticket`
// (the same in every thread): what the block wrote before is fenced first,
// and after a last ticket every other block's writes are visible.
__device__ __forceinline__ bool last_to_arrive(int* ticket, int count,
                                               int* s_flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *s_flag = atomicAdd(ticket, 1) == count - 1;
  __syncthreads();
  const bool last = *s_flag;
  if (last) __threadfence();
  return last;
}

// out = the sum of the used ones of n [C, D] partials at base (used flags
// at used), in a fixed order (sum_chunks); whether any was used. s_used and
// s_part are shared scratch of n ints and THREADS float4s.
__device__ __forceinline__ bool sum_partials(const float* base,
                                             const int32_t* used, int n,
                                             int CD, float* out, int* s_used,
                                             int* s_part) {
  for (int c = threadIdx.x; c < n; c += THREADS) s_used[c] = __ldcg(used + c);
  __syncthreads();
  if (CD % 4 == 0) {
    const float4* b4 = reinterpret_cast<const float4*>(base);
    float4* o4 = reinterpret_cast<float4*>(out);
    float4* part = reinterpret_cast<float4*>(s_part);
    if (CD / 4 > THREADS)
      sum_chunks<float4, 64 * 64 / 4 / THREADS, 4>(b4, o4, CD / 4, n, s_used,
                                                   part);
    else
      sum_chunks<float4, 1, 8>(b4, o4, CD / 4, n, s_used, part);
  } else {
    float* part = reinterpret_cast<float*>(s_part);
    if (CD > THREADS)
      sum_chunks<float, 64 * 64 / THREADS, 1>(base, out, CD, n, s_used, part);
    else
      sum_chunks<float, 1, 8>(base, out, CD, n, s_used, part);
  }
  bool any = false;
  for (int c = 0; c < n; ++c) any |= s_used[c] != 0;
  __syncthreads();                        // s_used and s_part free again
  return any;
}

// ------------------------------------------------------------- the kernel

template <class P>
__global__ void __launch_bounds__(THREADS, P::MIN_BLOCKS)
    wgrad_kernel(const Args a) {
  using T = typename P::T;
  constexpr int TILE = P::TILE;
  extern __shared__ __align__(16) unsigned char smem[];
  const int stage_bytes = P::stage_bytes(a.C, a.D);
  const int f_ld = P::f_ld_bytes(a.C), g_ld = P::g_ld_bytes(a.D);
  unsigned char* ring = smem;
  int* s_m = reinterpret_cast<int*>(smem + a.stages * stage_bytes);
  int* s_row = s_m + WIN;
  int* s_warp = s_row + WIN;              // WARPS totals, then a flag
  const T* feat = static_cast<const T*>(a.feat);
  const T* dout = static_cast<const T*>(a.dout);

  const int tid = threadIdx.x;
  const int chunk = blockIdx.x, chunks = gridDim.x;
  const int k = a.K <= MAX_ORDERED_TAPS ? a.tap_order[blockIdx.y] : blockIdx.y;
  const int m_begin = chunk * a.chunk_rows;
  const int m_end = min(a.B * a.Q, m_begin + a.chunk_rows);

  P path;
  path.init(a.C, a.D);
  if (P::ZERO_RING)
    for (int i = tid; i < a.stages * stage_bytes / 16; i += THREADS)
      reinterpret_cast<uint4*>(ring)[i] = make_uint4(0, 0, 0, 0);

  // the found bytes of the next two scan steps are in flight ahead of
  // their prefix; a step lists its found rows after those already listed,
  // until the list would overflow: then the list is processed and the step
  // is taken again into an empty list
  uint2 f0 = load_found(a.found, m_begin + tid * SCAN_ROWS, m_end, k, a.Q,
                        a.K);
  uint2 f1 = load_found(a.found, m_begin + WIN + tid * SCAN_ROWS, m_end, k,
                        a.Q, a.K);
  int next = m_begin;                     // the first row not listed yet
  bool any = false;                       // the same in every thread
  while (next < m_end) {
    int n = 0;
    while (next < m_end) {
      uint32_t bits = found_bits(f0);
      int pos, total;
      block_prefix(__popc(bits), s_warp, pos, total);
      if (n + total > WIN) break;         // uniform
      const int m = next + tid * SCAN_ROWS;
      pos += n;
      while (bits) {                      // list the row, fetch its tap_idx
        const int r = m + __ffs(bits) - 1, b = r / a.Q;
        bits &= bits - 1;
        s_m[pos] = r;
        cp_async(s_row + pos++,
                 a.tap_idx + ((long long)b * a.K + k) * a.Q + (r - b * a.Q),
                 4, true);
      }
      n += total;
      next = min(m_end, next + WIN);
      f0 = f1;
      f1 = load_found(a.found, next + WIN + tid * SCAN_ROWS, m_end, k, a.Q,
                      a.K);
      __syncthreads();                    // s_m listed, s_warp free
    }
    if (n == 0) continue;
    any = true;
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int i = tid; i < n; i += THREADS) {   // tap_idx -> feature row
      const int b = s_m[i] / a.Q, t = s_row[i];
      if (t < 0 || t >= a.N) __trap();
      s_row[i] = b * a.N + t;
    }
    __syncthreads();

    const int tiles = (n + TILE - 1) / TILE;
    auto issue = [&](int t) {
      unsigned char* st = ring + (t % a.stages) * stage_bytes;
      issue_rows<TILE>(st, f_ld, feat, a.C, a.f_unit, s_row, t * TILE, n);
      issue_rows<TILE>(st + TILE * f_ld, g_ld, dout, a.D, a.g_unit, s_m,
                       t * TILE, n);
    };
    for (int t = 0; t < a.stages - 1; ++t) {
      if (t < tiles) issue(t);
      cp_async_commit();
    }
    for (int t = 0; t < tiles; ++t) {
      if (a.stages == 4)                  // tile t has landed
        cp_async_wait<2>();
      else
        cp_async_wait<1>();
      __syncthreads();                    // ... for every thread; t - 1 done
      if (t + a.stages - 1 < tiles) issue(t + a.stages - 1);
      cp_async_commit();
      path.compute(ring + (t % a.stages) * stage_bytes,
                   min(TILE, n - t * TILE));
    }
    cp_async_wait<0>();
    __syncthreads();                      // the lists and the ring are free
  }

  const int CD = a.C * a.D;
  if (chunks == 1) {                      // the block is the tap's sum
    float* dst = a.dw + (long long)k * CD;
    if (any)
      path.finish(smem, dst, a.C, a.D);
    else
      for (int e = tid; e < CD; e += THREADS) dst[e] = 0.f;
    return;
  }
  if (any) path.finish(smem, a.partial + ((long long)k * chunks + chunk) * CD,
                       a.C, a.D);
  if (tid == 0) a.used[k * chunks + chunk] = any;

  // the last block of the chunk's group sums the group's partials in chunk
  // order into the group's partial; the last group of the tap sums the
  // groups' partials in group order into dW[k]
  const int groups = (chunks + GROUP - 1) / GROUP, g = chunk / GROUP;
  const int g0 = g * GROUP, gn = min(chunks, g0 + GROUP) - g0;
  int* tickets = a.counter + (long long)k * (groups + 1);
  if (!last_to_arrive(tickets + g, gn, s_warp + WARPS)) return;
  float* gsum = groups == 1 ? a.dw + (long long)k * CD
                            : a.gpartial + ((long long)k * groups + g) * CD;
  const bool used = sum_partials(a.partial + ((long long)k * chunks + g0) * CD,
                                 a.used + k * chunks + g0, gn, CD, gsum, s_m,
                                 s_row);
  if (tid == 0) tickets[g] = 0;           // ready for the next call
  if (groups == 1) return;
  if (tid == 0) a.gused[k * groups + g] = used;
  if (!last_to_arrive(tickets + groups, groups, s_warp + WARPS)) return;
  sum_partials(a.gpartial + (long long)k * groups * CD, a.gused + k * groups,
               groups, CD, a.dw + (long long)k * CD, s_m, s_row);
  if (tid == 0) tickets[groups] = 0;
}

template <class P>
cudaError_t launch(Args a, int chunks, cudaStream_t stream) {
  const int stage_bytes = P::stage_bytes(a.C, a.D);
  a.stages = 4 * stage_bytes <= RING_BYTES ? 4 : 3;
  const int smem =
      a.stages * stage_bytes + (2 * WIN + WARPS + 1) * (int)sizeof(int);
  static int configured = 0;              // bytes allowed so far
  if (smem > configured) {
    // above 48 KB only on request; all of the SM's memory to shared
    cudaError_t e = cudaFuncSetAttribute(
        wgrad_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(wgrad_kernel<P>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
    configured = smem;
  }
  wgrad_kernel<P><<<dim3(chunks, a.K), THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int MTC>
cudaError_t launch_mma(int nt, const Args& a, int chunks, cudaStream_t s) {
  switch (nt) {
    case 2:
      return launch<MmaPath<MTC, 2>>(a, chunks, s);
    case 4:
      return launch<MmaPath<MTC, 4>>(a, chunks, s);
    case 6:
      return launch<MmaPath<MTC, 6>>(a, chunks, s);
    case 8:
      return launch<MmaPath<MTC, 8>>(a, chunks, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// the widest copy (16, 8 or 4 bytes) that tiles a row and its alignment; 2
// (element by element) where none does
int copy_unit(int row_bytes, const void* p) {
  for (int u = 16; u >= 4; u /= 2)
    if (row_bytes % u == 0 && reinterpret_cast<uintptr_t>(p) % u == 0)
      return u;
  return 2;
}

}  // namespace

// dW [K, C, D] fp32 of features [B, N, C] and dout [B, Q, D], both bf16
// (mma = 1, tensor cores) or both fp32 (mma = 0, CUDA cores), over the
// rulebook tap_idx/found [B, K, Q]. partial [K, chunks, C, D] fp32, used
// [K, chunks] int32, gpartial [K, groups, C, D] fp32 and gused [K, groups]
// int32 (groups = ceil(chunks / 8)) are scratch; counter [K, groups + 1]
// int32 must be 0 and is left 0 (calls that share it run one after
// another, on one stream). chunk_rows (a multiple of 16) rows a block,
// chunks * chunk_rows >= B * Q.
extern "C" int subm_wgrad(int mma, const void* feat, const void* tap_idx,
                          const void* found, const void* dout, void* partial,
                          void* used, void* gpartial, void* gused,
                          void* counter, void* dw, int B, int N, int Q, int K,
                          int C, int D, int chunk_rows, int chunks,
                          void* stream) {
  const long long M = (long long)B * Q;
  if (C < 1 || C > 64 || D < 1 || D > 64 || K < 1 || K > 65535 ||
      chunk_rows < 16 || chunk_rows % 16 || chunks < 1 ||
      chunks > MAX_CHUNKS || chunks > 65535 ||
      (long long)chunks * chunk_rows < M ||
      (long long)chunks * chunk_rows + WIN >= (1LL << 31) ||
      (long long)B * N >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  Args a;
  a.feat = feat;
  a.tap_idx = static_cast<const int32_t*>(tap_idx);
  a.found = static_cast<const uint8_t*>(found);
  a.dout = dout;
  a.partial = static_cast<float*>(partial);
  a.used = static_cast<int32_t*>(used);
  a.gpartial = static_cast<float*>(gpartial);
  a.gused = static_cast<int32_t*>(gused);
  a.counter = static_cast<int32_t*>(counter);
  a.dw = static_cast<float*>(dw);
  a.B = B, a.N = N, a.Q = Q, a.K = K, a.C = C, a.D = D;
  a.chunk_rows = chunk_rows;
  // the grid's rows take the taps centre out (a submanifold conv's centre
  // tap finds every active row, its face neighbours the most after it), so
  // the heaviest blocks are dispatched first and the lighter ones fill in
  // behind them; the order changes no sum
  if (K <= MAX_ORDERED_TAPS) {
    int side = 1;
    while (side * side * side < K) ++side;
    const bool cube = side * side * side == K;
    int dist[MAX_ORDERED_TAPS];
    for (int k = 0; k < K; ++k) {
      const int c = (side - 1) / 2;
      dist[k] = cube ? abs(k / (side * side) - c) +
                           abs(k / side % side - c) + abs(k % side - c)
                     : abs(2 * k - (K - 1));
      a.tap_order[k] = k;
    }
    for (int i = 1; i < K; ++i)           // stable: ties keep tap order
      for (int j = i; j > 0 && dist[a.tap_order[j]] <
                                   dist[a.tap_order[j - 1]]; --j) {
        const int t = a.tap_order[j];
        a.tap_order[j] = a.tap_order[j - 1];
        a.tap_order[j - 1] = t;
      }
  }
  a.stages = 3;                           // set by launch<P>
  const int esz = mma ? 2 : 4;
  a.f_unit = copy_unit(C * esz, feat);
  a.g_unit = copy_unit(D * esz, dout);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!mma) return (int)launch<FmaPath>(a, chunks, s);
  const int nt = (D + 15) / 16 * 2;
  const cudaError_t e = C <= 16   ? launch_mma<1>(nt, a, chunks, s)
                        : C <= 32 ? launch_mma<2>(nt, a, chunks, s)
                                  : launch_mma<4>(nt, a, chunks, s);
  return (int)e;
}

extern "C" const char* subm_grad_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
