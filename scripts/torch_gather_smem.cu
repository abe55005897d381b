// Gather-to-shared-memory throughput on the card: the rows idx[i] of src
// (row_bytes each) into a ring of 64-row tiles in shared memory, by three
// methods: 16-byte cp.async per thread (mode 0), one cp.async.bulk per row
// completing on an mbarrier (mode 1), 16-byte vector loads into registers
// (mode 2). Built and driven by scripts/torch_gather_smem.py; it measures
// what bounds the sparse weight gradient's row gathers
// (second_tpu_torch/csrc/subm_grad.cu).
#include <cuda_runtime.h>
#include <stdint.h>
__device__ __forceinline__ uint32_t sa(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }
template <int N> __device__ __forceinline__ void wait_g() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }
__device__ __forceinline__ void mbar_init(uint64_t* b, int c) { asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(sa(b)), "r"(c) : "memory"); }
__device__ __forceinline__ void mbar_expect(uint64_t* b, int bytes) { asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(sa(b)), "r"(bytes) : "memory"); }
__device__ __forceinline__ void mbar_wait(uint64_t* b, int parity) {
  asm volatile("{\n.reg .pred p;\nW: mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n@!p bra W;\n}\n" ::"r"(sa(b)), "r"(parity) : "memory"); }
__device__ __forceinline__ void bulk(void* dst, const void* src, int bytes, uint64_t* b) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(sa(dst)), "l"(src), "r"(bytes), "r"(sa(b)) : "memory"); }

constexpr int TILE = 64;
template <int MODE, int STAGES>
__global__ void gbench(const char* __restrict__ src, const int* __restrict__ idx, int n, int rb, float* out) {
  extern __shared__ __align__(128) unsigned char sm[];
  __shared__ __align__(8) uint64_t bar[8];
  const int tiles = (n + TILE - 1) / TILE;
  const int per = rb / 16;
  float acc = 0.f;
  const int my = (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;   // tiles of this block
  auto tile_of = [&](int j) { return blockIdx.x + j * gridDim.x; };
  if (MODE == 1) {
    if (threadIdx.x == 0) for (int s = 0; s < STAGES; ++s) mbar_init(&bar[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    __syncthreads();
  }
  auto issue = [&](int j) {
    const int t = tile_of(j);
    unsigned char* st = sm + (j % STAGES) * TILE * rb;
    const int r0 = t * TILE;
    if (MODE == 0) {
      for (int w = threadIdx.x; w < TILE * per; w += blockDim.x) {
        const int r = w / per, u = w - r * per;
        const bool ok = r0 + r < n;
        const char* s = src + (ok ? (long long)idx[r0 + r] * rb + u * 16 : 0);
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(sa(st + r * rb + u * 16)), "l"(s), "r"(ok ? 16 : 0) : "memory");
      }
    } else {
      const int rows = min(TILE, n - r0);
      if (threadIdx.x == 0) mbar_expect(&bar[j % STAGES], rows * rb);
      __syncwarp();
      for (int r = threadIdx.x; r < rows; r += blockDim.x) bulk(st + r * rb, src + (long long)idx[r0 + r] * rb, rb, &bar[j % STAGES]);
    }
  };
  if (MODE == 2) {
    for (int j = 0; j < my; ++j) {
      const int r0 = tile_of(j) * TILE;
      for (int w = threadIdx.x; w < TILE * per; w += blockDim.x * 4) {
        uint4 v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) { const int ww = w + i * blockDim.x; const int r = ww / per, u = ww - r * per;
          v[i] = (ww < TILE * per && r0 + r < n) ? __ldg(reinterpret_cast<const uint4*>(src + (long long)idx[r0 + r] * rb + u * 16)) : make_uint4(0,0,0,0); }
#pragma unroll
        for (int i = 0; i < 4; ++i) acc += __int_as_float(v[i].x & 0x3f800000);
      }
    }
  } else {
    for (int j = 0; j < STAGES - 1; ++j) { if (j < my) issue(j); if (MODE == 0) asm volatile("cp.async.commit_group;\n" ::: "memory"); }
    for (int j = 0; j < my; ++j) {
      if (MODE == 0) { wait_g<STAGES - 2>(); } else { mbar_wait(&bar[j % STAGES], (j / STAGES) & 1); }
      __syncthreads();
      if (j + STAGES - 1 < my) issue(j + STAGES - 1);
      if (MODE == 0) asm volatile("cp.async.commit_group;\n" ::: "memory");
      const unsigned char* st = sm + (j % STAGES) * TILE * rb;
      if (threadIdx.x < TILE) acc += *reinterpret_cast<const float*>(st + threadIdx.x * rb);
    }
  }
  if (acc == 12345.f) out[0] = acc;
}

template <int MODE, int STAGES>
static int go(const void* src, const int* idx, int n, int rb, float* out, int blocks, int threads, void* s) {
  const int smem = MODE == 2 ? 0 : STAGES * TILE * rb;
  cudaFuncSetAttribute(gbench<MODE, STAGES>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  gbench<MODE, STAGES><<<blocks, threads, smem, (cudaStream_t)s>>>((const char*)src, idx, n, rb, out);
  return (int)cudaGetLastError();
}
extern "C" int gbench_run(int mode, int stages, const void* src, const int* idx, int n, int rb, float* out, int blocks, int threads, void* s) {
  if (mode == 0) return stages == 3 ? go<0, 3>(src, idx, n, rb, out, blocks, threads, s) : stages == 4 ? go<0, 4>(src, idx, n, rb, out, blocks, threads, s) : go<0, 8>(src, idx, n, rb, out, blocks, threads, s);
  if (mode == 1) return stages == 3 ? go<1, 3>(src, idx, n, rb, out, blocks, threads, s) : stages == 4 ? go<1, 4>(src, idx, n, rb, out, blocks, threads, s) : go<1, 8>(src, idx, n, rb, out, blocks, threads, s);
  return go<2, 1>(src, idx, n, rb, out, blocks, threads, s);
}
