// Row gather: out[m, :] = src[idx[m], :] over a batch-flattened source.
//
// Replaces: second_tpu/ops/pallas/gather.py `gather_rows_pallas` (kernel
// `_gather_kernel`), the DMA row gather behind `flat_rows`. The port uses it
// for the rulebook key checks, the active-set sorts and the prediction
// candidate gathers.
//
// Bound on the H100: bytes. A row gather does no arithmetic; it reads the
// indices and the referenced rows once and writes the output once, so its
// floor is (indices + rows read + rows written) / 3.35 TB/s. Rows are short
// (8 to 28 bytes on the fhd path) and the large calls (the rulebook key
// checks, 1.6-4.4 M indices) read 8-byte rows, so what limits it is how many
// narrow, dependent (index, then row) loads each SM keeps in flight.
//
// Design for Hopper:
//  * the index list is read as it comes, int32 or int64 (a template on the
//    index type), so no cast kernel runs before the gather;
//  * each thread moves units of the widest width (16, 8, 4, 2 or 1 bytes)
//    that divides the row and both base addresses, neighbouring threads on
//    neighbouring units of the output;
//  * a block takes chunks of rows whose units number at most UNITS_PER_CHUNK =
//    ILP x 256 (1024 rows of one unit, 146 rows of seven); inside a chunk all
//    arithmetic is 32-bit, and each thread first loads its ILP = 4 indices,
//    then the ILP rows they name, then stores them, so four independent
//    index-then-row loads are in flight per thread and a small call spreads
//    over as many blocks as its units allow;
//  * the grid is BLOCKS_PER_SM blocks on each SM (the SM count is queried once
//    per device) and strides over the chunks.
// An index outside [0, R) stops the kernel with a trap, which the next
// synchronisation reports, instead of reading out of bounds.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int ILP = 4;
constexpr int UNITS_PER_CHUNK = THREADS * ILP;
constexpr int BLOCKS_PER_SM = 2048 / THREADS;
constexpr int MAX_DEVICES = 64;

template <typename U, typename I>
__global__ void __launch_bounds__(THREADS)
    gather_rows_kernel(const U* __restrict__ src, const I* __restrict__ idx,
                       U* __restrict__ out, long long rows, int units,
                       int chunk_rows, long long src_rows) {
  const long long step = (long long)gridDim.x * chunk_rows;
  for (long long row0 = (long long)blockIdx.x * chunk_rows; row0 < rows;
       row0 += step) {
    // this chunk: n units of the output, 32-bit offsets from here on
    const int n =
        (int)(rows - row0 < chunk_rows ? rows - row0 : chunk_rows) * units;
    const I* ix = idx + row0;
    U* o = out + row0 * units;
    for (int e0 = threadIdx.x; e0 < n; e0 += THREADS * ILP) {
      I r[ILP];
      int u[ILP];
#pragma unroll
      for (int i = 0; i < ILP; ++i) {
        const int e = e0 + i * THREADS;
        r[i] = 0;
        u[i] = 0;
        if (e < n) {
          const int m = units == 1 ? e : e / units;
          u[i] = e - m * units;
          r[i] = __ldg(ix + m);
        }
      }
      U v[ILP];
#pragma unroll
      for (int i = 0; i < ILP; ++i) {
        if (e0 + i * THREADS < n) {
          if (r[i] < 0 || (long long)r[i] >= src_rows) __trap();
          v[i] = __ldg(src + (long long)r[i] * units + u[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < ILP; ++i) {
        const int e = e0 + i * THREADS;
        if (e < n) o[e] = v[i];
      }
    }
  }
}

int sm_count() {
  static int cached[MAX_DEVICES] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= MAX_DEVICES)
    dev = 0;
  if (!cached[dev]) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    cached[dev] = n > 0 ? n : 1;
  }
  return cached[dev];
}

template <typename U, typename I>
cudaError_t launch(const void* src, const void* idx, void* out,
                   long long rows, long long row_bytes, long long src_rows,
                   cudaStream_t stream) {
  const long long units = row_bytes / (long long)sizeof(U);
  if (units >= (1LL << 30)) return cudaErrorInvalidValue;
  // rows a chunk: its units fill the block's ILP slots once (one row at least)
  const int chunk_rows =
      units >= UNITS_PER_CHUNK ? 1 : UNITS_PER_CHUNK / (int)units;
  long long blocks = (rows + chunk_rows - 1) / chunk_rows;
  const long long most = (long long)sm_count() * BLOCKS_PER_SM;
  if (blocks > most) blocks = most;
  gather_rows_kernel<U, I><<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<const U*>(src), static_cast<const I*>(idx),
      static_cast<U*>(out), rows, (int)units, chunk_rows, src_rows);
  return cudaGetLastError();
}

template <typename I>
cudaError_t launch_unit(const void* src, const void* idx, void* out,
                        long long rows, long long row_bytes,
                        long long src_rows, cudaStream_t s) {
  // the widest unit dividing the row and both base addresses
  const unsigned long long mis = (unsigned long long)row_bytes |
                                 (unsigned long long)(uintptr_t)src |
                                 (unsigned long long)(uintptr_t)out;
#define GATHER_LAUNCH(U) \
  launch<U, I>(src, idx, out, rows, row_bytes, src_rows, s)
  if (!(mis & 15)) return GATHER_LAUNCH(uint4);
  if (!(mis & 7)) return GATHER_LAUNCH(uint2);
  if (!(mis & 3)) return GATHER_LAUNCH(uint32_t);
  if (!(mis & 1)) return GATHER_LAUNCH(uint16_t);
  return GATHER_LAUNCH(uint8_t);
#undef GATHER_LAUNCH
}

}  // namespace

// idx_bytes: 4 for int32 indices, 8 for int64.
extern "C" int gather_rows(const void* src, const void* idx, void* out,
                           long long rows, long long row_bytes,
                           long long src_rows, int idx_bytes, void* stream) {
  if (rows <= 0 || row_bytes <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (idx_bytes) {
    case 4:
      e = launch_unit<int>(src, idx, out, rows, row_bytes, src_rows, s);
      break;
    case 8:
      e = launch_unit<long long>(src, idx, out, rows, row_bytes, src_rows, s);
      break;
    default: e = cudaErrorInvalidValue;
  }
  return (int)e;
}

extern "C" const char* gather_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
