// Row gather: out[m, :] = src[idx[m], :] over a batch-flattened source.
//
// Replaces: second_tpu/ops/pallas/gather.py `gather_rows_pallas` (kernel
// `_gather_kernel`), the DMA row gather behind `flat_rows`. The port uses it
// for the rulebook key checks, the active-set sorts and the prediction
// candidate gathers.
//
// Bound on the H100: bytes. A row gather does no arithmetic; it reads the
// referenced rows and the indices once and writes the output once, so its
// floor is (rows read + indices + rows written) / 3.35 TB/s. Rows are short
// (8 to 28 bytes on the fhd path), so the risk is many narrow accesses.
//
// Design: each thread moves one unit of the widest width (16, 8, 4, 2 or 1
// bytes) that divides the row and the two base addresses, so a 16-byte row
// is one vectorised load and store per thread, and neighbouring threads
// touch neighbouring units of the output. A grid-stride loop covers any
// number of rows. An index outside [0, R) stops the kernel with a trap,
// which the next synchronisation reports, instead of reading out of bounds.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename U>
__global__ void gather_rows_kernel(const U* __restrict__ src,
                                   const int32_t* __restrict__ idx,
                                   U* __restrict__ out, long long rows,
                                   long long units, long long src_rows) {
  const long long total = rows * units;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += step) {
    const long long m = t / units;
    const long long u = t - m * units;
    const int32_t r = __ldg(idx + m);
    if (r < 0 || r >= src_rows) __trap();
    out[t] = src[(long long)r * units + u];
  }
}

template <typename U>
cudaError_t launch(const void* src, const int32_t* idx, void* out,
                   long long rows, long long row_bytes, long long src_rows,
                   cudaStream_t stream) {
  const long long units = row_bytes / (long long)sizeof(U);
  const long long total = rows * units;
  if (total == 0) return cudaSuccess;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;
  gather_rows_kernel<U><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const U*>(src), idx, static_cast<U*>(out), rows, units,
      src_rows);
  return cudaGetLastError();
}

}  // namespace

extern "C" int gather_rows(const void* src, const void* idx, void* out,
                           long long rows, long long row_bytes,
                           long long src_rows, int unit, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* ix = static_cast<const int32_t*>(idx);
  cudaError_t e;
  switch (unit) {
    case 16: e = launch<uint4>(src, ix, out, rows, row_bytes, src_rows, s); break;
    case 8: e = launch<uint2>(src, ix, out, rows, row_bytes, src_rows, s); break;
    case 4: e = launch<uint32_t>(src, ix, out, rows, row_bytes, src_rows, s); break;
    case 2: e = launch<uint16_t>(src, ix, out, rows, row_bytes, src_rows, s); break;
    case 1: e = launch<uint8_t>(src, ix, out, rows, row_bytes, src_rows, s); break;
    default: e = cudaErrorInvalidValue;
  }
  return (int)e;
}

extern "C" const char* gather_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
