// Row gather for Hopper (sm_90a): out[r] = src[idx[r]] for whole rows.
//
// Replaces gather_rows (_copy_kernel) of src/repro/kernels/sfc_gather.py,
// the paper's pack-by-index-list primitive: on the TPU the index list is a
// scalar-prefetch operand and each grid step DMAs one row of L elements.
// Here a row is L * itemsize bytes copied in units of 16, 8, 4, 2 or 1
// bytes (the widest that divides the row and both base addresses), and
// the R * units copies are spread flat over the grid, so neighbouring
// threads copy neighbouring units of one row, or of consecutive rows:
// loads and stores coalesce whenever a row is at least a few units long.
// A thread reads its row's index itself (no scalar prefetch on a GPU) and
// traps on an index outside [0, N), as the fused stencil kernel does on a
// table that does not fit its store. The kernel copies bytes, so one
// instance per unit width serves every dtype.
//
// What bounds it on an H100: bytes only. It reads R * L * itemsize bytes
// and 4 R bytes of indices and writes R * L * itemsize bytes, over
// 3.35 TB/s. At the distributed main path's shape (a deep face of the
// M=256, T=8 block store at h = 4: 4,096 rows for a k face, 8,192 for an
// i or j face, of 64 f32 each) that is at most 2 MiB each way, about
// 1.3 us: the launch itself (a few us) dominates, so the design spends
// nothing on staging, TMA or persistence.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 16;  // SMs x resident blocks; the rest loop

template <typename U>
__global__ void __launch_bounds__(THREADS)
gather_rows_kernel(const U* __restrict__ src, U* __restrict__ out,
                   const int* __restrict__ idx, int64_t n_rows, int64_t r_rows,
                   int64_t units) {
  const int64_t total = r_rows * units;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t r = i / units;
    const int64_t c = i - r * units;
    const int row = __ldg(idx + r);
    if (row < 0 || row >= n_rows) __trap();  // an index outside the source
    out[i] = src[static_cast<int64_t>(row) * units + c];
  }
}

template <typename U>
cudaError_t launch(const void* src, void* out, const int* idx, int64_t n_rows,
                   int64_t r_rows, int64_t row_bytes, cudaStream_t stream) {
  const int64_t units = row_bytes / static_cast<int64_t>(sizeof(U));
  const int64_t total = r_rows * units;
  const int64_t want = (total + THREADS - 1) / THREADS;
  const int blocks = static_cast<int>(want < MAX_BLOCKS ? want : MAX_BLOCKS);
  gather_rows_kernel<U><<<blocks, THREADS, 0, stream>>>(
      static_cast<const U*>(src), static_cast<U*>(out), idx, n_rows, r_rows,
      units);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// src (n_rows, row_bytes) bytes, idx int32 (r_rows,) -> out (r_rows,
// row_bytes). unit (16, 8, 4, 2 or 1) divides row_bytes and both base
// addresses; the caller picks it. r_rows >= 1.
int repro_gather_rows(const void* src, void* out, const void* idx,
                      int64_t n_rows, int64_t r_rows, int64_t row_bytes,
                      int unit, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto ix = static_cast<const int*>(idx);
  switch (unit) {
    case 16: return launch<uint4>(src, out, ix, n_rows, r_rows, row_bytes, st);
    case 8: return launch<uint2>(src, out, ix, n_rows, r_rows, row_bytes, st);
    case 4: return launch<uint32_t>(src, out, ix, n_rows, r_rows, row_bytes, st);
    case 2: return launch<uint16_t>(src, out, ix, n_rows, r_rows, row_bytes, st);
    case 1: return launch<uint8_t>(src, out, ix, n_rows, r_rows, row_bytes, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
