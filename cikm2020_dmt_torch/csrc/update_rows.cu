// Row write in place: table[ids[i], :] = rows[i, :] for unique ids; ids
// below 0 or at least R are dropped.
//
// Replaces two TPU kernels: cikm2020_dmt_tpu/ops/scatter_rows.py
// `_update_rows_kernel` (via `update_rows`, the lazy-Adam table write-back)
// and scripts/probe_mv3d_tpu.py `_kernel` (via `update_rows_3d`, the write
// into the stacked [2, R, D] moment tensor).  The port's wrapper launches
// this one kernel for both: the [2, R, D] moments are contiguous, so their
// rows are the rows of a free [2R, D] view with flat ids in [0, 2R).
// Writing in place (the TPU kernels alias the table in and out) is the
// port's choice to save memory: the 5M-row table and its moments are never
// copied.  Any element size of 2 or 4 bytes (bfloat16, float32) and any D.
//
// Bound: bytes.  At the flagship step the table write is handed 4U =
// 113,664 bf16 rows of 64 B (28,416 groups of 4; each written row is read
// from rows and written to the table) and the moment write twice as many
// float32 rows of 128 B; only the rows of groups the batch touched are in
// range, so the bytes depend on the batch (chip_smoke.py counts them).
//
// Design: one thread per element, neighbouring threads on neighbouring
// columns of one row, so each row is one coalesced read and write.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

template <typename T>
__global__ void update_rows_kernel(T* __restrict__ table, int64_t R, int D,
                                   const int64_t* __restrict__ ids,
                                   const T* __restrict__ rows, int64_t n) {
  const int64_t idx =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n * D) return;
  const int64_t i = idx / D;
  const int64_t id = ids[i];
  if (id < 0 || id >= R) return;
  table[id * D + idx % D] = rows[idx];
}

}  // namespace

extern "C" {

// table [R, D] and rows [n, D] of `elem_bytes` (2 or 4) bytes per element,
// ids int64 [n].  Launches on `stream`; returns the CUDA error code.
int update_rows(void* table, int64_t R, int D, int elem_bytes,
                const void* ids, const void* rows, int64_t n, void* stream) {
  if (n == 0 || D == 0) return 0;
  const int threads = 256;
  const int64_t blocks = (n * D + threads - 1) / threads;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* id = static_cast<const int64_t*>(ids);
  if (elem_bytes == 2) {
    update_rows_kernel<<<blocks, threads, 0, s>>>(
        static_cast<uint16_t*>(table), R, D, id,
        static_cast<const uint16_t*>(rows), n);
  } else if (elem_bytes == 4) {
    update_rows_kernel<<<blocks, threads, 0, s>>>(
        static_cast<uint32_t*>(table), R, D, id,
        static_cast<const uint32_t*>(rows), n);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* update_rows_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
