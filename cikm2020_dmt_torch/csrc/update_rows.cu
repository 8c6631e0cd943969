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
// 113,664 bf16 rows of 64 B and the moment write twice as many float32
// rows of 128 B; every id is read (8 B each), and only the rows of groups
// the batch touched are in range and read and written, so the bytes depend
// on the batch (chip_smoke.py counts them): ~2.4 us and ~8 us at 3.35 TB/s.
//
// Design: the work is a few bytes per row, so what costs is instructions
// per byte.  A row is copied by a group of L lanes (L a power of two, at
// most 32, the least that covers the row's vectors), so a warp copies
// 32 / L rows at once: the group's first lane loads the row's id once and
// hands it to the others by a shuffle, and each lane copies the row's
// vectors c, c + L, ... with the widest access the row allows, chosen once
// per launch on the host: 16 bytes (uint4) when the row's bytes and both
// base pointers are multiples of 16 (bf16 D=32: 4 lanes a row; f32 D=32:
// 8), else 4 bytes, else one element.  The vector width is a template
// parameter and the in-row arithmetic is 32-bit shifts and masks; the grid
// is sized from the row count, so no thread divides.  Rows whose id is out
// of range cost one id load.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// V is the unit of access (uint4, uint32_t or uint16_t); vpr the units in a
// row; lanes per row 1 << lshift.
template <typename V>
__global__ void __launch_bounds__(kThreads)
    update_rows_kernel(V* __restrict__ table, int64_t R,
                       const int64_t* __restrict__ ids,
                       const V* __restrict__ rows, int64_t n, int vpr,
                       int lshift) {
  const int lane = threadIdx.x & 31;
  const int L = 1 << lshift;
  const int c = lane & (L - 1);
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int64_t i = (warp << (5 - lshift)) + (lane >> lshift);
  int64_t id = -1;
  if (c == 0 && i < n) id = ids[i];
  // every lane of the warp takes part in the shuffle
  id = __shfl_sync(0xffffffffu, id, 0, L);
  if (i >= n || id < 0 || id >= R) return;
  const V* src = rows + i * vpr;
  V* dst = table + id * vpr;
  for (int k = c; k < vpr; k += L) dst[k] = src[k];
}

template <typename V>
cudaError_t launch(void* table, int64_t R, const int64_t* ids,
                   const void* rows, int64_t n, int row_bytes,
                   cudaStream_t s) {
  const int vpr = row_bytes / static_cast<int>(sizeof(V));
  int lshift = 0;
  while ((1 << lshift) < vpr && lshift < 5) ++lshift;
  const int64_t rows_per_block = static_cast<int64_t>(kThreads) >> lshift;
  const int64_t blocks = (n + rows_per_block - 1) / rows_per_block;
  update_rows_kernel<V><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<V*>(table), R, ids, static_cast<const V*>(rows), n, vpr,
      lshift);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// table [R, D] and rows [n, D] of `elem_bytes` (2 or 4) bytes per element,
// ids int64 [n].  Launches on `stream`; returns the CUDA error code.
int update_rows(void* table, int64_t R, int D, int elem_bytes,
                const void* ids, const void* rows, int64_t n, void* stream) {
  if (n == 0 || D == 0) return 0;
  if (elem_bytes != 2 && elem_bytes != 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* id = static_cast<const int64_t*>(ids);
  const int row_bytes = D * elem_bytes;
  const auto aligned = [&](int w) {
    return row_bytes % w == 0 && reinterpret_cast<uintptr_t>(table) % w == 0 &&
           reinterpret_cast<uintptr_t>(rows) % w == 0;
  };
  cudaError_t err;
  if (aligned(16)) {
    err = launch<uint4>(table, R, id, rows, n, row_bytes, s);
  } else if (aligned(4)) {
    err = launch<uint32_t>(table, R, id, rows, n, row_bytes, s);
  } else if (elem_bytes == 2) {
    err = launch<uint16_t>(table, R, id, rows, n, row_bytes, s);
  } else {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  return static_cast<int>(err);
}

const char* update_rows_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
