// Segment sum of id-sorted rows: out[s] = sum of g[order[r]] over the sorted
// positions r with seg[r] == s, accumulated in float32.
//
// Replaces the TPU kernel cikm2020_dmt_tpu/ops/scatter_rows.py
// `_sorted_segsum_kernel` (via `sorted_segment_sum_rows`), the backward of
// the lazy-Adam union gather (`take_rows_sparse_sorted`).  seg is
// nondecreasing and may skip slots (a lazy group's rows that no id names);
// out is zeroed by the caller, so slots no run names stay zero.  This
// kernel reads g through `order` directly, which saves the [N, D] reorder
// pass the TPU path makes before its kernel.
//
// Bound: bytes.  At the flagship step (N = 227,328 rows of D = 32 bf16,
// int64 order and seg, 113,665 float32 output rows: 28,416 groups of 4)
// ~32.5 MB move, ~9.7 us at 3.35 TB/s; there is one add per element read.
//
// Design: the TPU kernel's sequential grid carries a run from chunk to
// chunk; blocks on the card run in no order, so the sum is split in two
// passes with no atomics and a fixed order (deterministic):
// 1. one warp per chunk of kChunk sorted rows (lanes over columns) sums
//    each run inside the chunk in row order; a run wholly inside the chunk
//    is written to out, a run cut by the chunk's left edge goes to
//    head[chunk], one cut by its right edge to tail[chunk];
// 2. one warp per chunk where a cut run starts: tail[c] + head[c+1] + ...
//    over the chunks the run spans (its end found by binary search), in
//    chunk order, written to out once.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 64;
constexpr int kWarps = 8;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

struct Chunk {
  int64_t lo, hi, first_run, last_run;
  bool left_open, right_open;
};

__device__ __forceinline__ Chunk chunk_of(const int64_t* seg, int64_t N,
                                          int64_t c) {
  Chunk k;
  k.lo = c * kChunk;
  k.hi = min(k.lo + kChunk, N);
  k.first_run = seg[k.lo];
  k.last_run = seg[k.hi - 1];
  k.left_open = k.lo > 0 && seg[k.lo - 1] == k.first_run;
  k.right_open = k.hi < N && seg[k.hi] == k.last_run;
  return k;
}

template <typename T>
__global__ void segsum_chunks(const T* __restrict__ g,
                              const int64_t* __restrict__ order,
                              const int64_t* __restrict__ seg, int64_t N,
                              int D, float* __restrict__ out,
                              float* __restrict__ head,
                              float* __restrict__ tail) {
  const int64_t c =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (c * kChunk >= N) return;
  const Chunk k = chunk_of(seg, N, c);
  for (int c0 = 0; c0 < D; c0 += 32) {
    const int col = c0 + lane;
    const bool on = col < D;
    float acc = 0.f;
    int64_t run = k.first_run;
    for (int64_t r = k.lo; r <= k.hi; ++r) {
      const int64_t s = r < k.hi ? seg[r] : -1;
      if (s != run) {
        if (on) {
          float* dst;
          if (run == k.first_run && k.left_open) {
            dst = head + c * D;
          } else if (run == k.last_run && k.right_open) {
            dst = tail + c * D;
          } else {
            dst = out + run * D;
          }
          dst[col] = acc;
        }
        if (r == k.hi) break;
        acc = 0.f;
        run = s;
      }
      if (on) acc += to_float(g[order[r] * D + col]);
    }
  }
}

__global__ void segsum_stitch(const int64_t* __restrict__ seg, int64_t N,
                              int D, float* __restrict__ out,
                              const float* __restrict__ head,
                              const float* __restrict__ tail) {
  const int64_t c =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (c * kChunk >= N) return;
  const Chunk k = chunk_of(seg, N, c);
  // a run cut by this chunk's right edge that starts in this chunk
  if (!k.right_open || (k.first_run == k.last_run && k.left_open)) return;
  const int64_t run = k.last_run;
  // last sorted row of the run: upper bound of `run` in seg[hi, N)
  int64_t a = k.hi, b = N;
  while (a < b) {
    const int64_t m = (a + b) >> 1;
    if (seg[m] <= run) a = m + 1; else b = m;
  }
  const int64_t last_chunk = (a - 1) / kChunk;
  for (int c0 = 0; c0 < D; c0 += 32) {
    const int col = c0 + lane;
    if (col >= D) continue;
    float s = tail[c * D + col];
#pragma unroll 8
    for (int64_t j = c + 1; j <= last_chunk; ++j) s += head[j * D + col];
    out[run * D + col] = s;
  }
}

}  // namespace

extern "C" {

// g [N, D] float32 (is_bf16 0) or bfloat16 (1); order, seg int64 [N];
// out float32 [num_out, D], zeroed; head, tail float32 [ceil(N/64), D]
// scratch.  Launches both passes on `stream`; returns the CUDA error code.
int sorted_segsum(const void* g, int is_bf16, const void* order,
                  const void* seg, int64_t N, int D, void* out, void* head,
                  void* tail, void* stream) {
  if (N == 0) return 0;
  const int64_t chunks = (N + kChunk - 1) / kChunk;
  const int grid = static_cast<int>((chunks + kWarps - 1) / kWarps);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* o = static_cast<const int64_t*>(order);
  const auto* sg = static_cast<const int64_t*>(seg);
  auto* out_f = static_cast<float*>(out);
  auto* h = static_cast<float*>(head);
  auto* t = static_cast<float*>(tail);
  if (is_bf16) {
    segsum_chunks<<<grid, kWarps * 32, 0, s>>>(
        static_cast<const __nv_bfloat16*>(g), o, sg, N, D, out_f, h, t);
  } else {
    segsum_chunks<<<grid, kWarps * 32, 0, s>>>(static_cast<const float*>(g),
                                               o, sg, N, D, out_f, h, t);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  segsum_stitch<<<grid, kWarps * 32, 0, s>>>(sg, N, D, out_f, h, t);
  return static_cast<int>(cudaGetLastError());
}

const char* sorted_segsum_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
