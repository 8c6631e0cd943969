// Helpers shared by the fused block kernels (fused_block_fwd.cu,
// fused_block_bwd.cu): compute-type rounding, warp reductions, the
// row-tiled product of a shared-memory activation with a global weight,
// and the packed weight layout of ops/block.py `pack_weights`.
#pragma once

#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 512;
constexpr int kRowsPerThread = 4;
constexpr float kNegInf = -4294967295.0f;  // -(2^32) + 1, the reference pad
constexpr float kLnEps = 1e-8f;

template <bool BF16>
__device__ __forceinline__ float rnd(float x) {
  if constexpr (BF16) {
    return __bfloat162float(__float2bfloat16(x));
  } else {
    return x;
  }
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// out[r, j] = act(sum_k rnd(in[r, k]) * rnd(W[k, j]) + bias[j]), r < rows,
// j < cols; in and out in shared memory, W and bias in global memory.
template <bool BF16>
__device__ void matmul(const float* in, int ldi, int rows, int K,
                       const float* __restrict__ W, int ldw,
                       const float* __restrict__ bias, int cols, float* out,
                       int ldo, bool relu, bool round_out) {
  constexpr int RT = kRowsPerThread;
  const int groups = (rows + RT - 1) / RT;
  for (int idx = threadIdx.x; idx < groups * cols; idx += blockDim.x) {
    const int j = idx % cols;
    const int r0 = (idx / cols) * RT;
    const int nr = min(RT, rows - r0);
    float acc[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r) acc[r] = 0.f;
    const float* x = in + r0 * ldi;
    for (int k = 0; k < K; ++k) {
      const float w = rnd<BF16>(__ldg(W + static_cast<size_t>(k) * ldw + j));
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        if (r < nr) acc[r] = fmaf(rnd<BF16>(x[r * ldi + k]), w, acc[r]);
      }
    }
    const float b = __ldg(bias + j);
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      if (r < nr) {
        float v = acc[r] + b;
        if (relu) v = fmaxf(v, 0.f);
        out[(r0 + r) * ldo + j] = round_out ? rnd<BF16>(v) : v;
      }
    }
  }
}

// The packed weights of one sub-block (float32, row-major).
struct Weights {
  const float* wqkv;  // [D, 3D]
  const float* vecs;  // [8, D]
  const float* w1;    // [D, F]
  const float* b1;    // [F]
  const float* w2;    // [F, D]
};

}  // namespace
