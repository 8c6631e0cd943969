// Helpers shared by the block and attention kernels: compute-type
// rounding, warp reductions, and the packed weight layout of ops/block.py
// `pack_weights`.
#pragma once

#include <cuda_bf16.h>

namespace {

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

// The packed weights of one sub-block (float32, row-major).
struct Weights {
  const float* wqkv;  // [D, 3D]
  const float* vecs;  // [8, D]
  const float* w1;    // [D, F]
  const float* b1;    // [F]
  const float* w2;    // [F, D]
};

}  // namespace
