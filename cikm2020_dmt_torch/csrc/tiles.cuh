// Device helpers of the kernels redesigned for Hopper (attention_fwd.cu,
// fused_block_bwd.cu): 16-byte row I/O in float32 or bfloat16, reductions
// over a group of neighbouring lanes, and warp-level tensor-core tiles
// (mma.sync m16n8k8 on TF32 operands) with the 3xTF32 split that keeps
// float32 products.
//
// 3xTF32: a float32 a is split into hi = tf32(a) (10 explicit mantissa
// bits) and lo = tf32(a - hi); a * b is formed as lo*hi + hi*lo + hi*hi,
// which drops only lo*lo (~2^-22 relative) and the rounding of lo, so a
// product keeps about float32 accuracy with float32 sums.  Operands
// rounded to bfloat16 (8 mantissa bits) are exact in TF32, so one TF32
// product of them is exact: the bfloat16 contract (operands rounded to
// bfloat16, sums in float32) takes a single pass.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>

#include "block_common.cuh"

namespace {

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void sts4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 ldg4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const auto* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void stg4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void stg4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&a);
  u.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

// Four consecutive columns d.. of a row, zero at d + e >= n; one 16-byte
// (float32) or 8-byte (bfloat16) load when `vec` and the four lie inside.
template <typename T>
__device__ __forceinline__ float4 load_cols(const T* p, int d, int n,
                                            bool vec) {
  if (vec && d + 4 <= n) return ldg4(p);
  float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
  if (d < n) x.x = to_float(p[0]);
  if (d + 1 < n) x.y = to_float(p[1]);
  if (d + 2 < n) x.z = to_float(p[2]);
  if (d + 3 < n) x.w = to_float(p[3]);
  return x;
}

template <typename T>
__device__ __forceinline__ void store_cols(T* p, float4 x, int d, int n,
                                           bool vec) {
  if (vec && d + 4 <= n) {
    stg4(p, x);
    return;
  }
  if (d < n) store(p, x.x);
  if (d + 1 < n) store(p + 1, x.y);
  if (d + 2 < n) store(p + 2, x.z);
  if (d + 3 < n) store(p + 3, x.w);
}

__device__ __forceinline__ void fma4(float4& acc, float a, float4 x) {
  acc.x = fmaf(a, x.x, acc.x);
  acc.y = fmaf(a, x.y, acc.y);
  acc.z = fmaf(a, x.z, acc.z);
  acc.w = fmaf(a, x.w, acc.w);
}

// acc += a * b by component: four independent sums, so a dot product over
// n float4s is a chain of n dependent FMAs, not 4n; sum4 adds them up.
__device__ __forceinline__ void dot4x(float4 a, float4 b, float4& acc) {
  acc.x = fmaf(a.x, b.x, acc.x);
  acc.y = fmaf(a.y, b.y, acc.y);
  acc.z = fmaf(a.z, b.z, acc.z);
  acc.w = fmaf(a.w, b.w, acc.w);
}
__device__ __forceinline__ float sum4(float4 v) {
  return (v.x + v.y) + (v.z + v.w);
}

// Reductions over the `lanes` (a power of two) neighbouring lanes of a
// group; every lane of the warp takes part.  a + b == b + a in floating
// point, so every lane of a group ends with the same bits.
__device__ __forceinline__ float group_max(float v, int lanes) {
  for (int o = lanes >> 1; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float group_sum(float v, int lanes) {
  for (int o = lanes >> 1; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
// The same butterfly over each component of C float4s.
template <int C>
__device__ __forceinline__ void group_sum4(float4 (&o)[C], int lanes) {
  for (int off = lanes >> 1; off > 0; off >>= 1) {
#pragma unroll
    for (int cc = 0; cc < C; ++cc) {
      o[cc].x += __shfl_xor_sync(0xffffffffu, o[cc].x, off);
      o[cc].y += __shfl_xor_sync(0xffffffffu, o[cc].y, off);
      o[cc].z += __shfl_xor_sync(0xffffffffu, o[cc].z, off);
      o[cc].w += __shfl_xor_sync(0xffffffffu, o[cc].w, off);
    }
  }
}

// ---------------------------------------------------------------------------
// Tensor-core tiles: mma.sync.m16n8k8 with TF32 operands, float32 sums.
// Fragments (PTX ISA, "mma.m16n8k8", .tf32), g = lane / 4, t = lane % 4:
//   A 16x8:  a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B 8x8:   b0 (k = t, n = g), b1 (k = t + 4, n = g)
//   C 16x8:  c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t tf32_bits(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// The operand pair of x: 3xTF32 (hi, lo) for float32, or the bfloat16
// rounding of x (exact in TF32) and no lo.
template <bool BF16>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  if constexpr (BF16) {
    hi = __float_as_uint(__bfloat162float(__float2bfloat16(x)));
    lo = 0u;
  } else {
    hi = tf32_bits(x);
    lo = tf32_bits(x - __uint_as_float(hi));
  }
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a * b for operand pairs: the small terms first, then hi * hi.
template <bool BF16>
__device__ __forceinline__ void mma_split(float (&c)[4],
                                          const uint32_t (&ah)[4],
                                          const uint32_t (&al)[4],
                                          uint32_t bh0, uint32_t bh1,
                                          uint32_t bl0, uint32_t bl1) {
  if constexpr (!BF16) {
    mma_tf32(c, al, bh0, bh1);
    mma_tf32(c, ah, bl0, bl1);
  }
  mma_tf32(c, ah, bh0, bh1);
}

// The A fragment of rows r0 .. r0 + 15, columns k0 .. k0 + 7 of a
// row-major float32 matrix in shared memory (row stride lda floats, a
// multiple of 4 whose quarter is odd, so the eight rows of each 8 x 16-byte
// matrix hit distinct banks), with one ldmatrix.x4: lane L gives the
// address of row L % 8 (+ 8 for L / 8 odd) at column k0 + 4 (L / 16).
// Rows at or past `rows` read row rows - 1 (their results are not stored).
__device__ __forceinline__ void ldsm_a(uint32_t (&a)[4], const float* A,
                                       int lda, int r0, int rows, int k0) {
  const int lane = threadIdx.x & 31;
  const int r = min(r0 + (lane & 7) + ((lane >> 3) & 1) * 8, rows - 1);
  const float* p = A + r * lda + k0 + (lane >> 4) * 4;
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(s));
}

}  // namespace
