// Masked multi-head attention forward, one CUDA block per (example, head).
//
// Replaces the TPU kernel cikm2020_dmt_tpu/ops/attention.py
// `_attention_fwd_kernel` (launched through `_pallas_call_fwd`, entry
// `fused_attention`).  For example b and head h (columns h*dh .. h*dh+dh-1
// of the logical [B, T, D] tensors; no lane padding, no head masks):
//
//   P   = softmax(mask_k(q_h k_h^T * scale)) * q_mask   [Tq, Tk]
//   out = P v_h                                          [Tq, dh]
//
// Masked keys score -2^32+1, not -inf, so a row with every key masked gets
// a uniform softmax over its Tk keys instead of NaN.  The sequence is not
// padded: the TPU wrapper pads T to a multiple of 8 (16 in bf16), which
// makes that uniform softmax run over the padded length; the reference's
// per-op path and this kernel use the real Tk.
//
// Types: q, k, v and out are float32 or bfloat16.  Products take their
// operands in that type, sums and the softmax run in float32, and the
// probabilities are rounded to the input type before P v (the TPU kernel's
// `probs.astype(v.dtype)`).
//
// Bound: at the training shapes (B=2048, T=50, D=80) one launch does 1.64
// GFLOP against 131 MB of q, k, v and out, so it is bound by memory (~39
// us at 3.35 TB/s).  Design: the head's K and V slices ([Tk, dh], stride
// dh + 1 so the lanes of a warp reading different keys hit distinct banks)
// and Q slice sit in shared memory; one warp per query row, the keys of
// the row spread over the lanes (two per lane, so Tk <= 64), max and sum
// by warp shuffles; then lane d forms output column d.  Every element of
// q, k, v is read from device memory once, out written once.  No tensor
// cores: dh = 20 fills no mma tile; several examples per block with mma
// tiles is the next step.

#include <cfloat>
#include <type_traits>

#include <cuda_runtime.h>

#include "block_common.cuh"

namespace {

constexpr int kMaxT = 64;   // keys per row: two per lane
constexpr int kWarps = 4;   // query rows in flight per block

inline size_t smem_floats(int Tq, int Tk, int dh, int warps) {
  const size_t ld = static_cast<size_t>(dh) + 1;
  return 2 * Tk * ld + Tq * ld + Tk + static_cast<size_t>(warps) * kMaxT;
}

template <typename TIn>
__global__ void __launch_bounds__(kWarps * 32)
    attention_fwd_kernel(const TIn* __restrict__ q, const TIn* __restrict__ k,
                         const TIn* __restrict__ v,
                         const float* __restrict__ qm,
                         const float* __restrict__ km,
                         TIn* __restrict__ out, int Tq, int Tk, int D, int H,
                         float scale) {
  constexpr bool BF16 = !std::is_same<TIn, float>::value;
  extern __shared__ float smem[];
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int dh = D / H;
  const int ld = dh + 1;
  const int warps = blockDim.x >> 5;
  float* ks = smem;             // [Tk, ld]
  float* vs = ks + Tk * ld;     // [Tk, ld]
  float* qs = vs + Tk * ld;     // [Tq, ld]
  float* kms = qs + Tq * ld;    // [Tk]
  float* ps = kms + Tk;         // [warps, kMaxT] one probability row a warp

  const size_t kv0 = static_cast<size_t>(b) * Tk * D + h * dh;
  const size_t q0 = static_cast<size_t>(b) * Tq * D + h * dh;
  for (int i = threadIdx.x; i < Tk * dh; i += blockDim.x) {
    const int j = i / dh;
    const int d = i % dh;
    ks[j * ld + d] = to_float(k[kv0 + static_cast<size_t>(j) * D + d]);
    vs[j * ld + d] = to_float(v[kv0 + static_cast<size_t>(j) * D + d]);
  }
  for (int i = threadIdx.x; i < Tq * dh; i += blockDim.x) {
    const int r = i / dh;
    qs[r * ld + i % dh] =
        to_float(q[q0 + static_cast<size_t>(r) * D + i % dh]);
  }
  for (int j = threadIdx.x; j < Tk; j += blockDim.x)
    kms[j] = km[static_cast<size_t>(b) * Tk + j];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  float* pw = ps + (threadIdx.x >> 5) * kMaxT;
  for (int r = threadIdx.x >> 5; r < Tq; r += warps) {
    const float* qr = qs + r * ld;
    float s[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int j = lane + 32 * c;
      s[c] = -FLT_MAX;
      if (j < Tk) {
        const float* kj = ks + j * ld;
        float acc = 0.f;
        for (int d = 0; d < dh; ++d) acc = fmaf(qr[d], kj[d], acc);
        s[c] = kms[j] > 0.f ? acc * scale : kNegInf;
      }
    }
    const float m = warp_max(fmaxf(s[0], s[1]));
    float e[2];
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      e[c] = lane + 32 * c < Tk ? expf(s[c] - m) : 0.f;
      sum += e[c];
    }
    sum = warp_sum(sum);
    const float qmr = qm[static_cast<size_t>(b) * Tq + r];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int j = lane + 32 * c;
      if (j < Tk) pw[j] = rnd<BF16>(e[c] / sum * qmr);
    }
    __syncwarp();
    for (int d = lane; d < dh; d += 32) {
      float acc = 0.f;
      for (int j = 0; j < Tk; ++j) acc = fmaf(pw[j], vs[j * ld + d], acc);
      store(out + q0 + static_cast<size_t>(r) * D + d, acc);
    }
    __syncwarp();
  }
}

template <typename TIn>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* qm, const void* km, void* out, int B, int Tq,
                   int Tk, int D, int H, float scale, cudaStream_t stream) {
  const int warps = Tq < kWarps ? Tq : kWarps;
  const size_t bytes = smem_floats(Tq, Tk, D / H, warps) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      attention_fwd_kernel<TIn>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  attention_fwd_kernel<TIn><<<B * H, warps * 32, bytes, stream>>>(
      static_cast<const TIn*>(q), static_cast<const TIn*>(k),
      static_cast<const TIn*>(v), static_cast<const float*>(qm),
      static_cast<const float*>(km), static_cast<TIn*>(out), Tq, Tk, D, H,
      scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` (of the caller's current device); returns
// the CUDA error code of the launch, 0 on success.  Does not synchronise.
// The caller checks 1 <= Tq, Tk <= 64 and D % H == 0.
int attention_fwd(const void* q, const void* k, const void* v,
                  const void* q_mask, const void* k_mask, void* out, int B,
                  int Tq, int Tk, int D, int H, float scale, int is_bf16,
                  void* stream) {
  if (B == 0) return 0;
  if (Tq < 1 || Tk < 1 || Tk > kMaxT || Tq > kMaxT || H < 1 || D % H)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(q, k, v, q_mask, k_mask, out, B, Tq, Tk,
                                      D, H, scale, s)
              : launch<float>(q, k, v, q_mask, k_mask, out, B, Tq, Tk, D, H,
                              scale, s);
  return static_cast<int>(err);
}

const char* attention_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
