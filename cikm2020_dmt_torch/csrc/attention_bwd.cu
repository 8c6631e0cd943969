// Masked multi-head attention backward, one CUDA block per (example, head).
//
// Replaces the TPU kernel cikm2020_dmt_tpu/ops/attention.py
// `_attention_bwd_kernel` (launched through `_pallas_call_bwd`, the custom
// VJP of `fused_attention`).  For example b and head h, with do the
// output's cotangent, it recomputes the probabilities and chains back:
//
//   P0  = softmax(mask_k(q_h k_h^T * scale))            [Tq, Tk]
//   dP  = (do_h v_h^T) * q_mask                          (per query row)
//   dS  = P0 * (dP - rowsum(dP * P0)), 0 at masked keys
//   dq_h = dS k_h * scale;  dk_h = dS^T q_h * scale;  dv_h = (P0 * q_mask)^T do_h
//
// dS is zeroed at masked keys: a masked key's score is a constant, so no
// gradient reaches it.  That matters only on rows with no present key
// (uniform softmax), where the TPU kernel lets a gradient through and the
// reference's per-op path does not; this kernel follows the per-op path.
//
// Types: q, k, v, do and the gradients are float32 or bfloat16; products
// take operands in that type and sum in float32.  As in the TPU kernel,
// dS is rounded to the input type before the dq and dk products, and the
// query-masked probabilities before the dv product.
//
// Bound: at B=2048, T=50, D=80 one launch does 4.1 GFLOP against 229 MB
// (q, k, v, do read; dq, dk, dv written), bound by memory (~68 us).
// Design: the head's q, do, k and v slices ([T, dh], stride dh + 1) and
// the [Tq, Tk] probability and dS tiles sit in shared memory; one warp per
// query row forms P0, dP and dS with the keys over the lanes (Tk <= 64);
// then each thread owns output elements of dq, dk and dv and sums over
// the keys (dq) or the queries (dk, dv) in a fixed order.  Each block
// writes only its head's columns, so there are no atomics and two runs on
// the same inputs give the same bits.

#include <cfloat>
#include <type_traits>

#include <cuda_runtime.h>

#include "block_common.cuh"

namespace {

constexpr int kMaxT = 64;      // keys per row: two per lane
constexpr int kBwdThreads = 128;

inline size_t smem_floats(int Tq, int Tk, int dh) {
  const size_t ld = static_cast<size_t>(dh) + 1;
  return 2 * Tq * ld + 2 * Tk * ld + Tq + Tk +
         2 * static_cast<size_t>(Tq) * Tk;
}

template <typename TIn>
__global__ void __launch_bounds__(kBwdThreads)
    attention_bwd_kernel(const TIn* __restrict__ q, const TIn* __restrict__ k,
                         const TIn* __restrict__ v,
                         const float* __restrict__ qm,
                         const float* __restrict__ km,
                         const TIn* __restrict__ dout, TIn* __restrict__ dq,
                         TIn* __restrict__ dk, TIn* __restrict__ dv, int Tq,
                         int Tk, int D, int H, float scale) {
  constexpr bool BF16 = !std::is_same<TIn, float>::value;
  extern __shared__ float smem[];
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int dh = D / H;
  const int ld = dh + 1;
  float* qs = smem;              // [Tq, ld]
  float* dos = qs + Tq * ld;     // [Tq, ld]
  float* ks = dos + Tq * ld;     // [Tk, ld]
  float* vs = ks + Tk * ld;      // [Tk, ld]
  float* qms = vs + Tk * ld;     // [Tq]
  float* kms = qms + Tq;         // [Tk]
  float* P = kms + Tk;           // [Tq, Tk] P0 * q_mask, rounded
  float* S = P + Tq * Tk;        // [Tq, Tk] dS, rounded

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
    const int d = i % dh;
    qs[r * ld + d] = to_float(q[q0 + static_cast<size_t>(r) * D + d]);
    dos[r * ld + d] = to_float(dout[q0 + static_cast<size_t>(r) * D + d]);
  }
  for (int j = threadIdx.x; j < Tk; j += blockDim.x)
    kms[j] = km[static_cast<size_t>(b) * Tk + j];
  for (int r = threadIdx.x; r < Tq; r += blockDim.x)
    qms[r] = qm[static_cast<size_t>(b) * Tq + r];
  __syncthreads();

  // ---- per query row: P0, dP, dS (one warp a row, keys over lanes) ----
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < Tq; r += blockDim.x >> 5) {
    const float* qr = qs + r * ld;
    const float* gr = dos + r * ld;
    const float qmr = qms[r];
    float s[2], dp[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int j = lane + 32 * c;
      s[c] = -FLT_MAX;
      dp[c] = 0.f;
      if (j < Tk) {
        const float* kj = ks + j * ld;
        const float* vj = vs + j * ld;
        float acc = 0.f;
        float accp = 0.f;
        for (int d = 0; d < dh; ++d) {
          acc = fmaf(qr[d], kj[d], acc);
          accp = fmaf(gr[d], vj[d], accp);
        }
        s[c] = kms[j] > 0.f ? acc * scale : kNegInf;
        dp[c] = accp * qmr;
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
    float p[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) p[c] = e[c] / sum;
    const float t = warp_sum(dp[0] * p[0] + dp[1] * p[1]);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int j = lane + 32 * c;
      if (j < Tk) {
        const float ds = kms[j] > 0.f ? p[c] * (dp[c] - t) : 0.f;
        P[r * Tk + j] = rnd<BF16>(p[c] * qmr);
        S[r * Tk + j] = rnd<BF16>(ds);
      }
    }
  }
  __syncthreads();

  // ---- dq = dS k * scale ----
  for (int i = threadIdx.x; i < Tq * dh; i += blockDim.x) {
    const int r = i / dh;
    const int d = i % dh;
    const float* sr = S + r * Tk;
    float acc = 0.f;
    for (int j = 0; j < Tk; ++j) acc = fmaf(sr[j], ks[j * ld + d], acc);
    store(dq + q0 + static_cast<size_t>(r) * D + d, acc * scale);
  }
  // ---- dk = dS^T q * scale;  dv = P^T do ----
  for (int i = threadIdx.x; i < Tk * dh; i += blockDim.x) {
    const int j = i / dh;
    const int d = i % dh;
    float acck = 0.f;
    float accv = 0.f;
    for (int r = 0; r < Tq; ++r) {
      acck = fmaf(S[r * Tk + j], qs[r * ld + d], acck);
      accv = fmaf(P[r * Tk + j], dos[r * ld + d], accv);
    }
    store(dk + kv0 + static_cast<size_t>(j) * D + d, acck * scale);
    store(dv + kv0 + static_cast<size_t>(j) * D + d, accv);
  }
}

template <typename TIn>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* qm, const void* km, const void* dout, void* dq,
                   void* dk, void* dv, int B, int Tq, int Tk, int D, int H,
                   float scale, cudaStream_t stream) {
  const size_t bytes = smem_floats(Tq, Tk, D / H) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      attention_bwd_kernel<TIn>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  attention_bwd_kernel<TIn><<<B * H, kBwdThreads, bytes, stream>>>(
      static_cast<const TIn*>(q), static_cast<const TIn*>(k),
      static_cast<const TIn*>(v), static_cast<const float*>(qm),
      static_cast<const float*>(km), static_cast<const TIn*>(dout),
      static_cast<TIn*>(dq), static_cast<TIn*>(dk), static_cast<TIn*>(dv),
      Tq, Tk, D, H, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` (of the caller's current device); returns
// the CUDA error code of the launch, 0 on success.  Does not synchronise.
// The caller checks 1 <= Tq, Tk <= 64 and D % H == 0.
int attention_bwd(const void* q, const void* k, const void* v,
                  const void* q_mask, const void* k_mask, const void* dout,
                  void* dq, void* dk, void* dv, int B, int Tq, int Tk, int D,
                  int H, float scale, int is_bf16, void* stream) {
  if (B == 0) return 0;
  if (Tq < 1 || Tk < 1 || Tk > kMaxT || Tq > kMaxT || H < 1 || D % H)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(q, k, v, q_mask, k_mask, dout, dq, dk,
                                      dv, B, Tq, Tk, D, H, scale, s)
              : launch<float>(q, k, v, q_mask, k_mask, dout, dq, dk, dv, B,
                              Tq, Tk, D, H, scale, s);
  return static_cast<int>(err);
}

const char* attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
