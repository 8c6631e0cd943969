// Fused Deep-Interest-Transformer block forward, one CUDA block per example.
//
// Replaces the TPU kernel cikm2020_dmt_tpu/ops/block.py `_make_fwd_kernel`
// (launched through `_fwd_call`, entry `fused_encode_decode`).  For each
// example b:
//
//   encoder:  E0 = enc[b] [T, D] * dropout mask (training)
//             QKV = E0 @ wqkv + bqkv
//             per head h: P = softmax(mask_k(Q_h K_h^T * scale)) * mask_q
//                            * dropout mask (training)
//             h1 = LN1(P V + E0);  f = relu(h1 @ w1 + b1)
//             H2 = LN2(f @ w2 + b2 + h1)
//   decoder:  the single query D0 = dec[b] [D] (dropped out in training)
//             runs the same steps against H2 (keys masked, no query mask,
//             probabilities dropped out in training) -> out[b] [D]
//
// Dropout masks come from the hash in dropout.cuh, bit for bit the masks of
// ops/block.py `dropout_mask`; the seed is read from device memory.
//
// Masked keys score -2^32+1, not -inf, so a sequence with every key masked
// gets a uniform softmax over its T keys instead of NaN.  The sequence is
// not padded (the TPU wrapper pads T to a multiple of 8, which makes that
// uniform softmax run over the padded length; the jnp path and this kernel
// use the real T).
//
// Types: enc/dec/out are float32 or bfloat16.  With bfloat16 every operand
// of every product is rounded to bfloat16 first (the TPU kernel's compute
// dtype); sums, softmax and layer norm run in float32.  Weights arrive in
// float32 in the packed layout of ops/block.py `_pack_weights`: wqkv [D,3D],
// vecs [8,D] (bq bk bv ln1g ln1b ln2g ln2b b2), w1 [D,F], b1 [F], w2 [F,D].
//
// Bound: at the serving shape (T=50, D=80, F=320, 4 heads) one example is
// ~9.2 MFLOP against ~17 KB of input, so the block is bound by float32
// arithmetic (~42 us for 300 examples at 67 TFLOP/s), not by memory.
// Design: every activation of an example stays in shared memory (~148 KB
// at T=50, opted in above 48 KB); weights are read through the read-only
// cache; each thread computes RT rows of one output column so one weight
// load feeds RT FMAs.  No tensor cores yet: the next step is wgmma/mma.sync
// tiles over several examples per block.

#include <cfloat>
#include <type_traits>

#include <cuda_runtime.h>

#include "block_common.cuh"
#include "dropout.cuh"

namespace {

// x[r] = LN(x[r] + add[r]) * gamma + beta for each row r < rows; one warp
// per row, float32 statistics, population variance, eps inside the sqrt.
__device__ void add_layer_norm(float* x, const float* add, int rows, int n,
                               const float* __restrict__ gamma,
                               const float* __restrict__ beta) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < rows; r += blockDim.x >> 5) {
    float* xr = x + r * n;
    const float* ar = add + r * n;
    float s = 0.f;
    for (int i = lane; i < n; i += 32) {
      const float v = xr[i] + ar[i];
      xr[i] = v;
      s += v;
    }
    const float mean = warp_sum(s) / n;
    float sq = 0.f;
    for (int i = lane; i < n; i += 32) {
      const float d = xr[i] - mean;
      sq += d * d;
    }
    const float inv = rsqrtf(warp_sum(sq) / n + kLnEps);
    for (int i = lane; i < n; i += 32)
      xr[i] = (xr[i] - mean) * inv * __ldg(gamma + i) + __ldg(beta + i);
  }
}

// Row softmax in place over rows of length n; row r is then scaled by
// qmask[r % qmod] (qmask null: no query mask) and by the dropout mask of
// head r / qmod, query r % qmod, and rounded to the compute dtype, since
// probabilities only feed the P @ V product.
template <bool BF16>
__device__ void softmax_rows(float* s, int rows, int n, const float* qmask,
                             int qmod, const Dropout& drop, unsigned site,
                             unsigned b) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < rows; r += blockDim.x >> 5) {
    float* sr = s + r * n;
    float m = -FLT_MAX;
    for (int i = lane; i < n; i += 32) m = fmaxf(m, sr[i]);
    m = warp_max(m);
    float sum = 0.f;
    for (int i = lane; i < n; i += 32) {
      const float e = expf(sr[i] - m);
      sr[i] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    const float q = qmask ? qmask[r % qmod] : 1.f;
    const unsigned ex =
        drop.on ? drop.example(site * 16 + r / qmod, b) : 0u;
    for (int i = lane; i < n; i += 32)
      sr[i] = rnd<BF16>(sr[i] / sum * q * drop.scale_at(ex, r % qmod, i));
  }
}

inline size_t smem_floats(int T, int D, int F, int H) {
  const size_t tt = static_cast<size_t>(H) * T * T;
  const size_t tf = static_cast<size_t>(T) * F;
  return static_cast<size_t>(T) * D            // X: E0, then f2 / H2
         + static_cast<size_t>(T) * (3 * D + 1)  // QKV (decoder: Kd, Vd)
         + static_cast<size_t>(T) * D      // C: ctx, then h1
         + (tt > tf ? tt : tf)             // scores / FF hidden
         + T                               // key mask
         + 4 * static_cast<size_t>(D)      // D0, Qd, ctx_d / h1d, f2d
         + F                               // decoder FF hidden
         + static_cast<size_t>(H) * T;     // decoder scores
}

template <typename TIn>
__global__ void __launch_bounds__(kThreads)
    fused_block_fwd_kernel(const TIn* __restrict__ enc,
                           const TIn* __restrict__ dec,
                           const float* __restrict__ mask, Weights ew,
                           Weights dw, TIn* __restrict__ out, int T, int D,
                           int F, int H, float scale, Dropout drop) {
  constexpr bool BF16 = !std::is_same<TIn, float>::value;
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int dh = D / H;
  const int D3 = 3 * D;
  // QKV rows are D3 + 1 floats apart: an odd stride puts the K rows that
  // neighbouring threads read in the score loops on distinct banks
  const int LQ = D3 + 1;
  const size_t tt = static_cast<size_t>(H) * T * T;
  const size_t tf = static_cast<size_t>(T) * F;

  float* X = smem;
  float* QKV = X + T * D;
  float* C = QKV + T * LQ;
  float* SF = C + T * D;
  float* km = SF + (tt > tf ? tt : tf);
  float* d0 = km + T;
  float* qd = d0 + D;
  float* cd = qd + D;
  float* f2d = cd + D;
  float* fd = f2d + D;
  float* sd = fd + F;

  // ---- load ----
  if (drop.on) drop.load_seed();
  const TIn* e = enc + static_cast<size_t>(b) * T * D;
  const unsigned ex_e = drop.on ? drop.example(kSiteEncIn, b) : 0u;
  const unsigned ex_d = drop.on ? drop.example(kSiteDecIn, b) : 0u;
  for (int i = threadIdx.x; i < T * D; i += blockDim.x)
    X[i] = to_float(e[i]) * drop.scale_at(ex_e, i / D, i % D);
  for (int i = threadIdx.x; i < D; i += blockDim.x)
    d0[i] = to_float(dec[static_cast<size_t>(b) * D + i]) *
            drop.scale_at(ex_d, 0, i);
  for (int i = threadIdx.x; i < T; i += blockDim.x)
    km[i] = mask[static_cast<size_t>(b) * T + i];
  __syncthreads();

  // ---- encoder: QKV projection (stored rounded: only products read it) ----
  matmul<BF16>(X, D, T, D, ew.wqkv, D3, ew.vecs, D3, QKV, LQ, false, true);
  __syncthreads();

  // scores [H, T, T], masked keys at -2^32+1
  for (int idx = threadIdx.x; idx < H * T * T; idx += blockDim.x) {
    const int h = idx / (T * T);
    const int q = (idx / T) % T;
    const int k = idx % T;
    const float* qp = QKV + q * LQ + h * dh;
    const float* kp = QKV + k * LQ + D + h * dh;
    float s = 0.f;
    for (int d = 0; d < dh; ++d) s = fmaf(qp[d], kp[d], s);
    SF[idx] = km[k] > 0.f ? s * scale : kNegInf;
  }
  __syncthreads();
  softmax_rows<BF16>(SF, H * T, T, km, T, drop, kSiteEncProbs, b);
  __syncthreads();

  // ctx = P V -> C
  for (int idx = threadIdx.x; idx < T * D; idx += blockDim.x) {
    const int q = idx / D;
    const int j = idx % D;
    const float* p = SF + (j / dh) * T * T + q * T;
    const float* v = QKV + 2 * D + j;
    float s = 0.f;
    for (int k = 0; k < T; ++k) s = fmaf(p[k], v[k * LQ], s);
    C[idx] = s;
  }
  __syncthreads();

  // h1 = LN1(ctx + E0) in C; FF; H2 = LN2(f2 + h1) in X
  add_layer_norm(C, X, T, D, ew.vecs + 3 * D, ew.vecs + 4 * D);
  __syncthreads();
  matmul<BF16>(C, D, T, D, ew.w1, F, ew.b1, F, SF, F, true, false);
  __syncthreads();
  matmul<BF16>(SF, F, T, F, ew.w2, D, ew.vecs + 7 * D, D, X, D, false, false);
  __syncthreads();
  add_layer_norm(X, C, T, D, ew.vecs + 5 * D, ew.vecs + 6 * D);
  __syncthreads();

  // ---- decoder: one query against H2 ----
  matmul<BF16>(X, D, T, D, dw.wqkv + D, D3, dw.vecs + D, 2 * D, QKV + D, LQ,
               false, true);
  matmul<BF16>(d0, D, 1, D, dw.wqkv, D3, dw.vecs, D, qd, D, false, true);
  __syncthreads();

  for (int idx = threadIdx.x; idx < H * T; idx += blockDim.x) {
    const int h = idx / T;
    const int k = idx % T;
    const float* qp = qd + h * dh;
    const float* kp = QKV + k * LQ + D + h * dh;
    float s = 0.f;
    for (int d = 0; d < dh; ++d) s = fmaf(qp[d], kp[d], s);
    sd[idx] = km[k] > 0.f ? s * scale : kNegInf;
  }
  __syncthreads();
  softmax_rows<BF16>(sd, H, T, nullptr, 1, drop, kSiteDecProbs, b);
  __syncthreads();

  for (int j = threadIdx.x; j < D; j += blockDim.x) {
    const float* p = sd + (j / dh) * T;
    const float* v = QKV + 2 * D + j;
    float s = 0.f;
    for (int k = 0; k < T; ++k) s = fmaf(p[k], v[k * LQ], s);
    cd[j] = s;
  }
  __syncthreads();

  add_layer_norm(cd, d0, 1, D, dw.vecs + 3 * D, dw.vecs + 4 * D);
  __syncthreads();
  matmul<BF16>(cd, D, 1, D, dw.w1, F, dw.b1, F, fd, F, true, false);
  __syncthreads();
  matmul<BF16>(fd, F, 1, F, dw.w2, D, dw.vecs + 7 * D, D, f2d, D, false,
               false);
  __syncthreads();
  add_layer_norm(f2d, cd, 1, D, dw.vecs + 5 * D, dw.vecs + 6 * D);
  __syncthreads();

  for (int j = threadIdx.x; j < D; j += blockDim.x)
    store(out + static_cast<size_t>(b) * D + j, f2d[j]);
}

template <typename TIn>
cudaError_t launch(const void* enc, const void* dec, const void* mask,
                   Weights ew, Weights dw, void* out, int B, int T, int D,
                   int F, int H, float scale, Dropout drop,
                   cudaStream_t stream) {
  const size_t bytes = smem_floats(T, D, F, H) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fused_block_fwd_kernel<TIn>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  fused_block_fwd_kernel<TIn><<<B, kThreads, bytes, stream>>>(
      static_cast<const TIn*>(enc), static_cast<const TIn*>(dec),
      static_cast<const float*>(mask), ew, dw, static_cast<TIn*>(out), T, D,
      F, H, scale, drop);
  return cudaGetLastError();
}

Weights weights(const void* wqkv, const void* vecs, const void* w1,
                const void* b1, const void* w2) {
  return Weights{static_cast<const float*>(wqkv),
                 static_cast<const float*>(vecs),
                 static_cast<const float*>(w1), static_cast<const float*>(b1),
                 static_cast<const float*>(w2)};
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` (of the caller's current device); returns
// the CUDA error code of the launch, 0 on success.  Does not synchronise.
int fused_block_fwd(const void* enc, const void* dec, const void* mask,
                    const void* e_wqkv, const void* e_vecs, const void* e_w1,
                    const void* e_b1, const void* e_w2, const void* d_wqkv,
                    const void* d_vecs, const void* d_w1, const void* d_b1,
                    const void* d_w2, void* out, int B, int T, int D, int F,
                    int H, float scale, int is_bf16, const void* seed,
                    int train, int keep_thr, float drop_scale,
                    void* stream) {
  if (B == 0) return 0;
  const Dropout drop = make_dropout(seed, train, keep_thr, drop_scale);
  const Weights ew = weights(e_wqkv, e_vecs, e_w1, e_b1, e_w2);
  const Weights dw = weights(d_wqkv, d_vecs, d_w1, d_b1, d_w2);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(enc, dec, mask, ew, dw, out, B, T, D, F,
                                      H, scale, drop, s)
              : launch<float>(enc, dec, mask, ew, dw, out, B, T, D, F, H,
                              scale, drop, s);
  return static_cast<int>(err);
}

const char* fused_block_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
