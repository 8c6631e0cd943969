// Fused Deep-Interest-Transformer block backward.
//
// Replaces the TPU kernel cikm2020_dmt_tpu/ops/block.py `_make_bwd_kernel`
// (launched through `_bwd_call`): a full-recompute backward.  Per example it
// replays the forward of fused_block_fwd.cu (same dropout masks, from the
// hash in dropout.cuh) and chains the gradients by hand, as the TPU kernel's
// _ffln_bwd / _attend3_bwd / _ln_bwd do, with one difference: a masked
// key's score is a constant, so no gradient reaches it (this changes only
// rows with no present key, where the reference's jnp path and the TPU
// kernel disagree; the jnp path is followed).  Inputs: enc [B,T,D],
// dec [B,D], the key mask, the packed weights, the output cotangent g
// [B,D].  Outputs: d_enc, d_dec and the 10 float32 weight grads of
// ops/block.py `pack_weights`, summed over the batch, as one flat array.
//
// Types: as in the forward, with bfloat16 inputs every operand of every
// product (forward replay and gradient products alike) is rounded to
// bfloat16; everything else is float32.
//
// Bound: about 3x the forward's products (the replay, then the input and
// the weight gradient of each product): ~28 MFLOP per example at T=50,
// D=80, F=320, against ~33 KB moved, so bound by float32 arithmetic
// (ops/block.py `block_bwd_flops`).  This kernel recomputes the encoder FF
// hidden once more to save shared memory (+2.6 MFLOP per example).
//
// Design:
// - one block per SM, a persistent grid: each block loops over examples
//   b = blockIdx.x, blockIdx.x + gridDim.x, ... with every activation of
//   the example in shared memory (~210 KB at T=50: E0, QKV, xhat1,
//   xhat2, two [T,D] gradient buffers, one [T,F] / [T,3D] work area, one
//   head's [T,T] probabilities);
// - the per-head [T,T] gradient work reuses free [T,D] buffers and
//   recomputes each head's probabilities, as the TPU kernel does;
// - weight grads (571 KB at these widths, more than a block holds) go to a
//   per-block partial row in global memory with plain read-modify-write
//   (each element has one owner thread per step: no atomics); a second
//   kernel sums the rows in a fixed order, so runs are deterministic;
// - the products with a transposed weight (dX = dY W^T) read copies of
//   wqkv, w1 and w2 transposed by the wrapper, so that neighbouring threads
//   load neighbouring floats, as in the forward's products.
// No tensor cores yet.

#include <cfloat>
#include <type_traits>

#include <cuda_runtime.h>

#include "block_common.cuh"
#include "dropout.cuh"

namespace {

__device__ __forceinline__ void acc_put(float* p, float v, bool first) {
  *p = first ? v : *p + v;
}

// out[r, i] = (add ? add[r, i] : 0) + sum_j rnd(in[r, j]) * rnd(WT[j, i])
// for i < cols, or, with `gate`, out[r, i] = gate[r, i] > 0 ? sum : 0 (a
// relu's gradient through its stored output; gate may be out itself).  WT
// is a weight transposed by the wrapper, so that the product with W^T
// reads it row by row, neighbouring threads on neighbouring columns.  add
// and gate share out's row stride.
template <bool BF16>
__device__ void matmul_nt(const float* in, int ldi, int rows, int K,
                          const float* __restrict__ WT, int ldw, int cols,
                          float* out, int ldo, const float* add,
                          const float* gate) {
  constexpr int RT = kRowsPerThread;
  const int groups = (rows + RT - 1) / RT;
  for (int idx = threadIdx.x; idx < groups * cols; idx += blockDim.x) {
    const int i = idx % cols;
    const int r0 = (idx / cols) * RT;
    const int nr = min(RT, rows - r0);
    float acc[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r) acc[r] = 0.f;
    const float* x = in + r0 * ldi;
    for (int j = 0; j < K; ++j) {
      const float wv = rnd<BF16>(__ldg(WT + static_cast<size_t>(j) * ldw + i));
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        if (r < nr) acc[r] = fmaf(rnd<BF16>(x[r * ldi + j]), wv, acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      if (r < nr) {
        const int o = (r0 + r) * ldo + i;
        if (gate) {
          out[o] = gate[o] > 0.f ? acc[r] : 0.f;
        } else {
          out[o] = add ? add[o] + acc[r] : acc[r];
        }
      }
    }
  }
}

// acc[i, j] (+)= sum_t rnd(X[t, i]) * rnd(Y[t, j]) for i < M, j < N; acc
// is the block's partial weight grad in global memory (row stride lda).
template <bool BF16>
__device__ void wgrad(const float* X, int ldx, const float* Y, int ldy,
                      int rows, int M, int N, float* acc, int lda,
                      bool first) {
  constexpr int RI = 4;
  const int groups = (M + RI - 1) / RI;
  for (int idx = threadIdx.x; idx < groups * N; idx += blockDim.x) {
    const int j = idx % N;
    const int i0 = (idx / N) * RI;
    const int ni = min(RI, M - i0);
    float s[RI];
#pragma unroll
    for (int r = 0; r < RI; ++r) s[r] = 0.f;
    for (int t = 0; t < rows; ++t) {
      const float y = rnd<BF16>(Y[t * ldy + j]);
      const float* x = X + t * ldx + i0;
#pragma unroll
      for (int r = 0; r < RI; ++r) {
        if (r < ni) s[r] = fmaf(rnd<BF16>(x[r]), y, s[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < RI; ++r) {
      if (r < ni) acc_put(acc + static_cast<size_t>(i0 + r) * lda + j, s[r],
                          first);
    }
  }
}

// acc[j] (+)= sum_t X[t, j] * (Y ? Y[t, j] : 1) for j < N (row stride ld)
__device__ void colsum(const float* X, const float* Y, int ld, int rows,
                       int N, float* acc, bool first) {
  for (int j = threadIdx.x; j < N; j += blockDim.x) {
    float s = 0.f;
    for (int t = 0; t < rows; ++t)
      s += Y ? X[t * ld + j] * Y[t * ld + j] : X[t * ld + j];
    acc_put(acc + j, s, first);
  }
}

// Layer norm forward of x[r] + add[r], one warp per row: x[r] becomes
// xhat, inv[r] = 1 / sqrt(var + eps), and h[r] = gamma * xhat + beta (h
// may be null, or add itself: a row's add is read before its h is written)
__device__ void ln_fwd(float* x, const float* add, int rows, int n,
                       const float* __restrict__ gamma,
                       const float* __restrict__ beta, float* inv,
                       float* h) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < rows; r += blockDim.x >> 5) {
    float* xr = x + r * n;
    float s = 0.f;
    for (int i = lane; i < n; i += 32) {
      const float v = xr[i] + add[r * n + i];
      xr[i] = v;
      s += v;
    }
    const float mean = warp_sum(s) / n;
    float sq = 0.f;
    for (int i = lane; i < n; i += 32) {
      const float d = xr[i] - mean;
      sq += d * d;
    }
    const float iv = rsqrtf(warp_sum(sq) / n + kLnEps);
    for (int i = lane; i < n; i += 32) {
      const float xh = (xr[i] - mean) * iv;
      xr[i] = xh;
      if (h) h[r * n + i] = __ldg(gamma + i) * xh + __ldg(beta + i);
    }
    if (lane == 0) inv[r] = iv;
  }
}

// Layer norm backward in place, one warp per row:
// g[r] <- (gg - mean(gg) - xhat * mean(gg * xhat)) * inv[r], gg = g * gamma
__device__ void ln_bwd(float* g, const float* xhat, const float* inv,
                       int rows, int n, const float* __restrict__ gamma) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < rows; r += blockDim.x >> 5) {
    float* gr = g + r * n;
    const float* xr = xhat + r * n;
    float s1 = 0.f, s2 = 0.f;
    for (int i = lane; i < n; i += 32) {
      const float gg = gr[i] * __ldg(gamma + i);
      s1 += gg;
      s2 += gg * xr[i];
    }
    const float m1 = warp_sum(s1) / n;
    const float m2 = warp_sum(s2) / n;
    for (int i = lane; i < n; i += 32) {
      const float gg = gr[i] * __ldg(gamma + i);
      gr[i] = (gg - m1 - xr[i] * m2) * inv[r];
    }
  }
}

__device__ void softmax_plain(float* s, int rows, int n) {
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
    for (int i = lane; i < n; i += 32) sr[i] = sr[i] / sum;
  }
}

// One head's probabilities: S[q, k] = softmax_k of the masked, scaled
// scores of Q_h (Tq rows) against K_h (T keys), no query mask, no dropout,
// not rounded; DM[q, k] = qmask[q] * the dropout mask (site, b, q, k).
// Q and K are stored rounded to the compute type.
__device__ void head_probs(const float* Q, int ldq, const float* K, int ldk,
                           int Tq, int T, int dh, const float* km,
                           const float* qm, float scale, const Dropout& drop,
                           unsigned site, unsigned b, float* S, float* DM) {
  const unsigned ex = drop.on ? drop.example(site, b) : 0u;
  for (int idx = threadIdx.x; idx < Tq * T; idx += blockDim.x) {
    const int q = idx / T;
    const int k = idx % T;
    const float* qp = Q + q * ldq;
    const float* kp = K + k * ldk;
    float s = 0.f;
    for (int d = 0; d < dh; ++d) s = fmaf(qp[d], kp[d], s);
    S[idx] = km[k] > 0.f ? s * scale : kNegInf;
    DM[idx] = (qm ? qm[q] : 1.f) * drop.scale_at(ex, q, k);
  }
  __syncthreads();
  softmax_plain(S, Tq, T);
  __syncthreads();
}

__host__ __device__ inline size_t big_floats(int T, int D, int F) {
  const size_t a = static_cast<size_t>(T) * F;
  const size_t b = static_cast<size_t>(T) * (2 * D + 1) +
                   2 * static_cast<size_t>(T) * D;
  const size_t c = 3 * static_cast<size_t>(T) * D;
  return a > b ? (a > c ? a : c) : (b > c ? b : c);
}

inline size_t smem_floats(int T, int D, int F, int H) {
  const size_t TD = static_cast<size_t>(T) * D;
  const size_t TT = static_cast<size_t>(T) * T;
  return 5 * TD + static_cast<size_t>(T) * (3 * D + 1)  // E0 X1 X2 G2 G1 QKV
         + big_floats(T, D, F) + TT + (T <= 2 * D ? 0 : TT)  // work, S0, S1
         + 4 * static_cast<size_t>(T)                     // km inv1 inv2 rs
         + 8 * static_cast<size_t>(D) + 2 * static_cast<size_t>(F)
         + 2 * static_cast<size_t>(H) * T + 4;            // decoder vectors
}

// The weights of one sub-block transposed (the wrapper's copies): the
// gradient products with W^T read them row by row.
struct WeightsT {
  const float* wqkv;  // [3D, D]
  const float* w1;    // [F, D]
  const float* w2;    // [D, F]
};

template <typename TIn>
__global__ void __launch_bounds__(kThreads)
    fused_block_bwd_kernel(const TIn* __restrict__ enc,
                           const TIn* __restrict__ dec,
                           const float* __restrict__ mask, Weights ew,
                           Weights dw, WeightsT et, WeightsT dt,
                           const TIn* __restrict__ gout,
                           TIn* __restrict__ d_enc, TIn* __restrict__ d_dec,
                           float* __restrict__ partial, int B, int T, int D,
                           int F, int H, float scale, Dropout drop, int nw) {
  constexpr bool BF16 = !std::is_same<TIn, float>::value;
  extern __shared__ float smem[];
  const int dh = D / H;
  const int D3 = 3 * D;
  const int LQ = D3 + 1;     // odd row strides: conflict-free key reads
  const int LKV = 2 * D + 1;
  const int TD = T * D;
  const int TT = T * T;

  float* E0 = smem;                  // dropped-out encoder input
  float* QKV = E0 + TD;              // [T, LQ], rounded
  float* X1 = QKV + T * LQ;          // ctx, then xhat1
  float* X2 = X1 + TD;               // xhat2 (and S1 while free)
  float* G2 = X2 + TD;               // dH2 -> dln2
  float* G1 = G2 + TD;               // h1 -> H2 -> h1 -> dh1 -> da1
  float* BIG = G1 + TD;              // work area
  float* S0 = BIG + big_floats(T, D, F);
  float* S1 = T <= 2 * D ? X2 : S0 + TT;
  float* km = S0 + TT + (T <= 2 * D ? 0 : TT);
  float* inv1 = km + T;
  float* inv2 = inv1 + T;
  float* d0 = inv2 + 2 * T;          // (one [T] spare for alignment)
  float* qd = d0 + D;
  float* x1d = qd + D;
  float* hd = x1d + D;
  float* x2d = hd + D;
  float* gd = x2d + D;
  float* dhd = gd + D;
  float* dqd = dhd + D;
  float* fd = dqd + D;
  float* dfd = fd + F;
  float* pdd = dfd + F;              // decoder p0 [H, T]
  float* dmd = pdd + H * T;          // decoder dropout mask -> dp -> ds
  float* st = dmd + H * T;           // inv1d, inv2d
  float* KVd = BIG;                  // [T, LKV]: Kd | Vd, rounded
  float* dKd = BIG + T * LKV;
  float* dVd = dKd + TD;
  float* dQ = BIG;
  float* dK = BIG + TD;
  float* dV = BIG + 2 * TD;

  if (drop.on) drop.load_seed();
  float* acc_e = partial + static_cast<size_t>(blockIdx.x) * nw;
  float* acc_d = acc_e + nw / 2;
  const int o_vecs = D * D3;
  const int o_w1 = o_vecs + 8 * D;
  const int o_b1 = o_w1 + D * F;
  const int o_w2 = o_b1 + F;

  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    const bool first = b == static_cast<int>(blockIdx.x);
    const unsigned ex_e = drop.on ? drop.example(kSiteEncIn, b) : 0u;
    const unsigned ex_d = drop.on ? drop.example(kSiteDecIn, b) : 0u;
    const TIn* e = enc + static_cast<size_t>(b) * TD;
    for (int i = threadIdx.x; i < TD; i += blockDim.x)
      E0[i] = to_float(e[i]) * drop.scale_at(ex_e, i / D, i % D);
    for (int i = threadIdx.x; i < D; i += blockDim.x) {
      d0[i] = to_float(dec[static_cast<size_t>(b) * D + i]) *
              drop.scale_at(ex_d, 0, i);
      gd[i] = to_float(gout[static_cast<size_t>(b) * D + i]);
    }
    for (int i = threadIdx.x; i < T; i += blockDim.x)
      km[i] = mask[static_cast<size_t>(b) * T + i];
    __syncthreads();

    // ================= replay: encoder =================
    matmul<BF16>(E0, D, T, D, ew.wqkv, D3, ew.vecs, D3, QKV, LQ, false, true);
    __syncthreads();
    for (int h = 0; h < H; ++h) {
      head_probs(QKV + h * dh, LQ, QKV + D + h * dh, LQ, T, T, dh, km, km,
                 scale, drop, kSiteEncProbs * 16 + h, b, S0, S1);
      for (int idx = threadIdx.x; idx < T * dh; idx += blockDim.x) {
        const int q = idx / dh;
        const int j = h * dh + idx % dh;
        float s = 0.f;
        for (int k = 0; k < T; ++k)
          s = fmaf(rnd<BF16>(S0[q * T + k] * S1[q * T + k]),
                   QKV[k * LQ + 2 * D + j], s);
        X1[q * D + j] = s;
      }
      __syncthreads();
    }
    ln_fwd(X1, E0, T, D, ew.vecs + 3 * D, ew.vecs + 4 * D, inv1, G1);
    __syncthreads();
    matmul<BF16>(G1, D, T, D, ew.w1, F, ew.b1, F, BIG, F, true, false);
    __syncthreads();
    matmul<BF16>(BIG, F, T, F, ew.w2, D, ew.vecs + 7 * D, D, X2, D, false,
                 false);
    __syncthreads();
    // H2 overwrites h1 in G1 (h1 comes back from xhat1 when needed)
    ln_fwd(X2, G1, T, D, ew.vecs + 5 * D, ew.vecs + 6 * D, inv2, G1);
    __syncthreads();

    // ================= replay: decoder =================
    matmul<BF16>(G1, D, T, D, dw.wqkv + D, D3, dw.vecs + D, 2 * D, KVd, LKV,
                 false, true);
    matmul<BF16>(d0, D, 1, D, dw.wqkv, D3, dw.vecs, D, qd, D, false, true);
    __syncthreads();
    for (int h = 0; h < H; ++h)
      head_probs(qd + h * dh, D, KVd + h * dh, LKV, 1, T, dh, km, nullptr,
                 scale, drop, kSiteDecProbs * 16 + h, b, pdd + h * T,
                 dmd + h * T);
    for (int j = threadIdx.x; j < D; j += blockDim.x) {
      const int h = j / dh;
      float s = 0.f;
      for (int k = 0; k < T; ++k)
        s = fmaf(rnd<BF16>(pdd[h * T + k] * dmd[h * T + k]),
                 KVd[k * LKV + D + j], s);
      x1d[j] = s;
    }
    __syncthreads();
    ln_fwd(x1d, d0, 1, D, dw.vecs + 3 * D, dw.vecs + 4 * D, st, hd);
    __syncthreads();
    matmul<BF16>(hd, D, 1, D, dw.w1, F, dw.b1, F, fd, F, true, false);
    __syncthreads();
    matmul<BF16>(fd, F, 1, F, dw.w2, D, dw.vecs + 7 * D, D, x2d, D, false,
                 false);
    __syncthreads();
    ln_fwd(x2d, hd, 1, D, dw.vecs + 5 * D, dw.vecs + 6 * D, st + 1, nullptr);
    __syncthreads();

    // ================= backward: decoder FF and LNs =================
    colsum(gd, x2d, D, 1, D, acc_d + o_vecs + 5 * D, first);
    colsum(gd, nullptr, D, 1, D, acc_d + o_vecs + 6 * D, first);
    __syncthreads();
    ln_bwd(gd, x2d, st + 1, 1, D, dw.vecs + 5 * D);          // dln2
    __syncthreads();
    colsum(gd, nullptr, D, 1, D, acc_d + o_vecs + 7 * D, first);
    wgrad<BF16>(fd, F, gd, D, 1, F, D, acc_d + o_w2, D, first);
    matmul_nt<BF16>(gd, D, 1, D, dt.w2, F, F, dfd, F, nullptr, fd);
    __syncthreads();
    colsum(dfd, nullptr, F, 1, F, acc_d + o_b1, first);
    wgrad<BF16>(hd, D, dfd, F, 1, D, F, acc_d + o_w1, F, first);
    matmul_nt<BF16>(dfd, F, 1, F, dt.w1, D, D, dhd, D, gd, nullptr);  // dh1
    __syncthreads();
    colsum(dhd, x1d, D, 1, D, acc_d + o_vecs + 3 * D, first);
    colsum(dhd, nullptr, D, 1, D, acc_d + o_vecs + 4 * D, first);
    __syncthreads();
    ln_bwd(dhd, x1d, st, 1, D, dw.vecs + 3 * D);             // da1d
    __syncthreads();

    // ================= backward: decoder attention =================
    for (int idx = threadIdx.x; idx < TD; idx += blockDim.x) {
      const int k = idx / D;
      const int j = idx % D;
      const int h = j / dh;
      dVd[idx] = rnd<BF16>(pdd[h * T + k] * dmd[h * T + k]) *
                 rnd<BF16>(dhd[j]);
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < H * T; idx += blockDim.x) {
      const int h = idx / T;
      const int k = idx % T;
      float s = 0.f;
      for (int d = 0; d < dh; ++d)
        s = fmaf(rnd<BF16>(dhd[h * dh + d]), KVd[k * LKV + D + h * dh + d],
                 s);
      dmd[idx] = s * dmd[idx];
    }
    __syncthreads();
    {
      const int lane = threadIdx.x & 31;
      for (int h = threadIdx.x >> 5; h < H; h += blockDim.x >> 5) {
        float s = 0.f;
        for (int k = lane; k < T; k += 32) s += dmd[h * T + k] * pdd[h * T + k];
        const float rs = warp_sum(s);
        for (int k = lane; k < T; k += 32)
          dmd[h * T + k] = km[k] > 0.f
                               ? pdd[h * T + k] * (dmd[h * T + k] - rs)
                               : 0.f;
      }
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < TD; idx += blockDim.x) {
      const int k = idx / D;
      const int j = idx % D;
      dKd[idx] = rnd<BF16>(dmd[(j / dh) * T + k]) * rnd<BF16>(qd[j]) * scale;
    }
    for (int j = threadIdx.x; j < D; j += blockDim.x) {
      const int h = j / dh;
      float s = 0.f;
      for (int k = 0; k < T; ++k)
        s = fmaf(rnd<BF16>(dmd[h * T + k]), KVd[k * LKV + j], s);
      dqd[j] = s * scale;
    }
    __syncthreads();
    wgrad<BF16>(d0, D, dqd, D, 1, D, D, acc_d, D3, first);
    wgrad<BF16>(G1, D, dKd, D, T, D, D, acc_d + D, D3, first);
    wgrad<BF16>(G1, D, dVd, D, T, D, D, acc_d + 2 * D, D3, first);
    colsum(dqd, nullptr, D, 1, D, acc_d + o_vecs, first);
    colsum(dKd, nullptr, D, T, D, acc_d + o_vecs + D, first);
    colsum(dVd, nullptr, D, T, D, acc_d + o_vecs + 2 * D, first);
    for (int i = threadIdx.x; i < D; i += blockDim.x) {
      float s = 0.f;
      for (int j = 0; j < D; ++j)
        s = fmaf(rnd<BF16>(dqd[j]), rnd<BF16>(__ldg(dt.wqkv + j * D + i)), s);
      store(d_dec + static_cast<size_t>(b) * D + i,
            (dhd[i] + s) * drop.scale_at(ex_d, 0, i));
    }
    // dH2 = dKd wk^T + dVd wv^T
    for (int idx = threadIdx.x; idx < TD; idx += blockDim.x) {
      const int t = idx / D;
      const float* w = dt.wqkv + idx % D;
      float s1 = 0.f, s2 = 0.f;
      for (int j = 0; j < D; ++j) {
        s1 = fmaf(rnd<BF16>(dKd[t * D + j]),
                  rnd<BF16>(__ldg(w + (D + j) * D)), s1);
        s2 = fmaf(rnd<BF16>(dVd[t * D + j]),
                  rnd<BF16>(__ldg(w + (2 * D + j) * D)), s2);
      }
      G2[idx] = s1 + s2;
    }
    __syncthreads();

    // ================= backward: encoder FF and LNs =================
    colsum(G2, X2, D, T, D, acc_e + o_vecs + 5 * D, first);
    colsum(G2, nullptr, D, T, D, acc_e + o_vecs + 6 * D, first);
    for (int idx = threadIdx.x; idx < TD; idx += blockDim.x) {
      const int i = idx % D;
      G1[idx] = __ldg(ew.vecs + 3 * D + i) * X1[idx] +
                __ldg(ew.vecs + 4 * D + i);                 // h1
    }
    __syncthreads();
    ln_bwd(G2, X2, inv2, T, D, ew.vecs + 5 * D);              // dln2
    matmul<BF16>(G1, D, T, D, ew.w1, F, ew.b1, F, BIG, F, true, false);  // f
    __syncthreads();
    colsum(G2, nullptr, D, T, D, acc_e + o_vecs + 7 * D, first);
    wgrad<BF16>(BIG, F, G2, D, T, F, D, acc_e + o_w2, D, first);
    __syncthreads();
    matmul_nt<BF16>(G2, D, T, D, et.w2, F, F, BIG, F, nullptr, BIG);  // dfpre
    __syncthreads();
    colsum(BIG, nullptr, F, T, F, acc_e + o_b1, first);
    wgrad<BF16>(G1, D, BIG, F, T, D, F, acc_e + o_w1, F, first);
    __syncthreads();
    matmul_nt<BF16>(BIG, F, T, F, et.w1, D, D, G1, D, G2, nullptr);  // dh1
    __syncthreads();
    colsum(G1, X1, D, T, D, acc_e + o_vecs + 3 * D, first);
    colsum(G1, nullptr, D, T, D, acc_e + o_vecs + 4 * D, first);
    __syncthreads();
    ln_bwd(G1, X1, inv1, T, D, ew.vecs + 3 * D);              // da1
    __syncthreads();

    // ================= backward: encoder attention =================
    for (int h = 0; h < H; ++h) {
      head_probs(QKV + h * dh, LQ, QKV + D + h * dh, LQ, T, T, dh, km, km,
                 scale, drop, kSiteEncProbs * 16 + h, b, S0, S1);
      for (int idx = threadIdx.x; idx < T * dh; idx += blockDim.x) {
        const int k = idx / dh;
        const int j = h * dh + idx % dh;
        float s = 0.f;
        for (int q = 0; q < T; ++q)
          s = fmaf(rnd<BF16>(S0[q * T + k] * S1[q * T + k]),
                   rnd<BF16>(G1[q * D + j]), s);
        dV[k * D + j] = s;
      }
      __syncthreads();
      for (int idx = threadIdx.x; idx < TT; idx += blockDim.x) {
        const int q = idx / T;
        const int k = idx % T;
        const float* gp = G1 + q * D + h * dh;
        const float* vp = QKV + k * LQ + 2 * D + h * dh;
        float s = 0.f;
        for (int d = 0; d < dh; ++d) s = fmaf(rnd<BF16>(gp[d]), vp[d], s);
        S1[idx] = s * S1[idx];
      }
      __syncthreads();
      {
        const int lane = threadIdx.x & 31;
        for (int q = threadIdx.x >> 5; q < T; q += blockDim.x >> 5) {
          float s = 0.f;
          for (int k = lane; k < T; k += 32) s += S1[q * T + k] * S0[q * T + k];
          const float rs = warp_sum(s);
          for (int k = lane; k < T; k += 32)
            S0[q * T + k] =
                km[k] > 0.f ? S0[q * T + k] * (S1[q * T + k] - rs) : 0.f;
        }
      }
      __syncthreads();
      for (int idx = threadIdx.x; idx < T * dh; idx += blockDim.x) {
        const int r = idx / dh;
        const int j = h * dh + idx % dh;
        float sq = 0.f, sk = 0.f;
        for (int k = 0; k < T; ++k) {
          sq = fmaf(rnd<BF16>(S0[r * T + k]), QKV[k * LQ + D + j], sq);
          sk = fmaf(rnd<BF16>(S0[k * T + r]), QKV[k * LQ + j], sk);
        }
        dQ[r * D + j] = sq * scale;
        dK[r * D + j] = sk * scale;
      }
      __syncthreads();
    }
    wgrad<BF16>(E0, D, dQ, D, T, D, D, acc_e, D3, first);
    wgrad<BF16>(E0, D, dK, D, T, D, D, acc_e + D, D3, first);
    wgrad<BF16>(E0, D, dV, D, T, D, D, acc_e + 2 * D, D3, first);
    colsum(dQ, nullptr, D, T, D, acc_e + o_vecs, first);
    colsum(dK, nullptr, D, T, D, acc_e + o_vecs + D, first);
    colsum(dV, nullptr, D, T, D, acc_e + o_vecs + 2 * D, first);
    TIn* de = d_enc + static_cast<size_t>(b) * TD;
    for (int idx = threadIdx.x; idx < TD; idx += blockDim.x) {
      const int t = idx / D;
      const int i = idx % D;
      const float* w = et.wqkv + i;
      float s1 = 0.f, s2 = 0.f, s3 = 0.f;
      for (int j = 0; j < D; ++j) {
        s1 = fmaf(rnd<BF16>(dQ[t * D + j]), rnd<BF16>(__ldg(w + j * D)), s1);
        s2 = fmaf(rnd<BF16>(dK[t * D + j]),
                  rnd<BF16>(__ldg(w + (D + j) * D)), s2);
        s3 = fmaf(rnd<BF16>(dV[t * D + j]),
                  rnd<BF16>(__ldg(w + (2 * D + j) * D)), s3);
      }
      store(de + idx, ((G1[idx] + s1) + (s2 + s3)) *
                          drop.scale_at(ex_e, t, i));
    }
    __syncthreads();
  }
}

// out[i] = sum over the P partial rows, in row order (deterministic)
__global__ void reduce_partials(const float* __restrict__ partial, int P,
                                int nw, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nw) return;
  float s = 0.f;
  for (int p = 0; p < P; ++p) s += partial[static_cast<size_t>(p) * nw + i];
  out[i] = s;
}

template <typename TIn>
cudaError_t launch(const void* enc, const void* dec, const void* mask,
                   Weights ew, Weights dw, WeightsT et, WeightsT dt,
                   const void* g, void* d_enc,
                   void* d_dec, float* partial, float* gw, int B, int T,
                   int D, int F, int H, float scale, Dropout drop,
                   int blocks, cudaStream_t stream) {
  const size_t bytes = smem_floats(T, D, F, H) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fused_block_bwd_kernel<TIn>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const int nw = 2 * (D * 3 * D + 8 * D + D * F + F + F * D);
  fused_block_bwd_kernel<TIn><<<blocks, kThreads, bytes, stream>>>(
      static_cast<const TIn*>(enc), static_cast<const TIn*>(dec),
      static_cast<const float*>(mask), ew, dw, et, dt,
      static_cast<const TIn*>(g),
      static_cast<TIn*>(d_enc), static_cast<TIn*>(d_dec), partial, B, T, D,
      F, H, scale, drop, nw);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  reduce_partials<<<(nw + 255) / 256, 256, 0, stream>>>(partial, blocks, nw,
                                                        gw);
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

// Launches the backward and the partial-sum reduction on `stream`; returns
// the CUDA error code, 0 on success.  The *_t weights are the transposes
// of wqkv, w1 and w2.  `partial` holds blocks x nw floats
// (nw = 2 * (3D^2 + 8D + 2DF + F)), `gw` nw floats.  Does not synchronise.
int fused_block_bwd(const void* enc, const void* dec, const void* mask,
                    const void* e_wqkv, const void* e_vecs, const void* e_w1,
                    const void* e_b1, const void* e_w2, const void* d_wqkv,
                    const void* d_vecs, const void* d_w1, const void* d_b1,
                    const void* d_w2, const void* e_wqkv_t,
                    const void* e_w1_t, const void* e_w2_t,
                    const void* d_wqkv_t, const void* d_w1_t,
                    const void* d_w2_t, const void* g, void* d_enc,
                    void* d_dec,
                    void* partial, void* gw, int B, int T, int D, int F,
                    int H, float scale, int is_bf16, const void* seed,
                    int train, int keep_thr, float drop_scale, int blocks,
                    void* stream) {
  if (B == 0) return 0;
  const Weights ew = weights(e_wqkv, e_vecs, e_w1, e_b1, e_w2);
  const Weights dw = weights(d_wqkv, d_vecs, d_w1, d_b1, d_w2);
  const WeightsT et{static_cast<const float*>(e_wqkv_t),
                    static_cast<const float*>(e_w1_t),
                    static_cast<const float*>(e_w2_t)};
  const WeightsT dt{static_cast<const float*>(d_wqkv_t),
                    static_cast<const float*>(d_w1_t),
                    static_cast<const float*>(d_w2_t)};
  const Dropout drop = make_dropout(seed, train, keep_thr, drop_scale);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partial);
  float* out = static_cast<float*>(gw);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(enc, dec, mask, ew, dw, et, dt, g,
                                      d_enc, d_dec, p, out, B, T, D, F, H,
                                      scale, drop, blocks, s)
              : launch<float>(enc, dec, mask, ew, dw, et, dt, g, d_enc, d_dec,
                              p, out, B, T, D, F, H, scale, drop, blocks, s);
  return static_cast<int>(err);
}

const char* fused_block_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
