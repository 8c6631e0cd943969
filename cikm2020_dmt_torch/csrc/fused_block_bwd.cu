// Fused Deep-Interest-Transformer block backward.
//
// Replaces the TPU kernel cikm2020_dmt_tpu/ops/block.py `_make_bwd_kernel`
// (launched through `_bwd_call`): a full-recompute backward.  Per example it
// replays the forward with the functions of block_fwd_tiles.cuh, the ones
// fused_block_fwd.cu runs (same products in the same order, same dropout
// masks from dropout.cuh), and chains the gradients by hand, as the TPU
// kernel's _ffln_bwd / _attend3_bwd / _ln_bwd do, with one difference: a
// masked key's score is a constant, so no gradient reaches it (this changes
// only rows with no present key, where the reference's jnp path and the TPU
// kernel disagree; the jnp path is followed).  Inputs: enc [B,T,D],
// dec [B,D], the key mask, the packed weights, the output cotangent g
// [B,D].  Outputs: d_enc, d_dec and the 10 float32 weight grads of
// ops/block.py `pack_weights`, summed over the batch, as one flat array.
// Widths: D, F and H as built (block_fwd_tiles.cuh), any T >= 1.
//
// Types: as in the forward, with bfloat16 inputs every operand of every
// product (forward replay and gradient products alike) is rounded to
// bfloat16; everything else is float32.
//
// Bound: about 3x the forward's products (the replay, then the input and
// the weight gradient of each product): ~28 MFLOP per example at T=50,
// against ~33 KB moved, so bound by arithmetic (ops/block.py
// `block_bwd_flops`; `block_tc_bound_ms` for the tensor cores).
//
// Save mode (the TPU kernel's `save=True`, switched on by DMT_BLOCK_SAVE):
// given the encoder's Q, K, V and attention context that fused_block_fwd
// saved, the replay loads them and skips the encoder's QKV projection and
// attention forward (2.7 of the forward's 9.3 MFLOP an example at T=50),
// for 3 x 2 or 4 bytes and 4 bytes more read a position and column.  It
// still replays the encoder's FF + LN and the decoder, whose residuals the
// backward reads, and the attention backward still forms P again from
// QKV.  The saved values are the bits the replay would form, so both
// modes give the same bits.
//
// Design: three kernels in one call.
// 1. pack_kernel (block_fwd_tiles.cuh): the B operands of the per-example
//    products (wqkv, w1, w2, their transposes, the decoder's K/V columns
//    and their transpose) in mma fragment order, each element split into
//    TF32 hi and lo (or rounded to bfloat16), so a warp reads a fragment
//    with one coalesced 16-byte load a lane; it also clears the arrival
//    counters of kernel 3.
// 2. block_bwd_kernel: one example at a time a block (a persistent grid of
//    as many blocks as fit on the SMs), every activation of the example in
//    shared memory (~227 KB at T=50 and the model's widths, so one
//    512-thread block an SM; ~47 KB and 256 threads at T <= 32, so
//    several), or, past what a block can opt into, in the block's slice of
//    the workspace (SPILL).  The products of T rows with a weight (QKV, FF,
//    the decoder's K/V, and their input gradients) run on the tensor
//    cores: warp tiles of mma.sync m16n8k8, the activation fragment from
//    shared memory by ldmatrix and split in registers (3xTF32 for float32,
//    tiles.cuh), the weight fragment from kernel 1; rows are padded to 16
//    in registers only and masked at the store.  Attention runs on the FMA
//    units, a query row to a group of lanes holding its keys in registers
//    (softmax by shuffles); the decoder's one-row products split K over
//    all threads and add the slices in a fixed order.  It writes no weight
//    gradient: it writes the operand rows of each weight product (X and
//    dY, rounded where bf16 rounds) and each example's bias and layer-norm
//    sums to a scratch area.
// 3. wgrad_kernel: dW = X^T dY for the seven weight products over all
//    rows, on the tensor cores (3xTF32), in 80 x 80 tiles over fixed row
//    chunks; the last chunk of a tile to finish (an arrival counter) adds
//    the chunks' partial tiles in chunk order, and the bias sums are added
//    over the examples the same way.  No sum depends on timing, so two
//    launches give the same bits.
// So no weight gradient is read and written back per example (per-block
// partials updated for every example moved ~2.3 GB a launch), and every
// thread has work in the decoder's one-row phases.

// Phases skipped at compile time to split the kernel's time by phase
// (scripts/block_bwd_variants.py); 0 in the library.
#ifndef BLOCK_BWD_SKIP
#define BLOCK_BWD_SKIP 0
#endif

#include <cfloat>
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "block_fwd_tiles.cuh"

namespace {

constexpr int kNV = 8 * kD + kF;  // bias and layer-norm grads of a sub-block
constexpr int kSub = 3 * kD * kD + 8 * kD + 2 * kD * kF + kF;
constexpr int kOffVecs = 3 * kD * kD;
constexpr int kOffW1 = kOffVecs + 8 * kD;
constexpr int kOffB1 = kOffW1 + kD * kF;
constexpr int kOffW2 = kOffB1 + kF;

// A per-example sum kept as it is, at real column r (none at padding).
template <int KIND>
__device__ __forceinline__ void keep_sum(float* p, int r, float v) {
  if constexpr (run(kSkipWgrad))
    if (real<KIND>(r)) p[r] = v;
}
template <bool BF16>
__device__ __forceinline__ void keep4(float* p, float4 v) {
  if constexpr (run(kSkipWgrad))
    stg4(p, make_float4(rnd<BF16>(v.x), rnd<BF16>(v.y), rnd<BF16>(v.z),
                        rnd<BF16>(v.w)));
}

// Layer norm backward in place, one warp a row:
// g[r] <- (gg - mean(gg) - xhat * mean(gg * xhat)) * inv[r], gg = g * gamma
// over the real columns (padding 0); gk[r] (device memory, kDp a row) gets
// its rounding when not null.
template <bool BF16, int NW>
__device__ void ln_bwd_rows(float* g, int ldg, const float* xhat, int ldx,
                            const float* inv, int rows,
                            const float* __restrict__ gamma, float* gk) {
  constexpr int E = (kDp + 31) / 32;
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < rows; r += NW) {
    float gg[E];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int i = lane + 32 * e;
      gg[e] = 0.f;
      if (dreal(i)) {
        gg[e] = g[r * ldg + i] * vec_at<kMapD>(gamma, i);
        s1 += gg[e];
        s2 += gg[e] * xhat[r * ldx + i];
      }
    }
    const float m1 = warp_sum(s1) / kD;
    const float m2 = warp_sum(s2) / kD;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int i = lane + 32 * e;
      if (i < kDp) {
        const float out =
            dreal(i) ? (gg[e] - m1 - xhat[r * ldx + i] * m2) * inv[r] : 0.f;
        g[r * ldg + i] = out;
        if (gk) keep<BF16>(gk + r * kDp + i, out);
      }
    }
  }
}

// Column sums over t < rows: out[map(j)] = sum_t A[t, j], and, when X,
// out2[map(j)] = sum_t A[t, j] * X[t, j], for internal j < N, by the
// threads first .. first + count - 1.
template <int KIND>
__device__ void colsums(const float* A, int lda, const float* X, int ldx,
                        int rows, int N, float* out, float* out2, int first,
                        int count) {
  for (int j = threadIdx.x - first; j >= 0 && j < N; j += count) {
    const int rj = cmap<KIND>(j);
    if (!real<KIND>(rj)) continue;
    float s = 0.f, s2 = 0.f;
    for (int t = 0; t < rows; ++t) {
      const float a = A[t * lda + j];
      s += a;
      if (X) s2 += a * X[t * ldx + j];
    }
    keep_sum<KIND>(out, rj, s);
    if (X) keep_sum<KIND>(out2, rj, s2);
  }
}

__device__ __forceinline__ float4 rnd4_bf16(float4 v) {
  return make_float4(rnd<true>(v.x), rnd<true>(v.y), rnd<true>(v.z),
                     rnd<true>(v.w));
}

// Backward of head h, row pass: for every query q, P~ = rnd(P0 DM) -> SA,
// dP = (rnd(da1_h) v_h^T) DM, dS = P0 (dP - rowsum(dP P0)) (0 at masked
// keys), rnd(dS) -> SB, and dq_h = scale rnd(dS) k_h -> dQKV and ye.
template <bool BF16, int NT>
__device__ void enc_att_bwd_rows(int h, const float* QKV, const float* km,
                                 const float* G1, int T, float scale,
                                 const Dropout& drop, unsigned b, float* SA,
                                 float* SB, float* dQKV, float* ye) {
  constexpr int KS = kAttKeysBwd;
  const int lshift = lane_shift<KS>(T);
  const int L = 1 << lshift;
  const int c = threadIdx.x & (L - 1);
  const int g = threadIdx.x >> lshift;
  const int groups = NT >> lshift;
  const int warp_g0 = (threadIdx.x & ~31) >> lshift;
  const unsigned ex = drop.on ? drop.example(kSiteEncProbs * 16 + h, b) : 0u;
  for (int base = 0; base + warp_g0 < T; base += groups) {
    const int it = base + g;
    const bool active = it < T;
    const int q = active ? it : T - 1;
    float p0[KS];
    head_softmax<KS>(p0, QKV, km, T, h, q, scale, c, lshift);
    float4 gx[kC];
#pragma unroll
    for (int cc = 0; cc < kC; ++cc) {
      gx[cc] = lds4(G1 + q * LD1 + h * kDhp + 4 * cc);
      if (BF16) gx[cc] = rnd4_bf16(gx[cc]);
    }
    const float qmr = km[q];
    float dp[KS];
    float rs = 0.f;
#pragma unroll
    for (int i = 0; i < KS; ++i) {
      const int j = c + (i << lshift);
      const int jc = min(j, T - 1);
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int cc = 0; cc < kC; ++cc)
        dot4x(gx[cc], lds4(QKV + jc * LD3 + 2 * kDp + h * kDhp + 4 * cc),
              acc);
      const float dm = j < T ? qmr * drop.scale_at(ex, q, j) : 0.f;
      dp[i] = sum4(acc) * dm;
      if (active && j < T) SA[q * T + j] = rnd<BF16>(p0[i] * dm);
      rs += dp[i] * p0[i];
    }
    rs = group_sum(rs, L);
    float4 o[kC];
#pragma unroll
    for (int cc = 0; cc < kC; ++cc) o[cc] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int i = 0; i < KS; ++i) {
      const int j = c + (i << lshift);
      const int jc = min(j, T - 1);
      const float ds =
          rnd<BF16>(j < T && km[jc] > 0.f ? p0[i] * (dp[i] - rs) : 0.f);
      if (active && j < T) SB[q * T + j] = ds;
#pragma unroll
      for (int cc = 0; cc < kC; ++cc)
        fma4(o[cc], ds, lds4(QKV + jc * LD3 + kDp + h * kDhp + 4 * cc));
    }
    group_sum4(o, L);
    if (active) {
#pragma unroll
      for (int cc = 0; cc < kC; ++cc) {
        if ((cc & (L - 1)) == c) {
          const float4 v = make_float4(o[cc].x * scale, o[cc].y * scale,
                                       o[cc].z * scale, o[cc].w * scale);
          sts4(dQKV + q * LD3 + h * kDhp + 4 * cc, v);
          keep4<BF16>(ye + q * 3 * kDp + h * kDhp + 4 * cc, v);
        }
      }
    }
  }
}

// enc_att_bwd_rows past kRegT keys: a warp a query row; its SB row holds
// the softmax's exp and its SA row dP until both are overwritten.
template <bool BF16, int NW>
__device__ void enc_att_bwd_rows_long(int h, const float* QKV,
                                      const float* km, const float* G1,
                                      int T, float scale, const Dropout& drop,
                                      unsigned b, float* SA, float* SB,
                                      float* dQKV, float* ye) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const unsigned ex = drop.on ? drop.example(kSiteEncProbs * 16 + h, b) : 0u;
  for (int q = warp; q < T; q += NW) {
    float* sa = SA + q * T;
    float* sb = SB + q * T;
    const float inv = row_softmax_long(sb, QKV, km, T, h, q, scale);
    float4 gx[kC];
#pragma unroll
    for (int cc = 0; cc < kC; ++cc) {
      gx[cc] = lds4(G1 + q * LD1 + h * kDhp + 4 * cc);
      if (BF16) gx[cc] = rnd4_bf16(gx[cc]);
    }
    const float qmr = km[q];
    float rs = 0.f;
    for (int j = lane; j < T; j += 32) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int cc = 0; cc < kC; ++cc)
        dot4x(gx[cc], lds4(QKV + j * LD3 + 2 * kDp + h * kDhp + 4 * cc),
              acc);
      const float dp = sum4(acc) * (qmr * drop.scale_at(ex, q, j));
      sa[j] = dp;
      rs += dp * (sb[j] * inv);
    }
    rs = warp_sum(rs);
    float4 o[kC];
#pragma unroll
    for (int cc = 0; cc < kC; ++cc) o[cc] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j = lane; j < T; j += 32) {
      const float p0 = sb[j] * inv;
      const float ds = rnd<BF16>(km[j] > 0.f ? p0 * (sa[j] - rs) : 0.f);
      sa[j] = rnd<BF16>(p0 * (qmr * drop.scale_at(ex, q, j)));
      sb[j] = ds;
#pragma unroll
      for (int cc = 0; cc < kC; ++cc)
        fma4(o[cc], ds, lds4(QKV + j * LD3 + kDp + h * kDhp + 4 * cc));
    }
    group_sum4(o, 32);
#pragma unroll
    for (int cc = 0; cc < kC; ++cc) {
      if ((cc & 31) == lane) {
        const float4 v = make_float4(o[cc].x * scale, o[cc].y * scale,
                                     o[cc].z * scale, o[cc].w * scale);
        sts4(dQKV + q * LD3 + h * kDhp + 4 * cc, v);
        keep4<BF16>(ye + q * 3 * kDp + h * kDhp + 4 * cc, v);
      }
    }
    __syncwarp();
  }
}

// Backward of head h, column pass: dv_h[k] = sum_q SA[q, k] rnd(da1_h[q]),
// dk_h[k] = scale sum_q SB[q, k] q_h[q]; a thread owns one key's float4.
template <bool BF16, int NT>
__device__ void enc_att_bwd_cols(int h, const float* QKV, const float* G1,
                                 int T, float scale, const float* SA,
                                 const float* SB, float* dQKV, float* ye) {
  const int n = 2 * T * kC;
  for (int idx = threadIdx.x; idx < n; idx += NT) {
    const bool isk = idx >= T * kC;
    const int w = isk ? idx - T * kC : idx;
    const int k = w / kC;
    const int cc = w - k * kC;
    const float* P = isk ? SB : SA;
    const float* X = isk ? QKV + h * kDhp + 4 * cc : G1 + h * kDhp + 4 * cc;
    const int ldx = isk ? LD3 : LD1;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int q = 0; q < T; ++q) {
      float4 x = lds4(X + q * ldx);
      if (BF16 && !isk) x = rnd4_bf16(x);
      fma4(acc, P[q * T + k], x);
    }
    if (isk) {
      acc.x *= scale;
      acc.y *= scale;
      acc.z *= scale;
      acc.w *= scale;
    }
    const int col = (isk ? kDp : 2 * kDp) + h * kDhp + 4 * cc;
    sts4(dQKV + k * LD3 + col, acc);
    keep4<BF16>(ye + k * 3 * kDp + col, acc);
  }
}

// ---------------------------------------------------------------------------
// Kernel 2: one example at a time a block
// ---------------------------------------------------------------------------

// Where kernel 2 leaves the operand rows of the weight products (internal
// layout, rounded where bf16 rounds; rows b T + t) and each example's sums
// (real layout), for kernel 3.
struct Scratch {
  float* xe;   // [B T, kDp]   dropped-out encoder input E0   (x of wqkv)
  float* ye;   // [B T, 3 kDp] dq | dk | dv                   (dy of wqkv)
  float* xh;   // [B T, kDp]   h1                             (x of w1)
  float* yf;   // [B T, kFp]   dfpre                          (dy of w1)
  float* xf;   // [B T, kFp]   f                              (x of w2)
  float* yg;   // [B T, kDp]   dln2                           (dy of w2)
  float* xd;   // [B T, kDp]   H2               (x of the decoder's wk, wv)
  float* yd;   // [B T, 2 kDp] dk_d | dv_d                   (their dy)
  float* xq;   // [B, kDp]     decoder input d0   (x of the decoder's wq)
  float* yq;   // [B, kDp]     dq_d
  float* xhd;  // [B, kDp]     decoder h1
  float* yfd;  // [B, kFp]     decoder dfpre
  float* xfd;  // [B, kFp]     decoder f
  float* ygd;  // [B, kDp]     decoder dln2
  float* vp;   // [B, 2 kNV]   bias and layer-norm sums: encoder, decoder
};

template <int MGW, int NT, bool SPILL, typename TIn>
__global__ void __launch_bounds__(NT, NT == 256 ? 2 : 1)
    block_bwd_kernel(const TIn* __restrict__ enc, const TIn* __restrict__ dec,
                     const float* __restrict__ mask, Weights ew, Weights dw,
                     Packs pk, const TIn* __restrict__ gout,
                     TIn* __restrict__ d_enc, TIn* __restrict__ d_dec,
                     Scratch sc, float* spill, Probe probe, Saved sv, int B,
                     int T, float scale, Dropout drop) {
  constexpr bool BF16 = !std::is_same<TIn, float>::value;
  constexpr int NW = NT / 32;
  extern __shared__ float4 smem4[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  float* base = reinterpret_cast<float*>(smem4);
  if constexpr (SPILL)
    base = spill + blockIdx.x * act_floats(T, NT, true);
  const Act a = act_layout(base, T, NT, true);
  const int T4 = a.T4;
  float* const QKV = a.QKV;
  float* const H1 = a.H1;
  float* const HG = a.HG;
  float* const BIG = a.BIG;
  float* const KVd = a.BIG;               // [T, LD2] k_d | v_d, rounded
  float* const dKVd = a.BIG + T * LD2;    // [T, LD2] dk_d | dv_d
  float* const dQKV = a.BIG;              // [T, LD3]
  float* const km = a.km;
  float* const gd = a.gd;
  float* const dhd = a.dhd;
  float* const pdd = a.pdd;
  float* const dmd = a.dmd;
  float* const dsd = a.dsd;

  const float* evec = ew.vecs;
  const float* dvec = dw.vecs;
  if (drop.on) drop.load_seed();

  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    const unsigned ex_e = drop.on ? drop.example(kSiteEncIn, b) : 0u;
    const unsigned ex_d = drop.on ? drop.example(kSiteDecIn, b) : 0u;
    const size_t row0 = static_cast<size_t>(b) * T;
    float* vpe = sc.vp + static_cast<size_t>(b) * 2 * kNV;
    float* vpd = vpe + kNV;
    load_example<BF16, NT>(a, enc, dec, mask, T, b, drop, sc.xe, sc.xq);
    for (int i = tid; i < kDp; i += NT) {
      const int ri = dmap(i);
      gd[i] = real<kMapD>(ri) ? to_float(gout[static_cast<size_t>(b) * kD + ri])
                      : 0.f;
    }
    __syncthreads();

    if constexpr (run(kSkipReplay)) {
      replay<MGW, BF16, NW, NT, SPILL>(
          a, T, pk, ew, dw, scale, drop, b,
          Keep{sc.xh, sc.xd, sc.xhd, sc.xfd}, probe, sv, nullptr);
    }

    if constexpr (run(kSkipDecBwd)) {
      // ---- backward: decoder FF and layer norms ----
      if (warp == 0) {
        for (int i = lane; i < kDp; i += 32) {
          keep_sum<kMapD>(vpd + 5 * kD, dmap(i), gd[i] * a.x2d[i]);
          keep_sum<kMapD>(vpd + 6 * kD, dmap(i), gd[i]);
        }
        ln_bwd_rows<BF16, 1>(gd, kDp, a.x2d, kDp, a.st + 1, 1, dvec + 5 * kD,
                             sc.ygd + static_cast<size_t>(b) * kDp);
        for (int i = lane; i < kDp; i += 32)
          keep_sum<kMapD>(vpd + 7 * kD, dmap(i), gd[i]);
      }
      __syncthreads();
      rowvec<BF16, true, NT, kMapD, kMapF>(
          gd, kDp, dw.w2, kD, kFp, a.part, [&](int n, float y) {
            const float d = a.fd[n] > 0.f ? y : 0.f;
            a.dfd[n] = d;
            keep_sum<kMapF>(vpd + 8 * kD, fmap(n), d);
            keep<BF16>(sc.yfd + static_cast<size_t>(b) * kFp + n, d);
          });
      __syncthreads();
      rowvec<BF16, true, NT, kMapF, kMapD>(
          a.dfd, kFp, dw.w1, kF, kDp, a.part,
          [&](int n, float y) { dhd[n] = gd[n] + y; });
      __syncthreads();
      if (warp == 0) {
        for (int i = lane; i < kDp; i += 32) {
          keep_sum<kMapD>(vpd + 3 * kD, dmap(i), dhd[i] * a.x1d[i]);
          keep_sum<kMapD>(vpd + 4 * kD, dmap(i), dhd[i]);
        }
        ln_bwd_rows<BF16, 1>(dhd, kDp, a.x1d, kDp, a.st, 1, dvec + 3 * kD,
                             nullptr);
      }
      __syncthreads();

      // ---- backward: decoder attention ----
      // one warp a head: dS of the single query; the other threads form
      // dv_d = rnd(P0 DM)^T rnd(da1_d)
      const auto head_ds = [&](int h) {
        float rs = 0.f;
        for (int k = lane; k < T; k += 32) {
          float acc = 0.f;
          for (int d = 0; d < kDhp; ++d)
            acc = fmaf(rnd<BF16>(dhd[h * kDhp + d]),
                       KVd[k * LD2 + kDp + h * kDhp + d], acc);
          const float dp = acc * dmd[h * T4 + k];
          dsd[h * T4 + k] = dp;
          rs += dp * pdd[h * T4 + k];
        }
        rs = warp_sum(rs);
        for (int k = lane; k < T; k += 32)
          dsd[h * T4 + k] = km[k] > 0.f
                                ? pdd[h * T4 + k] * (dsd[h * T4 + k] - rs)
                                : 0.f;
      };
      const auto dv_rows = [&](int first, int count) {
        for (int i = first; i < T * kDp; i += count) {
          const int k = i / kDp;
          const int j = i - k * kDp;
          const int h = j / kDhp;
          const float v =
              head_ok(h) ? rnd<BF16>(pdd[h * T4 + k] * dmd[h * T4 + k]) *
                           rnd<BF16>(dhd[j])
                     : 0.f;
          dKVd[k * LD2 + kDp + j] = v;
          keep<BF16>(sc.yd + (row0 + k) * 2 * kDp + kDp + j, v);
        }
      };
      if constexpr (kH < NW) {
        if (warp < kH) {
          head_ds(warp);
        } else {
          dv_rows(tid - 32 * kH, NT - 32 * kH);
        }
      } else {
        for (int h = warp; h < kH; h += NW) head_ds(h);
        dv_rows(tid, NT);
      }
      __syncthreads();
      for (int i = tid; i < T * kDp; i += NT) {
        const int k = i / kDp;
        const int j = i - k * kDp;
        const int h = j / kDhp;
        const float v = head_ok(h) ? rnd<BF16>(dsd[h * T4 + k]) *
                                     rnd<BF16>(a.qd[j]) * scale
                               : 0.f;
        dKVd[k * LD2 + j] = v;
        keep<BF16>(sc.yd + (row0 + k) * 2 * kDp + j, v);
      }
      for (int j = tid; j < kDp; j += NT) {
        const int h = j / kDhp;
        float s = 0.f, sk = 0.f, sv = 0.f;
        if (head_ok(h)) {
          for (int k = 0; k < T; ++k) {
            const float ds = rnd<BF16>(dsd[h * T4 + k]);
            s = fmaf(ds, KVd[k * LD2 + j], s);
            sk += ds * rnd<BF16>(a.qd[j]) * scale;
            sv += dKVd[k * LD2 + kDp + j];
          }
        }
        a.dqd[j] = s * scale;
        keep_sum<kMapD>(vpd, dmap(j), a.dqd[j]);
        keep_sum<kMapD>(vpd + kD, dmap(j), sk);
        keep_sum<kMapD>(vpd + 2 * kD, dmap(j), sv);
        keep<BF16>(sc.yq + static_cast<size_t>(b) * kDp + j, a.dqd[j]);
      }
      __syncthreads();
      // dH2 = [dk_d dv_d] [wk wv]^T, and d_dec
      mma_rows<1, BF16, NW, SPILL>(dKVd, LD2, T, 2 * kDp, pk.d_kv_t, kDp,
                                   [&](int r, int c, float v) {
                                     HG[r * LD1 + c] = v;
                                   });
      rowvec<BF16, true, NT, kMapD, kMapD>(
          a.dqd, kDp, dw.wqkv, 3 * kD, kDp, a.part, [&](int n, float y) {
            const int rn = dmap(n);
            if (real<kMapD>(rn))
              store(d_dec + static_cast<size_t>(b) * kD + rn,
                    (dhd[n] + y) * drop.scale_at(ex_d, 0, rn));
          });
      __syncthreads();
    }

    if constexpr (run(kSkipEncFfln)) {
      // ---- backward: encoder FF and layer norms ----
      colsums<kMapD>(HG, LD1, a.X2, kDp, T, kDp, vpe + 6 * kD, vpe + 5 * kD,
                     0, NT);
      __syncthreads();
      ln_bwd_rows<BF16, NW>(HG, LD1, a.X2, kDp, a.inv2, T, evec + 5 * kD,
                            sc.yg + row0 * kDp);                 // dln2
      __syncthreads();
      colsums<kMapD>(HG, LD1, nullptr, 0, T, kDp, vpe + 7 * kD, nullptr, 0,
                     NT);
      // f again, from h1 (still in H1)
      mma_rows<MGW, BF16, NW, SPILL>(
          H1, LD1, T, kDp, pk.e_w1, kFp, [&](int r, int c, float v) {
            const float pre = v + vec_at<kMapF>(ew.b1, c);
            const float f = fmaxf(pre, 0.f);
            BIG[r * LDF + c] = f;
            keep<BF16>(sc.xf + (row0 + r) * kFp + c, f);
          });
      __syncthreads();
      mma_rows<MGW, BF16, NW, SPILL>(HG, LD1, T, kDp, pk.e_w2_t, kFp,
                                     [&](int r, int c, float v) {
                                       float* p = BIG + r * LDF + c;
                                       const float d = *p > 0.f ? v : 0.f;
                                       *p = d;
                                       keep<BF16>(sc.yf + (row0 + r) * kFp +
                                                      c, d);
                                     });                        // dfpre
      __syncthreads();
      colsums<kMapF>(BIG, LDF, nullptr, 0, T, kFp, vpe + 8 * kD, nullptr, 0,
                     NT);
      mma_rows<1, BF16, NW, SPILL>(BIG, LDF, T, kFp, pk.e_w1_t, kDp,
                                   [&](int r, int c, float v) {
                                     H1[r * LD1 + c] = HG[r * LD1 + c] + v;
                                   });                          // dh1
      __syncthreads();
      colsums<kMapD>(H1, LD1, a.X1, kDp, T, kDp, vpe + 4 * kD, vpe + 3 * kD,
                     0, NT);
      __syncthreads();
      ln_bwd_rows<BF16, NW>(H1, LD1, a.X1, kDp, a.inv1, T, evec + 3 * kD,
                            nullptr);                           // da1
      __syncthreads();
    }

    if constexpr (run(kSkipEncAtt)) {
      // ---- backward: encoder attention, one head at a time ----
      float* ye = sc.ye + row0 * 3 * kDp;
      if constexpr (kH * kDhp < kDp) {
        // the padding columns of dq | dk | dv, which no head writes
        constexpr int kPad = kDp - kH * kDhp;
        for (int i = tid; i < T * 3 * kPad; i += NT) {
          const int r = i / (3 * kPad);
          const int w = i - r * 3 * kPad;
          const int col = (w / kPad) * kDp + kH * kDhp + w % kPad;
          dQKV[r * LD3 + col] = 0.f;
          keep<BF16>(ye + r * 3 * kDp + col, 0.f);
        }
      }
      for (int h = 0; h < kH; ++h) {
        if (SPILL && T > kRegT) {
          enc_att_bwd_rows_long<BF16, NW>(h, QKV, km, H1, T, scale, drop, b,
                                          a.SA, a.SB, dQKV, ye);
        } else {
          enc_att_bwd_rows<BF16, NT>(h, QKV, km, H1, T, scale, drop, b, a.SA,
                                     a.SB, dQKV, ye);
        }
        __syncthreads();
        enc_att_bwd_cols<BF16, NT>(h, QKV, H1, T, scale, a.SA, a.SB, dQKV,
                                   ye);
        __syncthreads();
      }
    }

    // ---- d_enc = (da1 + [dq dk dv] wqkv^T) * dropout ----
    colsums<kMapD>(dQKV, LD3, nullptr, 0, T, 3 * kDp, vpe, nullptr, 0, NT);
    mma_rows<1, BF16, NW, SPILL>(
        dQKV, LD3, T, 3 * kDp, pk.e_qkv_t, kDp, [&](int r, int c, float v) {
          const int rc = dmap(c);
          if (real<kMapD>(rc))
            store(d_enc + (row0 + r) * kD + rc,
                  (H1[r * LD1 + c] + v) * drop.scale_at(ex_e, r, rc));
        });
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// Kernel 3: weight grads over all rows, fixed chunks, fixed order
// ---------------------------------------------------------------------------

constexpr int kTile = 80;           // an 80 x 80 tile of a weight grad
constexpr int kGemmThreads = 160;   // 5 warps: 16 rows of the tile each
constexpr int kSlab = 32;           // rows staged at a time
constexpr int LS = kTile + 8;       // staged stride: 24 mod 32, so the
                                    // fragments' 32 reads hit 32 banks
constexpr int kVecCols = 160;       // columns of a sum tile
// the internal widths are whole tiles and the real ones: no masks
constexpr bool kTilesExact =
    kDIdentity && kFp == kF && kDp % kTile == 0 && kFp % kTile == 0;

// A weight product out[map_m(m), map_n(n)] = sum_r X[r, m] Y[r, n] over
// internal m < M, n < N (X null: a job of N column sums of Y, written to
// the bias and layer-norm slots of gw).
struct Job {
  const float* X;
  const float* Y;
  float* out;
  int M, N, ldo, mmap, nmap, rows, chunk, nchunks, tn, ntiles, block0,
      part0, cnt0;
};
constexpr int kJobs = 8;
struct Jobs {
  Job j[kJobs];
  int n;
};

__device__ __forceinline__ int job_map(int kind, int i) {
  return kind == kMapD ? dmap(i) : fmap(i);
}

// The flat weight-grad offset of column `col` of the per-example sums.
__device__ __forceinline__ int vec_offset(int col) {
  const int side = col / kNV;
  const int c = col - side * kNV;
  return side * kSub + (c < 8 * kD ? kOffVecs + c : kOffB1 + c - 8 * kD);
}

// Element (m, n) of tile `tile` of job J into gw, where it is real.
__device__ __forceinline__ void put(const Job& J, int m, int n, float v) {
  if constexpr (!kTilesExact) {
    if (m >= J.M || n >= J.N) return;
    const int rm = job_map(J.mmap, m);
    const int rn = job_map(J.nmap, n);
    if (rm < 0 || rn < 0) return;
    J.out[static_cast<size_t>(rm) * J.ldo + rn] = v;
  } else {
    J.out[static_cast<size_t>(m) * J.ldo + n] = v;
  }
}

template <bool BF16>
__device__ void gemm_tile(const Job& J, int tile, int r0, int r1, float* Xs,
                          float* Ys, float* dst) {
  const int tm = tile / J.tn;
  const int m0 = tm * kTile;
  const int n0 = (tile - tm * J.tn) * kTile;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  float acc[kTile / 8][4];
#pragma unroll
  for (int i = 0; i < kTile / 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  // the next slab is loaded into registers while this one is multiplied
  constexpr int kPer = kSlab * kTile / 4 / kGemmThreads;
  static_assert(kPer * kGemmThreads == kSlab * kTile / 4, "slab split");
  float4 nx[kPer], ny[kPer];
  const auto fetch = [&](int s0) {
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int i = threadIdx.x + e * kGemmThreads;
      const int rr = i / (kTile / 4);
      const int c4 = (i - rr * (kTile / 4)) * 4;
      const int r = s0 + rr;
      nx[e] = ny[e] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < r1) {
        if (kTilesExact || m0 + c4 < J.M)
          nx[e] = ldg4(J.X + static_cast<size_t>(r) * J.M + m0 + c4);
        if (kTilesExact || n0 + c4 < J.N)
          ny[e] = ldg4(J.Y + static_cast<size_t>(r) * J.N + n0 + c4);
      }
    }
  };
  fetch(r0);
  for (int s0 = r0; s0 < r1; s0 += kSlab) {
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int i = threadIdx.x + e * kGemmThreads;
      const int rr = i / (kTile / 4);
      const int c4 = (i - rr * (kTile / 4)) * 4;
      sts4(Xs + rr * LS + c4, nx[e]);
      sts4(Ys + rr * LS + c4, ny[e]);
    }
    __syncthreads();
    if (s0 + kSlab < r1) fetch(s0 + kSlab);
#pragma unroll
    for (int ks = 0; ks < kSlab; ks += 8) {
      // A = X^T: a0 (g, t) = X[ks + t, g], a1 = row g + 8, a2 = k + 4, ...
      const float* xa = Xs + (ks + t) * LS + warp * 16 + g;
      uint32_t ah[4], al[4];
      split<BF16>(xa[0], ah[0], al[0]);
      split<BF16>(xa[8], ah[1], al[1]);
      split<BF16>(xa[4 * LS], ah[2], al[2]);
      split<BF16>(xa[4 * LS + 8], ah[3], al[3]);
#pragma unroll
      for (int nt = 0; nt < kTile / 8; ++nt) {
        const float* yb = Ys + (ks + t) * LS + nt * 8 + g;
        uint32_t bh0, bl0, bh1, bl1;
        split<BF16>(yb[0], bh0, bl0);
        split<BF16>(yb[4 * LS], bh1, bl1);
        mma_split<BF16>(acc[nt], ah, al, bh0, bh1, bl0, bl1);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int nt = 0; nt < kTile / 8; ++nt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = warp * 16 + g + 8 * half;
      const int n = nt * 8 + 2 * t;
      if (dst) {
        float* p = dst + m * kTile + n;
        p[0] = acc[nt][2 * half];
        p[1] = acc[nt][2 * half + 1];
      } else {
        put(J, m0 + m, n0 + n, acc[nt][2 * half]);
        put(J, m0 + m, n0 + n + 1, acc[nt][2 * half + 1]);
      }
    }
  }
}

template <bool BF16>
__global__ void __launch_bounds__(kGemmThreads)
    wgrad_kernel(Jobs jobs, float* __restrict__ part, int* counters) {
  __shared__ __align__(16) float Xs[kSlab * LS];
  __shared__ __align__(16) float Ys[kSlab * LS];
  __shared__ int last;
  int ji = 0;
  while (ji + 1 < jobs.n && static_cast<int>(blockIdx.x) >= jobs.j[ji + 1].block0)
    ++ji;
  const Job J = jobs.j[ji];
  const int local = blockIdx.x - J.block0;
  const int tile = local / J.nchunks;
  const int chunk = local - tile * J.nchunks;
  const int r0 = chunk * J.chunk;
  const int r1 = min(J.rows, r0 + J.chunk);
  const int tsize = J.X ? kTile * kTile : kVecCols;
  float* tile_part = part + J.part0 + static_cast<size_t>(tile) * J.nchunks *
                                          tsize;
  float* dst = J.nchunks > 1 ? tile_part + static_cast<size_t>(chunk) * tsize
                             : nullptr;
  if (J.X) {
    gemm_tile<BF16>(J, tile, r0, r1, Xs, Ys, dst);
  } else {
    for (int e = threadIdx.x; e < kVecCols; e += kGemmThreads) {
      const int col = tile * kVecCols + e;
      if (col >= J.N) continue;
      float s = 0.f;
      for (int r = r0; r < r1; ++r)
        s += __ldg(J.Y + static_cast<size_t>(r) * J.N + col);
      if (dst) {
        dst[e] = s;
      } else {
        J.out[vec_offset(col)] = s;
      }
    }
  }
  if (J.nchunks == 1) return;
  // the last chunk of the tile to arrive adds the partials in chunk order
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(counters + J.cnt0 + tile, 1) == J.nchunks - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // eight elements a thread at a time, so eight loads are in flight
  constexpr int kBatch = 8;
  for (int e0 = threadIdx.x; e0 < tsize; e0 += kBatch * kGemmThreads) {
    float s[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) s[k] = 0.f;
    for (int c = 0; c < J.nchunks; ++c) {
      const float* pc = tile_part + static_cast<size_t>(c) * tsize;
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int e = e0 + k * kGemmThreads;
        if (e < tsize) s[k] += __ldcg(pc + e);
      }
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int e = e0 + k * kGemmThreads;
      if (e >= tsize) continue;
      if (J.X) {
        const int tm = tile / J.tn;
        const int m = tm * kTile + e / kTile;
        const int n = (tile - tm * J.tn) * kTile + e % kTile;
        put(J, m, n, s[k]);
      } else {
        const int col = tile * kVecCols + e;
        if (col < J.N) J.out[vec_offset(col)] = s[k];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Launch plan: the workspace (floats, each region a multiple of 4) holds
// the weight fragments, the scratch rows, the partial tiles, the arrival
// counters and, with SPILL, one activation slice per block.
// ---------------------------------------------------------------------------

struct Plan {
  size_t packs, scratch, part, counters, spill, total;  // offsets (floats)
  int rows_chunk, b_chunk, v_chunk, ncounters, blocks;
  bool spill_acts;
};

inline size_t round4z(size_t x) { return (x + 3) & ~static_cast<size_t>(3); }

inline int chunk_rows(long long rows, int tiles, int target_blocks,
                      int floor) {
  long long c = (rows * tiles + target_blocks - 1) / target_blocks;
  c = (c + kSlab - 1) / kSlab * kSlab;
  return static_cast<int>(c < floor ? floor : c);
}

inline int nchunks(int rows, int chunk) {
  return rows > 0 ? (rows + chunk - 1) / chunk : 1;
}

inline int tiles_of(int n, int t) { return (n + t - 1) / t; }

// (rows, M, N) of the 7 weight products then the sums job
inline void job_shapes(int B, int T, int (&rows)[kJobs], int (&M)[kJobs],
                       int (&N)[kJobs]) {
  const int R = B * T;
  const int r[kJobs] = {R, R, R, R, B, B, B, B};
  const int m[kJobs] = {kDp, kDp, kFp, kDp, kDp, kDp, kFp, 0};
  const int n[kJobs] = {3 * kDp, kFp, kDp, 2 * kDp, kDp, kFp, kDp, 2 * kNV};
  for (int i = 0; i < kJobs; ++i) {
    rows[i] = r[i];
    M[i] = m[i];
    N[i] = n[i];
  }
}

inline int job_tiles(int M, int N) {
  return M ? tiles_of(M, kTile) * tiles_of(N, kTile) : tiles_of(N, kVecCols);
}

inline Plan make_plan(int B, int T, int sms) {
  Plan P;
  const int wtiles = job_tiles(kDp, 3 * kDp) + job_tiles(kDp, kFp) +
                     job_tiles(kFp, kDp) + job_tiles(kDp, 2 * kDp);
  const int btiles = job_tiles(kDp, kDp) + job_tiles(kDp, kFp) +
                     job_tiles(kFp, kDp);
  P.rows_chunk =
      chunk_rows(static_cast<long long>(B) * T, wtiles, 4 * sms, 256);
  P.b_chunk = chunk_rows(B, btiles, sms, 256);
  P.v_chunk = 128;
  const size_t R = static_cast<size_t>(B) * T;
  const size_t scratch =
      R * (kDp + 3 * kDp + kDp + kFp + kFp + kDp + kDp + 2 * kDp) +
      static_cast<size_t>(B) * (4 * kDp + 2 * kFp + 2 * kNV);
  int rows[kJobs], M[kJobs], N[kJobs];
  job_shapes(B, T, rows, M, N);
  size_t part = 0;
  P.ncounters = 0;
  for (int i = 0; i < kJobs; ++i) {
    const int chunk = i < 4 ? P.rows_chunk : i < 7 ? P.b_chunk : P.v_chunk;
    const int nc = nchunks(rows[i], chunk);
    const int tiles = job_tiles(M[i], N[i]);
    const int tsize = M[i] ? kTile * kTile : kVecCols;
    if (nc > 1) part += static_cast<size_t>(tiles) * nc * tsize;
    P.ncounters += tiles;
  }
  P.spill_acts = spills(T, smem_optin());
  P.blocks = spill_blocks(B, sms);
  P.packs = 0;
  P.scratch = round4z(pack_floats(true));
  P.part = P.scratch + round4z(scratch);
  P.counters = P.part + round4z(part);
  P.spill = P.counters + round4z(P.ncounters);
  P.total = P.spill + (P.spill_acts ? static_cast<size_t>(P.blocks) *
                                          act_floats(T, block_threads(T), true)
                                    : 0);
  return P;
}

Scratch scratch_of(float* s, int B, int T) {
  const size_t R = static_cast<size_t>(B) * T;
  const size_t Bz = static_cast<size_t>(B);
  Scratch sc;
  float* p = s;
  const auto take = [&p](size_t n) {
    float* q = p;
    p += n;
    return q;
  };
  sc.xe = take(R * kDp);
  sc.ye = take(R * 3 * kDp);
  sc.xh = take(R * kDp);
  sc.yf = take(R * kFp);
  sc.xf = take(R * kFp);
  sc.yg = take(R * kDp);
  sc.xd = take(R * kDp);
  sc.yd = take(R * 2 * kDp);
  sc.xq = take(Bz * kDp);
  sc.yq = take(Bz * kDp);
  sc.xhd = take(Bz * kDp);
  sc.yfd = take(Bz * kFp);
  sc.xfd = take(Bz * kFp);
  sc.ygd = take(Bz * kDp);
  sc.vp = take(Bz * 2 * kNV);
  return sc;
}

template <int MGW, int NT, bool SPILL, typename TIn>
cudaError_t launch_main(const TIn* enc, const TIn* dec, const float* mask,
                        Weights ew, Weights dw, Packs pk, const TIn* g,
                        TIn* d_enc, TIn* d_dec, Scratch sc, float* spill,
                        Probe probe, Saved sv, int B, int T, float scale,
                        Dropout drop, int sms, cudaStream_t stream) {
  auto kernel = block_bwd_kernel<MGW, NT, SPILL, TIn>;
  size_t bytes = 0;
  int blocks = spill_blocks(B, sms);
  if constexpr (!SPILL) {
    bytes = act_floats(T, NT, true) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT,
                                                        bytes);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    blocks = B < sms * per_sm ? B : sms * per_sm;
  }
  kernel<<<blocks, NT, bytes, stream>>>(enc, dec, mask, ew, dw, pk, g, d_enc,
                                        d_dec, sc, spill, probe, sv, B, T,
                                        scale, drop);
  return cudaGetLastError();
}

template <bool SPILL, typename TIn>
cudaError_t launch_rows(const TIn* e, const TIn* d, const float* mk,
                        Weights ew, Weights dw, Packs pk, const TIn* g,
                        TIn* de, TIn* dd, Scratch sc, float* spill,
                        Probe probe, Saved sv, int B, int T, float scale,
                        Dropout drop, int sms, cudaStream_t s) {
  // 256 threads at T <= 32 (one row tile a task at T <= 16), 512 above:
  // both block kernels pick their threads from T alone (block_threads),
  // which fixes the slices of the one-row products
  if (T > 32)
    return launch_main<2, 512, SPILL>(e, d, mk, ew, dw, pk, g, de, dd, sc,
                                      spill, probe, sv, B, T, scale, drop,
                                      sms, s);
  if (T > 16 || SPILL)
    return launch_main<2, 256, SPILL>(e, d, mk, ew, dw, pk, g, de, dd, sc,
                                      spill, probe, sv, B, T, scale, drop,
                                      sms, s);
  return launch_main<1, 256, SPILL>(e, d, mk, ew, dw, pk, g, de, dd, sc,
                                    spill, probe, sv, B, T, scale, drop, sms,
                                    s);
}

template <typename TIn>
cudaError_t launch(const void* enc, const void* dec, const void* mask,
                   Weights ew, Weights dw, const void* g, void* d_enc,
                   void* d_dec, float* ws, float* gw, Probe probe, Saved sv,
                   int B, int T, float scale, Dropout drop, int sms,
                   cudaStream_t stream) {
  constexpr bool BF16 = !std::is_same<TIn, float>::value;
  const Plan P = make_plan(B, T, sms);
  int* counters = reinterpret_cast<int*>(ws + P.counters);

  // ---- kernel 1: fragments ----
  Packs pk;
  cudaError_t err = pack_weights<BF16>(ew, dw, ws + P.packs, true, counters,
                                       P.ncounters, pk, stream);
  if (err != cudaSuccess) return err;

  // ---- kernel 2: per example ----
  const Scratch sc = scratch_of(ws + P.scratch, B, T);
  const TIn* e = static_cast<const TIn*>(enc);
  const TIn* d = static_cast<const TIn*>(dec);
  const TIn* gg = static_cast<const TIn*>(g);
  const float* mk = static_cast<const float*>(mask);
  TIn* de = static_cast<TIn*>(d_enc);
  TIn* dd = static_cast<TIn*>(d_dec);
  err = P.spill_acts
            ? launch_rows<true>(e, d, mk, ew, dw, pk, gg, de, dd, sc,
                                ws + P.spill, probe, sv, B, T, scale, drop,
                                sms, stream)
            : launch_rows<false>(e, d, mk, ew, dw, pk, gg, de, dd, sc,
                                 nullptr, probe, sv, B, T, scale, drop, sms,
                                 stream);
  if (err != cudaSuccess) return err;
  if constexpr (!run(kSkipWgrad)) return cudaSuccess;

  // ---- kernel 3: weight grads ----
  Jobs jobs;
  jobs.n = kJobs;
  int rows[kJobs], M[kJobs], N[kJobs];
  job_shapes(B, T, rows, M, N);
  const float* X[kJobs] = {sc.xe, sc.xh, sc.xf, sc.xd,
                           sc.xq, sc.xhd, sc.xfd, nullptr};
  const float* Y[kJobs] = {sc.ye, sc.yf, sc.yg, sc.yd,
                           sc.yq, sc.yfd, sc.ygd, sc.vp};
  // where each product's tile lands in gw, its row stride there, and the
  // maps of its rows and columns
  const size_t out[kJobs] = {0, kOffW1, kOffW2, kSub + kD,
                             kSub, kSub + kOffW1, kSub + kOffW2, 0};
  const int ldo[kJobs] = {3 * kD, kF, kD, 3 * kD, 3 * kD, kF, kD, 0};
  const int mm[kJobs] = {kMapD, kMapD, kMapF, kMapD, kMapD, kMapD, kMapF, 0};
  const int nm[kJobs] = {kMapD, kMapF, kMapD, kMapD, kMapD, kMapF, kMapD, 0};
  int block = 0, part = 0, cnt = 0;
  for (int i = 0; i < kJobs; ++i) {
    Job& J = jobs.j[i];
    J.X = X[i];
    J.Y = Y[i];
    J.out = gw + out[i];
    J.M = M[i];
    J.N = N[i];
    J.ldo = ldo[i];
    J.mmap = mm[i];
    J.nmap = nm[i];
    J.rows = rows[i];
    J.chunk = i < 4 ? P.rows_chunk : i < 7 ? P.b_chunk : P.v_chunk;
    J.nchunks = nchunks(rows[i], J.chunk);
    J.tn = M[i] ? tiles_of(N[i], kTile) : tiles_of(N[i], kVecCols);
    J.ntiles = job_tiles(M[i], N[i]);
    J.block0 = block;
    J.part0 = part;
    J.cnt0 = cnt;
    block += J.ntiles * J.nchunks;
    if (J.nchunks > 1) part += J.ntiles * J.nchunks * (M[i] ? kTile * kTile
                                                             : kVecCols);
    cnt += J.ntiles;
  }
  if (cnt > P.ncounters) return cudaErrorInvalidValue;
  wgrad_kernel<BF16><<<block, kGemmThreads, 0, stream>>>(jobs, ws + P.part,
                                                         counters);
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

// Floats of the workspace that fused_block_bwd needs for (B, T) on a card
// with `sms` SMs (the current device's shared memory decides whether the
// activations spill).
long long fused_block_bwd_workspace(int B, int T, int sms) {
  return static_cast<long long>(make_plan(B, T, sms).total);
}

// Launches the three kernels on `stream`; returns the CUDA error code, 0 on
// success.  `workspace` holds fused_block_bwd_workspace(B, T, sms) floats,
// 16-byte aligned; `gw` the 2 x kSub float32 weight grads.  Takes the
// library's D, F, H and any T >= 1.  `probe_enc` [B, T, F] and
// `probe_dec` [B, F], when not null, get the replay's FF pre-activations.
// `saved_q`, `saved_k`, `saved_v` (the input type) and `saved_ctx`
// (float32), [B, T, D] each, when not null, are what fused_block_fwd wrote
// in its save mode (all four or none): the replay reads them instead of
// forming the encoder's Q, K, V and attention context.  Does not
// synchronise.
int fused_block_bwd(const void* enc, const void* dec, const void* mask,
                    const void* e_wqkv, const void* e_vecs, const void* e_w1,
                    const void* e_b1, const void* e_w2, const void* d_wqkv,
                    const void* d_vecs, const void* d_w1, const void* d_b1,
                    const void* d_w2, const void* g, void* d_enc, void* d_dec,
                    void* workspace, void* gw, void* probe_enc,
                    void* probe_dec, const void* saved_q, const void* saved_k,
                    const void* saved_v, const void* saved_ctx, int B, int T,
                    int D, int F, int H, float scale, int is_bf16,
                    const void* seed, int train, int keep_thr,
                    float drop_scale, int sms, void* stream) {
  if (B == 0) return 0;
  const bool some = saved_q || saved_k || saved_v || saved_ctx;
  const bool all = saved_q && saved_k && saved_v && saved_ctx;
  if (D != kD || F != kF || H != kH || T < 1 || sms < 1 || some != all)
    return static_cast<int>(cudaErrorInvalidValue);
  const Weights ew = weights(e_wqkv, e_vecs, e_w1, e_b1, e_w2);
  const Weights dw = weights(d_wqkv, d_vecs, d_w1, d_b1, d_w2);
  const Dropout drop = make_dropout(seed, train, keep_thr, drop_scale);
  const Probe probe{static_cast<float*>(probe_enc),
                    static_cast<float*>(probe_dec)};
  // read only: the replay loads them (Saved::load)
  const Saved sv{const_cast<void*>(saved_q), const_cast<void*>(saved_k),
                 const_cast<void*>(saved_v),
                 static_cast<float*>(const_cast<void*>(saved_ctx)), some};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ws = static_cast<float*>(workspace);
  float* out = static_cast<float*>(gw);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(enc, dec, mask, ew, dw, g, d_enc, d_dec,
                                      ws, out, probe, sv, B, T, scale, drop,
                                      sms, s)
              : launch<float>(enc, dec, mask, ew, dw, g, d_enc, d_dec, ws,
                              out, probe, sv, B, T, scale, drop, sms, s);
  return static_cast<int>(err);
}

const char* fused_block_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
