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
// It takes D = 80, F = 320, H = 4 and 1 <= T <= 50 (the model's widths;
// the wrapper raises on others).
//
// Types: as in the forward, with bfloat16 inputs every operand of every
// product (forward replay and gradient products alike) is rounded to
// bfloat16; everything else is float32.
//
// Bound: about 3x the forward's products (the replay, then the input and
// the weight gradient of each product): ~28 MFLOP per example at T=50,
// against ~33 KB moved, so bound by arithmetic (ops/block.py
// `block_bwd_flops`; `block_bwd_tc_bound` for the tensor cores).
//
// Design: three kernels in one call.
// 1. pack_kernel: the B operands of the per-example products (wqkv, w1,
//    w2, their transposes, the decoder's K/V columns and their transpose)
//    in mma fragment order, each element split into TF32 hi and lo (or
//    rounded to bfloat16), so a warp reads a fragment with one coalesced
//    16-byte load a lane; it also clears the arrival counters of kernel 3.
// 2. block_bwd_kernel: one example at a time a block (a persistent grid of
//    as many blocks as fit on the SMs), every activation of the example in
//    shared memory (~227 KB at T=50, so one 512-thread block an SM; ~47 KB
//    and 256 threads at T <= 32, so several).  The products of T rows with
//    a weight (QKV, FF, the decoder's K/V, and their input gradients) run
//    on the tensor cores: warp tiles of mma.sync m16n8k8, the activation
//    fragment from shared memory by ldmatrix and split in registers
//    (3xTF32 for float32, tiles.cuh), the weight fragment from kernel 1;
//    rows are padded to 16 in registers only and masked at the store.
//    Attention runs on the FMA units, a query row to a group of lanes
//    holding its keys in registers (softmax by shuffles); the decoder's
//    one-row products split K over all threads and add the slices in a
//    fixed order.  It writes no weight gradient: it writes the operand
//    rows of each weight product (X and dY, rounded where bf16 rounds) and
//    each example's bias and layer-norm sums to a scratch area.
// 3. wgrad_kernel: dW = X^T dY for the seven weight products over all
//    rows, on the tensor cores (3xTF32), in 80 x 80 tiles over fixed row
//    chunks; the last chunk of a tile to finish (an arrival counter) adds
//    the chunks' partial tiles in chunk order, and the bias sums are added
//    over the examples the same way.  No sum depends on timing, so two
//    launches give the same bits.
// So no weight gradient is read and written back per example (per-block
// partials updated for every example moved ~2.3 GB a launch), and every
// thread has work in the decoder's one-row phases.

#include <cfloat>
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "block_common.cuh"
#include "dropout.cuh"
#include "tiles.cuh"

// Phases skipped at compile time to split the kernel's time by phase
// (scripts/block_bwd_variants.py); 0 in the library.
#ifndef BLOCK_BWD_SKIP
#define BLOCK_BWD_SKIP 0
#endif

namespace {

constexpr int kD = 80;
constexpr int kF = 320;
constexpr int kH = 4;
constexpr int kDh = kD / kH;
constexpr int kMaxT = 50;
// shared-memory row strides of mma A operands: a quarter that is odd
constexpr int L80 = kD + 4;
constexpr int L160 = 2 * kD + 4;
constexpr int L240 = 3 * kD + 4;
constexpr int L320 = kF + 4;
constexpr int kNV = 8 * kD + kF;  // bias and layer-norm grads of a sub-block
constexpr int kSub = 3 * kD * kD + 8 * kD + 2 * kD * kF + kF;  // 71,360
constexpr int kOffVecs = 3 * kD * kD;
constexpr int kOffW1 = kOffVecs + 8 * kD;
constexpr int kOffB1 = kOffW1 + kD * kF;
constexpr int kOffW2 = kOffB1 + kF;
constexpr int kCounters = 64;

constexpr int kSkipReplay = 1;
constexpr int kSkipDecBwd = 2;
constexpr int kSkipEncFfln = 4;
constexpr int kSkipEncAtt = 8;
constexpr int kSkipWgrad = 16;
__host__ __device__ constexpr bool run(int phase) { return (BLOCK_BWD_SKIP & phase) == 0; }

__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }

// A gradient operand row element kept for kernel 3, rounded where bf16
// rounds; a per-example sum kept as it is.
template <bool BF16>
__device__ __forceinline__ void keep(float* p, float v) {
  if constexpr (run(kSkipWgrad)) *p = rnd<BF16>(v);
}
__device__ __forceinline__ void keep_sum(float* p, float v) {
  if constexpr (run(kSkipWgrad)) *p = v;
}
template <bool BF16>
__device__ __forceinline__ void keep4(float* p, float4 v) {
  if constexpr (run(kSkipWgrad))
    stg4(p, make_float4(rnd<BF16>(v.x), rnd<BF16>(v.y), rnd<BF16>(v.z),
                        rnd<BF16>(v.w)));
}

// ---------------------------------------------------------------------------
// Kernel 1: weight fragments
// ---------------------------------------------------------------------------

// B [K, N] = W[:, c0:c0+N] (trans = 0) or W[:, c0:c0+K]^T (trans = 1), W
// row-major with row stride ldw; out[(kt * N/8 + nt) * 32 + lane] =
// (hi b0, hi b1, lo b0, lo b1) of the lane's fragment of tile (kt, nt).
struct PackSpec {
  const float* W;
  float4* out;
  int ldw, c0, K, N, trans, frag0;
};
constexpr int kPacks = 8;
struct PackSpecs {
  PackSpec s[kPacks];
  int total;
  int* counters;
};

template <bool BF16>
__global__ void pack_kernel(PackSpecs ps) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < kCounters) ps.counters[i] = 0;
  if (i >= ps.total) return;
  int si = 0;
  while (si + 1 < kPacks && i >= ps.s[si + 1].frag0) ++si;
  const PackSpec S = ps.s[si];
  const int f = i - S.frag0;
  const int lane = f & 31;
  const int tile = f >> 5;
  const int ntl = S.N >> 3;
  const int kt = tile / ntl;
  const int n = (tile - kt * ntl) * 8 + (lane >> 2);
  const int k0 = kt * 8 + (lane & 3);
  float w[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int k = k0 + 4 * e;
    w[e] = S.trans ? __ldg(S.W + static_cast<size_t>(n) * S.ldw + S.c0 + k)
                   : __ldg(S.W + static_cast<size_t>(k) * S.ldw + S.c0 + n);
  }
  uint32_t h0, l0, h1, l1;
  split<BF16>(w[0], h0, l0);
  split<BF16>(w[1], h1, l1);
  S.out[f] = make_float4(__uint_as_float(h0), __uint_as_float(h1),
                         __uint_as_float(l0), __uint_as_float(l1));
}

// The packed B operands of kernel 2.
struct Packs {
  const float4* e_qkv;    // wqkv [80 x 240]
  const float4* e_w1;     // w1 [80 x 320]
  const float4* e_w2;     // w2 [320 x 80]
  const float4* e_qkv_t;  // wqkv^T [240 x 80]
  const float4* e_w1_t;   // w1^T [320 x 80]
  const float4* e_w2_t;   // w2^T [80 x 320]
  const float4* d_kv;     // decoder wqkv[:, 80:240] [80 x 160]
  const float4* d_kv_t;   // its transpose [160 x 80]
};

// ---------------------------------------------------------------------------
// Kernel 2 helpers
// ---------------------------------------------------------------------------

// C = A B for the rows < `rows` of A (row-major in shared memory, stride
// lda, lda / 4 odd), K a multiple of 8, B [K, N] packed by pack_kernel.
// A warp takes tasks of MG row tiles x one 8-column tile; epi(r, c, v)
// gets each element of C once, on the thread that holds it.
template <int MG, bool BF16, int NW, class Epi>
__device__ __forceinline__ void mma_rows(const float* A, int lda, int rows,
                                         int K, const float4* __restrict__ Bp,
                                         int N, Epi epi) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int ntl = N >> 3;
  const int ktl = K >> 3;
  const int mtl = (rows + 15) >> 4;
  const int tasks = ((mtl + MG - 1) / MG) * ntl;
  for (int task = warp; task < tasks; task += NW) {
    const int mg = task / ntl;
    const int nt = task - mg * ntl;
    float acc[MG][4];
#pragma unroll
    for (int i = 0; i < MG; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    const float4* bp = Bp + nt * 32 + lane;
    float4 bn = __ldg(bp);
    for (int kt = 0; kt < ktl; ++kt) {
      const float4 b = bn;
      if (kt + 1 < ktl) bn = __ldg(bp + (kt + 1) * ntl * 32);
#pragma unroll
      for (int i = 0; i < MG; ++i) {
        const int r0 = (mg * MG + i) * 16;
        if (r0 < rows) {
          uint32_t a[4], ah[4], al[4];
          ldsm_a(a, A, lda, r0, rows, kt * 8);
#pragma unroll
          for (int j = 0; j < 4; ++j) split<BF16>(__uint_as_float(a[j]), ah[j],
                                                  al[j]);
          mma_split<BF16>(acc[i], ah, al, __float_as_uint(b.x),
                          __float_as_uint(b.y), __float_as_uint(b.z),
                          __float_as_uint(b.w));
        }
      }
    }
    const int g = lane >> 2;
    const int c = nt * 8 + 2 * (lane & 3);
#pragma unroll
    for (int i = 0; i < MG; ++i) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = (mg * MG + i) * 16 + g + 8 * half;
        if (r < rows) {
          epi(r, c, acc[i][2 * half]);
          epi(r, c + 1, acc[i][2 * half + 1]);
        }
      }
    }
  }
}

// y[n] = sum_k rnd(x[k]) rnd(W[k, n]) (TRANS: W[n, k]) for n < N, W
// row-major in device memory with row stride ldw.  The K terms are split
// into S = NT / N slices (at least one) whose sums go to `part` and are
// added in slice order; epi(n, y) runs on one thread per n after a
// barrier.  The caller syncs before reading what epi wrote.
template <bool BF16, bool TRANS, int NT, class Epi>
__device__ __forceinline__ void rowvec(const float* x, int K,
                                       const float* __restrict__ W, int ldw,
                                       int N, float* part, Epi epi) {
  const int S = NT / N > 0 ? NT / N : 1;
  const int kc = (K + S - 1) / S;
  for (int idx = threadIdx.x; idx < S * N; idx += NT) {
    const int s = idx / N;
    const int n = idx - s * N;
    const int k1 = min(K, (s + 1) * kc);
    float acc = 0.f;
    for (int k = s * kc; k < k1; ++k) {
      const float w = TRANS ? __ldg(W + static_cast<size_t>(n) * ldw + k)
                            : __ldg(W + static_cast<size_t>(k) * ldw + n);
      acc = fmaf(rnd<BF16>(x[k]), rnd<BF16>(w), acc);
    }
    part[idx] = acc;
  }
  __syncthreads();
  for (int n = threadIdx.x; n < N; n += NT) {
    float y = 0.f;
    for (int s = 0; s < S; ++s) y += part[s * N + n];
    epi(n, y);
  }
}

// Layer norm of x[r] + add[r] over kD columns, one warp a row: x[r]
// becomes xhat, inv[r] = 1 / sqrt(var + eps), and, when h, h[r] = gamma
// xhat + beta (and hg[r], kD a row in device memory, its rounding, when
// hg).  h may be add itself: a row's add is read before its h is written.
template <bool BF16, int NW>
__device__ void ln_rows(float* x, int ldx, const float* add, int lda,
                        int rows, const float* __restrict__ gamma,
                        const float* __restrict__ beta, float* inv, float* h,
                        int ldh, float* hg) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < rows; r += NW) {
    float v[3];
    float s = 0.f;
#pragma unroll
    for (int e = 0; e < 3; ++e) {
      const int i = lane + 32 * e;
      v[e] = 0.f;
      if (i < kD) {
        v[e] = x[r * ldx + i] + add[r * lda + i];
        s += v[e];
      }
    }
    const float mean = warp_sum(s) / kD;
    float sq = 0.f;
#pragma unroll
    for (int e = 0; e < 3; ++e) {
      if (lane + 32 * e < kD) {
        const float d = v[e] - mean;
        sq += d * d;
      }
    }
    const float iv = rsqrtf(warp_sum(sq) / kD + kLnEps);
#pragma unroll
    for (int e = 0; e < 3; ++e) {
      const int i = lane + 32 * e;
      if (i < kD) {
        const float xh = (v[e] - mean) * iv;
        x[r * ldx + i] = xh;
        if (h) {
          const float hv = __ldg(gamma + i) * xh + __ldg(beta + i);
          h[r * ldh + i] = hv;
          if (hg) keep<BF16>(hg + r * kD + i, hv);
        }
      }
    }
    if (lane == 0) inv[r] = iv;
  }
}

// Layer norm backward in place, one warp a row:
// g[r] <- (gg - mean(gg) - xhat * mean(gg * xhat)) * inv[r], gg = g * gamma;
// gk[r] (device memory, kD a row) gets its rounding when not null.
template <bool BF16, int NW>
__device__ void ln_bwd_rows(float* g, int ldg, const float* xhat, int ldx,
                            const float* inv, int rows,
                            const float* __restrict__ gamma, float* gk) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < rows; r += NW) {
    float gg[3];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int e = 0; e < 3; ++e) {
      const int i = lane + 32 * e;
      gg[e] = 0.f;
      if (i < kD) {
        gg[e] = g[r * ldg + i] * __ldg(gamma + i);
        s1 += gg[e];
        s2 += gg[e] * xhat[r * ldx + i];
      }
    }
    const float m1 = warp_sum(s1) / kD;
    const float m2 = warp_sum(s2) / kD;
#pragma unroll
    for (int e = 0; e < 3; ++e) {
      const int i = lane + 32 * e;
      if (i < kD) {
        const float out = (gg[e] - m1 - xhat[r * ldx + i] * m2) * inv[r];
        g[r * ldg + i] = out;
        if (gk) keep<BF16>(gk + r * kD + i, out);
      }
    }
  }
}

// Column sums over t < rows: out[j] = sum_t A[t, j], and, when X,
// out2[j] = sum_t A[t, j] * X[t, j], for j < N (device memory), by the
// threads first .. first + count - 1.
__device__ void colsums(const float* A, int lda, const float* X, int ldx,
                        int rows, int N, float* out, float* out2, int first,
                        int count) {
  for (int j = threadIdx.x - first; j >= 0 && j < N; j += count) {
    float s = 0.f, s2 = 0.f;
    for (int t = 0; t < rows; ++t) {
      const float a = A[t * lda + j];
      s += a;
      if (X) s2 += a * X[t * ldx + j];
    }
    keep_sum(out + j, s);
    if (X) keep_sum(out2 + j, s2);
  }
}

// The lane-group width L = 2^lshift with L * KS >= T keys.
template <int KS>
__device__ __forceinline__ int lane_shift(int T) {
  int s = 0;
  while ((KS << s) < T) ++s;
  return s;
}

// ---------------------------------------------------------------------------
// Encoder attention (FMA units).  QKV rows hold q | k | v, rounded, at
// stride L240 (a quarter that is odd: the L lanes of a group reading L
// consecutive key rows hit distinct banks).  An item is a (head, query
// row) of the forward, a query row of one head in the backward; lane c of
// its group holds keys c, c + L, ... (at most KS).
// ---------------------------------------------------------------------------

constexpr int kC = kDh / 4;  // float4s of a head's row

__device__ __forceinline__ float4 rnd4_bf16(float4 v) {
  return make_float4(rnd<true>(v.x), rnd<true>(v.y), rnd<true>(v.z),
                     rnd<true>(v.w));
}

// Scores of query row q of head h against its group's keys, masked and
// scaled, then the softmax: s[i] = P0[q, c + L i] (0 past T).
template <int KS>
__device__ __forceinline__ void head_softmax(float (&s)[KS], const float* QKV,
                                             const float* km, int T, int h,
                                             int q, float scale, int c,
                                             int lshift) {
  const int L = 1 << lshift;
  float4 qx[kC];
#pragma unroll
  for (int cc = 0; cc < kC; ++cc)
    qx[cc] = lds4(QKV + q * L240 + h * kDh + 4 * cc);
  // slots past T read key T - 1 and are dropped: no branch between the
  // slots, so their loads are in flight together
  float m = -FLT_MAX;
#pragma unroll
  for (int i = 0; i < KS; ++i) {
    const int j = c + (i << lshift);
    const int jc = min(j, T - 1);
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int cc = 0; cc < kC; ++cc)
      dot4x(qx[cc], lds4(QKV + jc * L240 + kD + h * kDh + 4 * cc), acc);
    s[i] = j >= T ? -FLT_MAX : km[jc] > 0.f ? sum4(acc) * scale : kNegInf;
    m = fmaxf(m, s[i]);
  }
  m = group_max(m, L);
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < KS; ++i) {
    s[i] = c + (i << lshift) < T ? expf(s[i] - m) : 0.f;
    sum += s[i];
  }
  const float inv = 1.f / group_sum(sum, L);
#pragma unroll
  for (int i = 0; i < KS; ++i) s[i] *= inv;
}

// Replay: ctx[q, h dh + d] = sum_k rnd(P0[q, k] DM[q, k]) v[k, h dh + d],
// DM = q_mask * dropout; every (head, query) item at once.
template <bool BF16, int NT>
__device__ void enc_att_fwd(const float* QKV, const float* km, int T,
                            float scale, const Dropout& drop, unsigned b,
                            float* X1) {
  constexpr int KS = 16;
  const int lshift = lane_shift<KS>(T);
  const int L = 1 << lshift;
  const int c = threadIdx.x & (L - 1);
  const int g = threadIdx.x >> lshift;
  const int groups = NT >> lshift;
  const int warp_g0 = (threadIdx.x & ~31) >> lshift;
  const int n_items = kH * T;
  for (int base = 0; base + warp_g0 < n_items; base += groups) {
    const int it = base + g;
    const bool active = it < n_items;
    const int itc = active ? it : n_items - 1;
    const int h = itc / T;
    const int q = itc - h * T;
    const unsigned ex = drop.on ? drop.example(kSiteEncProbs * 16 + h, b)
                                : 0u;
    float s[KS];
    head_softmax<KS>(s, QKV, km, T, h, q, scale, c, lshift);
    const float qmr = km[q];
    float4 o[kC];
#pragma unroll
    for (int cc = 0; cc < kC; ++cc) o[cc] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int i = 0; i < KS; ++i) {
      const int j = c + (i << lshift);
      const int jc = min(j, T - 1);
      const float p =
          j < T ? rnd<BF16>(s[i] * (qmr * drop.scale_at(ex, q, j))) : 0.f;
#pragma unroll
      for (int cc = 0; cc < kC; ++cc)
        fma4(o[cc], p, lds4(QKV + jc * L240 + 2 * kD + h * kDh + 4 * cc));
    }
    group_sum4(o, L);
    if (active) {
#pragma unroll
      for (int cc = 0; cc < kC; ++cc)
        if ((cc & (L - 1)) == c) sts4(X1 + q * kD + h * kDh + 4 * cc, o[cc]);
    }
  }
}

// Backward of head h, row pass: for every query q, P~ = rnd(P0 DM) -> SA,
// dP = (rnd(da1_h) v_h^T) DM, dS = P0 (dP - rowsum(dP P0)) (0 at masked
// keys), rnd(dS) -> SB, and dq_h = scale rnd(dS) k_h -> dQKV and ye.
template <bool BF16, int NT>
__device__ void enc_att_bwd_rows(int h, const float* QKV, const float* km,
                                 const float* G1, int T, float scale,
                                 const Dropout& drop, unsigned b, float* SA,
                                 float* SB, float* dQKV, float* ye) {
  constexpr int KS = 8;
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
      gx[cc] = lds4(G1 + q * L80 + h * kDh + 4 * cc);
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
        dot4x(gx[cc], lds4(QKV + jc * L240 + 2 * kD + h * kDh + 4 * cc), acc);
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
        fma4(o[cc], ds, lds4(QKV + jc * L240 + kD + h * kDh + 4 * cc));
    }
    group_sum4(o, L);
    if (active) {
#pragma unroll
      for (int cc = 0; cc < kC; ++cc) {
        if ((cc & (L - 1)) == c) {
          const float4 v = make_float4(o[cc].x * scale, o[cc].y * scale,
                                       o[cc].z * scale, o[cc].w * scale);
          sts4(dQKV + q * L240 + h * kDh + 4 * cc, v);
          keep4<BF16>(ye + q * 3 * kD + h * kDh + 4 * cc, v);
        }
      }
    }
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
    const float* X = isk ? QKV + h * kDh + 4 * cc : G1 + h * kDh + 4 * cc;
    const int ldx = isk ? L240 : L80;
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
    const int col = (isk ? kD : 2 * kD) + h * kDh + 4 * cc;
    sts4(dQKV + k * L240 + col, acc);
    keep4<BF16>(ye + k * 3 * kD + col, acc);
  }
}

// ---------------------------------------------------------------------------
// Kernel 2: one example at a time a block
// ---------------------------------------------------------------------------

// Where kernel 2 leaves the operand rows of the weight products (rounded
// where bf16 rounds; rows b T + t) and each example's sums, for kernel 3.
struct Scratch {
  float* xe;   // [B T, 80]  dropped-out encoder input E0   (x of wqkv)
  float* ye;   // [B T, 240] dq | dk | dv                   (dy of wqkv)
  float* xh;   // [B T, 80]  h1                             (x of w1)
  float* yf;   // [B T, 320] dfpre                          (dy of w1)
  float* xf;   // [B T, 320] f                              (x of w2)
  float* yg;   // [B T, 80]  dln2                           (dy of w2)
  float* xd;   // [B T, 80]  H2                 (x of the decoder's wk, wv)
  float* yd;   // [B T, 160] dk_d | dv_d                   (their dy)
  float* xq;   // [B, 80]    decoder input d0     (x of the decoder's wq)
  float* yq;   // [B, 80]    dq_d
  float* xhd;  // [B, 80]    decoder h1
  float* yfd;  // [B, 320]   decoder dfpre
  float* xfd;  // [B, 320]   decoder f
  float* ygd;  // [B, 80]    decoder dln2
  float* vp;   // [B, 2 kNV] bias and layer-norm sums: encoder, decoder
};

__host__ __device__ inline int big_floats(int T) {
  return T * L320 > 2 * T * L160 ? T * L320 : 2 * T * L160;
}

inline size_t smem_floats(int T, int NT) {
  const int T4 = round4(T);
  return static_cast<size_t>(T) * (3 * L80 + L240 + 2 * kD) + big_floats(T) +
         2 * round4(T * T) + 3 * T4 + 8 * kD + 2 * kF + 3 * kH * T4 + 4 +
         (NT > kF ? NT : kF);
}

template <int MT, int NT, typename TIn>
__global__ void __launch_bounds__(NT, NT == 256 ? 2 : 1)
    block_bwd_kernel(const TIn* __restrict__ enc, const TIn* __restrict__ dec,
                     const float* __restrict__ mask, Weights ew, Weights dw,
                     Packs pk, const TIn* __restrict__ gout,
                     TIn* __restrict__ d_enc, TIn* __restrict__ d_dec,
                     Scratch sc, int B, int T, float scale, Dropout drop) {
  constexpr bool BF16 = !std::is_same<TIn, float>::value;
  constexpr int NW = NT / 32;
  constexpr int MGW = MT >= 2 ? 2 : 1;  // row tiles a task, wide products
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int T4 = round4(T);

  float* E0 = smem;                  // [T, L80] dropped-out encoder input
  float* QKV = E0 + T * L80;         // [T, L240] q | k | v, rounded
  float* H1 = QKV + T * L240;        // [T, L80] h1, then dh1 -> da1
  float* HG = H1 + T * L80;          // [T, L80] H2, then dH2 -> dln2
  float* X1 = HG + T * L80;          // [T, 80] ctx, then xhat1
  float* X2 = X1 + T * kD;           // [T, 80] f2, then xhat2
  float* BIG = X2 + T * kD;          // f | K/V_d and their grads | dqkv
  float* SA = BIG + big_floats(T);   // [T, T] one head's rnd(P0 DM)
  float* SB = SA + round4(T * T);    // [T, T] one head's rnd(dS)
  float* km = SB + round4(T * T);    // [T4] key mask
  float* inv1 = km + T4;
  float* inv2 = inv1 + T4;
  float* d0 = inv2 + T4;             // decoder rows, kD each
  float* qd = d0 + kD;
  float* x1d = qd + kD;              // ctx_d, then xhat1_d
  float* hd = x1d + kD;
  float* x2d = hd + kD;              // f2_d, then xhat2_d
  float* gd = x2d + kD;              // g, then dln2_d
  float* dhd = gd + kD;              // dh1_d, then da1_d
  float* dqd = dhd + kD;
  float* fd = dqd + kD;              // [kF]
  float* dfd = fd + kF;              // [kF]
  float* pdd = dfd + kF;             // [kH, T4] decoder P0
  float* dmd = pdd + kH * T4;        // [kH, T4] decoder dropout
  float* dsd = dmd + kH * T4;        // [kH, T4] decoder dS
  float* st = dsd + kH * T4;         // inverse std of the decoder's LNs
  float* part = st + 4;              // rowvec slices
  float* KVd = BIG;                  // [T, L160] k_d | v_d, rounded
  float* dKVd = BIG + T * L160;      // [T, L160] dk_d | dv_d
  float* dQKV = BIG;                 // [T, L240]

  const float* evec = ew.vecs;
  const float* dvec = dw.vecs;
  if (drop.on) drop.load_seed();

  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    const unsigned ex_e = drop.on ? drop.example(kSiteEncIn, b) : 0u;
    const unsigned ex_d = drop.on ? drop.example(kSiteDecIn, b) : 0u;
    const size_t row0 = static_cast<size_t>(b) * T;
    float* vpe = sc.vp + static_cast<size_t>(b) * 2 * kNV;
    float* vpd = vpe + kNV;
    for (int i = tid; i < T * kD; i += NT) {
      const int r = i / kD;
      const int c = i - r * kD;
      const float e0 =
          to_float(enc[row0 * kD + i]) * drop.scale_at(ex_e, r, c);
      E0[r * L80 + c] = e0;
      keep<BF16>(sc.xe + row0 * kD + i, e0);
    }
    for (int i = tid; i < kD; i += NT) {
      d0[i] = to_float(dec[static_cast<size_t>(b) * kD + i]) *
              drop.scale_at(ex_d, 0, i);
      gd[i] = to_float(gout[static_cast<size_t>(b) * kD + i]);
      keep<BF16>(sc.xq + static_cast<size_t>(b) * kD + i, d0[i]);
    }
    for (int i = tid; i < T; i += NT) km[i] = mask[row0 + i];
    __syncthreads();

    if constexpr (run(kSkipReplay)) {
      // ---- replay: encoder ----
      mma_rows<MGW, BF16, NW>(E0, L80, T, kD, pk.e_qkv, 3 * kD,
                              [&](int r, int c, float v) {
                                QKV[r * L240 + c] =
                                    rnd<BF16>(v + __ldg(evec + c));
                              });
      __syncthreads();
      enc_att_fwd<BF16, NT>(QKV, km, T, scale, drop, b, X1);
      __syncthreads();
      ln_rows<BF16, NW>(X1, kD, E0, L80, T, evec + 3 * kD, evec + 4 * kD,
                        inv1, H1, L80, sc.xh + row0 * kD);
      __syncthreads();
      mma_rows<MGW, BF16, NW>(H1, L80, T, kD, pk.e_w1, kF,
                              [&](int r, int c, float v) {
                                BIG[r * L320 + c] =
                                    fmaxf(v + __ldg(ew.b1 + c), 0.f);
                              });
      __syncthreads();
      mma_rows<1, BF16, NW>(BIG, L320, T, kF, pk.e_w2, kD,
                            [&](int r, int c, float v) {
                              X2[r * kD + c] = v + __ldg(evec + 7 * kD + c);
                            });
      __syncthreads();
      ln_rows<BF16, NW>(X2, kD, H1, L80, T, evec + 5 * kD, evec + 6 * kD,
                        inv2, HG, L80, sc.xd + row0 * kD);
      __syncthreads();

      // ---- replay: decoder ----
      mma_rows<1, BF16, NW>(HG, L80, T, kD, pk.d_kv, 2 * kD,
                            [&](int r, int c, float v) {
                              KVd[r * L160 + c] =
                                  rnd<BF16>(v + __ldg(dvec + kD + c));
                            });
      rowvec<BF16, false, NT>(d0, kD, dw.wqkv, 3 * kD, kD, part,
                              [&](int n, float y) {
                                qd[n] = rnd<BF16>(y + __ldg(dvec + n));
                              });
      __syncthreads();
      if (warp < kH) {
        // one warp a head: the single query's probabilities over T keys
        const int h = warp;
        const unsigned ex = drop.on ? drop.example(kSiteDecProbs * 16 + h, b)
                                    : 0u;
        float s[2];
        float m = -FLT_MAX;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int k = lane + 32 * c;
          s[c] = -FLT_MAX;
          if (k < T) {
            float acc = 0.f;
            for (int d = 0; d < kDh; ++d)
              acc = fmaf(qd[h * kDh + d], KVd[k * L160 + h * kDh + d], acc);
            s[c] = km[k] > 0.f ? acc * scale : kNegInf;
            m = fmaxf(m, s[c]);
          }
        }
        m = warp_max(m);
        float sum = 0.f;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          s[c] = lane + 32 * c < T ? expf(s[c] - m) : 0.f;
          sum += s[c];
        }
        const float inv = 1.f / warp_sum(sum);
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int k = lane + 32 * c;
          if (k < T) {
            pdd[h * T4 + k] = s[c] * inv;
            dmd[h * T4 + k] = drop.scale_at(ex, 0, k);
          }
        }
      }
      __syncthreads();
      for (int j = tid; j < kD; j += NT) {
        const int h = j / kDh;
        float s = 0.f;
        for (int k = 0; k < T; ++k)
          s = fmaf(rnd<BF16>(pdd[h * T4 + k] * dmd[h * T4 + k]),
                   KVd[k * L160 + kD + j], s);
        x1d[j] = s;
      }
      __syncthreads();
      ln_rows<BF16, NW>(x1d, kD, d0, kD, 1, dvec + 3 * kD, dvec + 4 * kD, st,
                        hd, kD, sc.xhd + static_cast<size_t>(b) * kD);
      __syncthreads();
      rowvec<BF16, false, NT>(hd, kD, dw.w1, kF, kF, part,
                              [&](int n, float y) {
                                fd[n] = fmaxf(y + __ldg(dw.b1 + n), 0.f);
                                keep<BF16>(sc.xfd + static_cast<size_t>(b) *
                                                        kF + n, fd[n]);
                              });
      __syncthreads();
      rowvec<BF16, false, NT>(fd, kF, dw.w2, kD, kD, part,
                              [&](int n, float y) {
                                x2d[n] = y + __ldg(dvec + 7 * kD + n);
                              });
      __syncthreads();
      ln_rows<BF16, NW>(x2d, kD, hd, kD, 1, dvec + 5 * kD, dvec + 6 * kD,
                        st + 1, nullptr, kD, nullptr);
      __syncthreads();
    }

    if constexpr (run(kSkipDecBwd)) {
      // ---- backward: decoder FF and layer norms ----
      if (warp == 0) {
        for (int i = lane; i < kD; i += 32) {
          keep_sum(vpd + 5 * kD + i, gd[i] * x2d[i]);
          keep_sum(vpd + 6 * kD + i, gd[i]);
        }
        ln_bwd_rows<BF16, 1>(gd, kD, x2d, kD, st + 1, 1, dvec + 5 * kD,
                             sc.ygd + static_cast<size_t>(b) * kD);
        for (int i = lane; i < kD; i += 32) keep_sum(vpd + 7 * kD + i, gd[i]);
      }
      __syncthreads();
      rowvec<BF16, true, NT>(gd, kD, dw.w2, kD, kF, part,
                             [&](int n, float y) {
                               const float d = fd[n] > 0.f ? y : 0.f;
                               dfd[n] = d;
                               keep_sum(vpd + 8 * kD + n, d);
                               keep<BF16>(sc.yfd + static_cast<size_t>(b) *
                                                       kF + n, d);
                             });
      __syncthreads();
      rowvec<BF16, true, NT>(dfd, kF, dw.w1, kF, kD, part,
                             [&](int n, float y) { dhd[n] = gd[n] + y; });
      __syncthreads();
      if (warp == 0) {
        for (int i = lane; i < kD; i += 32) {
          keep_sum(vpd + 3 * kD + i, dhd[i] * x1d[i]);
          keep_sum(vpd + 4 * kD + i, dhd[i]);
        }
        ln_bwd_rows<BF16, 1>(dhd, kD, x1d, kD, st, 1, dvec + 3 * kD,
                             nullptr);
      }
      __syncthreads();

      // ---- backward: decoder attention ----
      if (warp < kH) {
        const int h = warp;
        float dp[2], p[2];
        float rs = 0.f;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int k = lane + 32 * c;
          dp[c] = p[c] = 0.f;
          if (k < T) {
            float acc = 0.f;
            for (int d = 0; d < kDh; ++d)
              acc = fmaf(rnd<BF16>(dhd[h * kDh + d]),
                         KVd[k * L160 + kD + h * kDh + d], acc);
            dp[c] = acc * dmd[h * T4 + k];
            p[c] = pdd[h * T4 + k];
            rs += dp[c] * p[c];
          }
        }
        rs = warp_sum(rs);
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int k = lane + 32 * c;
          if (k < T) dsd[h * T4 + k] = km[k] > 0.f ? p[c] * (dp[c] - rs) : 0.f;
        }
      } else {
        for (int i = tid - 32 * kH; i < T * kD; i += NT - 32 * kH) {
          const int k = i / kD;
          const int j = i - k * kD;
          const int h = j / kDh;
          const float v = rnd<BF16>(pdd[h * T4 + k] * dmd[h * T4 + k]) *
                          rnd<BF16>(dhd[j]);
          dKVd[k * L160 + kD + j] = v;
          keep<BF16>(sc.yd + (row0 + k) * 2 * kD + kD + j, v);
        }
      }
      __syncthreads();
      for (int i = tid; i < T * kD; i += NT) {
        const int k = i / kD;
        const int j = i - k * kD;
        const float v =
            rnd<BF16>(dsd[(j / kDh) * T4 + k]) * rnd<BF16>(qd[j]) * scale;
        dKVd[k * L160 + j] = v;
        keep<BF16>(sc.yd + (row0 + k) * 2 * kD + j, v);
      }
      for (int j = tid; j < kD; j += NT) {
        const int h = j / kDh;
        float s = 0.f, sk = 0.f, sv = 0.f;
        for (int k = 0; k < T; ++k) {
          const float ds = rnd<BF16>(dsd[h * T4 + k]);
          s = fmaf(ds, KVd[k * L160 + j], s);
          sk += ds * rnd<BF16>(qd[j]) * scale;
          sv += dKVd[k * L160 + kD + j];
        }
        dqd[j] = s * scale;
        keep_sum(vpd + j, dqd[j]);
        keep_sum(vpd + kD + j, sk);
        keep_sum(vpd + 2 * kD + j, sv);
        keep<BF16>(sc.yq + static_cast<size_t>(b) * kD + j, dqd[j]);
      }
      __syncthreads();
      // dH2 = [dk_d dv_d] [wk wv]^T, and d_dec
      mma_rows<1, BF16, NW>(dKVd, L160, T, 2 * kD, pk.d_kv_t, kD,
                            [&](int r, int c, float v) {
                              HG[r * L80 + c] = v;
                            });
      rowvec<BF16, true, NT>(
          dqd, kD, dw.wqkv, 3 * kD, kD, part, [&](int n, float y) {
            store(d_dec + static_cast<size_t>(b) * kD + n,
                  (dhd[n] + y) * drop.scale_at(ex_d, 0, n));
          });
      __syncthreads();
    }

    if constexpr (run(kSkipEncFfln)) {
      // ---- backward: encoder FF and layer norms ----
      colsums(HG, L80, X2, kD, T, kD, vpe + 6 * kD, vpe + 5 * kD, 0, NT);
      __syncthreads();
      ln_bwd_rows<BF16, NW>(HG, L80, X2, kD, inv2, T, evec + 5 * kD,
                            sc.yg + row0 * kD);                 // dln2
      __syncthreads();
      colsums(HG, L80, nullptr, 0, T, kD, vpe + 7 * kD, nullptr, 0, NT);
      // f again, from h1 (still in H1)
      mma_rows<MGW, BF16, NW>(H1, L80, T, kD, pk.e_w1, kF,
                              [&](int r, int c, float v) {
                                const float f =
                                    fmaxf(v + __ldg(ew.b1 + c), 0.f);
                                BIG[r * L320 + c] = f;
                                keep<BF16>(sc.xf + (row0 + r) * kF + c, f);
                              });
      __syncthreads();
      mma_rows<MGW, BF16, NW>(HG, L80, T, kD, pk.e_w2_t, kF,
                              [&](int r, int c, float v) {
                                float* p = BIG + r * L320 + c;
                                const float d = *p > 0.f ? v : 0.f;
                                *p = d;
                                keep<BF16>(sc.yf + (row0 + r) * kF + c, d);
                              });                               // dfpre
      __syncthreads();
      colsums(BIG, L320, nullptr, 0, T, kF, vpe + 8 * kD, nullptr, 0, NT);
      mma_rows<1, BF16, NW>(BIG, L320, T, kF, pk.e_w1_t, kD,
                            [&](int r, int c, float v) {
                              H1[r * L80 + c] = HG[r * L80 + c] + v;
                            });                                 // dh1
      __syncthreads();
      colsums(H1, L80, X1, kD, T, kD, vpe + 4 * kD, vpe + 3 * kD, 0, NT);
      __syncthreads();
      ln_bwd_rows<BF16, NW>(H1, L80, X1, kD, inv1, T, evec + 3 * kD,
                            nullptr);                           // da1
      __syncthreads();
    }

    if constexpr (run(kSkipEncAtt)) {
      // ---- backward: encoder attention, one head at a time ----
      float* ye = sc.ye + row0 * 3 * kD;
      for (int h = 0; h < kH; ++h) {
        enc_att_bwd_rows<BF16, NT>(h, QKV, km, H1, T, scale, drop, b, SA, SB,
                                   dQKV, ye);
        __syncthreads();
        enc_att_bwd_cols<BF16, NT>(h, QKV, H1, T, scale, SA, SB, dQKV, ye);
        __syncthreads();
      }
    }

    // ---- d_enc = (da1 + [dq dk dv] wqkv^T) * dropout ----
    colsums(dQKV, L240, nullptr, 0, T, 3 * kD, vpe, nullptr, 0, NT);
    mma_rows<1, BF16, NW>(dQKV, L240, T, 3 * kD, pk.e_qkv_t, kD,
                          [&](int r, int c, float v) {
                            store(d_enc + (row0 + r) * kD + c,
                                  (H1[r * L80 + c] + v) *
                                      drop.scale_at(ex_e, r, c));
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

// A weight product out[m, n] = sum_r X[r, m] Y[r, n] (X null: a job of
// column sums of Y, written to the bias and layer-norm slots of gw).
struct Job {
  const float* X;
  const float* Y;
  float* out;
  int M, N, ldo, rows, chunk, nchunks, tn, ntiles, block0, part0, cnt0;
};
constexpr int kJobs = 8;
struct Jobs {
  Job j[kJobs];
  int n;
};

// The flat weight-grad offset of column `col` of the per-example sums.
__device__ __forceinline__ int vec_offset(int col) {
  const int side = col / kNV;
  const int c = col - side * kNV;
  return side * kSub + (c < 8 * kD ? kOffVecs + c : kOffB1 + c - 8 * kD);
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
        nx[e] = ldg4(J.X + static_cast<size_t>(r) * J.M + m0 + c4);
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
      float* p = dst ? dst + m * kTile + n
                     : J.out + static_cast<size_t>(m0 + m) * J.ldo + n0 + n;
      p[0] = acc[nt][2 * half];
      p[1] = acc[nt][2 * half + 1];
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
        J.out[static_cast<size_t>(m) * J.ldo + n] = s[k];
      } else {
        J.out[vec_offset(tile * kVecCols + e)] = s[k];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Launch plan: the workspace (floats, each region a multiple of 4) holds
// the weight fragments, the scratch rows, the partial tiles and the
// arrival counters.
// ---------------------------------------------------------------------------

struct Mat {
  int ldw, c0, K, N, trans, side, which;  // which: 0 wqkv, 1 w1, 2 w2
};
// the packed operands, in the order of Packs
constexpr Mat kMats[kPacks] = {
    {3 * kD, 0, kD, 3 * kD, 0, 0, 0}, {kF, 0, kD, kF, 0, 0, 1},
    {kD, 0, kF, kD, 0, 0, 2},         {3 * kD, 0, 3 * kD, kD, 1, 0, 0},
    {kF, 0, kF, kD, 1, 0, 1},         {kD, 0, kD, kF, 1, 0, 2},
    {3 * kD, kD, kD, 2 * kD, 0, 1, 0}, {3 * kD, kD, 2 * kD, kD, 1, 1, 0}};

struct Plan {
  size_t packs, scratch, part, total;  // offsets (floats) and the size
  int rows_chunk, b_chunk, v_chunk;
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

// (rows, M, N, tiles) of the 7 weight products then the sums job
inline void job_shapes(int B, int T, int (&rows)[kJobs], int (&M)[kJobs],
                       int (&N)[kJobs]) {
  const int R = B * T;
  const int r[kJobs] = {R, R, R, R, B, B, B, B};
  const int m[kJobs] = {kD, kD, kF, kD, kD, kD, kF, 0};
  const int n[kJobs] = {3 * kD, kF, kD, 2 * kD, kD, kF, kD, 2 * kNV};
  for (int i = 0; i < kJobs; ++i) {
    rows[i] = r[i];
    M[i] = m[i];
    N[i] = n[i];
  }
}

inline Plan make_plan(int B, int T, int sms) {
  Plan P;
  P.rows_chunk = chunk_rows(static_cast<long long>(B) * T, 13, 4 * sms, 256);
  P.b_chunk = chunk_rows(B, 9, sms, 256);
  P.v_chunk = 128;
  size_t packs = 0;
  for (const Mat& m : kMats) packs += 2 * static_cast<size_t>(m.K) * m.N;
  const size_t R = static_cast<size_t>(B) * T;
  const size_t scratch =
      R * (kD + 3 * kD + kD + kF + kF + kD + kD + 2 * kD) +
      static_cast<size_t>(B) * (4 * kD + 2 * kF + 2 * kNV);
  int rows[kJobs], M[kJobs], N[kJobs];
  job_shapes(B, T, rows, M, N);
  size_t part = 0;
  for (int i = 0; i < kJobs; ++i) {
    const int chunk = i < 4 ? P.rows_chunk : i < 7 ? P.b_chunk : P.v_chunk;
    const int nc = nchunks(rows[i], chunk);
    const int tiles = M[i] ? (M[i] / kTile) * (N[i] / kTile)
                           : N[i] / kVecCols;
    const int tsize = M[i] ? kTile * kTile : kVecCols;
    if (nc > 1) part += static_cast<size_t>(tiles) * nc * tsize;
  }
  P.packs = 0;
  P.scratch = round4z(packs);
  P.part = P.scratch + round4z(scratch);
  P.total = P.part + round4z(part) + kCounters;
  return P;
}

Scratch scratch_of(float* s, int B, int T) {
  const size_t R = static_cast<size_t>(B) * T;
  Scratch sc;
  float* p = s;
  const auto take = [&p](size_t n) {
    float* q = p;
    p += n;
    return q;
  };
  sc.xe = take(R * kD);
  sc.ye = take(R * 3 * kD);
  sc.xh = take(R * kD);
  sc.yf = take(R * kF);
  sc.xf = take(R * kF);
  sc.yg = take(R * kD);
  sc.xd = take(R * kD);
  sc.yd = take(R * 2 * kD);
  sc.xq = take(static_cast<size_t>(B) * kD);
  sc.yq = take(static_cast<size_t>(B) * kD);
  sc.xhd = take(static_cast<size_t>(B) * kD);
  sc.yfd = take(static_cast<size_t>(B) * kF);
  sc.xfd = take(static_cast<size_t>(B) * kF);
  sc.ygd = take(static_cast<size_t>(B) * kD);
  sc.vp = take(static_cast<size_t>(B) * 2 * kNV);
  return sc;
}

template <int MT, int NT, typename TIn>
cudaError_t launch_main(const TIn* enc, const TIn* dec, const float* mask,
                        Weights ew, Weights dw, Packs pk, const TIn* g,
                        TIn* d_enc, TIn* d_dec, Scratch sc, int B, int T,
                        float scale, Dropout drop, int sms,
                        cudaStream_t stream) {
  auto kernel = block_bwd_kernel<MT, NT, TIn>;
  const size_t bytes = smem_floats(T, NT) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT,
                                                      bytes);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int blocks = B < sms * per_sm ? B : sms * per_sm;
  kernel<<<blocks, NT, bytes, stream>>>(enc, dec, mask, ew, dw, pk, g, d_enc,
                                        d_dec, sc, B, T, scale, drop);
  return cudaGetLastError();
}

template <typename TIn>
cudaError_t launch(const void* enc, const void* dec, const void* mask,
                   Weights ew, Weights dw, const void* g, void* d_enc,
                   void* d_dec, float* ws, float* gw, int B, int T,
                   float scale, Dropout drop, int sms, cudaStream_t stream) {
  constexpr bool BF16 = !std::is_same<TIn, float>::value;
  const Plan P = make_plan(B, T, sms);
  int* counters = reinterpret_cast<int*>(ws + P.total - kCounters);

  // ---- kernel 1: fragments ----
  PackSpecs ps;
  Packs pk;
  const float4** slots[kPacks] = {&pk.e_qkv,   &pk.e_w1,   &pk.e_w2,
                                  &pk.e_qkv_t, &pk.e_w1_t, &pk.e_w2_t,
                                  &pk.d_kv,    &pk.d_kv_t};
  float* p = ws + P.packs;
  int frag = 0;
  for (int i = 0; i < kPacks; ++i) {
    const Mat& m = kMats[i];
    const Weights& w = m.side ? dw : ew;
    PackSpec& s = ps.s[i];
    s.W = m.which == 0 ? w.wqkv : m.which == 1 ? w.w1 : w.w2;
    s.out = reinterpret_cast<float4*>(p);
    s.ldw = m.ldw;
    s.c0 = m.c0;
    s.K = m.K;
    s.N = m.N;
    s.trans = m.trans;
    s.frag0 = frag;
    *slots[i] = s.out;
    frag += (m.K / 8) * (m.N / 8) * 32;
    p += 2 * static_cast<size_t>(m.K) * m.N;
  }
  ps.total = frag;
  ps.counters = counters;
  pack_kernel<BF16><<<(frag + 255) / 256, 256, 0, stream>>>(ps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // ---- kernel 2: per example ----
  const Scratch sc = scratch_of(ws + P.scratch, B, T);
  const TIn* e = static_cast<const TIn*>(enc);
  const TIn* d = static_cast<const TIn*>(dec);
  const TIn* gg = static_cast<const TIn*>(g);
  const float* mk = static_cast<const float*>(mask);
  TIn* de = static_cast<TIn*>(d_enc);
  TIn* dd = static_cast<TIn*>(d_dec);
  switch ((T + 15) / 16) {
    case 1:
      err = launch_main<1, 256>(e, d, mk, ew, dw, pk, gg, de, dd, sc, B, T,
                                scale, drop, sms, stream);
      break;
    case 2:
      err = launch_main<2, 256>(e, d, mk, ew, dw, pk, gg, de, dd, sc, B, T,
                                scale, drop, sms, stream);
      break;
    case 3:
      err = launch_main<3, 512>(e, d, mk, ew, dw, pk, gg, de, dd, sc, B, T,
                                scale, drop, sms, stream);
      break;
    default:
      err = launch_main<4, 512>(e, d, mk, ew, dw, pk, gg, de, dd, sc, B, T,
                                scale, drop, sms, stream);
  }
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
  // where each product's tile lands in gw, and its row stride there
  const size_t out[kJobs] = {0, kOffW1, kOffW2, kSub + kD,
                             kSub, kSub + kOffW1, kSub + kOffW2, 0};
  const int ldo[kJobs] = {3 * kD, kF, kD, 3 * kD, 3 * kD, kF, kD, 0};
  int block = 0, part = 0, cnt = 0;
  for (int i = 0; i < kJobs; ++i) {
    Job& J = jobs.j[i];
    J.X = X[i];
    J.Y = Y[i];
    J.out = gw + out[i];
    J.M = M[i];
    J.N = N[i];
    J.ldo = ldo[i];
    J.rows = rows[i];
    J.chunk = i < 4 ? P.rows_chunk : i < 7 ? P.b_chunk : P.v_chunk;
    J.nchunks = nchunks(rows[i], J.chunk);
    J.tn = M[i] ? N[i] / kTile : N[i] / kVecCols;
    J.ntiles = M[i] ? (M[i] / kTile) * J.tn : J.tn;
    J.block0 = block;
    J.part0 = part;
    J.cnt0 = cnt;
    block += J.ntiles * J.nchunks;
    if (J.nchunks > 1) part += J.ntiles * J.nchunks * (M[i] ? kTile * kTile
                                                             : kVecCols);
    cnt += J.ntiles;
  }
  if (cnt > kCounters) return cudaErrorInvalidValue;
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
// with `sms` SMs.
long long fused_block_bwd_workspace(int B, int T, int sms) {
  return static_cast<long long>(make_plan(B, T, sms).total);
}

// Launches the three kernels on `stream`; returns the CUDA error code, 0 on
// success.  `workspace` holds fused_block_bwd_workspace(B, T, sms) floats,
// 16-byte aligned; `gw` the 2 * 71,360 float32 weight grads.  Takes D =
// 80, F = 320, H = 4, 1 <= T <= 50.  Does not synchronise.
int fused_block_bwd(const void* enc, const void* dec, const void* mask,
                    const void* e_wqkv, const void* e_vecs, const void* e_w1,
                    const void* e_b1, const void* e_w2, const void* d_wqkv,
                    const void* d_vecs, const void* d_w1, const void* d_b1,
                    const void* d_w2, const void* g, void* d_enc, void* d_dec,
                    void* workspace, void* gw, int B, int T, int D, int F,
                    int H, float scale, int is_bf16, const void* seed,
                    int train, int keep_thr, float drop_scale, int sms,
                    void* stream) {
  if (B == 0) return 0;
  if (D != kD || F != kF || H != kH || T < 1 || T > kMaxT || sms < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Weights ew = weights(e_wqkv, e_vecs, e_w1, e_b1, e_w2);
  const Weights dw = weights(d_wqkv, d_vecs, d_w1, d_b1, d_w2);
  const Dropout drop = make_dropout(seed, train, keep_thr, drop_scale);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ws = static_cast<float*>(workspace);
  float* out = static_cast<float*>(gw);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(enc, dec, mask, ew, dw, g, d_enc, d_dec,
                                      ws, out, B, T, scale, drop, sms, s)
              : launch<float>(enc, dec, mask, ew, dw, g, d_enc, d_dec, ws,
                              out, B, T, scale, drop, sms, s);
  return static_cast<int>(err);
}

const char* fused_block_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
