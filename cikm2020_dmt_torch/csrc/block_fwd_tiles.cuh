// The forward arithmetic of the fused Deep-Interest-Transformer block, one
// copy for both block kernels: fused_block_fwd.cu runs it to produce the
// block's output, and fused_block_bwd.cu runs it as the replay of its
// full-recompute backward.  Both compile these functions with the same
// template arguments, so the replay forms every product, sum, softmax and
// layer norm in the same order as the forward that ran, and a ReLU
// pre-activation takes the same branch in both (the TPU kernels share
// `_attend3` and `_ffln` between forward and replay the same way).
//
// Widths.  D, F and H are compile-time: -DBLOCK_D, -DBLOCK_F, -DBLOCK_H
// (the model's 80, 320 and 4 by default); ops/_build.py keys each library
// by them and builds a width at its first use.  T is a runtime argument.
// Internally a D-wide row holds the H heads at kDhp = dh rounded up to 4
// columns each, then zeros up to kDp (a multiple of 8); an F-wide row F
// columns, then zeros up to kFp.  The padding columns of every activation
// are 0 and the weight fragments are 0 there, so the mma.sync tiles
// (k and n in steps of 8) and the float4 head rows need no masks inside;
// dmap / fmap name the real column of an internal one (-1: padding).  At
// the model's widths (dh = 20, D = 80, F = 320) both are the identity and
// fold away.
//
// Where the backward's activations of one example do not fit in the
// shared memory a block can opt into (at the model's widths T > 51), both
// kernels are instantiated with SPILL (`spills`; the forward's own would
// fit up to T = 56, but it follows the backward so that the instantiations
// stay the same): the same layout lies in a global workspace of one slice
// per resident block (grid x per-example floats), and the tensor-core A
// fragments are read with plain loads instead of ldmatrix (the same bits).
//
// The same instantiation is still inlined into two kernels, and the
// language does not promise that two inlined copies contract a*b + c
// alike; chip_smoke.py `check_replay` holds the forward's and the
// replay's FF pre-activations to the same bits on the card, at T = 1, 10
// and 50 (no SPILL) and 55 and 128 (SPILL), in float32 and bfloat16.
//
// Save mode (`Saved`): the forward also writes the encoder's rounded Q, K,
// V and its attention context, and the backward's replay reads them in
// place of the projection and the attention; chip_smoke.py `check_save`
// holds both kernels' outputs to the same bits in either mode.
#pragma once

#include <cfloat>
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "block_common.cuh"
#include "dropout.cuh"
#include "tiles.cuh"

#ifndef BLOCK_D
#define BLOCK_D 80
#endif
#ifndef BLOCK_F
#define BLOCK_F 320
#endif
#ifndef BLOCK_H
#define BLOCK_H 4
#endif
// phases of the backward skipped at compile time (fused_block_bwd.cu)
#ifndef BLOCK_BWD_SKIP
#define BLOCK_BWD_SKIP 0
#endif

namespace {

__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }
__host__ __device__ constexpr int round8(int x) { return (x + 7) & ~7; }

constexpr int kD = BLOCK_D;
constexpr int kF = BLOCK_F;
constexpr int kH = BLOCK_H;
static_assert(kD > 0 && kF > 0 && kH > 0 && kD % kH == 0,
              "BLOCK_D must be a positive multiple of BLOCK_H");
constexpr int kDh = kD / kH;            // a head's columns
constexpr int kDhp = round4(kDh);       // ... in the internal layout
constexpr int kDp = round8(kH * kDhp);  // internal width of a D-wide row
constexpr int kFp = round8(kF);         // internal width of an F-wide row
constexpr int kC = kDhp / 4;            // float4s of a head's row
constexpr bool kDIdentity = kDhp == kDh && kDp == kD;
// shared-memory row strides of mma A operands: a quarter that is odd
constexpr int LD1 = kDp + 4;
constexpr int LD2 = 2 * kDp + 4;
constexpr int LD3 = 3 * kDp + 4;
constexpr int LDF = kFp + 4;

// The real column of internal column i of a row of D-wide parts (q | k |
// v, or k | v), or -1 at padding.
__host__ __device__ __forceinline__ int dmap(int i) {
  if constexpr (kDIdentity) {
    return i;
  } else {
    const int p = i / kDp;
    const int c = i - p * kDp;
    const int h = c / kDhp;
    const int d = c - h * kDhp;
    return h < kH && d < kDh ? p * kD + h * kDh + d : -1;
  }
}
__host__ __device__ __forceinline__ int fmap(int i) {
  if constexpr (kFp == kF) {
    return i;
  } else {
    return i < kF ? i : -1;
  }
}
constexpr int kMapD = 0;
constexpr int kMapF = 1;
template <int KIND>
__host__ __device__ __forceinline__ int cmap(int i) {
  return KIND == kMapD ? dmap(i) : fmap(i);
}
// Whether a mapped column r is a real one: always at the identity widths,
// where the checks fold away and the kernels keep the model's code.
template <int KIND>
__device__ __forceinline__ bool real(int r) {
  return (KIND == kMapD ? kDIdentity : kFp == kF) || r >= 0;
}
// Whether head h of an internal column exists: always where the heads
// fill the row.
__device__ __forceinline__ bool head_ok(int h) {
  return kH * kDhp == kDp || h < kH;
}
// p[map(i)], 0 at padding (biases, layer-norm scales)
template <int KIND>
__device__ __forceinline__ float vec_at(const float* __restrict__ p, int i) {
  const int r = cmap<KIND>(i);
  return real<KIND>(r) ? __ldg(p + r) : 0.f;
}
__device__ __forceinline__ bool dreal(int i) {
  return i < kDp && real<kMapD>(dmap(i));
}

constexpr int kSkipReplay = 1;
constexpr int kSkipDecBwd = 2;
constexpr int kSkipEncFfln = 4;
constexpr int kSkipEncAtt = 8;
constexpr int kSkipWgrad = 16;
__host__ __device__ constexpr bool run(int phase) {
  return (BLOCK_BWD_SKIP & phase) == 0;
}

// A weight-gradient operand element kept for the backward's weight-grad
// kernel, rounded where bf16 rounds.
template <bool BF16>
__device__ __forceinline__ void keep(float* p, float v) {
  if constexpr (run(kSkipWgrad)) *p = rnd<BF16>(v);
}

// ---------------------------------------------------------------------------
// Weight fragments: the B operands of the row products in mma fragment
// order, split into TF32 hi and lo (or rounded to bfloat16), packed once a
// call by pack_kernel.
// ---------------------------------------------------------------------------

// B [K, N] (internal, multiples of 8) with B[k][n] = W[map_k(k)][c0 +
// map_n(n)] (trans = 0) or W[map_n(n)][c0 + map_k(k)] (trans = 1), 0 where
// a map gives -1; W row-major with row stride ldw.  out[(kt * N/8 + nt) *
// 32 + lane] = (hi b0, hi b1, lo b0, lo b1) of the lane's fragment of tile
// (kt, nt).
struct PackSpec {
  const float* W;
  float4* out;
  int ldw, c0, K, N, kmap, nmap, trans, frag0;
};
constexpr int kPacks = 8;
struct PackSpecs {
  PackSpec s[kPacks];
  int n, total, ncounters;
  int* counters;
};

template <bool BF16>
__global__ void pack_kernel(PackSpecs ps) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < ps.ncounters) ps.counters[i] = 0;
  if (i >= ps.total) return;
  int si = 0;
  while (si + 1 < ps.n && i >= ps.s[si + 1].frag0) ++si;
  const PackSpec S = ps.s[si];
  const int f = i - S.frag0;
  const int lane = f & 31;
  const int tile = f >> 5;
  const int ntl = S.N >> 3;
  const int kt = tile / ntl;
  const int n = (tile - kt * ntl) * 8 + (lane >> 2);
  const int k0 = kt * 8 + (lane & 3);
  const int rn = S.nmap == kMapD ? dmap(n) : fmap(n);
  float w[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int k = k0 + 4 * e;
    const int rk = S.kmap == kMapD ? dmap(k) : fmap(k);
    w[e] = 0.f;
    if (rk >= 0 && rn >= 0)
      w[e] = S.trans
                 ? __ldg(S.W + static_cast<size_t>(rn) * S.ldw + S.c0 + rk)
                 : __ldg(S.W + static_cast<size_t>(rk) * S.ldw + S.c0 + rn);
  }
  uint32_t h0, l0, h1, l1;
  split<BF16>(w[0], h0, l0);
  split<BF16>(w[1], h1, l1);
  S.out[f] = make_float4(__uint_as_float(h0), __uint_as_float(h1),
                         __uint_as_float(l0), __uint_as_float(l1));
}

// The packed B operands of the block kernels; the forward uses the first
// three and d_kv.
struct Packs {
  const float4* e_qkv;    // wqkv [kDp x 3 kDp]
  const float4* e_w1;     // w1 [kDp x kFp]
  const float4* e_w2;     // w2 [kFp x kDp]
  const float4* e_qkv_t;  // wqkv^T [3 kDp x kDp]
  const float4* e_w1_t;   // w1^T [kFp x kDp]
  const float4* e_w2_t;   // w2^T [kDp x kFp]
  const float4* d_kv;     // decoder wqkv[:, D:3D] [kDp x 2 kDp]
  const float4* d_kv_t;   // its transpose [2 kDp x kDp]
};

struct Mat {
  int ldw, c0, K, N, kmap, nmap, trans, side, which;  // which: wqkv w1 w2
};
// the packed operands, in the order of Packs
constexpr Mat kMats[kPacks] = {
    {3 * kD, 0, kDp, 3 * kDp, kMapD, kMapD, 0, 0, 0},
    {kF, 0, kDp, kFp, kMapD, kMapF, 0, 0, 1},
    {kD, 0, kFp, kDp, kMapF, kMapD, 0, 0, 2},
    {3 * kD, 0, 3 * kDp, kDp, kMapD, kMapD, 1, 0, 0},
    {kF, 0, kFp, kDp, kMapF, kMapD, 1, 0, 1},
    {kD, 0, kDp, kFp, kMapD, kMapF, 1, 0, 2},
    {3 * kD, kD, kDp, 2 * kDp, kMapD, kMapD, 0, 1, 0},
    {3 * kD, kD, 2 * kDp, kDp, kMapD, kMapD, 1, 1, 0}};
constexpr bool kFwdPack[kPacks] = {true, true, true, false,
                                   false, false, true, false};

// Floats of the packed operands (the forward's or all).
inline size_t pack_floats(bool all) {
  size_t n = 0;
  for (int i = 0; i < kPacks; ++i)
    if (all || kFwdPack[i]) n += 2 * static_cast<size_t>(kMats[i].K) *
                                 kMats[i].N;
  return n;
}

// Packs the operands into `dst` (pack_floats(all) floats) and clears
// `ncounters` ints at `counters`; fills `pk`.
template <bool BF16>
cudaError_t pack_weights(const Weights& ew, const Weights& dw, float* dst,
                         bool all, int* counters, int ncounters, Packs& pk,
                         cudaStream_t stream) {
  PackSpecs ps;
  const float4** slots[kPacks] = {&pk.e_qkv,   &pk.e_w1,   &pk.e_w2,
                                  &pk.e_qkv_t, &pk.e_w1_t, &pk.e_w2_t,
                                  &pk.d_kv,    &pk.d_kv_t};
  float* p = dst;
  int frag = 0;
  ps.n = 0;
  for (int i = 0; i < kPacks; ++i) {
    *slots[i] = nullptr;
    if (!all && !kFwdPack[i]) continue;
    const Mat& m = kMats[i];
    const Weights& w = m.side ? dw : ew;
    PackSpec& s = ps.s[ps.n++];
    s.W = m.which == 0 ? w.wqkv : m.which == 1 ? w.w1 : w.w2;
    s.out = reinterpret_cast<float4*>(p);
    s.ldw = m.ldw;
    s.c0 = m.c0;
    s.K = m.K;
    s.N = m.N;
    s.kmap = m.kmap;
    s.nmap = m.nmap;
    s.trans = m.trans;
    s.frag0 = frag;
    *slots[i] = s.out;
    frag += (m.K / 8) * (m.N / 8) * 32;
    p += 2 * static_cast<size_t>(m.K) * m.N;
  }
  ps.total = frag;
  ps.ncounters = ncounters;
  ps.counters = counters;
  const int threads = frag > ncounters ? frag : ncounters;
  pack_kernel<BF16><<<(threads + 255) / 256, 256, 0, stream>>>(ps);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Row products on the tensor cores
// ---------------------------------------------------------------------------

// The A fragment of rows r0 .. r0 + 15, columns k0 .. k0 + 7 (tiles.cuh
// ldsm_a); with SPILL the matrix lies in device memory and the four
// elements are loaded one by one (the same bits).
template <bool SPILL>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const float* A,
                                       int lda, int r0, int rows, int k0) {
  if constexpr (SPILL) {
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const float* p0 = A + min(r0 + g, rows - 1) * lda + k0 + t;
    const float* p1 = A + min(r0 + g + 8, rows - 1) * lda + k0 + t;
    a[0] = __float_as_uint(p0[0]);
    a[1] = __float_as_uint(p1[0]);
    a[2] = __float_as_uint(p0[4]);
    a[3] = __float_as_uint(p1[4]);
  } else {
    ldsm_a(a, A, lda, r0, rows, k0);
  }
}

// C = A B for the rows < `rows` of A (row-major, stride lda, lda / 4 odd),
// K a multiple of 8, B [K, N] packed by pack_kernel.  A warp takes tasks
// of MG row tiles x one 8-column tile; epi(r, c, v) gets each element of C
// once, on the thread that holds it.
template <int MG, bool BF16, int NW, bool SPILL, class Epi>
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
          load_a<SPILL>(a, A, lda, r0, rows, kt * 8);
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

// y[n] = sum_k rnd(x[k]) rnd(B[k][n]) for internal n < N, k < K, where
// B[k][n] = W[map_k(k)][map_n(n)] (TRANS: W[map_n(n)][map_k(k)]), 0 at
// padding; W row-major in device memory with row stride ldw.  The K terms
// are split into S = NT / N slices (at least one) whose sums go to `part`
// and are added in slice order; epi(n, y) runs on one thread per n after a
// barrier.  The caller syncs before reading what epi wrote.
template <bool BF16, bool TRANS, int NT, int KM, int NM, class Epi>
__device__ __forceinline__ void rowvec(const float* x, int K,
                                       const float* __restrict__ W, int ldw,
                                       int N, float* part, Epi epi) {
  const int S = NT / N > 0 ? NT / N : 1;
  const int kc = (K + S - 1) / S;
  for (int idx = threadIdx.x; idx < S * N; idx += NT) {
    const int s = idx / N;
    const int n = idx - s * N;
    const int rn = cmap<NM>(n);
    const int k1 = min(K, (s + 1) * kc);
    float acc = 0.f;
    for (int k = s * kc; k < k1; ++k) {
      const int rk = cmap<KM>(k);
      float w = 0.f;
      if (real<KM>(rk) && real<NM>(rn))
        w = TRANS ? __ldg(W + static_cast<size_t>(rn) * ldw + rk)
                  : __ldg(W + static_cast<size_t>(rk) * ldw + rn);
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

// Layer norm of x[r] + add[r] over the D real columns, one warp a row:
// x[r] becomes xhat, inv[r] = 1 / sqrt(var + eps), and, when h, h[r] =
// gamma xhat + beta (and hg[r], kDp a row in device memory, its rounding,
// when hg); padding columns become 0.  h may be add itself: a row's add is
// read before its h is written.
template <bool BF16, int NW>
__device__ void ln_rows(float* x, int ldx, const float* add, int lda,
                        int rows, const float* __restrict__ gamma,
                        const float* __restrict__ beta, float* inv, float* h,
                        int ldh, float* hg) {
  constexpr int E = (kDp + 31) / 32;
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < rows; r += NW) {
    float v[E];
    float s = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int i = lane + 32 * e;
      v[e] = 0.f;
      if (dreal(i)) {
        v[e] = x[r * ldx + i] + add[r * lda + i];
        s += v[e];
      }
    }
    const float mean = warp_sum(s) / kD;
    float sq = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if (dreal(lane + 32 * e)) {
        const float d = v[e] - mean;
        sq += d * d;
      }
    }
    const float iv = rsqrtf(warp_sum(sq) / kD + kLnEps);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int i = lane + 32 * e;
      if (i < kDp) {
        const bool live = dreal(i);
        const float xh = live ? (v[e] - mean) * iv : 0.f;
        x[r * ldx + i] = xh;
        if (h) {
          const float hv =
              live ? vec_at<kMapD>(gamma, i) * xh + vec_at<kMapD>(beta, i)
                   : 0.f;
          h[r * ldh + i] = hv;
          if (hg) keep<BF16>(hg + r * kDp + i, hv);
        }
      }
    }
    if (lane == 0) inv[r] = iv;
  }
}

// The lane-group width L = 2^lshift with L * KS >= T.
template <int KS>
__device__ __forceinline__ int lane_shift(int T) {
  int s = 0;
  while ((KS << s) < T) ++s;
  return s;
}

// ---------------------------------------------------------------------------
// Encoder attention (FMA units).  QKV rows hold q | k | v, rounded, at
// stride LD3 (a quarter that is odd: the L lanes of a group reading L
// consecutive key rows hit distinct banks).  An item is a (head, query
// row) of the forward, a query row of one head in the backward; lane c of
// its group holds keys c, c + L, ... (at most KS).
// ---------------------------------------------------------------------------

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
    qx[cc] = lds4(QKV + q * LD3 + h * kDhp + 4 * cc);
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
      dot4x(qx[cc], lds4(QKV + jc * LD3 + kDp + h * kDhp + 4 * cc), acc);
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

// Key slots a lane of the register tilings; past kRegT keys (a warp's
// lanes times the backward's slots) the encoder attention takes a warp a
// row and keeps the row's scores in memory (the *_long functions)
constexpr int kAttKeysFwd = 16;
constexpr int kAttKeysBwd = 8;
constexpr int kRegT = 32 * kAttKeysBwd;

// A warp's softmax of query row q of head h over all T keys, lane c taking
// keys c, c + 32, ...: s[j] = exp(score - max) and the returned 1 / sum.
__device__ __forceinline__ float row_softmax_long(float* s, const float* QKV,
                                                  const float* km, int T,
                                                  int h, int q, float scale) {
  const int lane = threadIdx.x & 31;
  float4 qx[kC];
#pragma unroll
  for (int cc = 0; cc < kC; ++cc)
    qx[cc] = lds4(QKV + q * LD3 + h * kDhp + 4 * cc);
  float m = -FLT_MAX;
  for (int j = lane; j < T; j += 32) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int cc = 0; cc < kC; ++cc)
      dot4x(qx[cc], lds4(QKV + j * LD3 + kDp + h * kDhp + 4 * cc), acc);
    s[j] = km[j] > 0.f ? sum4(acc) * scale : kNegInf;
    m = fmaxf(m, s[j]);
  }
  m = warp_max(m);
  float sum = 0.f;
  for (int j = lane; j < T; j += 32) {
    s[j] = expf(s[j] - m);
    sum += s[j];
  }
  return 1.f / warp_sum(sum);
}

// enc_att_fwd past kRegT keys: a warp an item, the row's scores in `buf`
// (NW rows of T floats).
template <bool BF16, int NW>
__device__ void enc_att_fwd_long(const float* QKV, const float* km, int T,
                                 float scale, const Dropout& drop, unsigned b,
                                 float* X1, float* buf) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* s = buf + warp * T;
  for (int it = warp; it < kH * T; it += NW) {
    const int h = it / T;
    const int q = it - h * T;
    const unsigned ex = drop.on ? drop.example(kSiteEncProbs * 16 + h, b)
                                : 0u;
    const float inv = row_softmax_long(s, QKV, km, T, h, q, scale);
    const float qmr = km[q];
    float4 o[kC];
#pragma unroll
    for (int cc = 0; cc < kC; ++cc) o[cc] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j = lane; j < T; j += 32) {
      const float p = rnd<BF16>((s[j] * inv) * (qmr * drop.scale_at(ex, q, j)));
#pragma unroll
      for (int cc = 0; cc < kC; ++cc)
        fma4(o[cc], p, lds4(QKV + j * LD3 + 2 * kDp + h * kDhp + 4 * cc));
    }
    group_sum4(o, 32);
#pragma unroll
    for (int cc = 0; cc < kC; ++cc)
      if ((cc & 31) == lane) sts4(X1 + q * kDp + h * kDhp + 4 * cc, o[cc]);
    __syncwarp();
  }
}

// ctx[q, h dhp + d] = sum_k rnd(P0[q, k] DM[q, k]) v[k, h dhp + d], DM =
// q_mask * dropout; every (head, query) item at once.
template <bool BF16, int NT>
__device__ void enc_att_fwd(const float* QKV, const float* km, int T,
                            float scale, const Dropout& drop, unsigned b,
                            float* X1) {
  constexpr int KS = kAttKeysFwd;
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
        fma4(o[cc], p, lds4(QKV + jc * LD3 + 2 * kDp + h * kDhp + 4 * cc));
    }
    group_sum4(o, L);
    if (active) {
#pragma unroll
      for (int cc = 0; cc < kC; ++cc)
        if ((cc & (L - 1)) == c) sts4(X1 + q * kDp + h * kDhp + 4 * cc, o[cc]);
    }
  }
}

// ---------------------------------------------------------------------------
// One example's activations: the same layout in shared memory or, with
// SPILL, in its block's slice of a global workspace.  `bwd` adds what only
// the backward needs (one head's [T, T] tiles, the decoder's K/V grads).
// ---------------------------------------------------------------------------

struct Act {
  float *E0, *QKV, *H1, *HG, *X1, *X2, *BIG, *SA, *SB, *km, *inv1, *inv2;
  float *d0, *qd, *x1d, *hd, *x2d, *gd, *dhd, *dqd, *fd, *dfd, *pdd, *dmd,
      *dsd, *st, *part;
  int T4;
};

__host__ __device__ inline int big_floats(int T, bool bwd) {
  const int f = T * LDF;
  const int kv = (bwd ? 2 : 1) * T * LD2;
  return f > kv ? f : kv;
}

__host__ __device__ inline int part_floats(int NT) {
  const int m = kFp > kDp ? kFp : kDp;
  return NT > m ? NT : m;
}

__host__ __device__ inline Act act_layout(float* base, int T, int NT,
                                          bool bwd) {
  Act a;
  const int T4 = round4(T);
  // the backward's [T, T] tiles; the forward's score rows past kRegT
  const int TA = bwd ? round4(T * T) : T > kRegT ? 16 * T : 0;
  const int TB = bwd ? round4(T * T) : 0;
  a.T4 = T4;
  a.E0 = base;                        // [T, LD1] dropped-out encoder input
  a.QKV = a.E0 + T * LD1;             // [T, LD3] q | k | v, rounded
  a.H1 = a.QKV + T * LD3;             // [T, LD1] h1, then dh1 -> da1
  a.HG = a.H1 + T * LD1;              // [T, LD1] H2, then dH2 -> dln2
  a.X1 = a.HG + T * LD1;              // [T, kDp] ctx, then xhat1
  a.X2 = a.X1 + T * kDp;              // [T, kDp] f2, then xhat2
  a.BIG = a.X2 + T * kDp;             // f | K/V_d and their grads | dqkv
  a.SA = a.BIG + big_floats(T, bwd);  // [T, T] one head's rnd(P0 DM)
  a.SB = a.SA + TA;                   // [T, T] one head's rnd(dS)
  a.km = a.SB + TB;                   // [T4] key mask
  a.inv1 = a.km + T4;
  a.inv2 = a.inv1 + T4;
  a.d0 = a.inv2 + T4;                 // decoder rows, kDp each
  a.qd = a.d0 + kDp;
  a.x1d = a.qd + kDp;                 // ctx_d, then xhat1_d
  a.hd = a.x1d + kDp;
  a.x2d = a.hd + kDp;                 // f2_d, then xhat2_d
  a.gd = a.x2d + kDp;                 // forward: out; backward: g -> dln2_d
  a.dhd = a.gd + kDp;                 // dh1_d, then da1_d
  a.dqd = a.dhd + kDp;
  a.fd = a.dqd + kDp;                 // [kFp]
  a.dfd = a.fd + kFp;                 // [kFp]
  a.pdd = a.dfd + kFp;                // [kH, T4] decoder P0
  a.dmd = a.pdd + kH * T4;            // [kH, T4] decoder dropout
  a.dsd = a.dmd + kH * T4;            // [kH, T4] decoder dS
  a.st = a.dsd + kH * T4;             // inverse std of the decoder's LNs
  a.part = a.st + 4;                  // rowvec slices
  return a;
}

// Floats of one example's activations (a multiple of 4).
__host__ __device__ inline size_t act_floats(int T, int NT, bool bwd) {
  const Act a = act_layout(nullptr, T, NT, bwd);
  return static_cast<size_t>(a.part - static_cast<float*>(nullptr)) +
         part_floats(NT);
}

// Threads of a block: 512 above T = 32, 256 at or below.
__host__ __device__ inline int block_threads(int T) { return T > 32 ? 512 : 256; }

// Whether both block kernels run their SPILL instantiation at this T: when
// the backward's activations of one example exceed what a block can opt
// into, or T needs the encoder attention past kRegT keys, which only the
// SPILL instantiations carry (the backward's [T, T] tiles spill there
// anyway).  The forward, whose activations are smaller, follows the
// backward's rule, so that at every T the two kernels run the same
// instantiation of `replay`.
inline bool spills(int T, int smem_optin) {
  return T > kRegT || act_floats(T, block_threads(T), true) * sizeof(float) >
                          static_cast<size_t>(smem_optin);
}

// The kernels' grid: a persistent block an SM (more where they fit), at
// most B; with SPILL the workspace holds one slice per block.
inline int spill_blocks(int B, int sms) { return B < sms ? B : sms; }

inline int smem_optin() {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  return v;
}

// Where the replay leaves what only the backward's weight grads need (rows
// b T + t, or row b, kDp or kFp a row), and, when not null, where a probe
// copies the FF pre-activations.  Kernel arguments, offset where used, so
// no pointer of them stays live in a register across the replay.
struct Keep {
  float* xh;   // [B T, kDp] h1
  float* xd;   // [B T, kDp] H2
  float* xhd;  // [B, kDp] decoder h1
  float* xfd;  // [B, kFp] decoder f
};
struct Probe {
  float* enc;  // [B, T, F] encoder h1 w1 + b1
  float* dec;  // [B, F] decoder h1 w1 + b1
};
// The save mode of the TPU kernels (DMT_BLOCK_SAVE): the encoder's Q, K, V
// as the projection rounded them (in the input type, which holds them
// exactly) and its attention context (float32), [B, T, D] each in the
// real layout.  Null pointers: the mode is off.  The forward writes them;
// the backward, with `load`, reads them in place of the encoder's
// projection and attention, which would form the same bits.
struct Saved {
  void* q;
  void* k;
  void* v;
  float* ctx;
  bool load;
};

template <bool BF16>
using InType = typename std::conditional<BF16, __nv_bfloat16, float>::type;

// The two copies between an example's activations and the saved tensors
// run out of line: inlined into the replay, they took registers from it
// and cost both kernels 1-2.5% with the mode off (scripts/compare_trees.py
// on the H100); out of line, under 1%.

// Example b's Q, K and V between the rows of QKV (q | k | v, padding 0)
// and the saved tensors q, k, v: written from QKV, or, with LOAD, read
// into it.  Consecutive threads take consecutive columns of a row of one
// part.
template <bool BF16, int NT, bool LOAD>
__device__ __noinline__ void saved_qkv(float* QKV, int T, void* q, void* k,
                                       void* v, size_t row0) {
  using TIn = InType<BF16>;
  for (int i = threadIdx.x; i < 3 * T * kDp; i += NT) {
    const int p = i / (T * kDp);
    const int w = i - p * T * kDp;
    const int r = w / kDp;
    const int c = p * kDp + (w - r * kDp);
    const int rc = dmap(c);
    if (!real<kMapD>(rc)) {
      if (LOAD) QKV[r * LD3 + c] = 0.f;
      continue;
    }
    TIn* at = static_cast<TIn*>(p == 0 ? q : p == 1 ? k : v) +
              (row0 + r) * kD + (rc - p * kD);
    if constexpr (LOAD) {
      QKV[r * LD3 + c] = to_float(*at);
    } else {
      store(at, QKV[r * LD3 + c]);
    }
  }
}

// Example b's attention context between X1 (padding 0) and the saved
// float32 tensor: written from X1, or, with LOAD, read into it.
template <int NT, bool LOAD>
__device__ __noinline__ void saved_ctx(float* X1, int T, float* ctx,
                                       size_t row0) {
  for (int i = threadIdx.x; i < T * kDp; i += NT) {
    const int r = i / kDp;
    const int c = i - r * kDp;
    const int rc = dmap(c);
    if (!real<kMapD>(rc)) {
      if (LOAD) X1[i] = 0.f;
      continue;
    }
    float* at = ctx + (row0 + r) * kD + rc;
    if constexpr (LOAD) {
      X1[i] = *at;
    } else {
      *at = X1[i];
    }
  }
}

// Loads example b: the dropped-out encoder rows and decoder row (internal
// layout, padding 0) and the key mask; with `xe`/`xq` also keeps them.
template <bool BF16, int NT, typename TIn>
__device__ __forceinline__ void load_example(
    const Act& a, const TIn* __restrict__ enc, const TIn* __restrict__ dec,
    const float* __restrict__ mask, int T, unsigned b, const Dropout& drop,
    float* xe, float* xq) {
  const int tid = threadIdx.x;
  const unsigned ex_e = drop.on ? drop.example(kSiteEncIn, b) : 0u;
  const unsigned ex_d = drop.on ? drop.example(kSiteDecIn, b) : 0u;
  const size_t row0 = static_cast<size_t>(b) * T;
  for (int i = tid; i < T * kDp; i += NT) {
    const int r = i / kDp;
    const int c = i - r * kDp;
    const int rc = dmap(c);
    const float e0 = real<kMapD>(rc) ? to_float(enc[(row0 + r) * kD + rc]) *
                                   drop.scale_at(ex_e, r, rc)
                             : 0.f;
    a.E0[r * LD1 + c] = e0;
    if (xe) keep<BF16>(xe + (row0 + r) * kDp + c, e0);
  }
  for (int i = tid; i < kDp; i += NT) {
    const int rc = dmap(i);
    a.d0[i] = real<kMapD>(rc) ? to_float(dec[static_cast<size_t>(b) * kD + rc]) *
                            drop.scale_at(ex_d, 0, rc)
                      : 0.f;
    if (xq) keep<BF16>(xq + static_cast<size_t>(b) * kDp + i, a.d0[i]);
  }
  for (int i = tid; i < T; i += NT) a.km[i] = mask[row0 + i];
}

// The forward of example b from its loaded inputs: the encoder (QKV,
// attention, LN1, FF, LN2 -> H2 in HG) and the decoder's one query against
// H2 (Q, K/V, attention, LN1, FF, LN2): xhat2_d in x2d and, when `out`,
// the block's output row there.  The backward keeps the weight-grad
// operands in `kp`; the forward passes null pointers there.  With `sv`
// set, the forward writes the encoder's Q, K, V and attention context, and
// the backward (sv.load) reads them instead of forming them.  What the
// backward reads afterwards: QKV, X1 (xhat1), H1 (h1), X2 (xhat2), HG,
// inv1, inv2, BIG's K/V_d, qd, pdd, dmd, x1d, hd, fd, x2d, st.
template <int MGW, bool BF16, int NW, int NT, bool SPILL>
__device__ __forceinline__ void replay(const Act& a, int T, const Packs& pk,
                                       const Weights& ew, const Weights& dw,
                                       float scale, const Dropout& drop,
                                       unsigned b, const Keep& kp,
                                       const Probe& probe, const Saved& sv,
                                       float* out) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int T4 = a.T4;
  const float* evec = ew.vecs;
  const float* dvec = dw.vecs;
  float* QKV = a.QKV;
  float* BIG = a.BIG;
  float* KVd = a.BIG;  // [T, LD2] k_d | v_d, rounded
  const size_t row0 = static_cast<size_t>(b) * T;

  // ---- encoder ----
  if (sv.load) {
    saved_qkv<BF16, NT, true>(QKV, T, sv.q, sv.k, sv.v, row0);
    saved_ctx<NT, true>(a.X1, T, sv.ctx, row0);
    __syncthreads();
  } else {
    mma_rows<MGW, BF16, NW, SPILL>(a.E0, LD1, T, kDp, pk.e_qkv, 3 * kDp,
                                   [&](int r, int c, float v) {
                                     QKV[r * LD3 + c] = rnd<BF16>(
                                         v + vec_at<kMapD>(evec, c));
                                   });
    __syncthreads();
    if (sv.q) saved_qkv<BF16, NT, false>(QKV, T, sv.q, sv.k, sv.v, row0);
    // past kRegT keys both kernels spill (an example's [T, T] tiles alone
    // pass what a block can opt into), so only SPILL carries that path
    if (SPILL && T > kRegT) {
      enc_att_fwd_long<BF16, NW>(QKV, a.km, T, scale, drop, b, a.X1, a.SA);
    } else {
      enc_att_fwd<BF16, NT>(QKV, a.km, T, scale, drop, b, a.X1);
    }
    __syncthreads();
    if (sv.ctx) {
      saved_ctx<NT, false>(a.X1, T, sv.ctx, row0);
      __syncthreads();  // ln_rows overwrites X1
    }
  }
  ln_rows<BF16, NW>(a.X1, kDp, a.E0, LD1, T, evec + 3 * kD, evec + 4 * kD,
                    a.inv1, a.H1, LD1, kp.xh ? kp.xh + row0 * kDp : nullptr);
  __syncthreads();
  mma_rows<MGW, BF16, NW, SPILL>(a.H1, LD1, T, kDp, pk.e_w1, kFp,
                                 [&](int r, int c, float v) {
                                   const float pre =
                                       v + vec_at<kMapF>(ew.b1, c);
                                   BIG[r * LDF + c] = fmaxf(pre, 0.f);
                                   if (probe.enc && c < kF)
                                     probe.enc[(row0 + r) * kF + c] = pre;
                                 });
  __syncthreads();
  mma_rows<1, BF16, NW, SPILL>(BIG, LDF, T, kFp, pk.e_w2, kDp,
                               [&](int r, int c, float v) {
                                 a.X2[r * kDp + c] =
                                     v + vec_at<kMapD>(evec + 7 * kD, c);
                               });
  __syncthreads();
  ln_rows<BF16, NW>(a.X2, kDp, a.H1, LD1, T, evec + 5 * kD, evec + 6 * kD,
                    a.inv2, a.HG, LD1, kp.xd ? kp.xd + row0 * kDp : nullptr);
  __syncthreads();

  // ---- decoder ----
  mma_rows<1, BF16, NW, SPILL>(a.HG, LD1, T, kDp, pk.d_kv, 2 * kDp,
                               [&](int r, int c, float v) {
                                 KVd[r * LD2 + c] = rnd<BF16>(
                                     v + vec_at<kMapD>(dvec + kD, c));
                               });
  rowvec<BF16, false, NT, kMapD, kMapD>(
      a.d0, kDp, dw.wqkv, 3 * kD, kDp, a.part, [&](int n, float y) {
        a.qd[n] = rnd<BF16>(y + vec_at<kMapD>(dvec, n));
      });
  __syncthreads();
  // one warp a head: the single query's probabilities over the T keys
  for (int h = warp; h < kH; h += NW) {
    const unsigned ex = drop.on ? drop.example(kSiteDecProbs * 16 + h, b)
                                : 0u;
    float* p = a.pdd + h * T4;
    float m = -FLT_MAX;
    for (int k = lane; k < T; k += 32) {
      float acc = 0.f;
      for (int d = 0; d < kDhp; ++d)
        acc = fmaf(a.qd[h * kDhp + d], KVd[k * LD2 + h * kDhp + d], acc);
      p[k] = a.km[k] > 0.f ? acc * scale : kNegInf;
      m = fmaxf(m, p[k]);
    }
    m = warp_max(m);
    float sum = 0.f;
    for (int k = lane; k < T; k += 32) {
      p[k] = expf(p[k] - m);
      sum += p[k];
    }
    const float inv = 1.f / warp_sum(sum);
    for (int k = lane; k < T; k += 32) {
      p[k] *= inv;
      a.dmd[h * T4 + k] = drop.scale_at(ex, 0, k);
    }
  }
  __syncthreads();
  for (int j = tid; j < kDp; j += NT) {
    const int h = j / kDhp;
    float s = 0.f;
    if (head_ok(h)) {
      for (int k = 0; k < T; ++k)
        s = fmaf(rnd<BF16>(a.pdd[h * T4 + k] * a.dmd[h * T4 + k]),
                 KVd[k * LD2 + kDp + j], s);
    }
    a.x1d[j] = s;
  }
  __syncthreads();
  ln_rows<BF16, NW>(a.x1d, kDp, a.d0, kDp, 1, dvec + 3 * kD, dvec + 4 * kD,
                    a.st, a.hd, kDp,
                    kp.xhd ? kp.xhd + static_cast<size_t>(b) * kDp : nullptr);
  __syncthreads();
  rowvec<BF16, false, NT, kMapD, kMapF>(
      a.hd, kDp, dw.w1, kF, kFp, a.part, [&](int n, float y) {
        const float pre = y + vec_at<kMapF>(dw.b1, n);
        a.fd[n] = fmaxf(pre, 0.f);
        if (probe.dec && n < kF)
          probe.dec[static_cast<size_t>(b) * kF + n] = pre;
        if (kp.xfd)
          keep<BF16>(kp.xfd + static_cast<size_t>(b) * kFp + n, a.fd[n]);
      });
  __syncthreads();
  rowvec<BF16, false, NT, kMapF, kMapD>(
      a.fd, kFp, dw.w2, kD, kDp, a.part, [&](int n, float y) {
        a.x2d[n] = y + vec_at<kMapD>(dvec + 7 * kD, n);
      });
  __syncthreads();
  ln_rows<BF16, NW>(a.x2d, kDp, a.hd, kDp, 1, dvec + 5 * kD, dvec + 6 * kD,
                    a.st + 1, out, kDp, nullptr);
  __syncthreads();
}

}  // namespace
