// Masked multi-head attention backward.
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
// Bound: at B=2048, T=50, D=80 one launch does 2.0 G multiply-adds (five
// [50 x 50 x 20] products per example and head) against 229 MB of q, k, v,
// do, dq, dk and dv: ~69 us of memory, ~61 us of float32 FMA at 67 TFLOP/s.
//
// Design.  The unit of work is one (example, head): heads share no
// operand, so a unit needs only its own [T, dh] slices of q, k, v and do,
// and its [Tq, Tk] tiles of P and dS.  In float32 at T=50, dh=20 that is
// 37 KB of shared memory (an example's four heads together would be 150
// KB, one block per SM), so a block of 128 threads holds as many units as
// fit in ~24 KB, at least one: one unit at the encoder's T=50, 5 at T=10,
// 2 at Tq=1 over 50 keys, 10 at Tq=1 over 10, so every warp has work at
// every shape and B needs to be a multiple of nothing.  The block's
// threads work through a flat list of the block's (unit, tile) items in
// each phase, with no per-element division:
//
// - Load: the slices, 4 elements per access (16-byte float4 in float32,
//   8 bytes in bfloat16) where dh and D allow, four loads in flight a
//   thread, into rows of a padded width ld (dh rounded up to the
//   compile-time DH, then to an odd number of float4s, so that 8 lanes
//   reading 8 consecutive rows hit 32 distinct banks); the padding is zero.
// - Phase 1 (S, P0, dP, dS): a group of L lanes (a power of two, L <= 8)
//   shares RQ query rows; each lane holds 8 interleaved keys (j = lane +
//   L i) and accumulates the RQ x 8 scores in registers over DH (compile
//   time, unrolled), reading q and k as float4.  Row max and sum are
//   shuffles among the L lanes; P0 waits in the dS rows of shared memory
//   while a second pass forms the RQ x 8 dP from do and v the same way, so
//   only one set of accumulators is live.  A warp with no rows to do skips
//   the round.  P and dS go to shared memory, rounded.
// - Phase 2: each thread owns a 4 x 4 tile of an output (dq: 4 query rows
//   x 4 columns over the keys; dk or dv: 4 keys x 4 columns over the query
//   rows), reading dS or P as float4 along the keys and q, do or k as
//   float4 along the columns, so a float4 of each operand feeds 16 FMAs.
//
// Two instantiations per head width, picked from Tq: RQ = 2 rows a lane
// group and at most 102 registers a thread (five blocks an SM) for the
// encoder's self-attention, RQ = 1 and at most 64 registers (eight blocks)
// for Tq <= 4, where the work per unit is small and occupancy hides the
// loads' latency.  RQ = 4, 8 x 4 tiles in phase 2, dk and dv in one item
// and a tighter register cap were each slower on the H100 (PERF.md).
// What bounds it: at T=50 the kernel runs at ~6x its byte bound, far from
// both the memory and the FMA rate: it is latency-bound.  Timed with a
// phase skipped (scripts/attention_bwd_variants.py), phase 1 takes about
// half of the time.
//
// Tensor cores: none.  The float32 main path needs float32 products (the
// plain version's tolerance is 1e-4 relative with allow_tf32 off, and TF32
// keeps 10 mantissa bits), and a wgmma tile of 64 rows over T=50 queries
// and dh=20 columns would waste half of its work.  cp.async is not used: a
// block does its units at once, not in turn, and several blocks per SM
// overlap one block's loads with another's arithmetic.
//
// Past 64 keys or query rows, or a head wider than 64 columns, the
// launcher takes attention_bwd_rows and attention_bwd_cols instead
// (attention_rows.cuh), with the row statistics in the caller's workspace.
//
// Each output element has one owner thread that sums in a fixed order, so
// two launches on the same inputs give the same bits.

#include <cfloat>
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "attention_rows.cuh"
#include "block_common.cuh"

namespace {

constexpr int kBwdThreads = 128;
// at most 102 registers a thread, so that five blocks share an SM at T=50;
// with one query row a lane group (Tq <= 4) at most 64, so that eight do
constexpr int kMinBlocks = 5;
constexpr int kMinBlocksSmall = 8;
constexpr int kSmallTq = 4;
constexpr int kKeysPerLane = 8;        // phase 1, interleaved: L * 8 >= Tk
constexpr int kSmemTarget = 24 * 1024; // bytes of units per block
constexpr int kMaxUnits = 16;
constexpr int kLoadBatch = 4;

// A row width (a multiple of 4 floats) padded to an odd number of float4s.
__host__ __device__ constexpr int pad_ld(int w) {
  return (w / 4) % 2 ? w : w + 4;
}
__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }

// Offsets, in floats, of a unit's arrays in shared memory; every offset is
// a multiple of 4.
struct Layout {
  int Tk4, ld, lds;
  int q, dout, k, v, P, S, qm, km, size;
};

__host__ __device__ inline Layout layout(int Tq, int Tk, int DH) {
  Layout L;
  L.Tk4 = round4(Tk);
  L.ld = pad_ld(DH);
  L.lds = pad_ld(L.Tk4);
  L.q = 0;                          // [Tq, ld]
  L.dout = L.q + Tq * L.ld;         // [Tq, ld]
  L.k = L.dout + Tq * L.ld;         // [Tk4, ld], rows >= Tk zero
  L.v = L.k + L.Tk4 * L.ld;         // [Tk4, ld]
  L.P = L.v + L.Tk4 * L.ld;         // [Tq, lds] P0 * q_mask, rounded
  L.S = L.P + Tq * L.lds;           // [Tq, lds] dS, rounded
  L.qm = L.S + Tq * L.lds;          // [round4(Tq)]
  L.km = L.qm + round4(Tq);         // [Tk4], zero beyond Tk
  L.size = L.km + L.Tk4;
  return L;
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
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

// Four consecutive columns d.. of a row, zero at d + e >= dh.
template <typename T>
__device__ __forceinline__ float4 load_cols(const T* p, int d, int dh,
                                            bool vec) {
  if (vec && d + 4 <= dh) return ldg4(p);
  float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
  if (d < dh) x.x = to_float(p[0]);
  if (d + 1 < dh) x.y = to_float(p[1]);
  if (d + 2 < dh) x.z = to_float(p[2]);
  if (d + 3 < dh) x.w = to_float(p[3]);
  return x;
}

template <typename T>
__device__ __forceinline__ void store_cols(T* p, float4 x, int d, int dh,
                                           bool vec) {
  if (vec && d + 4 <= dh) {
    stg4(p, x);
    return;
  }
  if (d < dh) store(p, x.x);
  if (d + 1 < dh) store(p + 1, x.y);
  if (d + 2 < dh) store(p + 2, x.z);
  if (d + 3 < dh) store(p + 3, x.w);
}

__device__ __forceinline__ void fma4(float4& acc, float a, float4 x) {
  acc.x = fmaf(a, x.x, acc.x);
  acc.y = fmaf(a, x.y, acc.y);
  acc.z = fmaf(a, x.z, acc.z);
  acc.w = fmaf(a, x.w, acc.w);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// Reductions over the `lanes` (a power of two) neighbouring lanes of a
// group; every lane of the warp takes part.
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

template <int DH, int RQ, typename TIn>
__global__ void __launch_bounds__(kBwdThreads, RQ == 1 ? kMinBlocksSmall
                                                        : kMinBlocks)
    attention_bwd_kernel(const TIn* __restrict__ q, const TIn* __restrict__ k,
                         const TIn* __restrict__ v,
                         const float* __restrict__ qm,
                         const float* __restrict__ km,
                         const TIn* __restrict__ dout, TIn* __restrict__ dq,
                         TIn* __restrict__ dk, TIn* __restrict__ dv,
                         int n_units, int upb, int Tq, int Tk, int D, int H,
                         float scale, int vec_io, int lshift) {
  constexpr bool BF16 = !std::is_same<TIn, float>::value;
  constexpr int C = DH / 4;  // float4s of a padded row
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Layout L = layout(Tq, Tk, DH);
  const int dh = D / H;
  const bool vec = vec_io != 0;
  const int unit0 = blockIdx.x * upb;
  const int units = min(upb, n_units - unit0);
  const int t = threadIdx.x;

  // ---- load: q, do [Tq, dh], k, v [Tk, dh] slices and the masks ----
  {
    const int per_q = Tq * C;
    const int per_k = L.Tk4 * C;
    const int per_unit = 2 * per_q + 2 * per_k;
    // kLoadBatch loads in flight a thread before their stores
    const int n_load = units * per_unit;
    for (int i0 = t; i0 < n_load; i0 += kLoadBatch * kBwdThreads) {
      float4 x[kLoadBatch];
      float* dst[kLoadBatch];
#pragma unroll
      for (int e = 0; e < kLoadBatch; ++e) {
        const int i = i0 + e * kBwdThreads;
        x[e] = make_float4(0.f, 0.f, 0.f, 0.f);
        dst[e] = nullptr;
        if (i >= n_load) continue;
        const int u = i / per_unit;
        int w = i - u * per_unit;
        const int unit = unit0 + u;
        const int b = unit / H;
        const int hcol = (unit - b * H) * dh;
        const TIn* src;
        int off;
        int rows;
        if (w < 2 * per_q) {
          const bool isg = w >= per_q;
          if (isg) w -= per_q;
          src = (isg ? dout : q) + static_cast<size_t>(b) * Tq * D + hcol;
          off = isg ? L.dout : L.q;
          rows = Tq;
        } else {
          w -= 2 * per_q;
          const bool isv = w >= per_k;
          if (isv) w -= per_k;
          src = (isv ? v : k) + static_cast<size_t>(b) * Tk * D + hcol;
          off = isv ? L.v : L.k;
          rows = Tk;
        }
        const int r = w / C;
        const int d = (w - r * C) * 4;
        dst[e] = smem + u * L.size + off + r * L.ld + d;
        if (r < rows)
          x[e] = load_cols(src + static_cast<size_t>(r) * D + d, d, dh, vec);
      }
#pragma unroll
      for (int e = 0; e < kLoadBatch; ++e)
        if (dst[e]) *reinterpret_cast<float4*>(dst[e]) = x[e];
    }
    const int per_m = round4(Tq) + L.Tk4 + Tq * (L.Tk4 - Tk) * 2;
    for (int i = t; i < units * per_m; i += kBwdThreads) {
      const int u = i / per_m;
      int w = i - u * per_m;
      const int b = (unit0 + u) / H;
      float* U = smem + u * L.size;
      if (w < round4(Tq)) {
        U[L.qm + w] = w < Tq ? qm[static_cast<size_t>(b) * Tq + w] : 0.f;
        continue;
      }
      w -= round4(Tq);
      if (w < L.Tk4) {
        U[L.km + w] = w < Tk ? km[static_cast<size_t>(b) * Tk + w] : 0.f;
        continue;
      }
      // P and dS are zero at the padding keys Tk .. Tk4 - 1
      w -= L.Tk4;
      const int pad = L.Tk4 - Tk;
      const int r = w / (2 * pad);
      const int e = w - r * 2 * pad;
      U[(e < pad ? L.P : L.S) + r * L.lds + Tk + (e < pad ? e : e - pad)] =
          0.f;
    }
  }
  __syncthreads();

  // ---- phase 1: S, P0, dP, dS; a group of 2^lshift lanes per RQ rows ----
  {
    const int lanes = 1 << lshift;
    const int c = t & (lanes - 1);
    const int g = t >> lshift;
    const int groups = kBwdThreads >> lshift;
    const int warp_g0 = (t & ~31) >> lshift;  // the warp's first group
    const int nrq = (Tq + RQ - 1) / RQ;  // rows rq + nrq * a, a < RQ
    const int kc = (Tk + lanes - 1) >> lshift;  // key slots in use, <= 8
    const int n_items = units * nrq;
    // a warp runs an item round only if one of its groups has an item; the
    // shuffles below run on every lane of a warp that does
    for (int base = 0; base + warp_g0 < n_items; base += groups) {
      const int it = base + g;
      const bool active = it < n_items;
      const int u = active ? it / nrq : 0;
      const int rq = active ? it - u * nrq : 0;
      float* U = smem + u * L.size;
      int row[RQ];
      int na = 0;  // rows of the item below Tq
#pragma unroll
      for (int a = 0; a < RQ; ++a) {
        na += rq + nrq * a < Tq;
        row[a] = min(rq + nrq * a, Tq - 1);
      }
      int key[kKeysPerLane];
#pragma unroll
      for (int i = 0; i < kKeysPerLane; ++i)
        key[i] = min(c + (i << lshift), Tk - 1);
      float acc[RQ][kKeysPerLane];

      // pass A: scores, then P0 (kept in acc, and in the dS rows of shared
      // memory until pass B has formed dP)
#pragma unroll
      for (int a = 0; a < RQ; ++a)
#pragma unroll
        for (int i = 0; i < kKeysPerLane; ++i) acc[a][i] = 0.f;
#pragma unroll
      for (int d = 0; d < DH; d += 4) {
        float4 x[RQ];
#pragma unroll
        for (int a = 0; a < RQ; ++a)
          if (a < na) x[a] = lds4(U + L.q + row[a] * L.ld + d);
#pragma unroll
        for (int i = 0; i < kKeysPerLane; ++i) {
          if (i < kc) {
            const float4 kj = lds4(U + L.k + key[i] * L.ld + d);
#pragma unroll
            for (int a = 0; a < RQ; ++a)
              if (a < na) acc[a][i] = dot4(x[a], kj, acc[a][i]);
          }
        }
      }
#pragma unroll
      for (int a = 0; a < RQ; ++a) {
        float m = -FLT_MAX;
#pragma unroll
        for (int i = 0; i < kKeysPerLane; ++i) {
          const int j = c + (i << lshift);
          if (i < kc && j < Tk) {
            acc[a][i] = U[L.km + j] > 0.f ? acc[a][i] * scale : kNegInf;
            m = fmaxf(m, acc[a][i]);
          }
        }
        m = group_max(m, lanes);
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < kKeysPerLane; ++i) {
          const int j = c + (i << lshift);
          acc[a][i] = i < kc && j < Tk ? expf(acc[a][i] - m) : 0.f;
          sum += acc[a][i];
        }
        const float inv = 1.f / group_sum(sum, lanes);
        if (active && a < na) {
          float* Sr = U + L.S + row[a] * L.lds;
#pragma unroll
          for (int i = 0; i < kKeysPerLane; ++i) {
            const int j = c + (i << lshift);
            if (i < kc && j < Tk) Sr[j] = acc[a][i] * inv;
          }
        }
      }

      // pass B: dP, then dS = P0 (dP - rowsum(dP P0)) and the rounded P
#pragma unroll
      for (int a = 0; a < RQ; ++a)
#pragma unroll
        for (int i = 0; i < kKeysPerLane; ++i) acc[a][i] = 0.f;
#pragma unroll
      for (int d = 0; d < DH; d += 4) {
        float4 x[RQ];
#pragma unroll
        for (int a = 0; a < RQ; ++a)
          if (a < na) x[a] = lds4(U + L.dout + row[a] * L.ld + d);
#pragma unroll
        for (int i = 0; i < kKeysPerLane; ++i) {
          if (i < kc) {
            const float4 vj = lds4(U + L.v + key[i] * L.ld + d);
#pragma unroll
            for (int a = 0; a < RQ; ++a)
              if (a < na) acc[a][i] = dot4(x[a], vj, acc[a][i]);
          }
        }
      }
#pragma unroll
      for (int a = 0; a < RQ; ++a) {
        const bool mine = active && a < na;
        const float qmr = U[L.qm + row[a]];
        float* Pr = U + L.P + row[a] * L.lds;
        float* Sr = U + L.S + row[a] * L.lds;
        float p0[kKeysPerLane];
        float rs = 0.f;
#pragma unroll
        for (int i = 0; i < kKeysPerLane; ++i) {
          const int j = c + (i << lshift);
          p0[i] = mine && i < kc && j < Tk ? Sr[j] : 0.f;
          acc[a][i] *= qmr;
          rs = fmaf(acc[a][i], p0[i], rs);
        }
        rs = group_sum(rs, lanes);
        if (mine) {
#pragma unroll
          for (int i = 0; i < kKeysPerLane; ++i) {
            const int j = c + (i << lshift);
            if (i < kc && j < Tk) {
              const float ds =
                  U[L.km + j] > 0.f ? p0[i] * (acc[a][i] - rs) : 0.f;
              Pr[j] = rnd<BF16>(p0[i] * qmr);
              Sr[j] = rnd<BF16>(ds);
            }
          }
        }
      }
    }
  }
  __syncthreads();

  // ---- phase 2: 4 x 4 output tiles of dq, dk and dv ----
  {
    const int c4n = (dh + 3) >> 2;
    const int nrt = (Tq + 3) >> 2;  // dq row tiles: rows rt + nrt * i
    const int njt = L.Tk4 >> 2;     // key tiles: keys 4 jt .. 4 jt + 3
    const int n_dq = nrt * c4n;
    const int n_kv = njt * c4n;
    const int per_unit = n_dq + 2 * n_kv;
    for (int it = t; it < units * per_unit; it += kBwdThreads) {
      const int u = it / per_unit;
      int w = it - u * per_unit;
      const int unit = unit0 + u;
      const int b = unit / H;
      const int hcol = (unit - b * H) * dh;
      const float* U = smem + u * L.size;
      float4 acc[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (w < n_dq) {
        // dq[r, d..d+3] = scale * sum_j dS[r, j] k[j, d..d+3]
        const int rt = w / c4n;
        const int d = (w - rt * c4n) * 4;
        const float* Sr[4];
        int nr = 0;  // rows of the tile below Tq (1 when Tq == 1)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          Sr[i] = U + L.S + min(rt + nrt * i, Tq - 1) * L.lds;
          nr += rt + nrt * i < Tq;
        }
        const float* kc = U + L.k + d;
        for (int j = 0; j < L.Tk4; j += 4) {
          const float4 k0 = lds4(kc + j * L.ld);
          const float4 k1 = lds4(kc + (j + 1) * L.ld);
          const float4 k2 = lds4(kc + (j + 2) * L.ld);
          const float4 k3 = lds4(kc + (j + 3) * L.ld);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (i >= nr) break;
            const float4 sv = lds4(Sr[i] + j);
            fma4(acc[i], sv.x, k0);
            fma4(acc[i], sv.y, k1);
            fma4(acc[i], sv.z, k2);
            fma4(acc[i], sv.w, k3);
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = rt + nrt * i;
          if (r < Tq) {
            const float4 x = make_float4(acc[i].x * scale, acc[i].y * scale,
                                         acc[i].z * scale, acc[i].w * scale);
            store_cols(dq + (static_cast<size_t>(b) * Tq + r) * D + hcol + d,
                       x, d, dh, vec);
          }
        }
      } else {
        // dk[j, d..] = scale * sum_r dS[r, j] q[r, d..];
        // dv[j, d..] = sum_r P[r, j] do[r, d..]
        w -= n_dq;
        const bool isv = w >= n_kv;
        if (isv) w -= n_kv;
        const int jt = w / c4n;
        const int d = (w - jt * c4n) * 4;
        const float* A = U + (isv ? L.P : L.S) + 4 * jt;
        const float* X = U + (isv ? L.dout : L.q) + d;
        for (int r = 0; r < Tq; ++r) {
          const float4 a = lds4(A + r * L.lds);
          const float4 x = lds4(X + r * L.ld);
          fma4(acc[0], a.x, x);
          fma4(acc[1], a.y, x);
          fma4(acc[2], a.z, x);
          fma4(acc[3], a.w, x);
        }
        const float f = isv ? 1.f : scale;
        TIn* out = isv ? dv : dk;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int j = 4 * jt + i;
          if (j < Tk) {
            const float4 x = make_float4(acc[i].x * f, acc[i].y * f,
                                         acc[i].z * f, acc[i].w * f);
            store_cols(out + (static_cast<size_t>(b) * Tk + j) * D + hcol + d,
                       x, d, dh, vec);
          }
        }
      }
    }
  }
}

// Any shape (attention_rows.cuh), in two kernels.  Rows: one warp a query
// row forms the row's max and sum, rowsum(dP P0), and dq = scale rnd(dS) k,
// and keeps the three row statistics.  Columns: one warp a key forms dk =
// scale rnd(dS)^T q and dv = rnd(P0 q_mask)^T do from them, recomputing
// each row's score, P0 and dP.
template <typename TIn>
__global__ void __launch_bounds__(32 * kRowWarps)
    attention_bwd_rows(const TIn* __restrict__ q, const TIn* __restrict__ k,
                       const TIn* __restrict__ v,
                       const float* __restrict__ qm,
                       const float* __restrict__ km,
                       const TIn* __restrict__ dout, TIn* __restrict__ dq,
                       float* __restrict__ stats, int n_items, int Tq, int Tk,
                       int D, int H, float scale) {
  constexpr bool BF16 = !std::is_same<TIn, float>::value;
  const int lane = threadIdx.x & 31;
  const int item = blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  if (item >= n_items) return;
  const int dh = D / H;
  const RowItem it = row_item(item, Tq, H);
  const size_t row = static_cast<size_t>(it.b) * Tq + it.r;
  const TIn* qr = q + row * D + it.h * dh;
  const TIn* dr = dout + row * D + it.h * dh;
  const TIn* kb = k + static_cast<size_t>(it.b) * Tk * D + it.h * dh;
  const TIn* vb = v + static_cast<size_t>(it.b) * Tk * D + it.h * dh;
  const float* kmb = km + static_cast<size_t>(it.b) * Tk;
  const float qmr = __ldg(qm + row);
  float m, sum;
  row_stats(qr, kb, kmb, Tk, D, dh, scale, m, sum);
  const float inv = 1.f / sum;
  // P0 and dP of this lane's key j
  const auto p0_dp = [&](int j, float& p0, float& dp) {
    const size_t o = static_cast<size_t>(j) * D;
    p0 = expf(row_score(qr, kb + o, dh, __ldg(kmb + j), scale) - m) * inv;
    dp = dot_row(dr, vb + o, dh) * qmr;
  };
  float rs = 0.f;
  for (int j = lane; j < Tk; j += 32) {
    float p0, dp;
    p0_dp(j, p0, dp);
    rs = fmaf(dp, p0, rs);
  }
  rs = warp_sum(rs);
  if (lane == 0) {
    stats[3 * static_cast<size_t>(item)] = m;
    stats[3 * static_cast<size_t>(item) + 1] = inv;
    stats[3 * static_cast<size_t>(item) + 2] = rs;
  }
  TIn* dqr = dq + row * D + it.h * dh;
  for (int c0 = 0; c0 < dh; c0 += 32 * kSlabCols) {
    float o[kSlabCols];
#pragma unroll
    for (int c = 0; c < kSlabCols; ++c) o[c] = 0.f;
    for (int j0 = 0; j0 < Tk; j0 += 32) {
      const int j = j0 + lane;
      float ds = 0.f;
      if (j < Tk) {
        float p0, dp;
        p0_dp(j, p0, dp);
        ds = rnd<BF16>(__ldg(kmb + j) > 0.f ? p0 * (dp - rs) : 0.f);
      }
      const int n = min(32, Tk - j0);
      for (int jj = 0; jj < n; ++jj) {
        const float sj = __shfl_sync(0xffffffffu, ds, jj);
        const TIn* kr = kb + static_cast<size_t>(j0 + jj) * D;
#pragma unroll
        for (int c = 0; c < kSlabCols; ++c) {
          const int col = c0 + lane + 32 * c;
          if (col < dh) o[c] = fmaf(sj, to_float(kr[col]), o[c]);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < kSlabCols; ++c) {
      const int col = c0 + lane + 32 * c;
      if (col < dh) store(dqr + col, o[c] * scale);
    }
  }
}

template <typename TIn>
__global__ void __launch_bounds__(32 * kRowWarps)
    attention_bwd_cols(const TIn* __restrict__ q, const TIn* __restrict__ k,
                       const TIn* __restrict__ v,
                       const float* __restrict__ qm,
                       const float* __restrict__ km,
                       const TIn* __restrict__ dout, TIn* __restrict__ dk,
                       TIn* __restrict__ dv, const float* __restrict__ stats,
                       int n_items, int Tq, int Tk, int D, int H,
                       float scale) {
  constexpr bool BF16 = !std::is_same<TIn, float>::value;
  const int lane = threadIdx.x & 31;
  const int item = blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  if (item >= n_items) return;
  const int dh = D / H;
  const RowItem it = row_item(item, Tk, H);  // it.r: the key
  const size_t key = static_cast<size_t>(it.b) * Tk + it.r;
  const TIn* kr = k + key * D + it.h * dh;
  const TIn* vr = v + key * D + it.h * dh;
  const float kmj = __ldg(km + key);
  const TIn* qb = q + static_cast<size_t>(it.b) * Tq * D + it.h * dh;
  const TIn* db = dout + static_cast<size_t>(it.b) * Tq * D + it.h * dh;
  const float* st = stats + 3 * (static_cast<size_t>(it.b) * H + it.h) * Tq;
  const float* qmb = qm + static_cast<size_t>(it.b) * Tq;
  for (int c0 = 0; c0 < dh; c0 += 32 * kSlabCols) {
    float ok[kSlabCols], ov[kSlabCols];
#pragma unroll
    for (int c = 0; c < kSlabCols; ++c) ok[c] = ov[c] = 0.f;
    for (int r0 = 0; r0 < Tq; r0 += 32) {
      const int r = r0 + lane;
      float P = 0.f, S = 0.f;
      if (r < Tq) {
        const size_t o = static_cast<size_t>(r) * D;
        const float qmr = __ldg(qmb + r);
        const float p0 =
            expf(row_score(qb + o, kr, dh, kmj, scale) - st[3 * r]) *
            st[3 * r + 1];
        const float dp = dot_row(db + o, vr, dh) * qmr;
        P = rnd<BF16>(p0 * qmr);
        S = rnd<BF16>(kmj > 0.f ? p0 * (dp - st[3 * r + 2]) : 0.f);
      }
      const int n = min(32, Tq - r0);
      for (int rr = 0; rr < n; ++rr) {
        const float pr = __shfl_sync(0xffffffffu, P, rr);
        const float sr = __shfl_sync(0xffffffffu, S, rr);
        const size_t o = static_cast<size_t>(r0 + rr) * D;
#pragma unroll
        for (int c = 0; c < kSlabCols; ++c) {
          const int col = c0 + lane + 32 * c;
          if (col < dh) {
            ok[c] = fmaf(sr, to_float(qb[o + col]), ok[c]);
            ov[c] = fmaf(pr, to_float(db[o + col]), ov[c]);
          }
        }
      }
    }
#pragma unroll
    for (int c = 0; c < kSlabCols; ++c) {
      const int col = c0 + lane + 32 * c;
      if (col < dh) {
        store(dk + key * D + it.h * dh + col, ok[c] * scale);
        store(dv + key * D + it.h * dh + col, ov[c]);
      }
    }
  }
}

template <typename TIn>
cudaError_t launch_rows(const void* q, const void* k, const void* v,
                        const void* qm, const void* km, const void* dout,
                        void* dq, void* dk, void* dv, float* stats, int B,
                        int Tq, int Tk, int D, int H, float scale,
                        cudaStream_t stream) {
  const int rows = B * H * Tq;
  const int keys = B * H * Tk;
  constexpr int kT = 32 * kRowWarps;
  const auto* qc = static_cast<const TIn*>(q);
  const auto* kc = static_cast<const TIn*>(k);
  const auto* vc = static_cast<const TIn*>(v);
  const auto* dc = static_cast<const TIn*>(dout);
  const auto* qmc = static_cast<const float*>(qm);
  const auto* kmc = static_cast<const float*>(km);
  attention_bwd_rows<TIn><<<(rows + kRowWarps - 1) / kRowWarps, kT, 0,
                            stream>>>(qc, kc, vc, qmc, kmc, dc,
                                      static_cast<TIn*>(dq), stats, rows, Tq,
                                      Tk, D, H, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_bwd_cols<TIn><<<(keys + kRowWarps - 1) / kRowWarps, kT, 0,
                            stream>>>(qc, kc, vc, qmc, kmc, dc,
                                      static_cast<TIn*>(dk),
                                      static_cast<TIn*>(dv), stats, keys, Tq,
                                      Tk, D, H, scale);
  return cudaGetLastError();
}

template <int DH, int RQ, typename TIn>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* qm, const void* km, const void* dout, void* dq,
                   void* dk, void* dv, int B, int Tq, int Tk, int D, int H,
                   float scale, int vec_io, cudaStream_t stream) {
  const Layout L = layout(Tq, Tk, DH);
  const int unit_bytes = L.size * static_cast<int>(sizeof(float));
  const int n_units = B * H;
  int upb = kSmemTarget / unit_bytes;
  upb = upb < 1 ? 1 : (upb > kMaxUnits ? kMaxUnits : upb);
  upb = upb > n_units ? n_units : upb;
  const size_t bytes = static_cast<size_t>(upb) * unit_bytes;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        attention_bwd_kernel<DH, RQ, TIn>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
  }
  int lshift = 0;
  while ((kKeysPerLane << lshift) < Tk) ++lshift;
  const int blocks = (n_units + upb - 1) / upb;
  attention_bwd_kernel<DH, RQ, TIn><<<blocks, kBwdThreads, bytes, stream>>>(
      static_cast<const TIn*>(q), static_cast<const TIn*>(k),
      static_cast<const TIn*>(v), static_cast<const float*>(qm),
      static_cast<const float*>(km), static_cast<const TIn*>(dout),
      static_cast<TIn*>(dq), static_cast<TIn*>(dk), static_cast<TIn*>(dv),
      n_units, upb, Tq, Tk, D, H, scale, vec_io, lshift);
  return cudaGetLastError();
}

template <typename TIn>
cudaError_t launch_dh(const void* q, const void* k, const void* v,
                      const void* qm, const void* km, const void* dout,
                      void* dq, void* dk, void* dv, float* stats, int B,
                      int Tq, int Tk, int D, int H, float scale,
                      cudaStream_t s) {
  const int dh = D / H;
  if (long_rows(Tq, Tk, dh))
    return launch_rows<TIn>(q, k, v, qm, km, dout, dq, dk, dv, stats, B, Tq,
                            Tk, D, H, scale, s);
  constexpr int kElem = static_cast<int>(sizeof(TIn));
  const auto al = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % (4 * kElem) == 0;
  };
  const bool vec = dh % 4 == 0 && D % 4 == 0 && al(q) && al(k) && al(v) &&
                   al(dout) && al(dq) && al(dk) && al(dv);
  const int vi = vec ? 1 : 0;
#define ATT_BWD_LAUNCH(W)                                             \
  return Tq <= kSmallTq                                              \
             ? launch<W, 1, TIn>(q, k, v, qm, km, dout, dq, dk, dv, B, \
                                 Tq, Tk, D, H, scale, vi, s)          \
             : launch<W, 2, TIn>(q, k, v, qm, km, dout, dq, dk, dv, B, \
                                 Tq, Tk, D, H, scale, vi, s)
  if (dh <= 8) ATT_BWD_LAUNCH(8);
  if (dh <= 16) ATT_BWD_LAUNCH(16);
  if (dh <= 20) ATT_BWD_LAUNCH(20);
  if (dh <= 32) ATT_BWD_LAUNCH(32);
  if (dh <= 40) ATT_BWD_LAUNCH(40);
  if (dh <= 64) ATT_BWD_LAUNCH(64);
#undef ATT_BWD_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Floats of the workspace attention_bwd needs: the row statistics of the
// any-shape kernels (3 a query row and head), 0 for the tiled kernels.
long long attention_bwd_workspace(int B, int Tq, int Tk, int D, int H) {
  if (H < 1 || D % H || !long_rows(Tq, Tk, D / H)) return 0;
  return 3LL * B * H * Tq;
}

// Launches the kernel on `stream` (of the caller's current device); returns
// the CUDA error code of the launch, 0 on success.  Does not synchronise.
// Takes any 1 <= Tq, Tk and D % H == 0; past 64 keys or query rows or a
// head of 64 columns it launches attention_bwd_rows and attention_bwd_cols,
// with `workspace` of attention_bwd_workspace floats.
int attention_bwd(const void* q, const void* k, const void* v,
                  const void* q_mask, const void* k_mask, const void* dout,
                  void* dq, void* dk, void* dv, void* workspace, int B,
                  int Tq, int Tk, int D, int H, float scale, int is_bf16,
                  void* stream) {
  if (B == 0) return 0;
  if (Tq < 1 || Tk < 1 || H < 1 || D % H)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* stats = static_cast<float*>(workspace);
  const cudaError_t err =
      is_bf16 ? launch_dh<__nv_bfloat16>(q, k, v, q_mask, k_mask, dout, dq,
                                         dk, dv, stats, B, Tq, Tk, D, H,
                                         scale, s)
              : launch_dh<float>(q, k, v, q_mask, k_mask, dout, dq, dk, dv,
                                 stats, B, Tq, Tk, D, H, scale, s);
  return static_cast<int>(err);
}

const char* attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
