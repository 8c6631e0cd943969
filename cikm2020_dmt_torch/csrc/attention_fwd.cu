// Masked multi-head attention forward.
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
// us at 3.35 TB/s); the FLOPs alone would take ~24 us on the float32 FMA
// units, so tensor cores are not needed.  What held the first design back
// (one block per example and head, a warp walking query rows one at a
// time, 20 of 32 lanes busy in P v) was latency and idle lanes.
//
// Design.  The unit of work is one (example, head); a query row of a unit
// is an item.  An item belongs to a group of L neighbouring lanes (L a
// power of two): lane c of the group holds the scores of keys c, c + L,
// c + 2L, ... in registers (at most KS of them), forms each from its copy
// of the query row as four independent float4 sums (a dot product of dh
// terms is a chain of dh / 4 FMAs), takes the row's max and sum by
// shuffles over the group, scales by one reciprocal a row, rounds each
// probability, and accumulates P v over its keys for every column of the
// head (dh / 4 float4 accumulators); a butterfly over the group sums the
// partial rows, and the group's lanes store the row's float4s between
// them.  So every lane has independent work, no lane sits idle in P v,
// and no sum runs over more than KS keys in one lane.  A block takes as
// many units as give each of its groups an item, whole examples once it
// takes more than one, and the last block fewer: any B.
//
// The instantiation is picked from Tq:
// - Tq > 4 (the encoder's self-attention, each key row read by every query
//   row): a block stages its units in shared memory first, 16-byte loads,
//   several in flight a thread, and the key mask once an example.  KS =
//   16 keys a lane, L = 1, 2 or 4 for Tk <= 16, 32, 64.  Rows of a unit
//   sit at a stride whose quarter is odd, so the lanes of a group reading
//   L consecutive keys, and groups reading consecutive query rows, hit
//   distinct banks.  Registers are capped (six blocks an SM) at head
//   widths up to 20: at (50, 50) a block holds one unit (12 KB), and
//   latency is hidden by the blocks an SM holds.
// - Tq <= 4 (the decoder's single query): each key row is read by one
//   group only, so the groups read q, k and v straight from device memory
//   (16-byte loads, no shared memory, no barrier); KS = 8, L up to 8.
//
// On an H100 the IEEE division of every probability by its row's sum was
// the largest removable cost at (50, 50), hence one reciprocal a row; two
// query rows an item sharing each key load, and reading k and v straight
// from memory at Tq > 4, were each slower (PERF.md).
//
// Past 64 keys or query rows, or a head wider than 64 columns, the
// launcher takes attention_fwd_rows instead (attention_rows.cuh: one warp a
// query row, a running max and sum over the keys, then P v in column
// slabs).
//
// Each output element is summed by one group in a fixed order, so two
// launches give the same bits.

#include <cfloat>
#include <type_traits>

#include <cuda_runtime.h>

#include "attention_rows.cuh"
#include "block_common.cuh"
#include "tiles.cuh"

namespace {

constexpr int kFwdThreads = 128;
constexpr int kSmallTq = 4;       // Tq at or below: read straight from memory
constexpr int kKeysWide = 16;     // key slots a lane, staged instantiation
constexpr int kKeysNarrow = 8;    // key slots a lane, direct instantiation
// staged blocks an SM at head widths up to 20 (caps registers at 85)
constexpr int kMinBlocksWide = 6;
constexpr int kSmemMax = 96 * 1024;
constexpr int kLoadBatch = 8;

// A row width (a multiple of 4 floats) padded to an odd number of float4s.
__host__ __device__ constexpr int pad_ld(int w) {
  return (w / 4) % 2 ? w : w + 4;
}
__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }

// floats of one staged unit: q [Tq], k [Tk], v [Tk] rows of stride LD
__host__ __device__ inline int unit_floats(int Tq, int Tk, int LD) {
  return (Tq + 2 * Tk) * LD;
}

template <int DH, int KS, bool STAGE, typename TIn>
__global__ void __launch_bounds__(kFwdThreads,
                                  STAGE && DH <= 20 ? kMinBlocksWide : 1)
    attention_fwd_kernel(const TIn* __restrict__ q, const TIn* __restrict__ k,
                         const TIn* __restrict__ v,
                         const float* __restrict__ qm,
                         const float* __restrict__ km,
                         TIn* __restrict__ out, int n_units, int upb, int Tq,
                         int Tk, int D, int H, float scale, int vec_io,
                         int lshift) {
  constexpr bool BF16 = !std::is_same<TIn, float>::value;
  constexpr int C = DH / 4;        // float4s of a head's row
  constexpr int LD = pad_ld(DH);   // staged row stride
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int t = threadIdx.x;
  const int dh = D / H;
  const bool vec = vec_io != 0;
  const int unit0 = blockIdx.x * upb;
  const int units = min(upb, n_units - unit0);
  const int usize = unit_floats(Tq, Tk, LD);
  const int Tk4 = round4(Tk);
  const int ex0 = unit0 / H;
  float* kms = smem + upb * usize;  // [examples of the block][Tk4]

  if constexpr (STAGE) {
    const int rows = Tq + 2 * Tk;
    const int per_unit = rows * C;
    const int n_load = units * per_unit;
    for (int i0 = t; i0 < n_load; i0 += kLoadBatch * kFwdThreads) {
      float4 x[kLoadBatch];
      float* dst[kLoadBatch];
#pragma unroll
      for (int e = 0; e < kLoadBatch; ++e) {
        const int i = i0 + e * kFwdThreads;
        dst[e] = nullptr;
        if (i >= n_load) continue;
        const int u = i / per_unit;
        const int w = i - u * per_unit;
        const int r = w / C;
        const int cc = w - r * C;
        const int unit = unit0 + u;
        const int b = unit / H;
        const int col = (unit - b * H) * dh + 4 * cc;
        const TIn* src =
            r < Tq ? q + (static_cast<size_t>(b) * Tq + r) * D
            : r < Tq + Tk
                ? k + (static_cast<size_t>(b) * Tk + r - Tq) * D
                : v + (static_cast<size_t>(b) * Tk + r - Tq - Tk) * D;
        dst[e] = smem + u * usize + r * LD + 4 * cc;
        x[e] = load_cols(src + col, 4 * cc, dh, vec);
      }
#pragma unroll
      for (int e = 0; e < kLoadBatch; ++e)
        if (dst[e]) sts4(dst[e], x[e]);
    }
    const int n_ex = (unit0 + units - 1) / H - ex0 + 1;
    for (int i = t; i < n_ex * Tk4; i += kFwdThreads) {
      const int e = i / Tk4;
      const int j = i - e * Tk4;
      kms[i] = j < Tk ? __ldg(km + static_cast<size_t>(ex0 + e) * Tk + j)
                      : 0.f;
    }
    __syncthreads();
  }

  const int L = 1 << lshift;
  const int c = t & (L - 1);
  const int g = t >> lshift;
  const int groups = kFwdThreads >> lshift;
  const int warp_g0 = (t & ~31) >> lshift;  // the warp's first group
  const int n_items = units * Tq;
  // a warp runs a round if one of its groups has an item: the shuffles
  // below run on every lane of the warp
  for (int base = 0; base + warp_g0 < n_items; base += groups) {
    const int it = base + g;
    const bool active = it < n_items;
    const int itc = active ? it : n_items - 1;
    const int u = itc / Tq;
    const int r = itc - u * Tq;
    const int unit = unit0 + u;
    const int b = unit / H;
    const int hcol = (unit - b * H) * dh;
    const float* U = smem + u * usize;
    const float* kmu = kms + (b - ex0) * Tk4;
    const TIn* kg = k + static_cast<size_t>(b) * Tk * D + hcol;
    const TIn* vg = v + static_cast<size_t>(b) * Tk * D + hcol;

    float4 qx[C];
#pragma unroll
    for (int cc = 0; cc < C; ++cc)
      qx[cc] = STAGE ? lds4(U + r * LD + 4 * cc)
                     : load_cols(q + (static_cast<size_t>(b) * Tq + r) * D +
                                     hcol + 4 * cc,
                                 4 * cc, dh, vec);
    float s[KS];
    float m = -FLT_MAX;
#pragma unroll
    for (int i = 0; i < KS; ++i) {
      const int j = c + (i << lshift);
      s[i] = -FLT_MAX;
      if (j < Tk) {
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int cc = 0; cc < C; ++cc)
          dot4x(qx[cc],
                STAGE ? lds4(U + (Tq + j) * LD + 4 * cc)
                      : load_cols(kg + static_cast<size_t>(j) * D + 4 * cc,
                                  4 * cc, dh, vec),
                acc);
        const float kmj =
            STAGE ? kmu[j] : __ldg(km + static_cast<size_t>(b) * Tk + j);
        s[i] = kmj > 0.f ? sum4(acc) * scale : kNegInf;
        m = fmaxf(m, s[i]);
      }
    }
    m = group_max(m, L);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < KS; ++i) {
      s[i] = c + (i << lshift) < Tk ? expf(s[i] - m) : 0.f;
      sum += s[i];
    }
    // one division a row: the probabilities are e / sum as e * (1 / sum)
    const float scl =
        __ldg(qm + static_cast<size_t>(b) * Tq + r) / group_sum(sum, L);
    float4 o[C];
#pragma unroll
    for (int cc = 0; cc < C; ++cc) o[cc] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int i = 0; i < KS; ++i) {
      const int j = c + (i << lshift);
      if (j < Tk) {
        const float p = rnd<BF16>(s[i] * scl);
#pragma unroll
        for (int cc = 0; cc < C; ++cc)
          fma4(o[cc], p,
               STAGE ? lds4(U + (Tq + Tk + j) * LD + 4 * cc)
                     : load_cols(vg + static_cast<size_t>(j) * D + 4 * cc,
                                 4 * cc, dh, vec));
      }
    }
    group_sum4(o, L);
    if (active) {
      TIn* orow = out + (static_cast<size_t>(b) * Tq + r) * D + hcol;
#pragma unroll
      for (int cc = 0; cc < C; ++cc)
        if ((cc & (L - 1)) == c) store_cols(orow + 4 * cc, o[cc], 4 * cc, dh,
                                            vec);
    }
  }
}

// Any shape (attention_rows.cuh): one warp a query row; a second pass over
// the keys forms each probability from the row's max and sum, rounds it,
// and adds P v into kSlabCols columns a lane.
template <typename TIn>
__global__ void __launch_bounds__(32 * kRowWarps)
    attention_fwd_rows(const TIn* __restrict__ q, const TIn* __restrict__ k,
                       const TIn* __restrict__ v,
                       const float* __restrict__ qm,
                       const float* __restrict__ km, TIn* __restrict__ out,
                       int n_items, int Tq, int Tk, int D, int H,
                       float scale) {
  constexpr bool BF16 = !std::is_same<TIn, float>::value;
  const int lane = threadIdx.x & 31;
  const int item = blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  if (item >= n_items) return;
  const int dh = D / H;
  const RowItem it = row_item(item, Tq, H);
  const size_t row = static_cast<size_t>(it.b) * Tq + it.r;
  const TIn* qr = q + row * D + it.h * dh;
  const TIn* kb = k + static_cast<size_t>(it.b) * Tk * D + it.h * dh;
  const TIn* vb = v + static_cast<size_t>(it.b) * Tk * D + it.h * dh;
  const float* kmb = km + static_cast<size_t>(it.b) * Tk;
  float m, sum;
  row_stats(qr, kb, kmb, Tk, D, dh, scale, m, sum);
  // one division a row, as the tiled kernel: e * (q_mask / sum)
  const float scl = __ldg(qm + row) / sum;
  TIn* orow = out + row * D + it.h * dh;
  for (int c0 = 0; c0 < dh; c0 += 32 * kSlabCols) {
    float o[kSlabCols];
#pragma unroll
    for (int c = 0; c < kSlabCols; ++c) o[c] = 0.f;
    for (int j0 = 0; j0 < Tk; j0 += 32) {
      const int j = j0 + lane;
      const float p =
          j < Tk ? rnd<BF16>(expf(row_score(qr, kb + static_cast<size_t>(j) *
                                                         D,
                                            dh, __ldg(kmb + j), scale) -
                                  m) *
                             scl)
                 : 0.f;
      const int n = min(32, Tk - j0);
      for (int jj = 0; jj < n; ++jj) {
        const float pj = __shfl_sync(0xffffffffu, p, jj);
        const TIn* vr = vb + static_cast<size_t>(j0 + jj) * D;
#pragma unroll
        for (int c = 0; c < kSlabCols; ++c) {
          const int col = c0 + lane + 32 * c;
          if (col < dh) o[c] = fmaf(pj, to_float(vr[col]), o[c]);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < kSlabCols; ++c) {
      const int col = c0 + lane + 32 * c;
      if (col < dh) store(orow + col, o[c]);
    }
  }
}

template <typename TIn>
cudaError_t launch_rows(const void* q, const void* k, const void* v,
                        const void* qm, const void* km, void* out, int B,
                        int Tq, int Tk, int D, int H, float scale,
                        cudaStream_t stream) {
  const int n_items = B * H * Tq;
  attention_fwd_rows<TIn>
      <<<(n_items + kRowWarps - 1) / kRowWarps, 32 * kRowWarps, 0, stream>>>(
          static_cast<const TIn*>(q), static_cast<const TIn*>(k),
          static_cast<const TIn*>(v), static_cast<const float*>(qm),
          static_cast<const float*>(km), static_cast<TIn*>(out), n_items, Tq,
          Tk, D, H, scale);
  return cudaGetLastError();
}

template <int DH, bool WIDE, typename TIn>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* qm, const void* km, void* out, int B, int Tq,
                   int Tk, int D, int H, float scale, int vec_io,
                   cudaStream_t stream) {
  constexpr int KS = WIDE ? kKeysWide : kKeysNarrow;
  constexpr int LD = pad_ld(DH);
  int lshift = 0;
  while ((KS << lshift) < Tk) ++lshift;
  const int groups = kFwdThreads >> lshift;
  const int n_units = B * H;
  // units that give every group an item; past one example, whole examples,
  // so that a block reads whole rows
  int upb = (groups + Tq - 1) / Tq;
  if (upb > H) upb = (upb + H - 1) / H * H;
  size_t bytes = 0;
  if constexpr (WIDE) {
    const size_t usize =
        static_cast<size_t>(unit_floats(Tq, Tk, LD)) * sizeof(float);
    const size_t mbytes = static_cast<size_t>(round4(Tk)) * sizeof(float);
    const int fit = static_cast<int>((kSmemMax - 2 * mbytes) / usize);
    upb = upb > fit ? (fit < 1 ? 1 : fit) : upb;
    upb = upb > n_units ? n_units : upb;
    bytes = upb * usize + (upb / H + 2) * mbytes;
    if (bytes > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          attention_fwd_kernel<DH, KS, true, TIn>,
          cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(bytes));
      if (err != cudaSuccess) return err;
    }
  } else {
    upb = upb > n_units ? n_units : upb;
  }
  const int blocks = (n_units + upb - 1) / upb;
  attention_fwd_kernel<DH, KS, WIDE, TIn>
      <<<blocks, kFwdThreads, bytes, stream>>>(
          static_cast<const TIn*>(q), static_cast<const TIn*>(k),
          static_cast<const TIn*>(v), static_cast<const float*>(qm),
          static_cast<const float*>(km), static_cast<TIn*>(out), n_units,
          upb, Tq, Tk, D, H, scale, vec_io, lshift);
  return cudaGetLastError();
}

template <typename TIn>
cudaError_t launch_dh(const void* q, const void* k, const void* v,
                      const void* qm, const void* km, void* out, int B,
                      int Tq, int Tk, int D, int H, float scale,
                      cudaStream_t s) {
  const int dh = D / H;
  if (long_rows(Tq, Tk, dh))
    return launch_rows<TIn>(q, k, v, qm, km, out, B, Tq, Tk, D, H, scale, s);
  constexpr int kElem = static_cast<int>(sizeof(TIn));
  const auto al = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % (4 * kElem) == 0;
  };
  const int vi = dh % 4 == 0 && D % 4 == 0 && al(q) && al(k) && al(v) &&
                 al(out);
#define ATT_FWD_LAUNCH(W)                                                 \
  return Tq > kSmallTq                                                   \
             ? launch<W, true, TIn>(q, k, v, qm, km, out, B, Tq, Tk, D, H, \
                                    scale, vi, s)                         \
             : launch<W, false, TIn>(q, k, v, qm, km, out, B, Tq, Tk, D, \
                                     H, scale, vi, s)
  if (dh <= 8) ATT_FWD_LAUNCH(8);
  if (dh <= 16) ATT_FWD_LAUNCH(16);
  if (dh <= 20) ATT_FWD_LAUNCH(20);
  if (dh <= 32) ATT_FWD_LAUNCH(32);
  if (dh <= 40) ATT_FWD_LAUNCH(40);
  if (dh <= 64) ATT_FWD_LAUNCH(64);
#undef ATT_FWD_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` (of the caller's current device); returns
// the CUDA error code of the launch, 0 on success.  Does not synchronise.
// Takes any 1 <= Tq, Tk and D % H == 0; past 64 keys or query rows or a
// head of 64 columns it launches attention_fwd_rows.
int attention_fwd(const void* q, const void* k, const void* v,
                  const void* q_mask, const void* k_mask, void* out, int B,
                  int Tq, int Tk, int D, int H, float scale, int is_bf16,
                  void* stream) {
  if (B == 0) return 0;
  if (Tq < 1 || Tk < 1 || H < 1 || D % H)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_dh<__nv_bfloat16>(q, k, v, q_mask, k_mask, out, B, Tq,
                                         Tk, D, H, scale, s)
              : launch_dh<float>(q, k, v, q_mask, k_mask, out, B, Tq, Tk, D,
                                 H, scale, s);
  return static_cast<int>(err);
}

const char* attention_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
