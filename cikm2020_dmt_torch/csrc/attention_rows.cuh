// Attention at any shape (attention_fwd.cu, attention_bwd.cu): the kernels'
// register tilings hold at most 64 keys or query rows of a unit and heads
// of at most 64 columns; past either, the wrappers' launchers take these
// kernels instead.  One warp a row: its lanes take the keys (or, in the
// backward's column pass, the query rows) 32 at a time, and the output's
// columns 32 x kSlabCols at a time (a head wider than that is done in
// slabs, recomputing the scores for each).  The softmax keeps a running
// max and sum per row over the key chunks (row_stats); the probabilities
// are then formed from the final max and sum, so they are rounded where
// the other kernels round them.  Each output element is summed by one lane
// in a fixed order, so two launches give the same bits.  Bound: the same
// work as the tiled kernels; these read q, k and v through the L1 cache
// and recompute the scores once a pass, several times slower, and run
// only at shapes the main paths do not use.
#pragma once

#include <cfloat>
#include <cstdint>

#include <cuda_runtime.h>

#include "block_common.cuh"

namespace {

constexpr int kRowWarps = 4;   // rows (warps) a block
constexpr int kSlabCols = 4;   // output columns a lane, per slab
constexpr int kTileT = 64;     // longest Tq, Tk of the tiled kernels
constexpr int kTileDh = 64;    // widest head of the tiled kernels

__host__ __device__ inline bool long_rows(int Tq, int Tk, int dh) {
  return Tq > kTileT || Tk > kTileT || dh > kTileDh;
}

template <typename TIn>
__device__ __forceinline__ float dot_row(const TIn* a, const TIn* b, int n) {
  float s0 = 0.f, s1 = 0.f;
  int d = 0;
  for (; d + 1 < n; d += 2) {
    s0 = fmaf(to_float(a[d]), to_float(b[d]), s0);
    s1 = fmaf(to_float(a[d + 1]), to_float(b[d + 1]), s1);
  }
  if (d < n) s0 = fmaf(to_float(a[d]), to_float(b[d]), s0);
  return s0 + s1;
}

// The masked, scaled score of a query row against a key row.
template <typename TIn>
__device__ __forceinline__ float row_score(const TIn* qr, const TIn* kr,
                                           int dh, float kmj, float scale) {
  return kmj > 0.f ? dot_row(qr, kr, dh) * scale : kNegInf;
}

// The row's max and sum of exp(score - max) over its Tk keys, one warp,
// keys lane, lane + 32, ...; every lane ends with both.
template <typename TIn>
__device__ void row_stats(const TIn* qr, const TIn* kb, const float* kmb,
                          int Tk, int D, int dh, float scale, float& m,
                          float& sum) {
  const int lane = threadIdx.x & 31;
  m = -FLT_MAX;
  sum = 0.f;
  for (int j0 = 0; j0 < Tk; j0 += 32) {
    const int j = j0 + lane;
    const float s =
        j < Tk ? row_score(qr, kb + static_cast<size_t>(j) * D, dh,
                           __ldg(kmb + j), scale)
               : -FLT_MAX;
    const float mn = fmaxf(m, warp_max(s));
    const float e = j < Tk ? expf(s - mn) : 0.f;
    sum = sum * expf(m - mn) + warp_sum(e);
    m = mn;
  }
}

// The (b, h, row) of warp item `item` over rows of `n` per head.
struct RowItem {
  int b, h, r;
};
__device__ __forceinline__ RowItem row_item(int item, int n, int H) {
  const int bh = item / n;
  return RowItem{bh / H, bh - (bh / H) * H, item - bh * n};
}

}  // namespace
