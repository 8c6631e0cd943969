// Segment sum of id-sorted rows: out[s] = sum of g[order[r]] over the sorted
// positions r with seg[r] == s, accumulated in float32; slots that no
// position names are zero.
//
// Replaces the TPU kernel cikm2020_dmt_tpu/ops/scatter_rows.py
// `_sorted_segsum_kernel` (via `sorted_segment_sum_rows`), the backward of
// the lazy-Adam union gather (`take_rows_sparse_sorted`).  seg is
// nondecreasing and may skip slots (a lazy group's rows that no id names).
// This kernel reads g through `order` directly, which saves the [N, D]
// reorder pass the TPU path makes before its kernel, and writes every slot
// of out itself (the caller allocates it uninitialised).
//
// Bound: bytes.  At the flagship step (N = 227,328 rows of D = 32 bf16,
// int64 order and seg, 113,665 float32 output rows: 28,416 groups of 4 and
// the overflow slot) ~32.7 MB move, ~9.8 us at 3.35 TB/s; there is one add
// per element read.  About nine tenths of the output's slots are named by
// no run (103 K of 113,665 there): they cost only their write.
//
// Measured on an H100 80GB HBM3 at 700 W at that shape
// (scripts/segsum_variants.py): 0.027 ms in bf16, the first launch 0.014
// alone (one random 64-byte row gather a row; twice the bytes in f32 add
// only 0.002), the second 0.010 alone; each of its two parts alone, the
// zeroing and the padding run's sum, adds 0.007-0.008 to the first.
//
// Design.  Half the flagship's rows are one run (the padding id 0), the
// rest are short Zipf runs with a few long ones, and blocks on the card run
// in no order, so the sum is split into two launches, with no atomics and
// an association that depends only on N, D and seg (the same bits from run
// to run):
// 1. `segsum_tiles`: one block of 8 warps per tile of kTile = 256 sorted
//    rows and window of 32 columns.  The block loads the tile's seg and
//    order once, coalesced, into shared memory; then it gathers the tile's
//    rows into shared memory with 16-byte cp.async copies, all issued
//    before the first wait (bf16 D=32: 4 copies a row, 4 a thread; f32: 8),
//    or element by element where a row is not a whole number of 16-byte
//    pieces.  Each warp walks its 32 rows in order, lanes over columns,
//    adding rows from shared memory: a run wholly inside its rows is
//    written to out, the pieces cut by its edges go to shared memory, and
//    warp 0 joins them across the 8 slices in order.  A run wholly inside
//    the tile is written to out; the piece of a run cut by the tile's left
//    edge (or a tile inside one run) goes to head[tile], one cut by its
//    right edge to tail[tile].  The first row r of each run s is recorded
//    as first_row[s] = r.
// 2. `segsum_stitch`: one block per tile.  The block of a tile where a
//    cut run starts counts the tiles the run reaches (256 tiles a round,
//    one load a thread), then sums tail[c] + head[c+1] + ... with its 8
//    warps, each over every 8th piece in order, 8 loads in flight a
//    thread, and a fixed tree over the warps: the padding run's ~440
//    pieces take one block 7 rounds of 8 loads a thread.  Then each block
//    zeroes its share of the slots (a fixed range of ceil(num_out / tiles))
//    that no run names: slot z is named iff first_row[z] holds a row r with
//    seg[r] == z, which no leftover value in the uninitialised scratch can
//    fake, so nothing is cleared beforehand and every slot is written
//    once.  A warp decides 32 slots at once and writes their zeros
//    together, 16 bytes a lane.
//
// SEGSUM_SKIP (default 0) skips work for scripts/segsum_variants.py: bit 1
// the first launch, bit 2 the second; bit 4 the second's zeroing, bit 8 its
// sums of cut runs.

#include <cstdint>

#include <cuda_runtime.h>

#ifndef SEGSUM_SKIP
#define SEGSUM_SKIP 0
#endif

namespace {

constexpr int kTile = 256;   // sorted rows of a block in pass 1
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kSlice = kTile / kWarps;  // rows a warp walks
constexpr int kCols = 32;    // columns of a window (a lane a column)
constexpr int kBatch = 8;    // pieces a thread loads at once in the stitch

// rows are staged as their bits: bf16 as uint16_t, f32 as float
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(uint16_t b) {
  return __uint_as_float(static_cast<unsigned>(b) << 16);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// s_seg[1 + i] is the seg of the tile's row i; s_seg[0] that of the row
// before the tile and s_seg[n + 1] that of the row after it (-1 where
// there is none).  A slice [a, b) of the tile's rows:
struct Slice {
  int64_t first, last;  // runs of its first and last row
  bool lopen, ropen;    // the first run began before a, the last goes on past b
};

__device__ __forceinline__ Slice slice_of(const int64_t* s_seg, int a,
                                          int b) {
  Slice s;
  s.first = s_seg[1 + a];
  s.last = s_seg[b];
  s.lopen = s_seg[a] == s.first;
  s.ropen = s_seg[b + 1] == s.last;
  return s;
}

template <typename S, bool kVec>
__global__ void __launch_bounds__(kThreads)
    segsum_tiles(const S* __restrict__ g, const int64_t* __restrict__ order,
                 const int64_t* __restrict__ seg, int64_t N, int D,
                 float* __restrict__ out, float* __restrict__ head,
                 float* __restrict__ tail, int64_t* __restrict__ first_row) {
  __shared__ __align__(16) S rows[kTile][kCols];
  __shared__ int64_t s_seg[kTile + 2];
  __shared__ int64_t s_ord[kTile];
  __shared__ float pf[kWarps][kCols], pl[kWarps][kCols];

  const int64_t tile = blockIdx.x;
  const int64_t lo = tile * kTile;
  const int n = static_cast<int>(min(static_cast<int64_t>(kTile), N - lo));
  const int c0 = blockIdx.y * kCols;
  const int wc = min(kCols, D - c0);
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const bool on = lane < wc;

  if (t < n) {
    s_seg[1 + t] = seg[lo + t];
    s_ord[t] = order[lo + t];
  }
  if (t == 0) s_seg[0] = lo > 0 ? seg[lo - 1] : -1;
  if (t == kThreads - 1) s_seg[n + 1] = lo + n < N ? seg[lo + n] : -1;
  __syncthreads();

  if constexpr (kVec) {
    constexpr int kPer = 16 / sizeof(S);  // elements of a 16-byte piece
    const int vpr = wc / kPer;            // pieces of a row's window
    for (int k = t; k < n * vpr; k += kThreads) {
      const int r = k / vpr, p = k - r * vpr;
      cp_async16(&rows[r][p * kPer], g + s_ord[r] * D + c0 + p * kPer);
    }
    cp_async_wait_all();
  } else {
#pragma unroll 4
    for (int k = t; k < n * wc; k += kThreads) {
      const int r = k / wc, c = k - r * wc;
      rows[r][c] = g[s_ord[r] * D + c0 + c];
    }
  }
  __syncthreads();

  float* const outc = out + c0 + lane;
  const int a = w * kSlice, b = min(a + kSlice, n);
  if (a < b) {
    const Slice sl = slice_of(s_seg, a, b);
    int64_t run = sl.first;
    float acc = 0.f;
    for (int i = a; i < b; ++i) {
      const int64_t s = s_seg[1 + i];
      if (s != run) {  // the run before row i ended inside the slice
        if (run == sl.first && sl.lopen) {
          pf[w][lane] = acc;
        } else if (on) {
          outc[run * D] = acc;
        }
        run = s;
        acc = 0.f;
      }
      if (lane == 0 && blockIdx.y == 0 && s != s_seg[i]) {
        first_row[s] = lo + i;  // row i starts run s
      }
      if (on) acc += to_float(rows[i][lane]);
    }
    if (run == sl.first && sl.lopen) {
      pf[w][lane] = acc;
    } else if (sl.ropen) {
      pl[w][lane] = acc;
    } else if (on) {
      outc[run * D] = acc;
    }
  }
  __syncthreads();

  // warp 0 joins the runs cut by the slices' edges, slice by slice
  if (w != 0) return;
  const int slices = (n + kSlice - 1) / kSlice;
  int64_t cur = -1;
  float acc = 0.f;
  bool started = false;  // the run being joined began inside the tile
  bool open = false;     // the last slice's last run goes on past the tile
  const int64_t base = tile * D + c0 + lane;
  for (int v = 0; v < slices; ++v) {
    const Slice sl = slice_of(s_seg, v * kSlice, min(v * kSlice + kSlice, n));
    if (sl.lopen) {
      if (v == 0) {
        cur = sl.first;
        acc = pf[0][lane];
        started = false;
      } else {
        acc += pf[v][lane];
      }
      if (sl.first != sl.last || !sl.ropen) {  // the run ends in slice v
        if (on) {
          if (started) {
            outc[cur * D] = acc;
          } else {
            head[base] = acc;
          }
        }
      }
    }
    if (sl.ropen && !(sl.first == sl.last && sl.lopen)) {
      cur = sl.last;  // a run begins in slice v and goes on past it
      acc = pl[v][lane];
      started = true;
    }
    open = sl.ropen;
  }
  if (open && on) {  // the run goes on into the next tile
    if (started) {
      tail[base] = acc;
    } else {
      head[base] = acc;  // the whole tile is inside one run
    }
  }
}

// The sum of the run cut by tile c's right edge, where it began inside
// tile c, written to out (block-uniform: every thread of the block calls
// it, and it returns at once elsewhere).
__device__ __forceinline__ void stitch_run(const int64_t* __restrict__ seg,
                                           int64_t N, int D, int64_t tiles,
                                           int64_t c, float* __restrict__ out,
                                           const float* __restrict__ head,
                                           const float* __restrict__ tail,
                                           float (*part)[kCols]) {
  const int64_t lo = c * kTile, hi = min(lo + kTile, N);
  if (hi >= N || (SEGSUM_SKIP & 8)) return;
  const int64_t run = seg[hi - 1];
  if (seg[hi] != run) return;
  if (lo > 0 && seg[lo - 1] == run) return;
  // the tiles after c that the run reaches: a prefix of c + 1, c + 2, ...
  int64_t count = 0;
  for (int64_t first = c + 1;; first += kThreads) {
    const int64_t j = first + threadIdx.x;
    const int k = __syncthreads_count(j < tiles && seg[j * kTile] == run);
    count += k;
    if (k < kThreads) break;
  }
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  for (int c0 = 0; c0 < D; c0 += kCols) {
    const int col = c0 + lane;
    float s = 0.f;
    if (col < D) {
      // warp w: pieces w, w + 8, ... in order; piece 0 is tail[c], piece
      // m > 0 is head[c + m].  kBatch loads are issued before their adds
      // (a piece past the run adds 0)
      if (w == 0) s = tail[c * D + col];
      for (int64_t m0 = w == 0 ? kWarps : w; m0 <= count;
           m0 += kBatch * kWarps) {
        float v[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int64_t m = m0 + u * kWarps;
          v[u] = m <= count ? head[(c + m) * D + col] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) s += v[u];
      }
    }
    part[w][lane] = s;
    __syncthreads();
    for (int h = kWarps / 2; h > 0; h >>= 1) {
      if (w < h) part[w][lane] += part[w + h][lane];
      __syncthreads();
    }
    if (w == 0 && col < D) out[run * D + col] = part[0][lane];
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
    segsum_stitch(const int64_t* __restrict__ seg, int64_t N, int D,
                  int64_t num_out, int64_t tiles, bool vec,
                  float* __restrict__ out, const float* __restrict__ head,
                  const float* __restrict__ tail,
                  const int64_t* __restrict__ first_row) {
  __shared__ float part[kWarps][kCols];
  const int64_t c = blockIdx.x;
  // first the cut runs: the padding run's block is the longest
  stitch_run(seg, N, D, tiles, c, out, head, tail, part);

  // then the slots no run names, a fixed range of them a block, 32 a warp
  // at a time: slot z is named iff first_row[z] is a row r with seg[r] ==
  // z (pass 1 wrote it), whatever the uninitialised first_row holds
  // elsewhere.  A warp writes the zeros of its 32 slots together, 16 bytes
  // a lane where rows are whole 16-byte pieces (D % 4 == 0)
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int64_t per = (num_out + tiles - 1) / tiles;
  const int64_t z1 = (SEGSUM_SKIP & 4) ? 0 : min((c + 1) * per, num_out);
  const int unit = vec ? 4 : 1;      // floats a lane writes at once
  const int upr = D / unit;          // such units in a row
  for (int64_t zb = c * per + w * 32; zb < z1; zb += kThreads) {
    const int64_t z = zb + lane;
    bool unnamed = false;
    if (z < z1) {
      const int64_t r = first_row[z];
      unnamed = r < 0 || r >= N || seg[r] != z;
    }
    const unsigned m = __ballot_sync(0xffffffffu, unnamed);
    if (m == 0) continue;
    for (int k = lane; k < 32 * upr; k += 32) {
      const int slot = k / upr;
      if (!((m >> slot) & 1u)) continue;
      float* dst = out + (zb + slot) * D + (k - slot * upr) * unit;
      if (vec) {
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
        *dst = 0.f;
      }
    }
  }
}

template <typename S>
void launch_tiles(const void* g, bool vec, const int64_t* o,
                  const int64_t* sg, int64_t N, int D, float* out, float* h,
                  float* t, int64_t* first_row, dim3 grid, cudaStream_t s) {
  const auto* gs = static_cast<const S*>(g);
  if (vec) {
    segsum_tiles<S, true><<<grid, kThreads, 0, s>>>(gs, o, sg, N, D, out, h,
                                                    t, first_row);
  } else {
    segsum_tiles<S, false><<<grid, kThreads, 0, s>>>(gs, o, sg, N, D, out,
                                                     h, t, first_row);
  }
}

}  // namespace

extern "C" {

// g [N, D] float32 (is_bf16 0) or bfloat16 (1); order, seg int64 [N], seg
// nondecreasing with every value in [0, num_out); out float32 [num_out, D],
// uninitialised (every slot is written); scratch int64 [scratch_words],
// uninitialised: the float32 pieces [2, ceil(N / tile), D] (head, then
// tail), then first_row [num_out].  N >= 1.  Launches both passes on
// `stream`; returns the CUDA error code (cudaErrorInvalidValue, and no
// launch, when tile is not this kernel's or the scratch is short).
int sorted_segsum(const void* g, int is_bf16, const void* order,
                  const void* seg, int64_t N, int D, int64_t num_out,
                  void* out, int tile, void* scratch, int64_t scratch_words,
                  void* stream) {
  const int64_t tiles = (N + kTile - 1) / kTile;
  if (tile != kTile || N < 1 || num_out < 1 ||
      scratch_words < tiles * D + num_out) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(tiles),
                  static_cast<unsigned>((D + kCols - 1) / kCols));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* o = static_cast<const int64_t*>(order);
  const auto* sg = static_cast<const int64_t*>(seg);
  auto* out_f = static_cast<float*>(out);
  auto* h = static_cast<float*>(scratch);
  auto* t = h + tiles * D;
  auto* first_row = static_cast<int64_t*>(scratch) + tiles * D;
  const int elem = is_bf16 ? 2 : 4;
  // 16-byte copies where every row and window starts on 16 bytes
  const bool vec = (static_cast<int64_t>(D) * elem) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(g) % 16 == 0;
  if (!(SEGSUM_SKIP & 1)) {
    if (is_bf16) {
      launch_tiles<uint16_t>(g, vec, o, sg, N, D, out_f, h, t, first_row,
                             grid, s);
    } else {
      launch_tiles<float>(g, vec, o, sg, N, D, out_f, h, t, first_row, grid,
                          s);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (!(SEGSUM_SKIP & 2)) {
    // 16-byte zero stores where every output row starts on 16 bytes
    const bool vec_out = D % 4 == 0 &&
                         reinterpret_cast<uintptr_t>(out) % 16 == 0;
    segsum_stitch<<<static_cast<unsigned>(tiles), kThreads, 0, s>>>(
        sg, N, D, num_out, tiles, vec_out, out_f, h, t, first_row);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* sorted_segsum_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
