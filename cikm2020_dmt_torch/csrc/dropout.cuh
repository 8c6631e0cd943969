// Dropout masks of the fused block kernels: a counter-based hash of
// (seed, site, example, row, column), bit for bit the masks of
// cikm2020_dmt_torch/ops/block.py `dropout_mask`:
//
//   key  = lowbias32(seed + site * 0x9E3779B9)
//   bits = lowbias32(lowbias32(key ^ example) ^ (row << 16 | column))
//   kept when (bits >> 8) < keep_thr, and then scaled by 1 / (1 - rate).
//
// Sites follow the TPU kernel (ops/block.py SITE_*): the encoder and
// decoder inputs, and the probabilities of head h at site * 16 + h.
#pragma once

namespace {

constexpr unsigned kSiteEncIn = 0;
constexpr unsigned kSiteEncProbs = 1;
constexpr unsigned kSiteDecIn = 2;
constexpr unsigned kSiteDecProbs = 3;

__host__ __device__ __forceinline__ unsigned lowbias32(unsigned x) {
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x846ca68bu;
  x ^= x >> 16;
  return x;
}

struct Dropout {
  const int* seed_ptr;  // one int32 on the device; null outside training
  int on;
  unsigned keep_thr;
  float scale;
  unsigned seed;

  // every thread reads the seed once, before the first mask
  __device__ __forceinline__ void load_seed() {
    seed = static_cast<unsigned>(__ldg(seed_ptr));
  }
  // per (site, example) part of the hash
  __device__ __forceinline__ unsigned example(unsigned site,
                                              unsigned b) const {
    return lowbias32(lowbias32(seed + site * 0x9e3779b9u) ^ b);
  }
  // the scaled mask value of (row, col) under example hash `ex`; 1 when
  // dropout is off
  __device__ __forceinline__ float scale_at(unsigned ex, unsigned row,
                                            unsigned col) const {
    if (!on) return 1.f;
    const unsigned bits = lowbias32(ex ^ ((row << 16) | col));
    return (bits >> 8) < keep_thr ? scale : 0.f;
  }
};

inline Dropout make_dropout(const void* seed, int train, int keep_thr,
                            float scale) {
  Dropout d;
  d.seed_ptr = static_cast<const int*>(seed);
  d.on = train && seed != nullptr;
  d.keep_thr = static_cast<unsigned>(keep_thr);
  d.scale = scale;
  d.seed = 0;
  return d;
}

}  // namespace
