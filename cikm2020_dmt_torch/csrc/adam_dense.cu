// One Adam step on many dense leaves at once (multi-tensor apply): each
// launch takes up to kMaxLeaves leaves, passed by value as one 4 KB kernel
// parameter block, and writes the new parameter, first and second moment of
// every one of them into fresh outputs:
//
//   m' = (1 - b1) g + b1 m
//   v' = (1 - b2) g^2 + b2 v
//   u  = -lr ((m' / bc1) / (sqrt(v' / bc2) + eps))
//   p' = p + round_p(u)        (in p's type: two roundings for bfloat16)
//
// Replaces no TPU kernel: the JAX package leaves the dense optimizer to
// XLA, which fuses it into the step.  The port's eager PyTorch step ran it
// leaf by leaf, about 15 elementwise launches a leaf (cikm2020_dmt_torch/
// ops/adam.py `adam_dense_ref`), some 2,000 launches a step on the
// flagship's 138 dense leaves, each a few microseconds of host time; this
// kernel does the same work in 3 launches.
//
// Bit for bit the eager path's arithmetic on the card: every operation is
// one round-to-nearest intrinsic in the eager path's order, so nvcc cannot
// contract a multiply and an add into an FMA; the constants are the float32
// values torch gives the Python scalars (the header's c1, b1, c2, b2, eps,
// set by the wrapper); lr, bc1 and bc2 are read through device pointers, so
// the step needs no synchronisation.  m and v are float32 whatever p's type.
//
// Bound: bytes.  Each element reads p, g, m and v and writes p, m and v:
// 28 bytes a float32 element, 22 a bfloat16 one.  The flagship's dense tree
// (3.64 M float32 and 6.82 M bfloat16 elements) moves ~252 MB, ~75 us at
// 3.35 TB/s; there are ~12 flops an element.  Measured on an H100 80GB
// HBM3 at 700 W (chip_smoke.py `adam_phase`): 0.116 ms in 3 launches
// (0.199 ms with the wrapper's copies of 24 strided gradients), where the
// plain step leaf by leaf issues 2,078 launches in 18-27 ms of host time.
//
// Design.  A leaf is cut into tiles of kTile elements, one block each; the
// wrapper numbers the tiles of a launch and gives each leaf its first tile
// (`tile0`, nondecreasing; unused slots INT32_MAX), so a block finds its
// leaf by a binary search over the parameter block.  A thread takes kGroups
// groups of 4 elements, consecutive threads on consecutive groups, loads
// all of them before it computes, and moves a group with one 16-byte access
// a float32 array (8 bytes bfloat16) where the leaf allows it (`kVector`:
// every pointer aligned), else element by element, as for the last group
// of a leaf.  Every operand is contiguous: the wrapper copies a strided
// gradient (a weight's cut from a fused product) first.

#include <cstdint>
#include <cstring>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroups = 2;
constexpr int kTile = kThreads * kGroups * 4;
constexpr int kMaxLeaves = 63;

// kind bits of a leaf
constexpr int kPBf16 = 1;   // p (and p') bfloat16, else float32
constexpr int kGBf16 = 2;   // g bfloat16, else float32
constexpr int kVector = 4;  // 4-element accesses allowed

struct Leaf {         // 64 bytes
  const void* p;
  const void* g;
  const float* m;
  const float* v;
  void* p_out;
  int64_t out;        // the leaf's first element in m_out and v_out
  int64_t n;          // elements
  int32_t tile0;      // the launch's number of the leaf's first tile
  int32_t kind;
};

struct Chunk {        // 4096 bytes: the kernel parameter block
  const float* lr;
  const float* bc1;
  const float* bc2;
  float* m_out;
  float* v_out;
  float c1, b1, c2, b2, eps;
  int32_t pad;
  Leaf leaf[kMaxLeaves];
};

static_assert(sizeof(Leaf) == 64, "Leaf must match ops/adam.py LEAF");
static_assert(sizeof(Chunk) == 4096, "Chunk must match ops/adam.py CHUNK");

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// four consecutive elements at `src` (aligned), as float
__device__ __forceinline__ void load4(const float* src, float* out) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(src));
  out[0] = q.x;
  out[1] = q.y;
  out[2] = q.z;
  out[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* src, float* out) {
  const uint2 q = __ldg(reinterpret_cast<const uint2*>(src));
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&q.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&q.y);
  out[0] = __low2float(a);
  out[1] = __high2float(a);
  out[2] = __low2float(b);
  out[3] = __high2float(b);
}

__device__ __forceinline__ void store4(float* dst, const float* x) {
  *reinterpret_cast<float4*>(dst) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* dst, const float* x) {
  __nv_bfloat162 a, b;
  a.x = __float2bfloat16_rn(x[0]);
  a.y = __float2bfloat16_rn(x[1]);
  b.x = __float2bfloat16_rn(x[2]);
  b.y = __float2bfloat16_rn(x[3]);
  uint2 q;
  q.x = *reinterpret_cast<const uint32_t*>(&a);
  q.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(dst) = q;
}

__device__ __forceinline__ void store1(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* dst, float x) {
  *dst = __float2bfloat16_rn(x);
}

// p + u in p's type: u is rounded to p's type first (optax's
// apply_updates), then the sum in float is rounded to p's type on store
__device__ __forceinline__ float rounded(float u, float) { return u; }
__device__ __forceinline__ float rounded(float u, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(u));
}

struct Step {
  float neg_lr, bc1, bc2, c1, b1, c2, b2, eps;
};

// the new (p, m, v) of one element, in the eager path's order of roundings
template <typename P>
__device__ __forceinline__ void adam(const Step& s, float p, float g, float m,
                                     float v, float& p_new, float& m_new,
                                     float& v_new) {
  m_new = __fadd_rn(__fmul_rn(s.c1, g), __fmul_rn(s.b1, m));
  v_new = __fadd_rn(__fmul_rn(s.c2, __fmul_rn(g, g)), __fmul_rn(s.b2, v));
  const float u = __fmul_rn(
      s.neg_lr,
      __fdiv_rn(__fdiv_rn(m_new, s.bc1),
                __fadd_rn(__fsqrt_rn(__fdiv_rn(v_new, s.bc2)), s.eps)));
  p_new = __fadd_rn(p, rounded(u, P()));
}

template <typename P, typename G>
__device__ __forceinline__ void leaf_tile(const Chunk& c, const Leaf& L,
                                          int64_t base, const Step& s) {
  const P* p = static_cast<const P*>(L.p);
  const G* g = static_cast<const G*>(L.g);
  P* p_out = static_cast<P*>(L.p_out);
  float* m_out = c.m_out + L.out;
  float* v_out = c.v_out + L.out;
  const int64_t n = L.n;
  const bool vec = (L.kind & kVector) != 0;

  float rp[kGroups][4], rg[kGroups][4], rm[kGroups][4], rv[kGroups][4];
  int64_t at[kGroups];
#pragma unroll
  for (int k = 0; k < kGroups; ++k) {
    const int64_t i = base + 4 * (static_cast<int64_t>(k) * kThreads +
                                  threadIdx.x);
    at[k] = i;
    if (i >= n) continue;
    if (vec && i + 4 <= n) {
      load4(p + i, rp[k]);
      load4(g + i, rg[k]);
      load4(L.m + i, rm[k]);
      load4(L.v + i, rv[k]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool in = i + j < n;
        rp[k][j] = in ? to_f(p[i + j]) : 0.f;
        rg[k][j] = in ? to_f(g[i + j]) : 0.f;
        rm[k][j] = in ? L.m[i + j] : 0.f;
        rv[k][j] = in ? L.v[i + j] : 0.f;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kGroups; ++k) {
    const int64_t i = at[k];
    if (i >= n) continue;
    float np[4], nm[4], nv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      adam<P>(s, rp[k][j], rg[k][j], rm[k][j], rv[k][j], np[j], nm[j],
              nv[j]);
    if (vec && i + 4 <= n) {
      store4(p_out + i, np);
      store4(m_out + i, nm);
      store4(v_out + i, nv);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (i + j < n) {
          store1(p_out + i + j, np[j]);
          m_out[i + j] = nm[j];
          v_out[i + j] = nv[j];
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    adam_dense_kernel(const __grid_constant__ Chunk c) {
  const int b = static_cast<int>(blockIdx.x);
  int lo = 0, hi = kMaxLeaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (c.leaf[mid].tile0 <= b)
      lo = mid;
    else
      hi = mid - 1;
  }
  const Leaf& L = c.leaf[lo];
  const int64_t base = static_cast<int64_t>(b - L.tile0) * kTile;
  Step s;
  s.neg_lr = -__ldg(c.lr);
  s.bc1 = __ldg(c.bc1);
  s.bc2 = __ldg(c.bc2);
  s.c1 = c.c1;
  s.b1 = c.b1;
  s.c2 = c.c2;
  s.b2 = c.b2;
  s.eps = c.eps;
  switch (L.kind & (kPBf16 | kGBf16)) {
    case 0:
      leaf_tile<float, float>(c, L, base, s);
      break;
    case kPBf16:
      leaf_tile<__nv_bfloat16, float>(c, L, base, s);
      break;
    case kGBf16:
      leaf_tile<float, __nv_bfloat16>(c, L, base, s);
      break;
    default:
      leaf_tile<__nv_bfloat16, __nv_bfloat16>(c, L, base, s);
      break;
  }
}

}  // namespace

extern "C" {

// `chunk` points at the 4096-byte parameter block on the host (copied into
// the launch, so the caller may reuse it when this returns); `tiles` is the
// number of tiles of its leaves, `tile` the wrapper's tile size (refused
// unless it is kTile).  Launches on `stream`; returns the CUDA error code.
int adam_dense(const void* chunk, int tiles, int tile, void* stream) {
  if (tile != kTile) return static_cast<int>(cudaErrorInvalidValue);
  if (tiles <= 0) return 0;
  Chunk c;
  memcpy(&c, chunk, sizeof(Chunk));
  adam_dense_kernel<<<static_cast<unsigned>(tiles), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(c);
  return static_cast<int>(cudaGetLastError());
}

const char* adam_dense_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
