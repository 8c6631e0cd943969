// Fused Deep-Interest-Transformer block forward.
//
// Replaces the TPU kernel cikm2020_dmt_tpu/ops/block.py `_make_fwd_kernel`
// (launched through `_fwd_call`, entry `fused_encode_decode`).  For each
// example b:
//
//   encoder:  E0 = enc[b] [T, D] * dropout mask (training)
//             QKV = E0 @ wqkv + bqkv
//             per head h: P = softmax(mask_k(Q_h K_h^T * scale)) * mask_q
//                            * dropout mask (training)
//             h1 = LN1(P V + E0);  f = relu(h1 @ w1 + b1)
//             H2 = LN2(f @ w2 + b2 + h1)
//   decoder:  the single query D0 = dec[b] [D] (dropped out in training)
//             runs the same steps against H2 (keys masked, no query mask,
//             probabilities dropped out in training) -> out[b] [D]
//
// Dropout masks come from the hash in dropout.cuh, bit for bit the masks of
// ops/block.py `dropout_mask`; the seed is read from device memory.
//
// Masked keys score -2^32+1, not -inf, so a sequence with every key masked
// gets a uniform softmax over its T keys instead of NaN.  The sequence is
// not padded (the TPU wrapper pads T to a multiple of 8, which makes that
// uniform softmax run over the padded length; the jnp path and this kernel
// use the real T).
//
// Types: enc/dec/out are float32 or bfloat16.  With bfloat16 every operand
// of every product is rounded to bfloat16 first (the TPU kernel's compute
// dtype); sums, softmax and layer norm run in float32.  Weights arrive in
// float32 in the packed layout of ops/block.py `pack_weights`: wqkv [D,3D],
// vecs [8,D] (bq bk bv ln1g ln1b ln2g ln2b b2), w1 [D,F], b1 [F], w2 [F,D].
//
// Bound: at the serving shape (T=50, D=80, F=320, 4 heads) one example is
// ~9.2 MFLOP against ~17 KB of input, so the block is bound by arithmetic
// (~42 us for 300 examples at the 67 TFLOP/s float32 FMA peak), not by
// memory.
//
// Design: the forward is the backward's replay (block_fwd_tiles.cuh
// `replay`), so the two compute the same bits, and the backward's ReLU
// branches are those of the forward that ran.  Two kernels in one call:
// pack_kernel puts wqkv, w1, w2 and the decoder's K/V columns into mma
// fragment order (split into TF32 hi and lo, or rounded to bfloat16) in
// the caller's workspace; fused_block_fwd_kernel takes one example at a
// time a block, a persistent grid of as many blocks as fit on the SMs,
// 512 threads above T = 32 and 256 at or below, every activation of the
// example in shared memory (or, wherever the backward's would not fit in
// what a block can opt into, in its slice of the workspace: the two
// kernels spill at the same T, so they run one instantiation of the
// replay).  The products of T rows with a weight run on
// the tensor cores (mma.sync m16n8k8, 3xTF32 for float32 and one TF32
// pass for bfloat16 operands, which TF32 holds exactly); attention on the
// FMA units, a query row to a group of lanes holding its keys in
// registers; the decoder's one-row products split K over all threads and
// add the slices in a fixed order.  It writes out [B, D] and, when asked,
// the FF pre-activations (for the check that the backward's replay
// reproduces them) and, in the save mode of the TPU kernel
// (DMT_BLOCK_SAVE), the encoder's Q, K, V in the input type and its
// attention context in float32, [B, T, D] each, which the backward then
// reads instead of forming them again: 3 x 2 or 4 bytes and 4 bytes more
// written a position and column (131 MB in float32 at B=2048, T=50).

#include <type_traits>

#include <cuda_runtime.h>

#include "block_fwd_tiles.cuh"

namespace {

template <int MGW, int NT, bool SPILL, typename TIn>
__global__ void __launch_bounds__(NT, NT == 256 ? 2 : 1)
    fused_block_fwd_kernel(const TIn* __restrict__ enc,
                           const TIn* __restrict__ dec,
                           const float* __restrict__ mask, Weights ew,
                           Weights dw, Packs pk, TIn* __restrict__ out,
                           float* spill, Probe probe, Saved sv, int B, int T,
                           float scale, Dropout drop) {
  constexpr bool BF16 = !std::is_same<TIn, float>::value;
  constexpr int NW = NT / 32;
  extern __shared__ float4 smem4[];
  float* base = reinterpret_cast<float*>(smem4);
  if constexpr (SPILL)
    base = spill + blockIdx.x * act_floats(T, NT, false);
  const Act a = act_layout(base, T, NT, false);
  if (drop.on) drop.load_seed();
  const Keep none{nullptr, nullptr, nullptr, nullptr};

  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    load_example<BF16, NT>(a, enc, dec, mask, T, b, drop, nullptr, nullptr);
    __syncthreads();
    replay<MGW, BF16, NW, NT, SPILL>(a, T, pk, ew, dw, scale, drop, b, none,
                                     probe, sv, a.gd);
    for (int j = threadIdx.x; j < kDp; j += NT) {
      const int rj = dmap(j);
      if (real<kMapD>(rj)) store(out + static_cast<size_t>(b) * kD + rj, a.gd[j]);
    }
    __syncthreads();
  }
}

template <int MGW, int NT, bool SPILL, typename TIn>
cudaError_t launch_main(const TIn* enc, const TIn* dec, const float* mask,
                        Weights ew, Weights dw, Packs pk, TIn* out,
                        float* spill, Probe probe, Saved sv, int B, int T,
                        float scale, Dropout drop, int sms,
                        cudaStream_t stream) {
  auto kernel = fused_block_fwd_kernel<MGW, NT, SPILL, TIn>;
  size_t bytes = 0;
  int blocks = spill_blocks(B, sms);
  if constexpr (!SPILL) {
    bytes = act_floats(T, NT, false) * sizeof(float);
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
  kernel<<<blocks, NT, bytes, stream>>>(enc, dec, mask, ew, dw, pk, out,
                                        spill, probe, sv, B, T, scale, drop);
  return cudaGetLastError();
}

// The threads and row tiles of the backward's per-example kernel at this T
// (fused_block_bwd.cu launch_rows): the one-row products then split their
// sums the same way.
template <bool SPILL, typename TIn>
cudaError_t launch_rows(const TIn* e, const TIn* d, const float* mk,
                        Weights ew, Weights dw, Packs pk, TIn* o,
                        float* spill, Probe probe, Saved sv, int B, int T,
                        float scale, Dropout drop, int sms, cudaStream_t s) {
  if (T > 32)
    return launch_main<2, 512, SPILL>(e, d, mk, ew, dw, pk, o, spill, probe,
                                      sv, B, T, scale, drop, sms, s);
  if (T > 16 || SPILL)
    return launch_main<2, 256, SPILL>(e, d, mk, ew, dw, pk, o, spill, probe,
                                      sv, B, T, scale, drop, sms, s);
  return launch_main<1, 256, SPILL>(e, d, mk, ew, dw, pk, o, spill, probe,
                                    sv, B, T, scale, drop, sms, s);
}

// Workspace (floats): the forward's weight fragments, then, when the
// activations spill, one slice per block.
struct Plan {
  size_t spill, total;
  bool spill_acts;
};

inline Plan make_plan(int B, int T, int sms) {
  Plan P;
  P.spill_acts = spills(T, smem_optin());
  P.spill = (pack_floats(false) + 3) & ~static_cast<size_t>(3);
  P.total = P.spill + (P.spill_acts
                           ? static_cast<size_t>(spill_blocks(B, sms)) *
                                 act_floats(T, block_threads(T), false)
                           : 0);
  return P;
}

template <typename TIn>
cudaError_t launch(const void* enc, const void* dec, const void* mask,
                   Weights ew, Weights dw, void* out, float* ws, Probe probe,
                   Saved sv, int B, int T, float scale, Dropout drop, int sms,
                   cudaStream_t stream) {
  constexpr bool BF16 = !std::is_same<TIn, float>::value;
  const Plan P = make_plan(B, T, sms);
  Packs pk;
  cudaError_t err =
      pack_weights<BF16>(ew, dw, ws, false, nullptr, 0, pk, stream);
  if (err != cudaSuccess) return err;
  const TIn* e = static_cast<const TIn*>(enc);
  const TIn* d = static_cast<const TIn*>(dec);
  const float* mk = static_cast<const float*>(mask);
  TIn* o = static_cast<TIn*>(out);
  return P.spill_acts
             ? launch_rows<true>(e, d, mk, ew, dw, pk, o, ws + P.spill, probe,
                                 sv, B, T, scale, drop, sms, stream)
             : launch_rows<false>(e, d, mk, ew, dw, pk, o, nullptr, probe, sv,
                                  B, T, scale, drop, sms, stream);
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

// Floats of the workspace that fused_block_fwd needs for (B, T) on a card
// with `sms` SMs.
long long fused_block_fwd_workspace(int B, int T, int sms) {
  return static_cast<long long>(make_plan(B, T, sms).total);
}

// Launches the two kernels on `stream` (of the caller's current device);
// returns the CUDA error code of the launch, 0 on success.  `workspace`
// holds fused_block_fwd_workspace(B, T, sms) floats, 16-byte aligned.
// Takes the library's D, F, H and any T >= 1.  `probe_enc` [B, T, F]
// and `probe_dec` [B, F], when not null, get the FF pre-activations;
// `save_q`, `save_k`, `save_v` (the input type) and `save_ctx` (float32),
// [B, T, D] each, when not null, the encoder's Q, K, V and attention
// context (the save mode: all four or none).  Does not synchronise.
int fused_block_fwd(const void* enc, const void* dec, const void* mask,
                    const void* e_wqkv, const void* e_vecs, const void* e_w1,
                    const void* e_b1, const void* e_w2, const void* d_wqkv,
                    const void* d_vecs, const void* d_w1, const void* d_b1,
                    const void* d_w2, void* out, void* workspace,
                    void* probe_enc, void* probe_dec, void* save_q,
                    void* save_k, void* save_v, void* save_ctx, int B, int T,
                    int D, int F, int H, float scale, int is_bf16,
                    const void* seed, int train, int keep_thr,
                    float drop_scale, int sms, void* stream) {
  if (B == 0) return 0;
  const bool some = save_q || save_k || save_v || save_ctx;
  const bool all = save_q && save_k && save_v && save_ctx;
  if (D != kD || F != kF || H != kH || T < 1 || sms < 1 || some != all)
    return static_cast<int>(cudaErrorInvalidValue);
  const Dropout drop = make_dropout(seed, train, keep_thr, drop_scale);
  const Weights ew = weights(e_wqkv, e_vecs, e_w1, e_b1, e_w2);
  const Weights dw = weights(d_wqkv, d_vecs, d_w1, d_b1, d_w2);
  const Probe probe{static_cast<float*>(probe_enc),
                    static_cast<float*>(probe_dec)};
  const Saved sv{save_q, save_k, save_v, static_cast<float*>(save_ctx),
                 false};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ws = static_cast<float*>(workspace);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(enc, dec, mask, ew, dw, out, ws, probe,
                                      sv, B, T, scale, drop, sms, s)
              : launch<float>(enc, dec, mask, ew, dw, out, ws, probe, sv, B,
                              T, scale, drop, sms, s);
  return static_cast<int>(err);
}

const char* fused_block_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
