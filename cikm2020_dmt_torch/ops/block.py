"""Fused Deep-Interest-Transformer block: one CUDA kernel for the forward of
the whole encoder + single-query decoder of one behavior sequence, and one
for its backward.

Per example (``enc_in`` [T, D] already scaled and position-encoded,
``dec_in`` [D] the scaled target):

    enc: input dropout -> QKV proj -> masked MHA (key mask, query rows
         zeroed, prob dropout) -> +res -> LN -> FF(relu) -> +res -> LN = H2
    dec: input dropout -> QKV proj (query from dec_in, keys/values from H2)
         -> masked MHA (prob dropout) -> +res -> LN -> FF(relu) -> +res
         -> LN                                                       = out

``fused_encode_decode`` is differentiable (``torch.autograd.Function``).
For tensors on the card its forward launches ``csrc/fused_block_fwd.cu``
and its backward ``csrc/fused_block_bwd.cu``; for tensors on the CPU they
take the plain PyTorch versions ``fused_encode_decode_ref`` and
``fused_block_bwd_ref``.  Neither falls back to the other.

The kernels replace the TPU kernels of ``cikm2020_dmt_tpu/ops/block.py``:
``_make_fwd_kernel`` (via ``_fwd_call``) and ``_make_bwd_kernel`` (via
``_bwd_call``).  Unlike that wrapper, the sequence is not padded to a
multiple of 8: a sequence with no present key gets a uniform softmax over
its T real positions, as in the reference's per-op path.

Dropout (training, ``rate`` > 0) drops the input rows of ``enc_in`` and
``dec_in`` and, per head, the attention probabilities after the query
mask, keeping with probability 1 - rate and scaling kept values by
1 / (1 - rate).  Each mask element comes from a counter-based hash of
(seed, site, example, row, column) written once here (``dropout_mask``)
and once in the kernels, so the kernels, the plain versions and the
backward replay draw bit-identical masks.  The hash needs only the low 32
bits of each product, which int64 tensor arithmetic reproduces exactly.
It does not reproduce the TPU's hardware random bits.

Compute types follow the TPU kernel: with bfloat16 inputs every operand of
every product is rounded to bfloat16 (weights included); sums, softmax and
layer norm stay float32 and outputs are rounded to the input type.  Weight
gradients are float32, summed over the batch.

Save mode (``DMT_BLOCK_SAVE=1``, the TPU kernels' ``save=True``, read at
each call of ``fused_encode_decode`` where a backward can follow): the
forward also returns the encoder's Q, K, V (the input type, as the
projection rounded them) and its attention context ctx_e (float32), [B, T,
D] each, and the backward takes them (``saved``) instead of forming them
again.  Both modes give the same bits.  Off by default.
"""

from __future__ import annotations

import ctypes
import math
import os

import torch

from . import _build
from .attention import attend, attend_bwd, rounding, wide

KERNEL = "fused_block_fwd"
BWD_KERNEL = "fused_block_bwd"
LN_EPS = 1e-8

# dropout sites (the reference's ids); probabilities of head h use
# site * 16 + h
SITE_ENC_IN = 0
SITE_ENC_PROBS = 1
SITE_DEC_IN = 2
SITE_DEC_PROBS = 3

_MASK32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9


def pack_weights(p) -> tuple[torch.Tensor, ...]:
    """Block params -> the kernel layout, float32 and contiguous:
    wqkv [D, 3D], vecs [8, D] (bq bk bv ln1g ln1b ln2g ln2b b2),
    w1 [D, F], b1 [F], w2 [F, D].  Differentiable: the gradients of the
    packed tensors flow back to the param tree through the cat/stack."""
    mha, ff = p["mha"], p["ff"]
    wqkv = torch.cat([mha["q"]["w"], mha["k"]["w"], mha["v"]["w"]], dim=1)
    vecs = torch.stack([
        mha["q"]["b"], mha["k"]["b"], mha["v"]["b"],
        mha["ln"]["gamma"], mha["ln"]["beta"],
        ff["ln"]["gamma"], ff["ln"]["beta"], ff["fc2"]["b"]])
    return tuple(t.float().contiguous() for t in (
        wqkv, vecs, ff["fc1"]["w"], ff["fc1"]["b"], ff["fc2"]["w"]))


# ---------------------------------------------------------------------------
# Dropout masks: a counter-based hash, the same bits as the kernels
# ---------------------------------------------------------------------------


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for x in [0, 2**32), without int64 overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def lowbias32(x: torch.Tensor) -> torch.Tensor:
    """The lowbias32 integer finalizer on int64 tensors holding uint32."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def keep_threshold(rate: float) -> int:
    """An element is kept when the top 24 bits of its hash are below this."""
    return int(round((1.0 - rate) * (1 << 24)))


def dropout_mask(seed: int, site: int, B: int, rows: int, cols: int,
                 rate: float, device) -> torch.Tensor:
    """Scaled keep-mask [B, rows, cols] (float32, 0 or 1 / (1 - rate)) of
    one site: element (b, r, c) hashes (seed, site, b, r, c) as

        key  = lowbias32(seed + site * 0x9E3779B9)
        bits = lowbias32(lowbias32(key ^ b) ^ (r << 16 | c))

    and is kept when ``bits >> 8 < keep_threshold(rate)``."""
    key = lowbias32(torch.tensor((seed + site * _GOLDEN) & _MASK32,
                                 dtype=torch.int64, device=device))
    ex = lowbias32(key ^ torch.arange(B, device=device))
    rc = ((torch.arange(rows, device=device)[:, None] << 16)
          | torch.arange(cols, device=device)[None, :])
    bits = lowbias32(ex[:, None, None] ^ rc[None])
    keep = (bits >> 8) < keep_threshold(rate)
    scale = torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32,
                         device=device)
    return torch.where(keep, scale, torch.zeros((), device=device))


def _masks(B, T, D, H, train, rate, seed, device):
    """(enc input [B,T,D], dec input [B,D], enc probs [B,H,T,T], dec probs
    [B,H,1,T]) scaled keep-masks, or four Nones outside training."""
    if not (train and rate > 0.0):
        return None, None, None, None
    if seed is None:
        raise ValueError("fused block: training dropout needs a seed")
    s = int(seed.reshape(-1)[0])
    dm_e = dropout_mask(s, SITE_ENC_IN, B, T, D, rate, device)
    dm_d = dropout_mask(s, SITE_DEC_IN, B, 1, D, rate, device)[:, 0]
    dmp_e = torch.stack([dropout_mask(s, SITE_ENC_PROBS * 16 + h, B, T, T,
                                      rate, device) for h in range(H)], 1)
    dmp_d = torch.stack([dropout_mask(s, SITE_DEC_PROBS * 16 + h, B, 1, T,
                                      rate, device) for h in range(H)], 1)
    return dm_e, dm_d, dmp_e, dmp_d


# ---------------------------------------------------------------------------
# Plain PyTorch versions: forward replay and explicit backward, mirroring
# the TPU kernels' _ffln/_attend3 and _ffln_bwd/_attend3_bwd/_ln_bwd (the
# attention core is ops/attention.py's plain version)
# ---------------------------------------------------------------------------


def _ln(x, gamma, beta):
    mean = x.mean(-1, keepdim=True)
    xc = x - mean
    inv = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + LN_EPS)
    xhat = xc * inv
    return gamma * xhat + beta, xhat, inv


def _rows_sum(t):
    return t.reshape(-1, t.shape[-1]).sum(0)


def _ln_bwd(g, xhat, inv, gamma):
    """dL/dx of y = gamma * xhat + beta, and (dgamma, dbeta)."""
    gg = g * gamma
    dx = (gg - gg.mean(-1, keepdim=True)
          - xhat * (gg * xhat).mean(-1, keepdim=True)) * inv
    return dx, _rows_sum(g * xhat), _rows_sum(g)


def _sub_fwd(x, kv, km, qm, dmp, w, H, rnd, saved=None):
    """Attention + FF sub-block; x [B, Tq, D] queries and residual, kv
    [B, Tk, D] keys/values; ``saved`` (q, k, v, ctx), where given, stands
    for the projections and the attention.  Returns (out, residuals,
    ctx)."""
    wqkv, vecs, w1, b1, w2 = w
    D = x.shape[-1]
    if saved is None:
        q = rnd(x) @ rnd(wqkv[:, :D]) + vecs[0]
        k = rnd(kv) @ rnd(wqkv[:, D:2 * D]) + vecs[1]
        v = rnd(kv) @ rnd(wqkv[:, 2 * D:]) + vecs[2]
        ctx = attend(q, k, v, km, qm, dmp, H, rnd)
    else:
        q, k, v, ctx = saved
    h1, xhat1, inv1 = _ln(ctx + x, vecs[3], vecs[4])
    f = torch.relu(rnd(h1) @ rnd(w1) + b1)
    f2 = rnd(f) @ rnd(w2) + vecs[7]
    out, xhat2, inv2 = _ln(f2 + h1, vecs[5], vecs[6])
    return out, (q, k, v, h1, xhat1, inv1, f, xhat2, inv2), ctx


def _tdot(a, b, rnd):
    """sum over every leading row of a^T b: [.., M] x [.., N] -> [M, N]."""
    return (rnd(a).reshape(-1, a.shape[-1]).T
            @ rnd(b).reshape(-1, b.shape[-1]))


def _sub_bwd(g, x, kv, res, km, qm, dmp, w, H, rnd):
    """Backward of ``_sub_fwd``: (dx, dkv, packed weight grads)."""
    wqkv, vecs, w1, _, w2 = w
    q, k, v, h1, xhat1, inv1, f, xhat2, inv2 = res
    D = x.shape[-1]
    dln2, dg2, db2v = _ln_bwd(g, xhat2, inv2, vecs[5])
    df = rnd(dln2) @ rnd(w2).T
    dw2 = _tdot(f, dln2, rnd)
    dfpre = df * (f > 0)
    dh1 = dln2 + rnd(dfpre) @ rnd(w1).T
    dw1 = _tdot(h1, dfpre, rnd)
    da1, dg1, db1v = _ln_bwd(dh1, xhat1, inv1, vecs[3])
    dq, dk, dv = attend_bwd(da1, q, k, v, km, qm, dmp, H, rnd)
    dwqkv = torch.cat([_tdot(x, dq, rnd), _tdot(kv, dk, rnd),
                       _tdot(kv, dv, rnd)], dim=1)
    dvecs = torch.stack([_rows_sum(dq), _rows_sum(dk), _rows_sum(dv),
                         dg1, db1v, dg2, db2v, _rows_sum(dln2)])
    dx = da1 + rnd(dq) @ rnd(wqkv[:, :D]).T
    dkv = (rnd(dk) @ rnd(wqkv[:, D:2 * D]).T
           + rnd(dv) @ rnd(wqkv[:, 2 * D:]).T)
    return dx, dkv, (dwqkv, dvecs, dw1, _rows_sum(dfpre), dw2)


def _replay(ew, dw, enc_in, dec_in, seq_mask, H, masks, saved=None):
    """The forward with every residual: (e0, d0, H2, encoder residuals,
    out, decoder residuals, key mask, rounding, ctx_e).  ``saved`` (the
    encoder's q, k, v, ctx_e), where given, stands for the encoder's
    projections and attention."""
    rnd = rounding(enc_in.dtype)
    dm_e, dm_d, dmp_e, dmp_d = masks
    km = seq_mask.float()
    e0 = wide(enc_in)
    d0 = wide(dec_in)
    if dm_e is not None:
        e0, d0 = e0 * dm_e, d0 * dm_d
    d0 = d0[:, None, :]
    if saved is not None:
        saved = tuple(wide(t) for t in saved)
    h2, eres, ctx_e = _sub_fwd(e0, e0, km, km, dmp_e, ew, H, rnd, saved)
    out, dres, _ = _sub_fwd(d0, h2, km, None, dmp_d, dw, H, rnd)
    return e0, d0, h2, eres, out, dres, km, rnd, ctx_e


def _fwd_ref(ew, dw, enc_in, dec_in, seq_mask, H, train, rate, seed,
             save=False):
    """The forward's output [B, D]; with ``save``, (output, (q, k, v,
    ctx_e)) as the forward kernel saves them: q, k, v rounded to the input
    type, ctx_e float32."""
    B, T, D = enc_in.shape
    masks = _masks(B, T, D, H, train, rate, seed, enc_in.device)
    r = _replay(ew, dw, enc_in, dec_in, seq_mask, H, masks)
    out = r[4][:, 0, :].to(enc_in.dtype)
    if not save:
        return out
    q, k, v = r[3][:3]
    return out, tuple(t.to(enc_in.dtype).contiguous() for t in (q, k, v)) + (
        r[8].to(torch.float32).contiguous(),)


def fused_encode_decode_ref(enc_params, dec_params, *, enc_in, dec_in,
                            seq_mask, num_heads: int, train: bool = False,
                            rate: float = 0.0, seed=None) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel: the same arithmetic,
    the same dropout masks, the same bfloat16 rounding points."""
    return _fwd_ref(pack_weights(enc_params), pack_weights(dec_params),
                    enc_in, dec_in, seq_mask, num_heads, train, rate, seed)


def fused_block_bwd_ref(ew, dw, *, enc_in, dec_in, seq_mask, g,
                        num_heads: int, train: bool = False,
                        rate: float = 0.0, seed=None, saved=None):
    """Plain PyTorch version of the backward kernel: replays the forward
    and chains the gradients as the TPU kernel ``_make_bwd_kernel`` does.

    ``ew``/``dw`` are ``pack_weights`` tuples, ``g`` [B, D] the output's
    cotangent; ``saved``, where given, the forward's (q, k, v, ctx_e) of
    the save mode, which stand for the encoder's projections and attention
    in the replay (the same bits).  Returns (d_enc [B, T, D], d_dec [B,
    D], 10 float32 weight grads in the ``pack_weights`` layout, encoder's
    then decoder's, summed over the batch)."""
    B, T, D = enc_in.shape
    if saved is not None:
        _check_saved("fused_block_bwd", saved, enc_in)
    masks = _masks(B, T, D, num_heads, train, rate, seed, enc_in.device)
    e0, d0, h2, eres, _, dres, km, rnd, _ = _replay(
        ew, dw, enc_in, dec_in, seq_mask, num_heads, masks, saved)
    dd0, dh2, gdw = _sub_bwd(wide(g)[:, None, :], d0, h2, dres, km, None,
                             masks[3], dw, num_heads, rnd)
    dx, dkv, gew = _sub_bwd(dh2, e0, e0, eres, km, km, masks[2], ew,
                            num_heads, rnd)
    de0, dd0 = dx + dkv, dd0[:, 0, :]
    if masks[0] is not None:
        de0, dd0 = de0 * masks[0], dd0 * masks[1]
    return (de0.to(enc_in.dtype), dd0.to(dec_in.dtype),
            tuple(gew) + tuple(gdw))


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

_PTR, _I32, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


# enc dec mask, 10 weights, out, workspace, probe_enc probe_dec, save_q
# save_k save_v save_ctx | B T D F H | scale is_bf16 | seed train keep_thr
# drop_scale | sms | stream
_FWD_ARGS = tuple([_PTR] * 21 + [_I32] * 5
                  + [_F32, _I32, _PTR, _I32, _I32, _F32, _I32, _PTR])
# enc dec mask, 10 weights, g, d_enc d_dec, workspace, gw, probe_enc
# probe_dec, saved_q saved_k saved_v saved_ctx | B T D F H | scale is_bf16
# | seed train keep_thr drop_scale | sms | stream
_BWD_ARGS = tuple([_PTR] * 24 + [_I32] * 5
                  + [_F32, _I32, _PTR, _I32, _I32, _F32, _I32, _PTR])
_WS_ARGS = (_I32, _I32, _I32)
def library(kernel: str, D: int, F: int, H: int):
    """The build spec of a block kernel at widths (D, F, H): one library
    per width, built at its first use (``ops/_build.py``)."""
    return kernel, (f"BLOCK_D={D}", f"BLOCK_F={F}", f"BLOCK_H={H}")


def max_act_floats(D: int, F: int, H: int, T: int) -> int:
    """More floats than one example's activations take in either block
    kernel (whose exact layout is ``act_floats`` in
    ``csrc/block_fwd_tiles.cuh``): two [T, T] tiles, a dozen rows of the
    padded D and two of the padded F a position, and as many again for the
    decoder row and the sums.  Rows of D hold the heads at up to 3 zero
    columns each, then up to 7 more; rows of F up to 7."""
    dp, fp = D + 3 * H + 7, F + 7
    return 2 * T * T + (T + 1) * (12 * dp + 2 * fp + 4 * H + 64) + 1024


def check_widths(name: str, D: int, F: int, H: int, T: int) -> None:
    """Raises, before any build, on a shape the block kernels cannot take,
    with the reason."""
    if H < 1 or D % H:
        raise ValueError(f"{name}: D={D} is not a multiple of num_heads={H}")
    n = max_act_floats(D, F, H, T)
    if n >= 2 ** 31:
        raise ValueError(f"{name}: one example's activations at D={D}, "
                         f"F={F}, T={T} are {n} floats, past the kernels' "
                         "32-bit indexing")


def _sms(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _workspace(spec, fn_name, B, T, dev):
    """The float32 workspace a block kernel asks for at (B, T)."""
    n = _build.bind(spec, _WS_ARGS, fn_name)(B, T, _sms(dev))
    return torch.empty((int(n),), dtype=torch.float32, device=dev)


def _check(name, enc_in, dec_in, seq_mask, num_heads, ew, dw, seed, train,
           rate):
    """Raises on anything the kernels do not take; returns (B, T, D, F)."""
    if enc_in.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: enc_in dtype {enc_in.dtype} "
                        "(float32 or bfloat16 only)")
    if enc_in.dim() != 3:
        raise ValueError(f"{name}: enc_in must be [B, T, D], got "
                         f"{tuple(enc_in.shape)}")
    B, T, D = enc_in.shape
    if dec_in.shape != (B, D) or dec_in.dtype != enc_in.dtype:
        raise ValueError(f"{name}: dec_in {tuple(dec_in.shape)} "
                         f"{dec_in.dtype}, want ({B}, {D}) {enc_in.dtype}")
    if seq_mask.shape != (B, T):
        raise ValueError(f"{name}: seq_mask {tuple(seq_mask.shape)}, want "
                         f"({B}, {T})")
    if T < 1 or T > 65535 or D > 65535:
        raise ValueError(f"{name}: T={T}, D={D}")
    F = ew[2].shape[1]
    if ew[0].shape != (D, 3 * D) or dw[0].shape != (D, 3 * D) \
            or dw[2].shape != (D, F):
        raise ValueError(f"{name}: block weights do not match D={D}")
    check_widths(name, D, F, num_heads, T)
    drop = train and rate > 0.0
    if drop and not (0.0 < rate < 1.0):
        raise ValueError(f"{name}: dropout rate {rate}")
    if drop and (seed is None or seed.dtype != torch.int32
                 or seed.numel() != 1):
        raise ValueError(f"{name}: training dropout needs an int32 seed "
                         "tensor of one element")
    for t in (dec_in, seq_mask) + tuple(ew) + tuple(dw) + (
            (seed,) if drop else ()):
        if t.device != enc_in.device:
            raise ValueError(f"{name}: operand on {t.device}, enc_in on "
                             f"{enc_in.device}")
    return B, T, D, F


def _drop_args(train, rate, seed):
    if train and rate > 0.0:
        return (seed.data_ptr(), 1, keep_threshold(rate),
                float(torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32)))
    return (None, 0, 1 << 24, 1.0)


def _probe_args(probe):
    return (None, None) if probe is None else tuple(
        t.data_ptr() for t in probe)


def _saved_args(saved):
    return (None,) * 4 if saved is None else tuple(
        t.data_ptr() for t in saved)


def _check_saved(name, saved, enc_in):
    """Raises unless ``saved`` is the save mode's (q, k, v, ctx_e): [B, T,
    D] each, contiguous, on enc_in's device, q, k and v in enc_in's dtype
    and ctx_e float32."""
    if len(saved) != 4:
        raise ValueError(f"{name}: saved holds {len(saved)} tensors, want "
                         "(q, k, v, ctx_e)")
    want = tuple(enc_in.shape)
    for what, t, dtype in zip(("q", "k", "v", "ctx_e"), saved,
                              (enc_in.dtype,) * 3 + (torch.float32,)):
        if (tuple(t.shape) != want or t.dtype != dtype
                or t.device != enc_in.device or not t.is_contiguous()):
            raise ValueError(
                f"{name}: saved {what} {tuple(t.shape)} {t.dtype} on "
                f"{t.device}, contiguous {t.is_contiguous()}; want {want} "
                f"{dtype} on {enc_in.device}, contiguous")


def _fwd_kernel(ew, dw, enc_in, dec_in, seq_mask, num_heads, train, rate,
                seed, probe=None, save=False):
    """The forward kernel: out [B, D]; with ``save``, (out, (q, k, v,
    ctx_e)), the save mode's outputs (``_fwd_ref``'s contract)."""
    B, T, D, F = _check("fused_block_fwd", enc_in, dec_in, seq_mask,
                        num_heads, ew, dw, seed, train, rate)
    dev = enc_in.device
    enc = enc_in.contiguous()
    dec = dec_in.contiguous()
    mask = seq_mask.to(torch.float32).contiguous()
    out = torch.empty((B, D), dtype=enc_in.dtype, device=dev)
    saved = tuple(torch.empty((B, T, D), dtype=t, device=dev)
                  for t in (enc_in.dtype,) * 3 + (torch.float32,)) \
        if save else None
    if B == 0:
        return (out, saved) if save else out
    spec = library(KERNEL, D, F, num_heads)
    with torch.cuda.device(dev):
        work = _workspace(spec, KERNEL + "_workspace", B, T, dev)
        launch = _build.bind(spec, _FWD_ARGS)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(
            enc.data_ptr(), dec.data_ptr(), mask.data_ptr(),
            *(t.data_ptr() for t in ew), *(t.data_ptr() for t in dw),
            out.data_ptr(), work.data_ptr(), *_probe_args(probe),
            *_saved_args(saved), B, T, D, F, num_heads,
            1.0 / math.sqrt(D // num_heads),
            int(enc_in.dtype == torch.bfloat16),
            *_drop_args(train, rate, seed), _sms(dev), stream)
    _build.check(spec, err, f"B={B} T={T} D={D} F={F}")
    fused_encode_decode.launches += 1
    if save:
        fused_encode_decode.save_launches += 1
        return out, saved
    return out


def fused_block_bwd(ew, dw, *, enc_in, dec_in, seq_mask, g, num_heads: int,
                    train: bool = False, rate: float = 0.0, seed=None,
                    probe=None, saved=None):
    """The block's backward: ``fused_block_bwd_ref``'s contract.  CPU
    tensors take the plain version; CUDA tensors launch the kernel (three
    CUDA kernels: the weights packed into tensor-core fragments, the
    per-example backward, and the weight grads summed over all rows in
    fixed chunks and a fixed order, so runs are deterministic), built for
    the block's widths at their first use; anything else raises
    (``check_widths``, ``_check_saved``) before any build.  ``saved`` (the
    save-mode forward's q, k, v, ctx_e) skips the encoder's projections
    and attention in the replay.  ``probe`` (two float32 tensors [B, T, F]
    and [B, F]) gets the replay's FF pre-activations
    (``ff_preactivations``)."""
    if enc_in.device.type == "cpu":
        return fused_block_bwd_ref(ew, dw, enc_in=enc_in, dec_in=dec_in,
                                   seq_mask=seq_mask, g=g,
                                   num_heads=num_heads, train=train,
                                   rate=rate, seed=seed, saved=saved)
    if enc_in.device.type != "cuda":
        raise ValueError(f"fused_block_bwd: unsupported device "
                         f"{enc_in.device}")
    B, T, D, F = _check("fused_block_bwd", enc_in, dec_in, seq_mask,
                        num_heads, ew, dw, seed, train, rate)
    if g.shape != (B, D) or g.device != enc_in.device:
        raise ValueError(f"fused_block_bwd: g {tuple(g.shape)} on "
                         f"{g.device}, want ({B}, {D})")
    if saved is not None:
        _check_saved("fused_block_bwd", saved, enc_in)
    dev = enc_in.device
    enc = enc_in.contiguous()
    dec = dec_in.contiguous()
    gg = g.to(enc_in.dtype).contiguous()
    mask = seq_mask.to(torch.float32).contiguous()
    d_enc = torch.empty_like(enc)
    d_dec = torch.empty_like(dec)
    sizes = [D * 3 * D, 8 * D, D * F, F, F * D]
    nw = 2 * sum(sizes)
    gw = torch.empty((nw,), dtype=torch.float32, device=dev)
    if B == 0:
        gw.zero_()
    else:
        spec = library(BWD_KERNEL, D, F, num_heads)
        with torch.cuda.device(dev):
            work = _workspace(spec, BWD_KERNEL + "_workspace", B, T, dev)
            launch = _build.bind(spec, _BWD_ARGS)
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = launch(
                enc.data_ptr(), dec.data_ptr(), mask.data_ptr(),
                *(t.data_ptr() for t in ew), *(t.data_ptr() for t in dw),
                gg.data_ptr(), d_enc.data_ptr(), d_dec.data_ptr(),
                work.data_ptr(), gw.data_ptr(), *_probe_args(probe),
                *_saved_args(saved), B, T, D, F, num_heads,
                1.0 / math.sqrt(D // num_heads),
                int(enc_in.dtype == torch.bfloat16),
                *_drop_args(train, rate, seed), _sms(dev), stream)
        _build.check(spec, err, f"B={B} T={T} D={D} F={F}")
        fused_block_bwd.launches += 1
        if saved is not None:
            fused_block_bwd.save_launches += 1
    shapes = [(D, 3 * D), (8, D), (D, F), (F,), (F, D)] * 2
    parts = torch.split(gw, sizes * 2)
    return d_enc, d_dec, tuple(p.view(s) for p, s in zip(parts, shapes))


fused_block_bwd.launches = 0
# of those, the launches that read the save mode's tensors
fused_block_bwd.save_launches = 0


def ff_preactivations(ew, dw, *, enc_in, dec_in, seq_mask, num_heads: int,
                      train: bool = False, rate: float = 0.0, seed=None):
    """The FF pre-activations (h1 w1 + b1; encoder [B, T, F], decoder [B,
    F], float32) as the forward kernel formed them and as the backward
    kernel's replay formed them, on the card: ((enc, dec) of the forward,
    (enc, dec) of the replay).  The two are the same bits when the replay
    reproduces the forward, so every ReLU takes the same branch in both."""
    B, T, D = enc_in.shape
    F = ew[2].shape[1]

    def probe():
        return (torch.full((B, T, F), float("nan"), device=enc_in.device),
                torch.full((B, F), float("nan"), device=enc_in.device))

    fwd, bwd = probe(), probe()
    kw = dict(enc_in=enc_in, dec_in=dec_in, seq_mask=seq_mask)
    _fwd_kernel(ew, dw, enc_in, dec_in, seq_mask, num_heads, train, rate,
                seed, probe=fwd)
    g = torch.zeros((B, D), dtype=enc_in.dtype, device=enc_in.device)
    fused_block_bwd(ew, dw, g=g, num_heads=num_heads, train=train, rate=rate,
                    seed=seed, probe=bwd, **kw)
    return fwd, bwd


def save_wanted() -> bool:
    """Whether ``DMT_BLOCK_SAVE`` asks for the save mode (``=1``), read at
    each call as the JAX package's ``_save_wanted`` reads it."""
    return os.environ.get("DMT_BLOCK_SAVE", "0") == "1"


class _FusedBlock(torch.autograd.Function):
    """The fused block with its hand-written backward; the weights enter
    packed (``pack_weights``).  With ``save``, the forward keeps the save
    mode's (q, k, v, ctx_e) for the backward."""

    @staticmethod
    def forward(ctx, enc_in, dec_in, seq_mask, seed, num_heads, train, rate,
                save, *w):
        ew, dw = w[:5], w[5:]
        fwd = _fwd_ref if enc_in.device.type == "cpu" else _fwd_kernel
        out = fwd(ew, dw, enc_in, dec_in, seq_mask, num_heads, train, rate,
                  seed, save=save)
        saved = ()
        if save:
            out, saved = out
        ctx.save_for_backward(enc_in, dec_in, seq_mask, seed, *w, *saved)
        ctx.opts = (num_heads, train, rate)
        return out

    @staticmethod
    def backward(ctx, g):
        enc_in, dec_in, seq_mask, seed, *rest = ctx.saved_tensors
        num_heads, train, rate = ctx.opts
        w, saved = rest[:10], tuple(rest[10:])
        d_enc, d_dec, gw = fused_block_bwd(
            tuple(w[:5]), tuple(w[5:]), enc_in=enc_in, dec_in=dec_in,
            seq_mask=seq_mask, g=g, num_heads=num_heads, train=train,
            rate=rate, seed=seed, saved=saved or None)
        return (d_enc, d_dec, None, None, None, None, None, None) + tuple(gw)


def fused_encode_decode(enc_params, dec_params, *, enc_in, dec_in, seq_mask,
                        num_heads: int, train: bool = False,
                        rate: float = 0.0, seed=None) -> torch.Tensor:
    """enc_in [B, T, D] (scaled, position-encoded), dec_in [B, D] (scaled
    target), seq_mask [B, T] (1 = present) -> [B, D] in enc_in's dtype.
    ``train`` with ``rate`` > 0 drops out as the module docstring says,
    from ``seed`` (an int32 tensor of one element on the inputs' device).

    CPU tensors take the plain versions; CUDA tensors launch the kernels,
    and anything the kernels do not take raises.  Where a backward can
    follow (grad mode on, an input or weight that requires grad) and
    ``save_wanted()``, the block runs in the save mode (module
    docstring)."""
    if enc_in.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_encode_decode: unsupported device "
                         f"{enc_in.device}")
    ew, dw = pack_weights(enc_params), pack_weights(dec_params)
    save = save_wanted() and torch.is_grad_enabled() and any(
        t.requires_grad for t in (enc_in, dec_in) + ew + dw)
    return _FusedBlock.apply(enc_in, dec_in, seq_mask, seed, num_heads,
                             bool(train), float(rate), save, *ew, *dw)


fused_encode_decode.launches = 0
# of those, the launches in the save mode
fused_encode_decode.save_launches = 0


# ---------------------------------------------------------------------------
# Work of one launch, for the bound
# ---------------------------------------------------------------------------


def _enc_qkv_att_flops(T: int, D: int) -> int:
    """One example's encoder QKV projection, scores and P.V: what the
    save mode's tensors stand for."""
    return 2 * T * D * 3 * D + 2 * 2 * T * T * D


def _saved_bytes(B: int, T: int, D: int, elem: int) -> int:
    """The save mode's q, k, v (``elem`` bytes) and float32 ctx_e."""
    return (3 * elem + 4) * B * T * D


def block_flops(B: int, T: int, D: int, F: int) -> int:
    """Multiply-adds x 2 of one forward launch: encoder QKV, scores, P.V
    and FF; decoder Q, K/V over T rows, scores, P.V and FF."""
    enc = _enc_qkv_att_flops(T, D) + 2 * 2 * T * D * F
    dec = 2 * D * D + 2 * T * D * 2 * D + 2 * 2 * T * D + 2 * 2 * D * F
    return B * (enc + dec)


def block_bytes(B: int, T: int, D: int, F: int, elem: int,
                save: bool = False) -> int:
    """Each input read once and each output written once: enc_in, dec_in
    and out in the input type (``elem`` bytes), the float32 mask and the
    two float32 weight sets; with ``save``, the saved q, k, v and ctx_e
    written too."""
    weights = 2 * 4 * (D * 3 * D + 8 * D + D * F + F + F * D)
    return (elem * (B * T * D + 2 * B * D) + 4 * B * T + weights
            + (_saved_bytes(B, T, D, elem) if save else 0))


def block_bwd_flops(B: int, T: int, D: int, F: int,
                    saved: bool = False) -> int:
    """One backward launch: the forward's products replayed, then each
    product's two gradient products (input and weight), so 3x; with
    ``saved``, less the encoder's QKV projection and attention, which the
    saved tensors stand for in the replay."""
    ops = 3 * block_flops(B, T, D, F)
    return ops - B * _enc_qkv_att_flops(T, D) if saved else ops


def block_bwd_bytes(B: int, T: int, D: int, F: int, elem: int,
                    saved: bool = False) -> int:
    """Inputs read once (enc_in, dec_in, g, mask, weights; with ``saved``,
    the saved q, k, v and ctx_e) and outputs written once (d_enc, d_dec,
    float32 weight grads)."""
    weights = 2 * 4 * (D * 3 * D + 8 * D + D * F + F + F * D)
    return (2 * elem * (B * T * D + 2 * B * D) + 4 * B * T + 2 * weights
            + (_saved_bytes(B, T, D, elem) if saved else 0))


# dense tensor-core peaks of one H100 SXM (NVIDIA data sheet, 700 W)
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12


def block_tc_bound_ms(ops: int, dtype) -> float:
    """Least ms of a block kernel's ``ops`` operations (``block_flops`` or
    ``block_bwd_flops``) on the tensor cores: float32 by the 3xTF32 split
    (three TF32 products for each, at 495 TFLOP/s), bfloat16 at 989
    TFLOP/s.  Beside the float32 FMA bound (at 67 TFLOP/s) it says how far
    tensor cores could take the kernel; it is not the kernel's bound, which
    counts the function's float32 operations at their own rate."""
    if dtype == torch.bfloat16:
        return ops / PEAK_BF16_FLOPS * 1e3
    return 3 * ops / PEAK_TF32_FLOPS * 1e3
