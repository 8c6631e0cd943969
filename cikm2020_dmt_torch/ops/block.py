"""Fused Deep-Interest-Transformer block forward: one CUDA kernel for the
whole encoder + single-query decoder of one behavior sequence, eval mode.

Per example (``enc_in`` [T, D] already scaled and position-encoded,
``dec_in`` [D] the scaled target):

    enc: QKV proj -> masked MHA (key mask, query rows zeroed) -> +res -> LN
         -> FF(relu) -> +res -> LN                                  = H2 [T, D]
    dec: QKV proj (query from dec_in, keys/values from H2) -> masked MHA
         -> +res -> LN -> FF(relu) -> +res -> LN                    = out [D]

``fused_encode_decode`` launches the kernel (``csrc/fused_block_fwd.cu``)
for tensors on the card and takes the plain PyTorch version
``fused_encode_decode_ref`` for tensors on the CPU; it never falls back
from the one to the other.

The kernel replaces the TPU kernel ``cikm2020_dmt_tpu/ops/block.py``
``_make_fwd_kernel`` (launched by ``_fwd_call``, entry
``fused_encode_decode``) with ``train=False``.  Unlike that wrapper, the
sequence is not padded to a multiple of 8: a sequence with no present key
gets a uniform softmax over its T real positions, as in the reference's
per-op path (the padded TPU kernel spreads it over the padded length).

Compute types follow the TPU kernel: with bfloat16 inputs every operand of
every product is rounded to bfloat16 (weights included); sums, softmax and
layer norm stay float32 and the output is rounded to the input type.

Bound on the H100: ~9.2 MFLOP per example at T=50 against ~17 KB of input,
so float32 arithmetic bounds it (see ``block_flops`` / ``block_bytes``).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..nn.layers import layer_norm_apply
from . import _build

KERNEL = "fused_block_fwd"
NEG_INF = -(2.0 ** 32) + 1  # score of a masked key (the reference's pad)


def pack_weights(p) -> tuple[torch.Tensor, ...]:
    """Block params -> the kernel layout, float32 and contiguous:
    wqkv [D, 3D], vecs [8, D] (bq bk bv ln1g ln1b ln2g ln2b b2),
    w1 [D, F], b1 [F], w2 [F, D]."""
    mha, ff = p["mha"], p["ff"]
    wqkv = torch.cat([mha["q"]["w"], mha["k"]["w"], mha["v"]["w"]], dim=1)
    vecs = torch.stack([
        mha["q"]["b"], mha["k"]["b"], mha["v"]["b"],
        mha["ln"]["gamma"], mha["ln"]["beta"],
        ff["ln"]["gamma"], ff["ln"]["beta"], ff["fc2"]["b"]])
    return tuple(t.float().contiguous() for t in (
        wqkv, vecs, ff["fc1"]["w"], ff["fc1"]["b"], ff["fc2"]["w"]))


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------


def _sub_block(x, kv, k_mask, q_mask, w, num_heads, rnd):
    """One attention + FF sub-block.  x [B, Tq, D] queries and residual,
    kv [B, Tk, D] keys/values source; masks [B, Tk] / [B, Tq] or None."""
    wqkv, vecs, w1, b1, w2 = w
    B, Tq, D = x.shape
    Tk = kv.shape[1]
    dh = D // num_heads
    q = rnd(x) @ rnd(wqkv[:, :D]) + vecs[0]
    k = rnd(kv) @ rnd(wqkv[:, D:2 * D]) + vecs[1]
    v = rnd(kv) @ rnd(wqkv[:, 2 * D:]) + vecs[2]
    qh = rnd(q).reshape(B, Tq, num_heads, dh).transpose(1, 2)
    kh = rnd(k).reshape(B, Tk, num_heads, dh).transpose(1, 2)
    vh = rnd(v).reshape(B, Tk, num_heads, dh).transpose(1, 2)
    s = (qh @ kh.transpose(-1, -2)) * (1.0 / math.sqrt(dh))
    s = torch.where(k_mask[:, None, None, :] > 0, s,
                    torch.full((), NEG_INF, device=s.device))
    p = torch.softmax(s, dim=-1)
    if q_mask is not None:
        p = p * q_mask[:, None, :, None]
    ctx = (rnd(p) @ vh).transpose(1, 2).reshape(B, Tq, D)
    h1 = layer_norm_apply({"gamma": vecs[3], "beta": vecs[4]}, ctx + x)
    f = torch.relu(rnd(h1) @ rnd(w1) + b1)
    f2 = rnd(f) @ rnd(w2) + vecs[7]
    return layer_norm_apply({"gamma": vecs[5], "beta": vecs[6]}, f2 + h1)


def fused_encode_decode_ref(enc_params, dec_params, *, enc_in, dec_in,
                            seq_mask, num_heads: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same arithmetic, with the
    same bfloat16 rounding points for bfloat16 inputs."""
    if enc_in.dtype == torch.bfloat16:
        def rnd(t):
            return t.to(torch.bfloat16).float()
    else:
        def rnd(t):
            return t
    km = seq_mask.float()
    e0 = enc_in.float()
    h2 = _sub_block(e0, e0, km, km, pack_weights(enc_params), num_heads, rnd)
    out = _sub_block(dec_in.float()[:, None, :], h2, km, None,
                     pack_weights(dec_params), num_heads, rnd)
    return out[:, 0, :].to(enc_in.dtype)


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load(KERNEL)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.fused_block_fwd.argtypes = (
        [ptr] * 14 + [i32] * 5 + [ctypes.c_float, i32, ptr])
    lib.fused_block_fwd.restype = i32
    lib.fused_block_fwd_error_string.argtypes = [i32]
    lib.fused_block_fwd_error_string.restype = ctypes.c_char_p
    return lib


def fused_encode_decode(enc_params, dec_params, *, enc_in, dec_in, seq_mask,
                        num_heads: int) -> torch.Tensor:
    """enc_in [B, T, D] (scaled, position-encoded), dec_in [B, D] (scaled
    target), seq_mask [B, T] (1 = present) -> [B, D] in enc_in's dtype.

    CPU tensors take ``fused_encode_decode_ref``; CUDA tensors launch the
    kernel, and anything the kernel does not take raises."""
    if enc_in.device.type == "cpu":
        return fused_encode_decode_ref(
            enc_params, dec_params, enc_in=enc_in, dec_in=dec_in,
            seq_mask=seq_mask, num_heads=num_heads)
    if enc_in.device.type != "cuda":
        raise ValueError(f"fused_encode_decode: unsupported device "
                         f"{enc_in.device}")
    if enc_in.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_encode_decode: enc_in dtype {enc_in.dtype} "
                        "(float32 or bfloat16 only)")
    if enc_in.dim() != 3:
        raise ValueError(f"fused_encode_decode: enc_in must be [B, T, D], "
                         f"got {tuple(enc_in.shape)}")
    B, T, D = enc_in.shape
    if dec_in.shape != (B, D) or dec_in.dtype != enc_in.dtype:
        raise ValueError(f"fused_encode_decode: dec_in {tuple(dec_in.shape)} "
                         f"{dec_in.dtype}, want ({B}, {D}) {enc_in.dtype}")
    if seq_mask.shape != (B, T):
        raise ValueError(f"fused_encode_decode: seq_mask "
                         f"{tuple(seq_mask.shape)}, want ({B}, {T})")
    if T < 1 or D % num_heads:
        raise ValueError(f"fused_encode_decode: T={T}, D={D}, "
                         f"num_heads={num_heads}")
    dev = enc_in.device
    ew, dw = pack_weights(enc_params), pack_weights(dec_params)
    F = ew[2].shape[1]
    for t in (dec_in, seq_mask) + ew + dw:
        if t.device != dev:
            raise ValueError(f"fused_encode_decode: operand on {t.device}, "
                             f"enc_in on {dev}")
    if ew[0].shape != (D, 3 * D) or dw[2].shape != (D, F):
        raise ValueError("fused_encode_decode: block weights do not match "
                         f"D={D}")
    enc = enc_in.contiguous()
    dec = dec_in.contiguous()
    mask = seq_mask.to(torch.float32).contiguous()
    out = torch.empty((B, D), dtype=enc_in.dtype, device=dev)
    if B == 0:
        return out
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fused_block_fwd(
            enc.data_ptr(), dec.data_ptr(), mask.data_ptr(),
            *(t.data_ptr() for t in ew), *(t.data_ptr() for t in dw),
            out.data_ptr(), B, T, D, F, num_heads,
            1.0 / math.sqrt(D // num_heads),
            int(enc_in.dtype == torch.bfloat16), stream)
    if err != 0:
        msg = lib.fused_block_fwd_error_string(err).decode()
        raise RuntimeError(f"fused_block_fwd launch failed: CUDA error {err} "
                           f"({msg}) at B={B} T={T} D={D} F={F}")
    fused_encode_decode.launches += 1
    return out


fused_encode_decode.launches = 0


# ---------------------------------------------------------------------------
# Work of one launch, for the bound
# ---------------------------------------------------------------------------


def block_flops(B: int, T: int, D: int, F: int) -> int:
    """Multiply-adds x 2 of one launch: encoder QKV, scores, P.V and FF;
    decoder Q, K/V over T rows, scores, P.V and FF."""
    enc = 2 * T * D * 3 * D + 2 * 2 * T * T * D + 2 * 2 * T * D * F
    dec = 2 * D * D + 2 * T * D * 2 * D + 2 * 2 * T * D + 2 * 2 * D * F
    return B * (enc + dec)


def block_bytes(B: int, T: int, D: int, F: int, elem: int) -> int:
    """Each input read once and the output written once: enc_in, dec_in
    and out in the input type (``elem`` bytes), the float32 mask and the
    two float32 weight sets."""
    weights = 2 * 4 * (D * 3 * D + 8 * D + D * F + F + F * D)
    return elem * (B * T * D + 2 * B * D) + 4 * B * T + weights
