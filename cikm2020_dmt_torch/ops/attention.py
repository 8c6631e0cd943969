"""Masked multi-head attention core: one CUDA kernel for the forward and
one for its recompute backward.

Per example, with q [Tq, D], k and v [Tk, D] already projected, H heads of
dh = D / H columns each, and masks (1 = present):

    P_h = softmax(mask_k(q_h k_h^T / sqrt(dh))) * q_mask    (rows of absent
                                                             queries zeroed)
    out = concat_h(P_h v_h)

Masked keys score -2^32+1 (not -inf), so a row with no present key gets a
uniform softmax over its Tk real keys.  The TPU wrapper pads Tk to a
multiple of 8 (16 in bf16) first, which makes that softmax uniform over
the padded length; this module follows the reference's per-op path
(``nn/transformer.py`` ``attention_core``) instead.  In the backward a
masked key's score is a constant: no gradient reaches it (the TPU kernel
lets one through on such rows, the per-op path does not).

``fused_attention`` is differentiable (``torch.autograd.Function``).  For
tensors on the card its forward launches ``csrc/attention_fwd.cu`` and its
backward ``csrc/attention_bwd.cu``; for tensors on the CPU they take the
plain PyTorch versions ``fused_attention_ref`` and
``fused_attention_bwd_ref``.  Neither falls back to the other.  The kernels
replace the TPU kernels of ``cikm2020_dmt_tpu/ops/attention.py``:
``_attention_fwd_kernel`` (via ``_pallas_call_fwd``) and
``_attention_bwd_kernel`` (via ``_pallas_call_bwd``).  They take any
Tq, Tk >= 1 and any head width: up to 64 keys and query rows and 64
columns a head they run their register tilings; past either the launchers
take kernels of one warp a row, which process the keys in chunks with a
running max and sum per row and the columns in slabs
(``csrc/attention_rows.cuh``).

Compute types follow the TPU kernel: products take their operands in the
input type (float32 or bfloat16), every sum and the softmax run in
float32, and the probabilities are rounded to the input type before
``P v`` and before the ``dv`` product, ``dS`` before the ``dq`` and ``dk``
products.  Outputs are in the input type.

The plain helpers below (``attention_probs``, ``attend``, ``attend_bwd``)
are also the attention of the fused block's plain versions
(``ops/block.py``), which adds dropout masks and rounds projected
operands.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

KERNEL = "attention_fwd"
BWD_KERNEL = "attention_bwd"
NEG_INF = -(2.0 ** 32) + 1  # score of a masked key (the reference's pad)


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def rounding(dtype):
    """Rounding of a product operand to the compute type ``dtype``."""
    if dtype == torch.bfloat16:
        return lambda t: t.to(torch.bfloat16).float()
    return lambda t: t


def wide(t):
    """float32, or float64 for float64 inputs (a reference for rounding)."""
    return t if t.dtype == torch.float64 else t.float()


def heads(x, H):
    B, T, D = x.shape
    return x.reshape(B, T, H, D // H).transpose(1, 2)


def merge(x):
    B, H, T, dh = x.shape
    return x.transpose(1, 2).reshape(B, T, H * dh)


def attention_probs(qh, kh, km, rnd=lambda t: t):
    """Softmax over the keys of ``q_h k_h^T / sqrt(dh)`` with masked keys
    at -2^32+1: [B, H, Tq, Tk] in the operands' type, query mask not yet
    applied."""
    scale = 1.0 / math.sqrt(qh.shape[-1])
    s = (rnd(qh) @ rnd(kh).transpose(-1, -2)) * scale
    s = torch.where(km[:, None, None, :] > 0, s,
                    torch.full((), NEG_INF, dtype=s.dtype, device=s.device))
    return torch.softmax(s, dim=-1)


def attend(q, k, v, km, qm, dmp, H, rnd):
    """Attention over projected [B, T, D] operands: query rows zeroed where
    ``qm`` is 0 (None: no query mask), probabilities scaled by the dropout
    mask ``dmp`` [B, H, Tq, Tk] (None: no dropout)."""
    p = attention_probs(heads(q, H), heads(k, H), km, rnd)
    if qm is not None:
        p = p * qm[:, None, :, None]
    if dmp is not None:
        p = p * dmp
    return merge(rnd(p) @ rnd(heads(v, H)))


def attend_bwd(gc, q, k, v, km, qm, dmp, H, rnd):
    """Backward of ``attend`` for the cotangent ``gc``, recomputing the
    probabilities: (dq, dk, dv), each [B, T, D]."""
    qh, kh, vh, gh = (heads(t, H) for t in (q, k, v, gc))
    scale = 1.0 / math.sqrt(qh.shape[-1])
    p0 = attention_probs(qh, kh, km, rnd)
    pd = p0 if qm is None else p0 * qm[:, None, :, None]
    if dmp is not None:
        pd = pd * dmp
    dv = rnd(pd).transpose(-1, -2) @ rnd(gh)
    dp = rnd(gh) @ rnd(vh).transpose(-1, -2)
    if dmp is not None:
        dp = dp * dmp
    if qm is not None:
        dp = dp * qm[:, None, :, None]
    ds = p0 * (dp - (dp * p0).sum(-1, keepdim=True))
    # a masked key's score is a constant: no gradient reaches it (this
    # matters only on len-0 rows, where the softmax is uniform; the TPU
    # kernels let it through, the reference's jnp path does not)
    ds = torch.where(km[:, None, None, :] > 0, ds,
                     torch.zeros((), dtype=ds.dtype, device=ds.device))
    dq = (rnd(ds) @ rnd(kh)) * scale
    dk = (rnd(ds).transpose(-1, -2) @ rnd(qh)) * scale
    return merge(dq), merge(dk), merge(dv)


def fused_attention_ref(q, k, v, q_mask, k_mask, num_heads: int):
    """Plain PyTorch version of the forward kernel: the same arithmetic and
    the same bfloat16 rounding points; [B, Tq, D] in q's dtype."""
    out = attend(wide(q), wide(k), wide(v), k_mask.float(), q_mask.float(),
                 None, num_heads, rounding(q.dtype))
    return out.to(q.dtype)


def fused_attention_bwd_ref(q, k, v, q_mask, k_mask, do, num_heads: int):
    """Plain PyTorch version of the backward kernel, written out as the
    TPU kernel ``_attention_bwd_kernel`` states it (not through autograd):
    (dq, dk, dv) in the dtypes of q, k and v."""
    dq, dk, dv = attend_bwd(wide(do), wide(q), wide(k), wide(v),
                            k_mask.float(), q_mask.float(), None, num_heads,
                            rounding(q.dtype))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

_PTR, _I32, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# q k v q_mask k_mask out | B Tq Tk D H | scale is_bf16 | stream
_FWD_ARGS = tuple([_PTR] * 6 + [_I32] * 5 + [_F32, _I32, _PTR])
# q k v q_mask k_mask do dq dk dv workspace | B Tq Tk D H | scale is_bf16 |
# stream
_BWD_ARGS = tuple([_PTR] * 10 + [_I32] * 5 + [_F32, _I32, _PTR])


def _check(name, q, k, v, q_mask, k_mask, num_heads, do=None):
    """Raises on anything the kernels do not take; returns (B, Tq, Tk, D)."""
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: q dtype {q.dtype} (float32 or bfloat16 "
                        "only)")
    if q.dim() != 3 or k.dim() != 3:
        raise ValueError(f"{name}: q and k must be [B, T, D], got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    B, Tq, D = q.shape
    Tk = k.shape[1]
    for t, want in ((k, (B, Tk, D)), (v, (B, Tk, D)), (q_mask, (B, Tq)),
                    (k_mask, (B, Tk))) + (((do, (B, Tq, D)),) if do is not None
                                          else ()):
        if tuple(t.shape) != want:
            raise ValueError(f"{name}: operand {tuple(t.shape)}, want {want}")
        if t.device != q.device:
            raise ValueError(f"{name}: operand on {t.device}, q on "
                             f"{q.device}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q, k, v dtypes {q.dtype}, {k.dtype}, "
                        f"{v.dtype} differ")
    if Tq < 1 or Tk < 1:
        raise ValueError(f"{name}: Tq={Tq}, Tk={Tk}; the kernels take at "
                         "least one query row and one key")
    if num_heads < 1 or D % num_heads:
        raise ValueError(f"{name}: D={D}, num_heads={num_heads}")
    return B, Tq, Tk, D


def _masks(q_mask, k_mask):
    return (q_mask.to(torch.float32).contiguous(),
            k_mask.to(torch.float32).contiguous())


def _fwd_kernel(q, k, v, q_mask, k_mask, num_heads):
    B, Tq, Tk, D = _check(KERNEL, q, k, v, q_mask, k_mask, num_heads)
    qc, kc, vc = (t.contiguous() for t in (q, k, v))
    qm, km = _masks(q_mask, k_mask)
    out = torch.empty((B, Tq, D), dtype=q.dtype, device=q.device)
    if B == 0:
        return out
    launch = _build.bind(KERNEL, _FWD_ARGS)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = launch(qc.data_ptr(), kc.data_ptr(), vc.data_ptr(),
                     qm.data_ptr(), km.data_ptr(), out.data_ptr(), B, Tq, Tk,
                     D, num_heads, 1.0 / math.sqrt(D // num_heads),
                     int(q.dtype == torch.bfloat16), stream)
    _build.check(KERNEL, err, f"B={B} Tq={Tq} Tk={Tk} D={D}")
    fused_attention.launches += 1
    return out


def fused_attention_bwd(q, k, v, q_mask, k_mask, do, num_heads: int):
    """The backward: ``fused_attention_bwd_ref``'s contract.  CPU tensors
    take the plain version; CUDA tensors launch the kernel (each output
    element has one owner thread summing in a fixed order, so runs are
    deterministic); anything else raises."""
    if q.device.type == "cpu":
        return fused_attention_bwd_ref(q, k, v, q_mask, k_mask, do,
                                       num_heads)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention_bwd: unsupported device "
                         f"{q.device}")
    B, Tq, Tk, D = _check(BWD_KERNEL, q, k, v, q_mask, k_mask, num_heads,
                          do)
    qc, kc, vc = (t.contiguous() for t in (q, k, v))
    dc = do.to(q.dtype).contiguous()
    qm, km = _masks(q_mask, k_mask)
    dq, dk, dv = (torch.empty_like(t) for t in (qc, kc, vc))
    if B == 0:
        return dq, dk, dv
    launch = _build.bind(BWD_KERNEL, _BWD_ARGS)
    with torch.cuda.device(q.device):
        n = _build.bind(BWD_KERNEL, (_I32,) * 5, BWD_KERNEL + "_workspace")(
            B, Tq, Tk, D, num_heads)
        work = torch.empty((max(int(n), 1),), dtype=torch.float32,
                           device=q.device)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = launch(qc.data_ptr(), kc.data_ptr(), vc.data_ptr(),
                     qm.data_ptr(), km.data_ptr(), dc.data_ptr(),
                     dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                     work.data_ptr(), B, Tq, Tk, D, num_heads,
                     1.0 / math.sqrt(D // num_heads),
                     int(q.dtype == torch.bfloat16), stream)
    _build.check(BWD_KERNEL, err, f"B={B} Tq={Tq} Tk={Tk} D={D}")
    fused_attention_bwd.launches += 1
    return dq, dk, dv


fused_attention_bwd.launches = 0


class _FusedAttention(torch.autograd.Function):
    """The attention core with its hand-written backward."""

    @staticmethod
    def forward(ctx, q, k, v, q_mask, k_mask, num_heads):
        if q.device.type == "cpu":
            out = fused_attention_ref(q, k, v, q_mask, k_mask, num_heads)
        else:
            out = _fwd_kernel(q, k, v, q_mask, k_mask, num_heads)
        ctx.save_for_backward(q, k, v, q_mask, k_mask)
        ctx.num_heads = num_heads
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, q_mask, k_mask = ctx.saved_tensors
        dq, dk, dv = fused_attention_bwd(q, k, v, q_mask, k_mask, do,
                                         ctx.num_heads)
        return dq, dk, dv, None, None, None


def fused_attention(q, k, v, q_mask, k_mask, num_heads: int) -> torch.Tensor:
    """q [B, Tq, D], k and v [B, Tk, D] (float32 or bfloat16, one dtype),
    q_mask [B, Tq] and k_mask [B, Tk] (1 = present) -> [B, Tq, D] in q's
    dtype.  CPU tensors take the plain versions; CUDA tensors launch the
    kernels, and anything the kernels do not take raises."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_attention: unsupported device {q.device}")
    return _FusedAttention.apply(q, k, v, q_mask, k_mask, num_heads)


fused_attention.launches = 0


# ---------------------------------------------------------------------------
# Work of one launch, for the bound
# ---------------------------------------------------------------------------


def attention_flops(B: int, Tq: int, Tk: int, D: int) -> int:
    """Multiply-adds x 2 of one forward launch: scores and P v."""
    return 4 * B * Tq * Tk * D


def attention_bytes(B: int, Tq: int, Tk: int, D: int, elem: int) -> int:
    """q, k, v read once and the output written once in the input type
    (``elem`` bytes), and the two float32 masks."""
    return elem * (2 * B * Tq * D + 2 * B * Tk * D) + 4 * B * (Tq + Tk)


def attention_bwd_flops(B: int, Tq: int, Tk: int, D: int) -> int:
    """One backward launch: the scores replayed, then dP = do v^T, dq,
    dk and dv, five products."""
    return 10 * B * Tq * Tk * D


def attention_bwd_bytes(B: int, Tq: int, Tk: int, D: int, elem: int) -> int:
    """q, k, v, do and the masks read once, dq, dk, dv written once."""
    return (elem * (3 * B * Tq * D + 4 * B * Tk * D)
            + 4 * B * (Tq + Tk))
