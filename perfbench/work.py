"""The work that a batch or a request needs, counted from the
configuration's widths and the real lengths of the inputs (present
positions, never the padding), and the card's published peaks.

Operations are multiply-adds x 2.  A training step needs 3x the
forward's operations (the forward, and each product's two gradient
products); a recompute that a kernel chooses is not counted.  Bytes count
each input read once and each output written once, in float32.  The
least time of a piece of work is the larger of its operations over the
peak rate and its bytes over the memory rate; a roofline share is that
least time over the time the device took.
"""

from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM data sheet, dense, 700 W: the TF32 tensor-core rate
# bounds every float32-accurate route on the card (the FMA units at 67
# TFLOP/s, 3xTF32 at about a third of this), so no share can pass 100%
PEAK_FLOPS = 495e12
PEAK_BYTES = 3.35e12
F32 = 4


def least_s(ops: float, nbytes: float) -> float:
    return max(ops / PEAK_FLOPS, nbytes / PEAK_BYTES)


# ---------------------------------------------------------------------------
# The behaviour transformer
# ---------------------------------------------------------------------------


def encoder_macs(t, D: int, F: int):
    """One encoder block over t present positions: Q, K, V, scores, P V,
    FF.  ``t`` may be an array of lengths."""
    t = np.asarray(t, np.float64)
    return 3 * t * D * D + 2 * t * t * D + 2 * t * D * F


def decoder_macs(t, D: int, F: int, kv: bool = True, q: bool = True):
    """One single-query decoder block over t encoder rows: Q (``q``), K
    and V over the rows (``kv``), scores, P V, FF (``q``)."""
    t = np.asarray(t, np.float64)
    out = 2 * t * D if q else 0 * t
    if kv:
        out = out + 2 * t * D * D
    if q:
        out = out + D * D + 2 * D * F
    return out


def block_weights(D: int, F: int) -> int:
    """Floats of one block: Q, K, V with biases, two LNs, FF."""
    return 3 * D * D + 3 * D + 4 * D + D * F + F + F * D + D


def block_train_work(lens, D: int, F: int) -> tuple[float, float]:
    """(operations, bytes) of one fused encoder + decoder launch pair,
    forward and backward, over examples of the given real lengths."""
    t = np.asarray(lens, np.float64)
    macs = float((encoder_macs(t, D, F) + decoder_macs(t, D, F)).sum())
    w = 2 * block_weights(D, F)
    nbytes = F32 * (float(t.sum()) * D * 2 + t.size * D * 4 + float(t.sum())
                    + 2 * w)
    return 3 * 2 * macs, nbytes


def block_serve_work(t_user: int, candidates: int, D: int, F: int
                     ) -> tuple[float, float]:
    """(operations, bytes) of the block forward one request needs: the
    encoder and the decoder's K and V over the user's rows once, the
    decoder's query path once per candidate."""
    macs = (encoder_macs(t_user, D, F) + decoder_macs(t_user, D, F, q=False)
            + candidates * decoder_macs(t_user, D, F, kv=False))
    w = 2 * block_weights(D, F)
    nbytes = F32 * (t_user * D + t_user + candidates * 2 * D + w)
    return 2 * float(macs), float(nbytes)


def attention_train_work(lens, D: int, blocks_enc: int, blocks_dec: int
                         ) -> tuple[float, float]:
    """(operations, bytes) of the attention cores of one sequence's
    per-op stack, forward and backward: scores and P V over present
    positions; q, k, v, the masks and the output read or written once
    forward, the output's cotangent read and dq, dk, dv written once
    backward."""
    t = np.asarray(lens, np.float64)
    enc_macs = 2 * t * t * D
    dec_macs = 2 * t * D
    macs = float((blocks_enc * enc_macs + blocks_dec * dec_macs).sum())
    enc_bytes = F32 * (8 * t * D + 2 * t)
    dec_bytes = F32 * (4 * D + 4 * t * D + 2 * t + 2)
    nbytes = float((blocks_enc * enc_bytes + blocks_dec * dec_bytes).sum())
    return 3 * 2 * macs, nbytes


# ---------------------------------------------------------------------------
# The whole model
# ---------------------------------------------------------------------------


def trunk_macs(conf) -> float:
    """MMoE, both towers: per candidate or example."""
    n_in = (conf.feature_dimension + sum(s.dim for s in conf.embeddings)
            + conf.d_model * len(conf.attention_pairs))
    dims = (n_in,) + tuple(conf.hidden_bottom)
    experts = conf.num_experts * sum(a * b for a, b in zip(dims, dims[1:]))
    gates = 2 * n_in * conf.num_experts + 2 * conf.num_experts * dims[-1]
    tdims = (dims[-1],) + tuple(conf.hidden_task) + (1,)
    towers = 2 * sum(a * b for a, b in zip(tdims, tdims[1:]))
    return float(experts + gates + towers)


def bias_macs(conf) -> float:
    dims = ((sum(s.dim for s in conf.embeddings_bias),)
            + tuple(conf.hidden_bias) + (1,))
    return float(sum(a * b for a, b in zip(dims, dims[1:])))


def _stack_macs(conf, t):
    D, F = conf.d_model, conf.d_ff
    return (conf.blocks_encode * encoder_macs(t, D, F)
            + conf.blocks_decode * decoder_macs(t, D, F))


def group_lens(conf, batch_lens: dict) -> list:
    """Each sequence group's real lengths: its first user feature's."""
    return [np.asarray(batch_lens[g[0][0]]) for g in conf.attention_pairs]


def train_step_ops(conf, batch_lens: dict) -> float:
    """Operations of one training step over a batch whose id features have
    the given lengths (feature -> [B] array): 3x the forward of the
    pooling, the transformers, MMoE, the towers and the bias net."""
    B = len(next(iter(batch_lens.values())))
    macs = sum(float(_stack_macs(conf, t).sum())
               for t in group_lens(conf, batch_lens))
    pool = sum(float(np.asarray(batch_lens[s.feature]).sum()) * s.dim
               for s in conf.embeddings + conf.embeddings_bias)
    macs += pool + B * (trunk_macs(conf) + bias_macs(conf))
    return 3 * 2 * macs


def request_ops(conf, lens: dict, candidates: int) -> float:
    """Operations of the forward one request needs: the user's rows
    (encoders, the decoders' K and V, the pooling of the user's
    sequences) once, every per-candidate part once per candidate."""
    D, F = conf.d_model, conf.d_ff
    macs = 0.0
    for g in conf.attention_pairs:
        t = float(lens[g[0][0]])
        macs += (conf.blocks_encode * encoder_macs(t, D, F)
                 + conf.blocks_decode * (decoder_macs(t, D, F, q=False)
                                         + candidates
                                         * decoder_macs(t, D, F, kv=False)))
    for s in conf.embeddings:
        macs += (float(lens[s.feature]) * s.dim if s.side == "u"
                 else candidates * s.dim)
    macs += candidates * trunk_macs(conf)
    return 2 * float(macs)
