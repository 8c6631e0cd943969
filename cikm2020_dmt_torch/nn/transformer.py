"""Deep Interest Transformer: masked MHA encoder + single-query decoder.

Same contract as ``cikm2020_dmt_tpu/nn/transformer.py``:

- key mask: scores at absent key positions are set to -2^32+1 before the
  softmax, so a sequence with no present key attends uniformly over its T
  positions;
- query mask: probability rows of absent queries are zeroed after the
  softmax;
- inputs are scaled by sqrt(d_model), scores by 1/sqrt(d_head).

Which path launches which kernel (for tensors on the card; tensors on the
CPU take each kernel's plain PyTorch version):

- one encoder and one decoder block (the production shape):
  ``ops.block.fused_encode_decode``, the fused block kernels
  ``csrc/fused_block_fwd.cu`` and, in training, ``csrc/fused_block_bwd.cu``;
- any other block count: the per-op path below.  Its ``mha_apply`` runs
  the attention core through ``ops.attention.fused_attention`` (kernels
  ``csrc/attention_fwd.cu`` and, in training, ``csrc/attention_bwd.cu``)
  wherever dropout is off: inference, eval, and training at
  ``transformer_dropout_rate = 0``.  With dropout active in training it
  runs ``attention_core`` in plain PyTorch, as the reference does.

In training, dropout (rate semantics) hits the encoder and decoder inputs
and the attention probabilities: the fused path draws one kernel seed per
call from the caller's generator, the per-op path draws its masks from the
generator directly.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..core.config import TransformerConfig
from ..ops.attention import attention_probs, fused_attention, heads, merge
from ..ops.block import fused_encode_decode
from .layers import (Params, dense_apply, dense_init, dropout_rate,
                     glorot_uniform, layer_norm_apply, layer_norm_init)


def sincos_table(maxlen: int, dim: int) -> np.ndarray:
    """angle(pos, i) = pos / 10000^((i - i%2)/dim); sin on even, cos on odd
    columns."""
    pos = np.arange(maxlen)[:, None].astype(np.float64)
    i = np.arange(dim)[None, :].astype(np.float64)
    angle = pos / np.power(10000.0, (i - i % 2) / dim)
    table = np.zeros((maxlen, dim), np.float64)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table.astype(np.float32)


# ---------------------------------------------------------------------------
# Multi-head attention
# ---------------------------------------------------------------------------


def mha_init(gen: torch.Generator, d_model: int, dtype=torch.float32) -> Params:
    g = glorot_uniform()
    return {
        "q": dense_init(gen, d_model, d_model, w_init=g, dtype=dtype),
        "k": dense_init(gen, d_model, d_model, w_init=g, dtype=dtype),
        "v": dense_init(gen, d_model, d_model, w_init=g, dtype=dtype),
        "ln": layer_norm_init(gen, d_model, dtype),
    }


def attention_core(q, k, v, q_mask, k_mask, num_heads: int, *,
                   dropout: float, gen: torch.Generator) -> torch.Tensor:
    """Masked scaled-dot-product attention over projected q/k/v with
    probability dropout: the core of training with dropout active.

    q: [B, Tq, D]; k, v: [B, Tk, D]; masks: [B, T] (1 = present).
    Returns [B, Tq, D].  The probabilities are the attention kernel's plain
    version's (``ops.attention.attention_probs``), in the operands' type,
    dropped out before ``P v``."""
    probs = attention_probs(heads(q, num_heads), heads(k, num_heads), k_mask)
    probs = probs * q_mask[:, None, :, None].to(probs.dtype)
    probs = dropout_rate(gen, probs, dropout)
    return merge(probs @ heads(v, num_heads))


def mha_apply(params: Params, queries, keys, values, q_mask, k_mask, *,
              num_heads: int, dropout: float = 0.0, train: bool = False,
              gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """Projection -> attention -> residual -> LN.  The attention core is
    the kernel (``ops.attention.fused_attention``) unless dropout is on,
    as in the reference (``nn/transformer.py`` ``_use_fused_kernel``)."""
    q = dense_apply(params["q"], queries)
    k = dense_apply(params["k"], keys)
    v = dense_apply(params["v"], values)
    if train and dropout > 0.0 and gen is not None:
        out = attention_core(q, k, v, q_mask, k_mask, num_heads,
                             dropout=dropout, gen=gen)
    else:
        out = fused_attention(q, k, v, q_mask, k_mask, num_heads)
    return layer_norm_apply(params["ln"], out + queries)


def ff_init(gen: torch.Generator, d_model: int, d_ff: int,
            dtype=torch.float32) -> Params:
    g = glorot_uniform()
    return {
        "fc1": dense_init(gen, d_model, d_ff, w_init=g, dtype=dtype),
        "fc2": dense_init(gen, d_ff, d_model, w_init=g, dtype=dtype),
        "ln": layer_norm_init(gen, d_model, dtype),
    }


def ff_apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Position-wise FFN (relu) + residual + LN."""
    y = torch.relu(dense_apply(params["fc1"], x))
    y = dense_apply(params["fc2"], y)
    return layer_norm_apply(params["ln"], y + x)


# ---------------------------------------------------------------------------
# Encoder / decoder
# ---------------------------------------------------------------------------


def transformer_init(gen: torch.Generator, tc: TransformerConfig, *,
                     ts_dim: int = 0, in_dim: int = 0,
                     dtype=torch.float32) -> Params:
    """Params for one behavior-sequence transformer (the reference tree)."""
    params: Params = {}
    g = glorot_uniform()
    if tc.position_encoding_method == "position_learn":
        params["pos_learn"] = g(gen, (tc.maxlen_k, tc.d_model), dtype)
    if tc.position_encoding_method in ("time_add", "time_concat") and ts_dim:
        src = (ts_dim if tc.position_encoding_method == "time_add"
               else tc.d_model + ts_dim)
        params["ts_proj"] = dense_init(gen, src, tc.d_model, w_init=g,
                                       dtype=dtype)
    if tc.is_trans_input_by_mlp and in_dim:
        params["in_seq"] = dense_init(gen, in_dim, tc.d_model, w_init=g,
                                      dtype=dtype)
        params["in_tar"] = dense_init(gen, in_dim, tc.d_model, w_init=g,
                                      dtype=dtype)
    if tc.is_trans_out_concat_item and tc.is_trans_out_by_mlp:
        out_in = tc.d_model + (tc.d_model if tc.is_trans_input_by_mlp
                               or not in_dim else in_dim)
        params["out_proj"] = dense_init(gen, out_in, tc.d_model, w_init=g,
                                        dtype=dtype)
    params["enc"] = [
        {"mha": mha_init(gen, tc.d_model, dtype),
         "ff": ff_init(gen, tc.d_model, tc.d_ff, dtype)}
        for _ in range(tc.num_blocks_encode)]
    params["dec"] = [
        {"mha": mha_init(gen, tc.d_model, dtype),
         "ff": ff_init(gen, tc.d_model, tc.d_ff, dtype)}
        for _ in range(tc.num_blocks_decode)]
    return params


def _position_encode(params: Params, tc: TransformerConfig,
                     seq: torch.Tensor,
                     ts_emb: Optional[torch.Tensor]) -> torch.Tensor:
    """Adds (or mixes in) the position signal: sin/cos table, learned
    table, projected time embedding, or time concat + projection."""
    T = seq.shape[1]
    method = tc.position_encoding_method
    if method == "position_sin_cos":
        table = torch.as_tensor(sincos_table(tc.maxlen_k, tc.d_model),
                                dtype=seq.dtype, device=seq.device)
        seq = seq + table[:T][None]
    elif method == "position_learn":
        seq = seq + params["pos_learn"][:T][None].to(seq.dtype)
    elif method == "time_add" and ts_emb is not None and "ts_proj" in params:
        seq = seq + dense_apply(params["ts_proj"], ts_emb)
    elif (method == "time_concat" and ts_emb is not None
          and "ts_proj" in params):
        seq = dense_apply(params["ts_proj"], torch.cat([seq, ts_emb], dim=-1))
    return seq


def encode_decode(params: Params, tc: TransformerConfig, *,
                  seq_emb: torch.Tensor,       # [B, Tk, d_model]
                  seq_mask: torch.Tensor,      # [B, Tk] 1 = present
                  tar_emb: torch.Tensor,       # [B, d_model]
                  ts_emb: Optional[torch.Tensor] = None,
                  train: bool = False,
                  gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """Encode the behavior sequence, decode the target against it; returns
    the user-interest state [B, d_model].  ``train`` turns dropout on;
    its randomness comes from ``gen`` (on the inputs' device)."""
    drop = train and tc.dropout_rate > 0.0 and gen is not None
    # the reference's weak-typed Python scalar takes the inputs' type
    scale = float(torch.tensor(math.sqrt(tc.d_model), dtype=seq_emb.dtype))
    enc = _position_encode(params, tc, seq_emb * scale, ts_emb)
    dec = tar_emb * scale
    if tc.is_decoder_add_pos_emb:
        table = torch.as_tensor(sincos_table(tc.maxlen_q, tc.d_model),
                                dtype=dec.dtype, device=dec.device)
        dec = dec + table[0][None]
    if len(params["enc"]) == 1 and len(params["dec"]) == 1:
        seed = (torch.randint(0, 2 ** 31 - 1, (1,), generator=gen,
                              device=gen.device, dtype=torch.int32)
                if drop else None)
        return fused_encode_decode(params["enc"][0], params["dec"][0],
                                   enc_in=enc, dec_in=dec, seq_mask=seq_mask,
                                   num_heads=tc.num_heads, train=drop,
                                   rate=tc.dropout_rate, seed=seed)
    rate = tc.dropout_rate if drop else 0.0
    if drop:
        enc = dropout_rate(gen, enc, rate)
    for block in params["enc"]:
        enc = mha_apply(block["mha"], enc, enc, enc, seq_mask, seq_mask,
                        num_heads=tc.num_heads, dropout=rate, train=drop,
                        gen=gen)
        enc = ff_apply(block["ff"], enc)
    dec = dec[:, None, :]
    if drop:
        dec = dropout_rate(gen, dec, rate)
    q_mask = torch.ones((dec.shape[0], 1), dtype=dec.dtype, device=dec.device)
    for block in params["dec"]:
        dec = mha_apply(block["mha"], dec, enc, enc, q_mask, seq_mask,
                        num_heads=tc.num_heads, dropout=rate, train=drop,
                        gen=gen)
        dec = ff_apply(block["ff"], dec)
    return dec[:, 0, :]
