"""The paper baselines (``cikm2020_dmt_tpu/models/baselines.py``): LR,
Wide & Deep, DCN, DIN and DIEN, each a single-logit model ``y [B, 1]``.

- ``lr``: one dense layer over the combiner's output;
- ``wnd``: a dense layer over the dense features (whatever
  ``is_use_feature`` says) plus an MLP over the combiner's output;
- ``dcn``: three cross layers ``x0 * (x . w) + b + x`` beside an MLP
  without an output layer, then one dense layer over ``[x | deep]``;
- ``din``: per behavior group a scoring MLP 40/20/1 (sigmoid, sigmoid,
  identity; bias 0.1) over ``[u, t, u - t, u * t]``, divided by
  ``sqrt(D)``; the raw scores (no softmax) become the weights of the
  group's user features, and every pooled feature pools with the "sum"
  combiner;
- ``dien``: per group a GRU(16) over the behaviors, a masked-softmax
  attention of the target over its states, and an attention-update GRU
  whose final state joins the MLP's input; the combiner leaves out the
  groups' user features.

The GRUs follow TF's GRUCell: one kernel over ``[x | h]`` gives the reset
and update gates (bias 1), the candidate reads ``[x | r * h]``, the new
state is ``u * h + (1 - u) * c``; the attention-update GRU scales
``u <- (1 - a) * u`` first.  Padded steps keep the previous state.  The
scans are plain loops over the sequence.

Params have the JAX package's trees, so ``convert.py`` carries a JAX init
across; the values of a fresh init differ (another generator)."""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..nn.layers import (Params, State, batchnorm_apply, dense_apply,
                         dense_init, dense_layer_init, glorot_uniform,
                         mlp_init)
from .base import BaseModel
from .components import (combiner_dim, embedding_combiner, group_embeddings,
                         seq_input_dim)

NEG_INF = -(2.0 ** 32) + 1      # masked attention scores (DIEN)
DIN_ATTENTION_UNITS = (40, 20)
DIEN_ATTENTION_UNITS = (80, 40)


class LR(BaseModel):
    """Logistic regression over [dense | pooled embeddings]."""

    name = "lr"

    def init(self, gen):
        return {"emb": self._emb_init(gen),
                "linear": dense_init(gen, combiner_dim(self.cfg), 1,
                                     bias_init=0.0, dtype=self.dtype)}

    def forward(self, params, state, batch, *, train, gen, is_predict):
        x = embedding_combiner(params["emb"], batch, self.cfg,
                               engine=self.engine).to(self.compute_dtype)
        return dense_apply(params["linear"], x).float(), {}


class WideAndDeep(BaseModel):
    """A linear wide part on the dense features plus a deep MLP on the
    combiner's output."""

    name = "wnd"

    def init(self, gen):
        cfg = self.cfg
        return {"emb": self._emb_init(gen),
                "wide": dense_init(gen, cfg.feature_dimension, 1,
                                   bias_init=0.0, dtype=self.dtype),
                "deep": mlp_init(gen, combiner_dim(cfg), cfg.hidden_units,
                                 cfg.output_units, is_bn=cfg.is_bn,
                                 out_bias_init=0.0, dtype=self.dtype)}

    def forward(self, params, state, batch, *, train, gen, is_predict):
        cd = self.compute_dtype
        x = embedding_combiner(params["emb"], batch, self.cfg,
                               engine=self.engine).to(cd)
        deep, st = self._mlp(params["deep"], state.get("deep", {}), x,
                             self.cfg.dropout, train, gen)
        wide = dense_apply(params["wide"], batch["features"].to(cd))
        return (deep + wide).float(), ({"deep": st} if st else {})


class DCN(BaseModel):
    """Deep & Cross: explicit cross layers beside a deep MLP."""

    name = "dcn"
    num_cross_layers = 3

    def init(self, gen):
        cfg = self.cfg
        dim = combiner_dim(cfg)
        g = glorot_uniform()
        return {
            "emb": self._emb_init(gen),
            "deep": mlp_init(gen, dim, cfg.hidden_units, None,
                             is_bn=cfg.is_bn, dtype=self.dtype),
            "cross": [{"w": g(gen, (dim, 1), self.dtype),
                       "b": torch.zeros((dim,), dtype=self.dtype,
                                        device=gen.device)}
                      for _ in range(self.num_cross_layers)],
            "out": dense_init(gen, dim + cfg.hidden_units[-1], 1,
                              bias_init=0.0, dtype=self.dtype),
        }

    def forward(self, params, state, batch, *, train, gen, is_predict):
        x0 = embedding_combiner(params["emb"], batch, self.cfg,
                                engine=self.engine).to(self.compute_dtype)
        x = x0
        for layer in params["cross"]:
            xw = x @ layer["w"].to(x.dtype)                      # [B, 1]
            x = x0 * xw + layer["b"].to(x.dtype) + x
        deep, st = self._mlp(params["deep"], state.get("deep", {}), x0,
                             self.cfg.dropout, train, gen)
        y = dense_apply(params["out"], torch.cat([x, deep], dim=-1))
        return y.float(), ({"deep": st} if st else {})


# ---------------------------------------------------------------------------
# DIN
# ---------------------------------------------------------------------------


def din_attention_init(gen: torch.Generator, dim: int, *,
                       is_bn: bool = False, dtype=torch.float32) -> Params:
    """The local activation unit: dense layers 4 dim -> 40 -> 20 -> 1,
    bias 0.1, each with a batch norm under ``is_bn``."""
    sizes = (4 * dim,) + DIN_ATTENTION_UNITS + (1,)
    return {f"layer{i}": dense_layer_init(gen, sizes[i], sizes[i + 1],
                                          bias_init=0.1, is_bn=is_bn,
                                          dtype=dtype)
            for i in range(3)}


def din_attention_scores(params: Params, state: State, seq: torch.Tensor,
                         tar: torch.Tensor, *, train: bool,
                         is_bn: bool = False, bn_decay: float = 0.999
                         ) -> tuple[torch.Tensor, State]:
    """Raw (not softmaxed) scores [B, L] of ``seq`` [B, L, D] against
    ``tar`` [B, D], divided by sqrt(D) in their dtype, and the new state.
    Padded positions are scored too (the pooling's presence mask drops
    them), so under ``is_bn`` they enter the batch statistics, as in the
    JAX package."""
    B, L, D = seq.shape
    t = tar[:, None, :].expand(B, L, D)
    y = torch.cat([seq, t, seq - t, seq * t], dim=-1).reshape(B * L, 4 * D)
    acts: tuple[Callable, ...] = (torch.sigmoid, torch.sigmoid,
                                  lambda v: v)
    new_state: State = {}
    for i, act in enumerate(acts):
        p = params[f"layer{i}"]
        y = dense_apply(p["dense"], y)
        if is_bn:
            y, new_state[f"layer{i}"] = batchnorm_apply(
                p["bn"], state[f"layer{i}"], y, train=train, decay=bn_decay)
        y = act(y)
    scale = torch.sqrt(torch.tensor(float(D), dtype=y.dtype,
                                    device=y.device))
    return y.reshape(B, L) / scale, new_state


class DIN(BaseModel):
    """Deep Interest Network: the attention scores weight the groups' user
    features, and every feature pools with the "sum" combiner into the
    MLP's input; the pooled features of the groups read the grids the
    scoring gathered."""

    name = "din"

    def init(self, gen):
        cfg = self.cfg
        params = {"emb": self._emb_init(gen)}
        for gi in range(len(cfg.attention_pairs)):
            params[f"attn{gi}"] = din_attention_init(
                gen, seq_input_dim(cfg, gi), is_bn=cfg.is_bn,
                dtype=self.dtype)
        params["mlp"] = mlp_init(gen, combiner_dim(cfg), cfg.hidden_units,
                                 cfg.output_units, is_bn=cfg.is_bn,
                                 out_bias_init=0.0, dtype=self.dtype)
        return params

    def forward(self, params, state, batch, *, train, gen, is_predict):
        cfg, cd = self.cfg, self.compute_dtype
        new_state: State = {}
        wts_override: dict = {}
        cache: dict = {}
        for gi, group in enumerate(cfg.attention_pairs):
            seq, tar, _ = group_embeddings(params["emb"], batch, cfg, gi,
                                           self.engine, cache)
            y, st = din_attention_scores(
                params[f"attn{gi}"], state.get(f"attn{gi}", {}), seq.to(cd),
                tar.to(cd), train=train, is_bn=cfg.is_bn,
                bn_decay=cfg.bn_decay)
            if st:
                new_state[f"attn{gi}"] = st
            for user_feat, _ in group:
                wts_override[user_feat] = y.float()
        x = embedding_combiner(params["emb"], batch, cfg, engine=self.engine,
                               combiner="sum", wts_override=wts_override,
                               seq_cache=cache).to(cd)
        y, st = self._mlp(params["mlp"], state.get("mlp", {}), x,
                          cfg.dropout, train, gen)
        if st:
            new_state["mlp"] = st
        return y.float(), new_state


# ---------------------------------------------------------------------------
# DIEN
# ---------------------------------------------------------------------------


def gru_init(gen: torch.Generator, in_dim: int, hidden: int,
             dtype=torch.float32) -> Params:
    """TF GRUCell's layout: ``gates`` [in + H, 2H] (r, then u; bias 1),
    ``cand`` [in + H, H] (bias 0), glorot kernels."""
    g = glorot_uniform()
    return {
        "gates": {"w": g(gen, (in_dim + hidden, 2 * hidden), dtype),
                  "b": torch.ones((2 * hidden,), dtype=dtype,
                                  device=gen.device)},
        "cand": {"w": g(gen, (in_dim + hidden, hidden), dtype),
                 "b": torch.zeros((hidden,), dtype=dtype,
                                  device=gen.device)},
    }


def _gru_cell(params: Params, h: torch.Tensor, x: torch.Tensor,
              att_score: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One GRU step; with ``att_score`` [B] the attention-update GRU's."""
    ru = torch.sigmoid(dense_apply(params["gates"], torch.cat([x, h], -1)))
    r, u = ru.chunk(2, dim=-1)
    c = torch.tanh(dense_apply(params["cand"], torch.cat([x, r * h], -1)))
    if att_score is not None:
        u = (1.0 - att_score[:, None]) * u
    return u * h + (1.0 - u) * c


def gru_scan(params: Params, seq: torch.Tensor, mask: torch.Tensor,
             update_scales: Optional[torch.Tensor] = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The (attention-update) GRU over ``seq`` [B, L, D] from a zero
    state: (final state [B, H], every state [B, L, H]); a step whose mask
    is 0 keeps the previous state."""
    B, L, _ = seq.shape
    params = {k: {n: t.to(seq.dtype) for n, t in v.items()}
              for k, v in params.items()}
    h = seq.new_zeros((B, params["cand"]["w"].shape[1]))
    states = []
    for t in range(L):
        a = None if update_scales is None else update_scales[:, t]
        h = torch.where(mask[:, t, None] > 0,
                        _gru_cell(params, h, seq[:, t], a), h)
        states.append(h)
    return h, torch.stack(states, dim=1)


def prelu_init(dim: int, dtype=torch.float32,
               device: Optional[torch.device] = None) -> Params:
    """Per-channel alpha, 0.1."""
    return {"alpha": torch.full((dim,), 0.1, dtype=dtype, device=device)}


def prelu_apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    """``max(0, x) + alpha * min(0, x)`` (at x = 0 the gradient splits
    evenly between the branches, as in JAX)."""
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return (torch.maximum(zero, x)
            + params["alpha"].to(x.dtype) * torch.minimum(zero, x))


def dien_attention_init(gen: torch.Generator, q_dim: int, h: int,
                        dtype=torch.float32) -> Params:
    """The query projection ``f1`` (q_dim -> h) with a prelu, then the
    [q, f, q - f, q * f] MLP 80 sigmoid -> 40 sigmoid -> 1; glorot
    kernels, zero biases."""
    g = glorot_uniform()
    sizes = (4 * h,) + DIEN_ATTENTION_UNITS + (1,)
    params: Params = {
        "f1": dense_init(gen, q_dim, h, w_init=g, bias_init=0.0,
                         dtype=dtype),
        "prelu": prelu_init(h, dtype, gen.device),
    }
    for i in range(3):
        params[f"att{i}"] = dense_init(gen, sizes[i], sizes[i + 1],
                                       w_init=g, bias_init=0.0, dtype=dtype)
    return params


def dien_attention_apply(params: Params, query: torch.Tensor,
                         facts: torch.Tensor, mask: torch.Tensor
                         ) -> torch.Tensor:
    """Softmax attention weights [B, L] of ``query`` [B, Dq] over
    ``facts`` [B, L, H]: masked scores are ``NEG_INF`` and the softmax is
    not masked again, so a row with no present step weighs its L steps
    uniformly."""
    B, L, H = facts.shape
    q = prelu_apply(params["prelu"], dense_apply(params["f1"], query))
    qs = q[:, None, :].expand(B, L, H)
    y = torch.cat([qs, facts, qs - facts, qs * facts],
                  dim=-1).reshape(B * L, 4 * H)
    y = torch.sigmoid(dense_apply(params["att0"], y))
    y = torch.sigmoid(dense_apply(params["att1"], y))
    y = dense_apply(params["att2"], y).reshape(B, L)
    scores = torch.where(mask > 0, y, y.new_tensor(NEG_INF))
    return torch.softmax(scores, dim=-1)


class DIEN(BaseModel):
    """Deep Interest Evolution Network: per group the interest-extraction
    GRU, the attention of the target over its states and the
    attention-update GRU, whose final state joins [dense | pooled
    features without the groups' user features]."""

    name = "dien"
    hidden_size = 16

    def _input_dim(self) -> int:
        return (combiner_dim(self.cfg, skip_seq=True)
                + self.hidden_size * len(self.cfg.attention_pairs))

    def init(self, gen):
        cfg, h = self.cfg, self.hidden_size
        params = {"emb": self._emb_init(gen)}
        for gi in range(len(cfg.attention_pairs)):
            d = seq_input_dim(cfg, gi)
            params[f"gru{gi}"] = gru_init(gen, d, h, self.dtype)
            params[f"augru{gi}"] = gru_init(gen, h, h, self.dtype)
            params[f"attn{gi}"] = dien_attention_init(gen, d, h, self.dtype)
        params["mlp"] = mlp_init(gen, self._input_dim(), cfg.hidden_units,
                                 cfg.output_units, is_bn=cfg.is_bn,
                                 out_bias_init=0.0, dtype=self.dtype)
        return params

    def forward(self, params, state, batch, *, train, gen, is_predict):
        cfg, cd = self.cfg, self.compute_dtype
        cache: dict = {}
        groups = [group_embeddings(params["emb"], batch, cfg, gi,
                                   self.engine, cache)
                  for gi in range(len(cfg.attention_pairs))]
        # the item features pool from the groups' grids
        parts = [embedding_combiner(params["emb"], batch, cfg, skip_seq=True,
                                    engine=self.engine,
                                    seq_cache=cache).to(cd)]
        for gi, (seq, tar, mask) in enumerate(groups):
            _, states = gru_scan(params[f"gru{gi}"], seq.to(cd), mask)
            alphas = dien_attention_apply(params[f"attn{gi}"], tar.to(cd),
                                          states, mask)
            h, _ = gru_scan(params[f"augru{gi}"], states, mask,
                            update_scales=alphas)
            parts.append(h)
        y, st = self._mlp(params["mlp"], state.get("mlp", {}),
                          torch.cat(parts, dim=-1), cfg.dropout, train, gen)
        return y.float(), ({"mlp": st} if st else {})
