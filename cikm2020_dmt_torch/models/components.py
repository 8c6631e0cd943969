"""Shared model components: feature combiner, behavior-sequence interest,
MMoE, task towers and the bias net
(``cikm2020_dmt_tpu/models/components.py``).  ``train`` turns dropout on
and batch norm's batch statistics; dropout's randomness comes from the
caller's ``torch.Generator``.  Components with batch norm take and return
their part of the model's state tree (``nn/layers.bn_state``)."""

from __future__ import annotations

from typing import Optional

import torch

from ..core.config import DMTConfig
from ..data.pipeline import IDS, LEN, WTS
from ..nn.embedding import (collection_init, pooled_from_grid, presence_mask,
                            ts_bucketize)
from ..nn.layers import (Params, State, dense_apply, dense_init,
                         dropout_keep, dropout_rate, glorot_uniform,
                         mlp_apply, mlp_init)
from ..nn.transformer import encode_decode, transformer_init
from ..parallel.embedding_shard import DENSE_ENGINE, EmbeddingEngine


def feature_wts(batch: dict, feature: str, ids) -> torch.Tensor:
    """Per-id weights; a presence mask from the lengths when the batch
    carries none."""
    wts = batch.get(feature + WTS)
    if wts is not None:
        return wts
    pos = torch.arange(ids.shape[-1], device=ids.device)
    return (pos < batch[feature + LEN][..., None]).to(torch.float32)


# ---------------------------------------------------------------------------
# Pooled feature combiner
# ---------------------------------------------------------------------------


def _attention_user_features(cfg: DMTConfig) -> frozenset:
    return frozenset(user for group in cfg.attention_pairs
                     for user, _ in group)


def combiner_dim(cfg: DMTConfig, skip_seq: bool = False) -> int:
    dim = cfg.feature_dimension if cfg.is_use_feature else 0
    skip = _attention_user_features(cfg) if skip_seq else frozenset()
    dim += sum(spec.dim for spec in cfg.embeddings
               if spec.feature not in skip)
    for a, _ in cfg.sim_embed:
        spec = next(s for s in cfg.embeddings if s.feature == a)
        dim += 2 + 2 * spec.dim  # inner + cosine + |diff| + diff^2
    return dim


def embedding_combiner(emb: Params, batch: dict, cfg: DMTConfig, *,
                       skip_seq: bool = False,
                       engine: EmbeddingEngine = DENSE_ENGINE,
                       seq_cache: Optional[dict] = None,
                       combiner: str = "mean",
                       wts_override: Optional[dict] = None) -> torch.Tensor:
    """[dense features | pooled embedding per spec | sim crosses].

    Features found in ``seq_cache`` (the raw grids ``sequence_interest``
    or DIN/DIEN gathered) pool from the cached grid instead of gathering
    again.  ``skip_seq`` leaves out the attention-pairs' user (sequence)
    features, as the single-sequence ``transformer`` model does; the item
    features still pool.  ``combiner`` ("mean" or "sum") applies to every
    pooled feature; ``wts_override`` (feature -> [B, L] weights) replaces
    a feature's own weights, padded slots still dropped by the presence
    mask: DIN pools with "sum" and its raw attention scores as the
    attention-pair user features' weights."""
    parts = []
    if cfg.is_use_feature:
        parts.append(batch["features"])
    skip = _attention_user_features(cfg) if skip_seq else frozenset()
    ts_feats = frozenset(cfg.attention_ts)
    sim_wanted = frozenset(x for pair in cfg.sim_embed for x in pair)
    sim_pool: dict[str, torch.Tensor] = {}
    for spec in cfg.embeddings:
        if spec.feature in skip:
            continue
        ids = batch[spec.feature + IDS]
        if spec.feature in ts_feats:
            ids = ts_bucketize(ids, spec.id_size)
        if wts_override and spec.feature in wts_override:
            wts = wts_override[spec.feature]
        else:
            wts = feature_wts(batch, spec.feature, ids)
        lens = batch[spec.feature + LEN]
        if seq_cache is not None and spec.feature in seq_cache:
            pooled = pooled_from_grid(seq_cache[spec.feature], wts, lens,
                                      combiner)
        else:
            pooled = engine.pooled(spec.table, emb[spec.table], ids, wts,
                                   lens, feature=spec.feature,
                                   combiner=combiner)
        if spec.feature in sim_wanted:
            sim_pool[spec.feature] = pooled
        parts.append(pooled)
    out = torch.cat(parts, dim=-1) if len(parts) > 1 else parts[0]
    for a, b in cfg.sim_embed:
        ea, eb = sim_pool[a], sim_pool[b]
        inner = (ea * eb).sum(dim=1, keepdim=True)
        norms = torch.linalg.norm(ea, dim=1) * torch.linalg.norm(eb, dim=1)
        cosine = inner / norms[:, None].clamp(min=1e-12)
        diff = (ea - eb).abs()
        out = torch.cat([out, inner, cosine, diff, diff * diff], dim=-1)
    return out


# ---------------------------------------------------------------------------
# Behavior sequences -> interest states
# ---------------------------------------------------------------------------


def seq_input_dim(cfg: DMTConfig, group_idx: int) -> int:
    spec_of = {s.feature: s for s in cfg.embeddings}
    return sum(spec_of[u].dim for u, _ in cfg.attention_pairs[group_idx])


def ts_dim_of(cfg: DMTConfig, group_idx: int) -> int:
    if not cfg.is_use_seq_ts or group_idx >= len(cfg.attention_ts):
        return 0
    spec = {s.feature: s for s in cfg.embeddings}.get(
        cfg.attention_ts[group_idx])
    return spec.dim if spec else 0


def interest_dim(cfg: DMTConfig) -> int:
    tc = cfg.transformer
    per = tc.d_model
    if tc.is_trans_out_concat_item and not tc.is_trans_out_by_mlp:
        per = tc.d_model + (tc.d_model if tc.is_trans_input_by_mlp
                            else seq_input_dim(cfg, 0))
    return per * len(cfg.attention_pairs)


def sequences_init(gen: torch.Generator, cfg: DMTConfig,
                   dtype=torch.float32) -> Params:
    return {f"seq{i}": transformer_init(gen, cfg.transformer,
                                        ts_dim=ts_dim_of(cfg, i),
                                        in_dim=seq_input_dim(cfg, i),
                                        dtype=dtype)
            for i in range(len(cfg.attention_pairs))}


def zero_pad_rows(ids: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    """Zero the rows whose id is 0 (padding / 'unknow')."""
    return torch.where((ids > 0)[..., None], emb,
                       torch.zeros((), dtype=emb.dtype, device=emb.device))


def group_embeddings(emb: Params, batch: dict, cfg: DMTConfig, gi: int,
                     engine: EmbeddingEngine, cache: dict
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(seq [B, L, D], target [B, D], mask [B, L]) of behavior group
    ``gi``: the concat of its user features' rows and of its single-id item
    features' rows, zero-padded where ``cfg.zero_pad``, and the presence
    mask of its first user feature.  Each lookup names its feature (the
    lazy overlay slices by feature), and ``cache`` collects the raw (not
    zero-padded) grids by feature for the pooled combiner to reuse."""
    spec_of = {s.feature: s for s in cfg.embeddings}
    group = cfg.attention_pairs[gi]
    first_user = group[0][0]
    wts = feature_wts(batch, first_user, batch[first_user + IDS])
    mask = presence_mask(wts, batch[first_user + LEN])
    seq_parts, tar_parts = [], []
    for user_feat, item_feat in group:
        for feat, parts in ((user_feat, seq_parts), (item_feat, tar_parts)):
            spec, ids = spec_of[feat], batch[feat + IDS]
            raw = engine.seq(spec.table, emb[spec.table], ids, feature=feat)
            cache[feat] = raw
            parts.append(zero_pad_rows(ids, raw) if cfg.zero_pad else raw)
    return (torch.cat(seq_parts, dim=-1),
            torch.cat([t[:, 0, :] for t in tar_parts], dim=-1), mask)


def sequence_interest(params: Params, emb: Params, batch: dict,
                      cfg: DMTConfig, *,
                      engine: EmbeddingEngine = DENSE_ENGINE,
                      dtype: Optional[torch.dtype] = None,
                      train: bool = False,
                      gen: Optional[torch.Generator] = None
                      ) -> tuple[torch.Tensor, dict]:
    """Concat of per-sequence user-interest states [B, n_seq * d_model],
    and the raw (not zero-padded) gathered grids by feature, which the
    pooled combiner reuses."""
    spec_of = {s.feature: s for s in cfg.embeddings}
    tc = cfg.transformer
    states = []
    cache: dict[str, torch.Tensor] = {}
    for gi in range(len(cfg.attention_pairs)):
        seq_emb, tar_emb, mask = group_embeddings(emb, batch, cfg, gi,
                                                  engine, cache)
        if dtype is not None:
            seq_emb, tar_emb = seq_emb.to(dtype), tar_emb.to(dtype)

        ts_emb = None
        if cfg.is_use_seq_ts and gi < len(cfg.attention_ts):
            ts_feat = cfg.attention_ts[gi]
            tspec = spec_of.get(ts_feat)
            if tspec is not None:
                buckets = ts_bucketize(batch[ts_feat + IDS], tspec.id_size)
                raw_ts = engine.seq(tspec.table, emb[tspec.table], buckets,
                                    feature=ts_feat)
                cache[ts_feat] = raw_ts
                ts_emb = (zero_pad_rows(buckets, raw_ts) if cfg.zero_pad
                          else raw_ts)
                if dtype is not None:
                    ts_emb = ts_emb.to(dtype)

        p = params[f"seq{gi}"]
        if tc.is_trans_input_by_mlp:
            seq_emb = dense_apply(p["in_seq"], seq_emb)
            tar_in = dense_apply(p["in_tar"], tar_emb)
        else:
            tar_in = tar_emb
        state = encode_decode(p, tc, seq_emb=seq_emb, seq_mask=mask,
                              tar_emb=tar_in, ts_emb=ts_emb, train=train,
                              gen=gen)
        if tc.is_trans_out_concat_item:
            state = torch.cat([state, tar_in], dim=-1)
            if tc.is_trans_out_by_mlp:
                state = dense_apply(p["out_proj"], state)
        states.append(state)
    return torch.cat(states, dim=-1), cache


# ---------------------------------------------------------------------------
# MMoE and task towers
# ---------------------------------------------------------------------------


def mmoe_init(gen: torch.Generator, in_dim: int, cfg: DMTConfig,
              num_tasks: int = 2, dtype=torch.float32) -> Params:
    return {
        "experts": [mlp_init(gen, in_dim, cfg.hidden_units_bottom, None,
                             is_bn=cfg.is_bn, dtype=dtype)
                    for _ in range(cfg.num_experts)],
        "gates": [dense_init(gen, in_dim, cfg.num_experts, bias_init=0.1,
                             dtype=dtype) for _ in range(num_tasks)],
    }


def _mmoe_stacked(params: Params, x: torch.Tensor, cfg: DMTConfig, *,
                  train: bool, gen: Optional[torch.Generator]
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """All experts in batched matmuls (layer 0 as one [in, E * H0]
    product, deeper layers batched over the expert axis), both gates in
    one product: (experts [B, H, E], gate logits [B, T, E])."""
    experts = params["experts"]
    E = len(experts)

    def maybe_dropout(y, i):
        kp = cfg.dropout_bottom[i] if i < len(cfg.dropout_bottom) else 1.0
        if cfg.is_dropout and train and kp < 1.0:
            return dropout_keep(gen, y, kp)
        return y

    w0 = torch.cat([p["layer0"]["dense"]["w"] for p in experts], dim=1)
    b0 = torch.cat([p["layer0"]["dense"]["b"] for p in experts])
    y = torch.relu(x @ w0.to(x.dtype) + b0.to(x.dtype))
    y = maybe_dropout(y.reshape(x.shape[0], E, -1), 0)     # [B, E, H0]
    n_layers = sum(1 for k in experts[0] if k.startswith("layer"))
    for i in range(1, n_layers):
        wi = torch.stack([p[f"layer{i}"]["dense"]["w"] for p in experts])
        bi = torch.stack([p[f"layer{i}"]["dense"]["b"] for p in experts])
        y = maybe_dropout(torch.relu(
            torch.einsum("beh,ehk->bek", y, wi.to(y.dtype))
            + bi[None].to(y.dtype)), i)
    gates = params["gates"]
    wg = torch.cat([g["w"] for g in gates], dim=1)
    bg = torch.cat([g["b"] for g in gates])
    gz = (x @ wg.to(x.dtype) + bg.to(x.dtype)).reshape(x.shape[0],
                                                        len(gates), E)
    return y.transpose(1, 2), gz


def mmoe_apply(params: Params, state: State, x: torch.Tensor,
               cfg: DMTConfig, *, train: bool = False,
               gen: Optional[torch.Generator] = None,
               return_gates: bool = False):
    """Per-task mixtures [B, hidden_bottom[-1]] and the new state.  In
    training with ``is_dropout``, expert layer i keeps with
    ``dropout_bottom[i]``.  Without batch norm all experts run in batched
    matmuls and both gates in one product; with it (the experts' moving
    statistics) each expert is its own MLP and each gate its own product,
    as in the reference.  With ``return_gates`` a third value: the
    per-task gate softmax [T, B, E], taken in float32 of the same gate
    products (JAX ``MMoE.gate_values``)."""
    if not cfg.is_bn:
        experts_out, gz = _mmoe_stacked(params, x, cfg, train=train,
                                        gen=gen)
        mix = torch.softmax(gz, dim=-1).unbind(1)          # T x [B, E]
        new_state: State = {}
    else:
        outs, est = [], []
        states = state.get("experts", [{}] * len(params["experts"]))
        for p, st in zip(params["experts"], states):
            y, st = mlp_apply(p, st, x, keep_probs=cfg.dropout_bottom,
                              train=train, is_bn=True,
                              is_dropout=cfg.is_dropout,
                              bn_decay=cfg.bn_decay, gen=gen)
            outs.append(y)
            est.append(st)
        experts_out = torch.stack(outs, dim=-1)            # [B, H, E]
        gz = torch.stack([dense_apply(g, x) for g in params["gates"]],
                         dim=1)                            # [B, T, E]
        mix = [torch.softmax(gz[:, t], dim=-1) for t in range(gz.shape[1])]
        new_state = {"experts": est}
    outs = [torch.einsum("bhe,be->bh", experts_out, m) for m in mix]
    if return_gates:
        return (outs, new_state,
                torch.softmax(gz.float(), dim=-1).transpose(0, 1))
    return outs, new_state


def tower_init(gen: torch.Generator, in_dim: int, cfg: DMTConfig,
               dtype=torch.float32) -> Params:
    """hidden_units_task relu layers + a 1-unit output with bias 0.1."""
    return mlp_init(gen, in_dim, cfg.hidden_units_task, cfg.output_units,
                    is_bn=cfg.is_bn, out_bias_init=0.1, dtype=dtype)


def tower_apply(params: Params, state: State, x: torch.Tensor,
                cfg: DMTConfig, *, train: bool = False,
                gen: Optional[torch.Generator] = None
                ) -> tuple[torch.Tensor, State]:
    return mlp_apply(params, state, x, keep_probs=cfg.dropout_task,
                     train=train, is_bn=cfg.is_bn,
                     is_dropout=cfg.is_dropout, bn_decay=cfg.bn_decay,
                     gen=gen)


# ---------------------------------------------------------------------------
# Bias net (training only: serving drops the bias head)
# ---------------------------------------------------------------------------


def bias_combiner_dim(cfg: DMTConfig) -> int:
    return sum(s.dim for s in cfg.embeddings_bias)


def bias_net_init(gen: torch.Generator, cfg: DMTConfig,
                  dtype=torch.float32) -> Params:
    """Bias-net tables keep the param dtype whatever their size, as in the
    reference; the bias net has no batch norm."""
    return {"emb": collection_init(gen, cfg.embeddings_bias, dtype),
            "mlp": mlp_init(gen, bias_combiner_dim(cfg),
                            cfg.hidden_units_bias,
                            cfg.output_units, out_bias_init=0.0,
                            hidden_bias_init=0.0, w_init=glorot_uniform(),
                            dtype=dtype)}


def bias_net_apply(params: Params, batch: dict, cfg: DMTConfig, *,
                   train: bool = False,
                   gen: Optional[torch.Generator] = None,
                   engine: EmbeddingEngine = DENSE_ENGINE) -> torch.Tensor:
    """Bias logit [B, 1] from the position / neighbour-exposure embeddings.
    Its tables are looked up as ``bias:<table>`` (distinct from main tables
    of the same name) and keep float32; its hidden layers use rate dropout
    that is always on in training, unlike the towers' keep-prob dropout."""
    parts = []
    for spec in cfg.embeddings_bias:
        ids = batch[spec.feature + IDS]
        parts.append(engine.pooled(
            "bias:" + spec.table, params["emb"][spec.table], ids,
            feature_wts(batch, spec.feature, ids), batch[spec.feature + LEN],
            feature=spec.feature))
    y = torch.cat(parts, dim=-1)
    p = params["mlp"]
    for i in range(len(cfg.hidden_units_bias)):
        y = torch.relu(dense_apply(p[f"layer{i}"]["dense"], y))
        if train and i < len(cfg.dropout_rate_bias):
            y = dropout_rate(gen, y, cfg.dropout_rate_bias[i])
    return dense_apply(p["out"]["dense"], y)
