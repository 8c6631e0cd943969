"""Model zoo: the flagship ``mmoe_transformer_unbias``.

Same composition as ``cikm2020_dmt_tpu/models/zoo.py``: ``MMoE`` is the
trunk (pooled features -> stacked MMoE -> click and order towers),
``MMoETransformer`` adds the behavior-sequence interest states to its
input, and ``MMoETransformerUnbias`` adds the bias net.  ``apply`` returns
the relevance logits ``(click_logit, order_logit)`` and never runs the bias
net, as the reference's ``is_predict=True`` does; with ``train=True`` (or
``is_predict=False``, the eval step) the unbias model returns
``((click_logit, order_logit), bias_logit)``, in training with dropout on,
its randomness drawn from ``gen``.

Params are plain nested dicts with the reference's tree (logical
``[R, D]`` tables), so ``convert.py`` copies a JAX init leaf by leaf.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.config import DMTConfig
from ..data.schema import FeatureSchema
from ..nn.embedding import collection_init
from ..nn.layers import Params
from ..parallel.embedding_shard import EmbeddingEngine
from .components import (bias_net_apply, bias_net_init, combiner_dim,
                         embedding_combiner,
                         interest_dim, mmoe_apply, mmoe_init,
                         sequence_interest, sequences_init, tower_apply,
                         tower_init)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class MMoE:
    """Multi-gate mixture-of-experts over the pooled features."""

    name = "mmoe"
    use_interest = False

    def __init__(self, cfg: DMTConfig, schema: Optional[FeatureSchema] = None):
        self.cfg = cfg
        self.schema = schema or FeatureSchema.from_config(cfg)
        self.dtype = _DTYPES[cfg.param_dtype]
        self.compute_dtype = _DTYPES[cfg.compute_dtype]
        self.engine = EmbeddingEngine()

    def _input_dim(self) -> int:
        dim = combiner_dim(self.cfg)
        if self.use_interest:
            dim += interest_dim(self.cfg)
        return dim

    def init(self, gen: torch.Generator) -> Params:
        """Random params on ``gen``'s device, the reference's tree."""
        cfg = self.cfg
        params: Params = {"emb": collection_init(
            gen, cfg.embeddings, self.dtype, cfg.table_bf16_threshold)}
        if self.use_interest:
            params["trans"] = sequences_init(gen, cfg, self.dtype)
        params["mmoe"] = mmoe_init(gen, self._input_dim(), cfg, num_tasks=2,
                                   dtype=self.dtype)
        head_in = cfg.hidden_units_bottom[-1]
        params["click"] = tower_init(gen, head_in, cfg, self.dtype)
        params["order"] = tower_init(gen, head_in, cfg, self.dtype)
        if cfg.loss_weight_method == "uncertainty":
            params["uncertainty"] = {
                "click_weight": torch.zeros((1,), device=gen.device),
                "order_weight": torch.zeros((1,), device=gen.device)}
        return params

    def apply(self, params: Params, batch: dict, *, train: bool = False,
              gen: Optional[torch.Generator] = None,
              return_gates: bool = False):
        """Relevance logits ``([B, 1], [B, 1])`` in float32.  With
        ``return_gates``, ``(logits, gates)``: the per-task expert-gate
        softmax [T, B, E] in float32 from this same forward (JAX
        ``MMoE.gate_values`` recomputes the trunk for it)."""
        cfg = self.cfg
        if self.use_interest:
            # interest first: the pooled combiner reuses its raw gathers
            interest, cache = sequence_interest(
                params["trans"], params["emb"], batch, cfg,
                engine=self.engine, dtype=self.compute_dtype, train=train,
                gen=gen)
            x = embedding_combiner(params["emb"], batch, cfg,
                                   engine=self.engine, seq_cache=cache)
            x = torch.cat([x.to(self.compute_dtype), interest], dim=-1)
        else:
            x = embedding_combiner(params["emb"], batch, cfg,
                                   engine=self.engine).to(self.compute_dtype)
        outs = mmoe_apply(params["mmoe"], x, cfg, train=train, gen=gen,
                          return_gates=return_gates)
        if return_gates:
            outs, gates = outs
        click = tower_apply(params["click"], outs[0], cfg, train=train,
                            gen=gen)
        order = tower_apply(params["order"], outs[1], cfg, train=train,
                            gen=gen)
        logits = click.float(), order.float()
        return (logits, gates) if return_gates else logits


class MMoETransformer(MMoE):
    """MMoE over [dense | pooled | interest]."""

    name = "mmoe_transformer"
    use_interest = True


class MMoETransformerUnbias(MMoETransformer):
    """Full DMT: MMoE transformer plus the bias net, which training and
    the eval step run; serving drops the bias head."""

    name = "mmoe_transformer_unbias"

    def init(self, gen: torch.Generator) -> Params:
        params = super().init(gen)
        params["bias_net"] = bias_net_init(gen, self.cfg, self.dtype)
        return params

    def apply(self, params: Params, batch: dict, *, train: bool = False,
              gen: Optional[torch.Generator] = None,
              is_predict: Optional[bool] = None,
              return_gates: bool = False):
        """``is_predict`` (default: not ``train``, the Scorer's case): the
        relevance logits.  Otherwise ``((click_logit, order_logit),
        bias_logit)``, each [B, 1] float32, with dropout where ``train``
        (the eval step asks for this with ``train=False``).  With
        ``return_gates``, ``(that, gates)`` as ``MMoE.apply`` gives
        them."""
        rel = super().apply(params, batch, train=train, gen=gen,
                            return_gates=return_gates)
        if return_gates:
            rel, gates = rel
        if is_predict is None:
            is_predict = not train
        out = rel
        if not is_predict:
            bias = bias_net_apply(params["bias_net"], batch, self.cfg,
                                  train=train, gen=gen, engine=self.engine)
            out = rel, bias.float()
        return (out, gates) if return_gates else out


def build_model(cfg: DMTConfig,
                schema: Optional[FeatureSchema] = None) -> MMoE:
    """Dispatch by ``model_type``; only the flagship is ported."""
    if cfg.model_type != MMoETransformerUnbias.name:
        raise ValueError(
            f"model_type {cfg.model_type!r} is not ported; available: "
            f"[{MMoETransformerUnbias.name!r}]")
    return MMoETransformerUnbias(cfg, schema)
