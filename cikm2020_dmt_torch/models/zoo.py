"""Model zoo: the DMT composition lattice
(``cikm2020_dmt_tpu/models/zoo.py``) and the registry, which also holds
the paper baselines of ``models/baselines.py`` (lr, wnd, dcn, din, dien).

    mlp ⊂ embed_mlp ⊂ {multi_task, mmoe} ⊂ +transformer ⊂ +unbias

Each model is a pair of functions composed from ``models/components.py``:
``init(gen)`` gives the params, ``init_state(params)`` the batch-norm
moving statistics (``{}`` without ``is_bn``), and ``apply(params, batch,
...)`` the logits:

    single-task models:    y [B, 1]
    multi-task models:     (click_logit, order_logit)
    unbias, not predict:   ((click_logit, order_logit), bias_logit)
    single-task unbias:    (rel_logit, bias_logit)
    unbias with predict:   the relevance logits alone

``is_predict`` defaults to ``not train`` (the Scorer's case); the eval step
asks for the bias head with ``train=False, is_predict=False``.  In training
with dropout on, the randomness is drawn from ``gen``.  ``apply(...,
state=..., return_state=True)`` also returns the new model state (in
training, the moving statistics after this batch).

Params are plain nested dicts with the reference's tree (logical ``[R, D]``
tables), so ``convert.py`` copies a JAX init leaf by leaf.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.config import DMTConfig
from ..data.schema import FeatureSchema
from ..nn.layers import State, mlp_init
from .base import BaseModel
from .baselines import DCN, DIEN, DIN, LR, WideAndDeep
from .components import (bias_net_apply, bias_net_init, combiner_dim,
                         embedding_combiner, interest_dim, mmoe_apply,
                         mmoe_init, sequence_interest, sequences_init,
                         tower_apply, tower_init)


class MLP(BaseModel):
    """Dense features only, one logit."""

    name = "mlp"
    has_tables = False

    def init(self, gen):
        cfg = self.cfg
        return mlp_init(gen, cfg.feature_dimension, cfg.hidden_units,
                        cfg.output_units, is_bn=cfg.is_bn, out_bias_init=0.0,
                        dtype=self.dtype)

    def forward(self, params, state, batch, *, train, gen, is_predict):
        y, st = self._mlp(params, state,
                          batch["features"].to(self.compute_dtype),
                          self.cfg.dropout, train, gen)
        return y.float(), st


class EmbedMLP(BaseModel):
    """Pooled embeddings and dense features -> MLP, one logit."""

    name = "embed_mlp"

    def init(self, gen):
        cfg = self.cfg
        params = {"emb": self._emb_init(gen)}
        params["mlp"] = mlp_init(gen, combiner_dim(cfg), cfg.hidden_units,
                                 cfg.output_units, is_bn=cfg.is_bn,
                                 out_bias_init=0.0, dtype=self.dtype)
        return params

    def forward(self, params, state, batch, *, train, gen, is_predict):
        x = embedding_combiner(params["emb"], batch, self.cfg,
                               engine=self.engine).to(self.compute_dtype)
        y, st = self._mlp(params["mlp"], state.get("mlp", {}), x,
                          self.cfg.dropout, train, gen)
        return y.float(), ({"mlp": st} if st else {})


class EmbedMLPUnbias(EmbedMLP):
    """embed_mlp plus the bias net: one relevance logit and the bias logit
    (the reference dispatches this type but never committed its source;
    the JAX package composes it from the shipped pieces, and so does the
    port)."""

    name = "embed_mlp_unbias"

    def init(self, gen):
        params = super().init(gen)
        params["bias_net"] = bias_net_init(gen, self.cfg, self.dtype)
        return params

    def forward(self, params, state, batch, *, train, gen, is_predict):
        y, st = super().forward(params, state, batch, train=train, gen=gen,
                                is_predict=is_predict)
        if is_predict:
            return y, st
        bias = bias_net_apply(params["bias_net"], batch, self.cfg,
                              train=train, gen=gen, engine=self.engine)
        return (y, bias.float()), st


class _TwoTask(BaseModel):
    """The two-task trunk input: [dense | pooled | interest] (the interest
    states with ``use_interest``; their raw gathers feed the pooling)."""

    num_tasks = 2
    use_interest = False

    def _input_dim(self) -> int:
        dim = combiner_dim(self.cfg)
        if self.use_interest:
            dim += interest_dim(self.cfg)
        return dim

    def _init_emb(self, gen) -> Params:
        params: Params = {"emb": self._emb_init(gen)}
        if self.use_interest:
            params["trans"] = sequences_init(gen, self.cfg, self.dtype)
        return params

    def _input(self, params, batch, train, gen) -> torch.Tensor:
        cfg = self.cfg
        if self.use_interest:
            # interest first: the pooled combiner reuses its raw gathers
            interest, cache = sequence_interest(
                params["trans"], params["emb"], batch, cfg,
                engine=self.engine, dtype=self.compute_dtype, train=train,
                gen=gen)
            x = embedding_combiner(params["emb"], batch, cfg,
                                   engine=self.engine, seq_cache=cache)
            return torch.cat([x.to(self.compute_dtype), interest], dim=-1)
        return embedding_combiner(params["emb"], batch, cfg,
                                  engine=self.engine).to(self.compute_dtype)

    def _towers(self, params, state, new_state, outs, train, gen):
        """Click and order towers over the per-task inputs."""
        click, st_c = tower_apply(params["click"], state.get("click", {}),
                                  outs[0], self.cfg, train=train, gen=gen)
        order, st_o = tower_apply(params["order"], state.get("order", {}),
                                  outs[1], self.cfg, train=train, gen=gen)
        if st_c:
            new_state["click"], new_state["order"] = st_c, st_o
        return (click.float(), order.float()), new_state


class MultiTask(_TwoTask):
    """Shared bottom MLP, then the click and order towers."""

    name = "multi_task"

    def init(self, gen):
        cfg = self.cfg
        params = self._init_emb(gen)
        params["bottom"] = mlp_init(gen, self._input_dim(),
                                    cfg.hidden_units_bottom, None,
                                    is_bn=cfg.is_bn, dtype=self.dtype)
        head_in = cfg.hidden_units_bottom[-1]
        # task towers: output bias 0.0 (the reference's multi_task)
        for task in ("click", "order"):
            params[task] = mlp_init(gen, head_in, cfg.hidden_units_task,
                                    cfg.output_units, is_bn=cfg.is_bn,
                                    out_bias_init=0.0, dtype=self.dtype)
        return self._uncertainty(gen, params)

    def forward(self, params, state, batch, *, train, gen, is_predict):
        x = self._input(params, batch, train, gen)
        y, st = self._mlp(params["bottom"], state.get("bottom", {}), x,
                          self.cfg.dropout_bottom, train, gen)
        new_state: State = {"bottom": st} if st else {}
        return self._towers(params, state, new_state, (y, y), train, gen)


class MMoE(_TwoTask):
    """Multi-gate mixture-of-experts over the pooled features."""

    name = "mmoe"
    has_gates = True

    def init(self, gen):
        cfg = self.cfg
        params = self._init_emb(gen)
        params["mmoe"] = mmoe_init(gen, self._input_dim(), cfg, num_tasks=2,
                                   dtype=self.dtype)
        head_in = cfg.hidden_units_bottom[-1]
        params["click"] = tower_init(gen, head_in, cfg, self.dtype)
        params["order"] = tower_init(gen, head_in, cfg, self.dtype)
        return self._uncertainty(gen, params)

    def forward(self, params, state, batch, *, train, gen, is_predict,
                return_gates=False):
        x = self._input(params, batch, train, gen)
        res = mmoe_apply(params["mmoe"], state.get("mmoe", {}), x, self.cfg,
                         train=train, gen=gen, return_gates=return_gates)
        outs, st = res[0], res[1]
        new_state: State = {"mmoe": st} if st else {}
        logits, new_state = self._towers(params, state, new_state, outs,
                                         train, gen)
        if return_gates:
            return (logits, res[2]), new_state
        return logits, new_state


class Transformer(BaseModel):
    """Single-logit deep-interest transformer: the combiner skips the
    sequences' user features, the interest states join the MLP input."""

    name = "transformer"

    def init(self, gen):
        cfg = self.cfg
        params = {"emb": self._emb_init(gen),
                  "trans": sequences_init(gen, cfg, self.dtype)}
        params["mlp"] = mlp_init(
            gen, combiner_dim(cfg, skip_seq=True) + interest_dim(cfg),
            cfg.hidden_units, cfg.output_units, is_bn=cfg.is_bn,
            out_bias_init=0.0, dtype=self.dtype)
        return params

    def forward(self, params, state, batch, *, train, gen, is_predict):
        cfg = self.cfg
        interest, cache = sequence_interest(
            params["trans"], params["emb"], batch, cfg, engine=self.engine,
            dtype=self.compute_dtype, train=train, gen=gen)
        x = embedding_combiner(params["emb"], batch, cfg, skip_seq=True,
                               engine=self.engine, seq_cache=cache)
        x = torch.cat([x.to(self.compute_dtype), interest], dim=-1)
        y, st = self._mlp(params["mlp"], state.get("mlp", {}), x,
                          cfg.dropout, train, gen)
        return y.float(), ({"mlp": st} if st else {})


class MultiTaskTransformer(MultiTask):
    """Shared bottom over [dense | pooled | interest]."""

    name = "multi_task_transformer"
    use_interest = True


class MMoETransformer(MMoE):
    """MMoE over [dense | pooled | interest]."""

    name = "mmoe_transformer"
    use_interest = True


class MMoETransformerUnbias(MMoETransformer):
    """Full DMT: MMoE transformer plus the bias net, which training and
    the eval step run; serving drops the bias head."""

    name = "mmoe_transformer_unbias"

    def init(self, gen):
        params = super().init(gen)
        params["bias_net"] = bias_net_init(gen, self.cfg, self.dtype)
        return params

    def forward(self, params, state, batch, *, train, gen, is_predict,
                return_gates=False):
        rel, new_state = super().forward(params, state, batch, train=train,
                                         gen=gen, is_predict=is_predict,
                                         return_gates=return_gates)
        if return_gates:
            rel, gates = rel
        out = rel
        if not is_predict:
            bias = bias_net_apply(params["bias_net"], batch, self.cfg,
                                  train=train, gen=gen, engine=self.engine)
            out = rel, bias.float()
        return ((out, gates) if return_gates else out), new_state


MODEL_REGISTRY = {
    m.name: m for m in (
        MLP, EmbedMLP, EmbedMLPUnbias, MultiTask, MMoE, Transformer,
        MultiTaskTransformer, MMoETransformer, MMoETransformerUnbias,
        LR, WideAndDeep, DCN, DIN, DIEN)
}

# reference dispatch names whose model sources were never committed; the
# JAX package does not build them either
UNRECONSTRUCTIBLE_MODEL_TYPES = (
    "id_mlp", "embed_mlp_mulnet", "din_id", "din_v2", "dien_v2")


def model_class(model_type: str) -> type:
    """The registry's class of ``model_type``; an unknown name raises
    ``ValueError``."""
    try:
        return MODEL_REGISTRY[model_type]
    except KeyError:
        raise ValueError(
            f"unknown model_type {model_type!r}; available: "
            f"{sorted(MODEL_REGISTRY)}") from None


def build_model(cfg: DMTConfig,
                schema: Optional[FeatureSchema] = None) -> BaseModel:
    """Dispatch by ``model_type`` (reference inference_mlp.py:25-68)."""
    return model_class(cfg.model_type)(cfg, schema)
