"""The models' common base (``cikm2020_dmt_tpu/models/zoo.py``
``BaseModel``): the config, the param and compute dtypes, the embedding
engine, and ``apply``, which every model of the lattice and every paper
baseline (``models/baselines.py``) shares.  ``models/zoo.py`` documents
the logits' contract and holds the registry."""

from __future__ import annotations

from typing import Optional

import torch

from ..core.config import DMTConfig
from ..data.schema import FeatureSchema
from ..nn.embedding import collection_init
from ..nn.layers import Params, State, bn_state, mlp_apply
from ..parallel.embedding_shard import EmbeddingEngine

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def float32_sums(device: torch.device) -> None:
    """On the card, bfloat16 products are summed in float32, as the
    reference's kernels and XLA sum them: cuBLAS may otherwise reduce a
    bfloat16 product's partial sums in bfloat16
    (``allow_bf16_reduced_precision_reduction``, on by default in PyTorch),
    which on an H100 put the bfloat16 step's gradients several times
    farther from the CPU's than the CPU's are from float32.  The entry
    points on a CUDA device call this (a process-wide setting)."""
    if torch.device(device).type == "cuda":
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False


class BaseModel:
    name = "base"
    num_tasks = 1
    has_gates = False   # the MMoE family: ``apply(..., return_gates=True)``
    has_tables = True   # params["emb"]: every model but mlp

    def __init__(self, cfg: DMTConfig, schema: Optional[FeatureSchema] = None):
        self.cfg = cfg
        self.schema = schema or FeatureSchema.from_config(cfg)
        self.dtype = _DTYPES[cfg.param_dtype]
        self.compute_dtype = _DTYPES[cfg.compute_dtype]
        self.engine = EmbeddingEngine(cfg)

    def _emb_init(self, gen: torch.Generator) -> Params:
        return collection_init(gen, self.cfg.embeddings, self.dtype,
                               self.cfg.table_bf16_threshold)

    def _uncertainty(self, gen: torch.Generator, params: Params) -> Params:
        """Kendall uncertainty loss-weight variables."""
        if self.cfg.loss_weight_method == "uncertainty":
            params["uncertainty"] = {
                "click_weight": torch.zeros((1,), device=gen.device),
                "order_weight": torch.zeros((1,), device=gen.device)}
        return params

    def _mlp(self, params, state, x, keep_probs, train, gen):
        cfg = self.cfg
        return mlp_apply(params, state, x, keep_probs=keep_probs,
                         train=train, is_bn=cfg.is_bn,
                         is_dropout=cfg.is_dropout, bn_decay=cfg.bn_decay,
                         gen=gen)

    def init(self, gen: torch.Generator) -> Params:
        """Random params on ``gen``'s device, the reference's tree."""
        raise NotImplementedError

    def init_state(self, params: Params) -> State:
        """The model state of a fresh model: zero moving statistics."""
        return bn_state(params)

    def forward(self, params: Params, state: State, batch: dict, *,
                train: bool, gen: Optional[torch.Generator],
                is_predict: bool):
        """(logits, new state)."""
        raise NotImplementedError

    def apply(self, params: Params, batch: dict, *, train: bool = False,
              gen: Optional[torch.Generator] = None,
              is_predict: Optional[bool] = None,
              state: Optional[State] = None, return_state: bool = False,
              return_gates: bool = False):
        """The logits of the contract above; with ``return_state``,
        ``(logits, new state)``.  ``state`` defaults to a fresh model's.
        With ``return_gates`` (the MMoE family only; others raise
        ``ValueError``) the logits come as ``(logits, gates)``: the
        per-task expert-gate softmax [T, B, E] in float32 from this same
        forward (JAX ``MMoE.gate_values`` recomputes the trunk for it)."""
        kw = {}
        if return_gates:
            if not self.has_gates:
                raise ValueError(f"model_type {self.name!r} has no expert "
                                 "gates (only the MMoE family has)")
            kw["return_gates"] = True
        if not state:
            state = self.init_state(params) if self.cfg.is_bn else {}
        if is_predict is None:
            is_predict = not train
        out, new_state = self.forward(params, state, batch, train=train,
                                      gen=gen, is_predict=is_predict, **kw)
        return (out, new_state) if return_state else out
