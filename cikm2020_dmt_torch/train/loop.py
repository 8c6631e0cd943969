"""Single-device training step (``cikm2020_dmt_tpu/train/loop.py``
``_lazy_step`` and the metric update of its ``step_fn``).

One ``Trainer.train_step``:

1. ``collect`` the id union of every lazy-Adam table (``train/lazy.py``);
2. forward with those tables' lookups sliced from the union grid, the
   ``multi_task_unbias_loss``, and its backward;
3. dense Adam (``train/optim.py``) on every other leaf;
4. LazyAdam on the touched rows of each lazy table, in place;
5. the streaming AUC / precision / recall / mean-loss update.

The train state is a dict: ``params``, the dense Adam state ``opt``
(``m``, ``v``, ``count``), ``lazy_opt[table]["mv"]`` ([2, R, D] float32
moments), ``step`` and ``lazy_overflow`` (distinct row groups past the
budget, cumulated; their gradient is skipped for that step).  A batch is a dict of
tensors on the trainer's device, keyed like the reference's batch.  Only
the flagship model's loss (``mmoe_transformer_unbias``) is ported.
"""

from __future__ import annotations

import os

import torch

from ..core.config import DMTConfig
from ..metrics.streaming import task_metrics_update
from ..models.zoo import build_model
from .lazy import build_lazy_plan, collect, lazy_adam_rows, make_overlay
from .losses import multi_task_unbias_loss, scores_from_logits
from .optim import adam_init, adam_update, piecewise_constant


def _flatten(tree, out):
    if isinstance(tree, dict):
        for v in tree.values():
            _flatten(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _flatten(v, out)
    else:
        out.append(tree)
    return out


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_rebuild(v, it) for v in tree]
    return next(it)


class Trainer:
    """Trains the flagship model on one device.  The default device is
    the card: without CUDA the constructor raises instead of training on
    the CPU.  Pass ``device="cpu"`` for the plain PyTorch path."""

    def __init__(self, cfg: DMTConfig, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"Trainer: device {self.device} requested but CUDA is not "
                "available; pass device='cpu' to train on the CPU")
        if not cfg.is_unbias_model or cfg.model_type != \
                "mmoe_transformer_unbias":
            raise ValueError(f"Trainer: model_type {cfg.model_type!r} is "
                             "not ported")
        if cfg.optimizer.lower() != "adam" or cfg.wnd_wd > 1e-5:
            raise ValueError("Trainer: only Adam without dense weight decay "
                             "is ported")
        if cfg.grid_bf16 or os.environ.get("DMT_GRID_BF16", "0") == "1":
            raise ValueError(
                "Trainer: grid_bf16 (or DMT_GRID_BF16=1) is not ported; it "
                "rounds the union grid of a float32 lazy table to bfloat16, "
                "which would change the trained values")
        self.cfg = cfg
        self.model = build_model(cfg)
        self.lazy_plan = build_lazy_plan(cfg)
        self.schedule = piecewise_constant(cfg.step_boundary,
                                           cfg.learning_rate)

    def _dense(self, params: dict) -> dict:
        """The params minus the lazily updated tables (what dense Adam
        sees)."""
        lazy = {t.name for t in self.lazy_plan}
        out = dict(params)
        out["emb"] = {k: v for k, v in params["emb"].items()
                      if k not in lazy}
        return out

    def init_state(self, gen: torch.Generator) -> dict:
        """Random params from ``gen`` (on the trainer's device) and zero
        optimizer state."""
        params = self.model.init(gen)
        state = {"params": params, "opt": adam_init(self._dense(params)),
                 "step": torch.zeros((), dtype=torch.int64,
                                     device=self.device),
                 "lazy_overflow": torch.zeros((), dtype=torch.int64,
                                              device=self.device)}
        state["lazy_opt"] = {
            t.name: {"mv": torch.zeros((2,) + tuple(
                params["emb"][t.name].shape), dtype=torch.float32,
                device=self.device)}
            for t in self.lazy_plan}
        return state

    def train_step(self, state: dict, metrics: dict, batch: dict,
                   gen: torch.Generator):
        """One step; returns (state, metrics, loss).  The lazy tables and
        their moments are updated in place; the other leaves are new
        tensors.  ``gen`` (on the trainer's device) drives dropout."""
        cfg = self.cfg
        params = state["params"]
        cols = {t.name: collect(t, batch, params["emb"][t.name],
                                cfg.dedup_budget_div)
                for t in self.lazy_plan}
        dense = self._dense(params)
        leaves = [t.detach().requires_grad_() for t in _flatten(dense, [])]
        dense_d = _rebuild(dense, iter(leaves))
        rows_d = {name: c.rows.detach().requires_grad_()
                  for name, c in cols.items()}
        full = dict(dense_d)
        full["emb"] = dict(dense_d["emb"])
        for name in cols:
            full["emb"][name] = params["emb"][name]
        engine = self.model.engine
        engine.overlay = {
            name: make_overlay(c, rows_d[name],
                               table=(params["emb"][name]
                                      if cfg.lazy_overflow_exact else None))
            for name, c in cols.items()}
        try:
            out = self.model.apply(full, batch, train=True, gen=gen)
            loss = multi_task_unbias_loss(cfg, out, batch["mask"],
                                          full.get("uncertainty"))
        finally:
            engine.overlay = {}
        wrt = leaves + list(rows_d.values())
        grads = torch.autograd.grad(loss, wrt, allow_unused=True)
        grads = [torch.zeros_like(w) if g is None else g
                 for w, g in zip(wrt, grads)]
        g_dense = _rebuild(dense, iter(grads[:len(leaves)]))
        g_rows = dict(zip(rows_d, grads[len(leaves):]))

        with torch.no_grad():
            new_dense, opt = adam_update(dense, g_dense, state["opt"],
                                         self.schedule)
            count = state["step"] + 1
            new_params = dict(new_dense)
            new_params["emb"] = dict(new_dense["emb"])
            lazy_opt = {}
            for name, c in cols.items():
                table, mv = lazy_adam_rows(
                    params["emb"][name], state["lazy_opt"][name]["mv"],
                    c.uids, c.rows, g_rows[name], count, self.schedule)
                new_params["emb"][name] = table
                lazy_opt[name] = {"mv": mv}
            overflow = state["lazy_overflow"]
            for c in cols.values():
                overflow = overflow + c.overflow
            new_state = {"params": new_params, "opt": opt, "step": count,
                         "lazy_opt": lazy_opt, "lazy_overflow": overflow}
            logits = ((out[0][0].detach(), out[0][1].detach()),
                      out[1].detach())
            p_ctr, p_cvr = scores_from_logits(cfg, logits)
            metrics = task_metrics_update(
                metrics, mask=batch["mask"], p_ctr=p_ctr, p_cvr=p_cvr,
                loss=loss.detach(), weights=batch["valid"])
        return new_state, metrics, loss.detach()
