"""The eval step and a drain over batches
(``cikm2020_dmt_tpu/train/evaluate.py`` ``make_eval_step`` and
``run_eval``).

One eval step is the forward with ``train=False`` (dropout off, so a
per-op transformer stack runs the attention kernel), the flagship's
``multi_task_unbias_loss``, ``scores_from_logits`` and the streaming
metric update weighted by ``valid``.  ``run_eval`` drains a given iterable
of batches (dicts of numpy arrays or tensors, keyed like the training
batch; padded rows have ``valid`` 0 and come last) and returns the metric
values and the scores of the valid rows.

Only the flagship model (``mmoe_transformer_unbias``) is ported; any other
model type raises.  Parts of the reference module wait for the data
pipeline and checkpoint ports: the file reader that makes the batches, the
header lines with ``HeaderCollector`` and the offline session metrics, the
per-row detail file, ``collect_gates``, the mesh, and ``validation`` /
``predict`` with their checkpoint polling and the relevance-only scores
they select by ``test_score_method``.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch

from ..core.config import DMTConfig
from ..metrics.streaming import (task_metrics_init, task_metrics_update,
                                 task_metrics_values)
from ..models.zoo import MMoE
from ..nn.layers import tree_map
from .losses import multi_task_unbias_loss, scores_from_logits

PORTED = "mmoe_transformer_unbias"


def _check_model(cfg: DMTConfig) -> None:
    if cfg.model_type != PORTED or not cfg.is_unbias_model:
        raise ValueError(f"eval: model_type {cfg.model_type!r} is not "
                         f"ported; available: [{PORTED!r}]")


def make_eval_step(cfg: DMTConfig, model: MMoE):
    """``eval_step(params, metrics, batch) -> (metrics, p_ctr, p_cvr)`` on
    the device of ``batch``'s tensors."""
    _check_model(cfg)

    @torch.inference_mode()
    def eval_step(params, metrics, batch):
        out = model.apply(params, batch, train=False, is_predict=False)
        loss = multi_task_unbias_loss(cfg, out, batch["mask"],
                                      params.get("uncertainty"))
        p_ctr, p_cvr = scores_from_logits(cfg, out)
        metrics = task_metrics_update(
            metrics, mask=batch["mask"], p_ctr=p_ctr, p_cvr=p_cvr,
            loss=loss, weights=batch["valid"])
        return metrics, p_ctr, p_cvr

    return eval_step


def _tensor(v, device) -> torch.Tensor:
    t = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))
    return t.to(device)


def run_eval(cfg: DMTConfig, model: MMoE, params, batches: Iterable[dict],
             *, device="cuda"):
    """Drain ``batches`` on ``device``; returns (metric values, p_clk,
    p_ord), the scores as numpy arrays over the valid rows of every batch.
    The default device is the card: without CUDA this raises instead of
    evaluating on the CPU.  Pass ``device="cpu"`` for the plain path."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"run_eval: device {device} requested but CUDA is "
                           "not available; pass device='cpu' to evaluate on "
                           "the CPU")
    step = make_eval_step(cfg, model)
    params = tree_map(lambda t: t.to(device), params)
    metrics = task_metrics_init(device)
    clk, ord_ = [], []
    for batch in batches:
        b = {k: _tensor(v, device) for k, v in batch.items()}
        metrics, p_ctr, p_cvr = step(params, metrics, b)
        n_valid = int(b["valid"].sum())
        clk.append(p_ctr[:n_valid].cpu().numpy())
        ord_.append(p_cvr[:n_valid].cpu().numpy())
    p_clk = np.concatenate(clk) if clk else np.zeros(0, np.float32)
    p_ord = np.concatenate(ord_) if ord_ else np.zeros(0, np.float32)
    return task_metrics_values(metrics), p_clk, p_ord
