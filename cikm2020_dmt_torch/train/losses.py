"""Probabilities from model logits (``cikm2020_dmt_tpu/train/losses.py``
``scores_from_logits``).  The training losses are not ported yet."""

from __future__ import annotations

import torch

from ..core.config import DMTConfig


def scores_from_logits(cfg: DMTConfig, logits, *, rel_only: bool = False
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """(p_ctr, p_cvr), each ``[B]``.

    - ``((click, order), bias)``: the unbias two-head output; ``rel_only``
      drops the bias head, otherwise it is added to (two_head_add) or
      multiplied with (two_head_multiply) each relevance head;
    - ``(rel, bias)`` of a single-head unbias model: one probability twice;
    - ``(click, order)``: a multi-task model;
    - one logit tensor: a single-task model, one probability twice.
    """
    sig = torch.sigmoid
    if isinstance(logits, tuple) and isinstance(logits[0], tuple):
        (click, order), bias = logits
        click, order, bias = (t.reshape(-1) for t in (click, order, bias))
        if rel_only:
            return sig(click), sig(order)
        if cfg.loss_unbias_method == "two_head_multiply":
            return sig(click) * sig(bias), sig(order) * sig(bias)
        return sig(click + bias), sig(order + bias)
    if (isinstance(logits, tuple) and cfg.is_unbias_model
            and not cfg.is_multi_task):
        rel, bias = (t.reshape(-1) for t in logits)
        if rel_only:
            p = sig(rel)
        elif cfg.loss_unbias_method == "two_head_multiply":
            p = sig(rel) * sig(bias)
        else:
            p = sig(rel + bias)
        return p, p
    if isinstance(logits, tuple):
        click, order = logits
        return sig(click.reshape(-1)), sig(order.reshape(-1))
    p = sig(logits.reshape(-1))
    return p, p
