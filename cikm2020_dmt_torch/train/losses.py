"""Probabilities from model logits and the flagship's training loss
(``cikm2020_dmt_tpu/train/losses.py``), in the reference's reduction order:

    loss_task = sum_c mean_b (mask[b, c] * class_weight[c] * xent[b])

with the ESMM-style labels derived from the one-hot class mask over the
classes [0, 1, 2, 4, 5]: click = any of {1, 2, 4, 5}, order = {4, 5}.
Only ``multi_task_unbias_loss`` (the flagship's) is ported."""

from __future__ import annotations

from typing import Optional

import torch

from ..core.config import DMTConfig

KERAS_EPS = 1e-7  # keras' probability clip in sparse categorical CE


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


def binary_xent_from_prob(p: torch.Tensor, labels: torch.Tensor
                          ) -> torch.Tensor:
    """The reference's cal_cross_entropy: keras sparse-categorical CE over
    [1 - p, p] with the probability clipped to [eps, 1 - eps]."""
    p_label = torch.where(labels > 0.5, p, 1.0 - p)
    return -torch.log(p_label.clamp(KERAS_EPS, 1.0 - KERAS_EPS))


def weighted_class_reduce(xent: torch.Tensor, mask: torch.Tensor,
                          class_weights: torch.Tensor) -> torch.Tensor:
    """sum_c mean_b (mask[b, c] * w[c] * xent[b])."""
    mw = mask * class_weights[None, :]
    return (mw * xent[:, None]).mean(dim=0).sum()


def derive_task_labels(mask: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    return mask[:, 1:5].sum(dim=-1), mask[:, 3] + mask[:, 4]


def _task_weight(cfg: DMTConfig, loss_clk, loss_order,
                 uncertainty: Optional[dict]):
    """Fixed or Kendall-uncertainty task weighting."""
    if cfg.loss_weight_method == "uncertainty" and uncertainty is not None:
        wc = uncertainty["click_weight"][0]
        wo = uncertainty["order_weight"][0]
        return (torch.exp(-wc) * loss_clk + 0.5 * wc
                + torch.exp(-wo) * loss_order + 0.5 * wo)
    return cfg.loss_weight[0] * loss_clk + cfg.loss_weight[1] * loss_order


def multi_task_unbias_loss(cfg: DMTConfig, logits, mask: torch.Tensor,
                           uncertainty: Optional[dict] = None
                           ) -> torch.Tensor:
    """Unbiased two-head loss (reference logit_loss_unbias): CE on the
    biased probability sigma(rel + bias) (or sigma(rel) * sigma(bias)),
    plus, in ``ctr_rel`` mode, CE on the relevance-only probability."""
    (click, order), bias = logits
    click, order, bias = (t.reshape(-1) for t in (click, order, bias))
    sig = torch.sigmoid
    if cfg.loss_unbias_method == "two_head_multiply":
        p_ctr, p_cvr = sig(click) * sig(bias), sig(order) * sig(bias)
    else:
        p_ctr, p_cvr = sig(click + bias), sig(order + bias)
    labels_clk, labels_order = derive_task_labels(mask)
    xent_clk = binary_xent_from_prob(p_ctr, labels_clk)
    xent_ord = binary_xent_from_prob(p_cvr, labels_order)
    if cfg.loss_ctr_rel_method == "ctr_rel":
        xent_clk = xent_clk + binary_xent_from_prob(sig(click), labels_clk)
        xent_ord = xent_ord + binary_xent_from_prob(sig(order), labels_order)
    w_ctr = torch.tensor(cfg.weight_vector(cfg.weight_ctr), dtype=mask.dtype,
                         device=mask.device)
    w_ecvr = torch.tensor(cfg.weight_vector(cfg.weight_ecvr),
                          dtype=mask.dtype, device=mask.device)
    loss_clk = weighted_class_reduce(xent_clk, mask, w_ctr)
    loss_order = weighted_class_reduce(xent_ord, mask, w_ecvr)
    return _task_weight(cfg, loss_clk, loss_order, uncertainty)
