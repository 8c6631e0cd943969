"""Probabilities from model logits, the training losses of every model
family and the L2 regularization (``cikm2020_dmt_tpu/train/losses.py``),
in the reference's reduction order:

    loss_task = sum_c mean_b (mask[b, c] * class_weight[c] * xent[b])

with the ESMM-style labels derived from the one-hot class mask over the
classes [0, 1, 2, 4, 5]: click = any of {1, 2, 4, 5}, order = {4, 5}.

- ``multi_task_unbias_loss``: the unbias two-head models;
- ``single_task_unbias_loss``: ``embed_mlp_unbias``;
- ``multi_task_loss``: multi_task, mmoe and their transformer variants,
  with an optional per-example (propensity) weight;
- ``single_task_loss``: mlp, embed_mlp and transformer;
- ``model_loss`` dispatches among them as the JAX loops do."""

from __future__ import annotations

from typing import Optional

import torch

from ..core.config import DMTConfig

KERAS_EPS = 1e-7  # keras' probability clip in sparse categorical CE


def sigmoid_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """tf.nn.sigmoid_cross_entropy_with_logits in its stable form:
    max(l, 0) - l * z + log1p(exp(-|l|))."""
    return (logits.clamp(min=0.0) - logits * labels
            + torch.log1p(torch.exp(-logits.abs())))


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


def _class_weights(cfg: DMTConfig, pairs, mask: torch.Tensor
                   ) -> torch.Tensor:
    return torch.tensor(cfg.weight_vector(pairs), dtype=mask.dtype,
                        device=mask.device)


def multi_task_loss(cfg: DMTConfig, logits, mask: torch.Tensor,
                    uncertainty: Optional[dict] = None,
                    sample_weight: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Two-head sigmoid-CE loss (reference logit_loss).  ``sample_weight``
    multiplies each example's CE (the propensity weight the trainer passes
    under ``propensity_em``)."""
    click, order = logits
    labels_clk, labels_order = derive_task_labels(mask)
    xent_clk = sigmoid_xent(click.reshape(-1), labels_clk)
    xent_ord = sigmoid_xent(order.reshape(-1), labels_order)
    if sample_weight is not None:
        xent_clk = xent_clk * sample_weight
        xent_ord = xent_ord * sample_weight
    loss_clk = weighted_class_reduce(xent_clk, mask,
                                     _class_weights(cfg, cfg.weight_ctr, mask))
    loss_order = weighted_class_reduce(
        xent_ord, mask, _class_weights(cfg, cfg.weight_ecvr, mask))
    return _task_weight(cfg, loss_clk, loss_order, uncertainty)


def _single_target(cfg: DMTConfig, mask: torch.Tensor,
                   labels: Optional[torch.Tensor]) -> torch.Tensor:
    """The derived click label, or under ``single_task_raw_label`` the
    raw label column (the reference's exact single-task target)."""
    if cfg.single_task_raw_label and labels is not None:
        return labels.reshape(-1).to(mask.dtype)
    return derive_task_labels(mask)[0]


def single_task_loss(cfg: DMTConfig, logits: torch.Tensor,
                     mask: torch.Tensor,
                     labels: Optional[torch.Tensor] = None,
                     train: bool = True) -> torch.Tensor:
    """Single-logit CTR loss: sigmoid CE against ``_single_target``,
    weighted by ``train_weight`` in training and ``valid_weight`` in
    eval."""
    weights = cfg.train_weight if train else cfg.valid_weight
    xent = sigmoid_xent(logits.reshape(-1),
                        _single_target(cfg, mask, labels))
    return weighted_class_reduce(xent, mask,
                                 _class_weights(cfg, weights, mask))


def single_task_unbias_loss(cfg: DMTConfig, logits, mask: torch.Tensor,
                            labels: Optional[torch.Tensor] = None,
                            train: bool = True) -> torch.Tensor:
    """The single-head analog of ``multi_task_unbias_loss``: CE on the
    biased probability plus, in ``ctr_rel`` mode, on the relevance-only
    one, weighted as ``single_task_loss``."""
    rel, bias = (t.reshape(-1) for t in logits)
    sig = torch.sigmoid
    if cfg.loss_unbias_method == "two_head_multiply":
        p = sig(rel) * sig(bias)
    else:
        p = sig(rel + bias)
    target = _single_target(cfg, mask, labels)
    xent = binary_xent_from_prob(p, target)
    if cfg.loss_ctr_rel_method == "ctr_rel":
        xent = xent + binary_xent_from_prob(sig(rel), target)
    weights = cfg.train_weight if train else cfg.valid_weight
    return weighted_class_reduce(xent, mask,
                                 _class_weights(cfg, weights, mask))


def model_loss(cfg: DMTConfig, num_tasks: int, out, params: dict,
               batch: dict, *, train: bool) -> torch.Tensor:
    """The loss of a model's output (JAX ``make_loss_fn`` in training,
    the eval step's dispatch otherwise): by unbias and task count.  Only
    training passes the propensity weight (``cfg.propensity_em``)."""
    uncertainty = params.get("uncertainty")
    mask = batch["mask"]
    if cfg.is_unbias_model and num_tasks == 2:
        return multi_task_unbias_loss(cfg, out, mask, uncertainty)
    if cfg.is_unbias_model:
        return single_task_unbias_loss(cfg, out, mask, batch.get("label"),
                                       train=train)
    if num_tasks == 2:
        sw = (batch["propensity_weight_mul"]
              if train and cfg.propensity_em else None)
        return multi_task_loss(cfg, out, mask, uncertainty, sample_weight=sw)
    return single_task_loss(cfg, out, mask, batch.get("label"), train=train)


def l2_regularization(cfg: DMTConfig, params: dict, batch: dict,
                      mesh=None) -> torch.Tensor:
    """``0.5 * wnd_wd * sum(w^2)`` over every dense kernel (a ``"w"``
    leaf), plus ``l2_emb_lambda / batch_size`` times half the squared norm
    of each table row the batch touches, counted once per row (a presence
    vector per table; ids outside a table's rows are dropped).  On a
    ``mesh`` the presence is the global batch's: one max-``all_reduce`` of
    the ranks' vectors, so each rank's term is the whole batch's, as the
    JAX term over the sharded batch.  A model-split table (``emb[name]``
    the rank's share) adds its share's term, summed over the model group
    with the identity backward."""
    from ..data.pipeline import IDS

    reg = torch.zeros((), dtype=torch.float32)
    if cfg.wnd_wd > 0.0:
        def dense_sq(tree):
            if isinstance(tree, dict):
                return sum((v.float().square().sum() if k == "w"
                            else dense_sq(v)) for k, v in tree.items()
                           if k == "w" or isinstance(v, (dict, list)))
            if isinstance(tree, list):
                return sum(dense_sq(v) for v in tree)
            return 0.0

        reg = reg + 0.5 * cfg.wnd_wd * dense_sq(params)
    emb = params.get("emb")
    if emb and cfg.l2_emb_lambda > 0.0:
        touched: dict[str, torch.Tensor] = {}
        for spec in cfg.embeddings:
            key = spec.feature + IDS
            if key not in batch:
                continue
            ids = batch[key].reshape(-1).long()
            presence = touched.get(spec.table)
            if presence is None:
                presence = torch.zeros((spec.id_size,), dtype=torch.float32,
                                       device=ids.device)
            keep = (ids >= 0) & (ids < presence.shape[0])
            presence = presence.index_fill(0, ids[keep], 1.0)
            touched[spec.table] = presence
        if mesh is not None and mesh.size > 1 and touched:
            flat = mesh.all_reduce(torch.cat(list(touched.values())), "max")
            touched = dict(zip(touched, flat.split(
                [v.shape[0] for v in touched.values()])))
        split = {}
        if mesh is not None and mesh.model > 1:
            from ..parallel.embedding_shard import (model_split_tables,
                                                    shard_lo)
            split = model_split_tables(cfg, mesh.size, mesh.model)

        def term(name, presence):
            table = emb[name]
            if name in split:
                lo = shard_lo(mesh, *split[name])
                presence = presence[lo:lo + table.shape[0]]
            return 0.5 * (presence * table.float().square().sum(-1)).sum()

        total = sum(term(n, p) for n, p in touched.items() if n not in split)
        shares = [term(n, p) for n, p in touched.items() if n in split]
        if shares:
            from ..core.mesh import model_axis_sum
            total = total + model_axis_sum(sum(shares), mesh)
        reg = reg + total * cfg.l2_emb_lambda / cfg.batch_size
    return reg


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
    loss_clk = weighted_class_reduce(xent_clk, mask,
                                     _class_weights(cfg, cfg.weight_ctr, mask))
    loss_order = weighted_class_reduce(
        xent_ord, mask, _class_weights(cfg, cfg.weight_ecvr, mask))
    return _task_weight(cfg, loss_clk, loss_order, uncertainty)
