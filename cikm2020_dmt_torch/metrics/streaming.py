"""Streaming metrics on the device: precision / recall / AUC / mean loss
(``cikm2020_dmt_tpu/metrics/streaming.py``), the reference's
``tf.metrics`` locals.  AUC is TF1's bucketed estimator: 200 thresholds
spanning [-eps, 1 + eps], trapezoids over the ROC curve; each update drops
every example into one threshold bucket (a histogram) and takes suffix
sums.  Every update weights examples by ``weights`` (padded rows 0).
"""

from __future__ import annotations

import torch

NUM_THRESHOLDS = 200
EPS = 1e-7


def _thresholds(n: int, device) -> torch.Tensor:
    mid = [(i + 1) / (n - 1) for i in range(n - 2)]
    return torch.tensor([-EPS] + mid + [1.0 + EPS], dtype=torch.float32,
                        device=device)


def _zeros(shape, device):
    return torch.zeros(shape, dtype=torch.float32, device=device)


def task_metrics_init(device="cpu", n: int = NUM_THRESHOLDS) -> dict:
    def task():
        return {"prf": {k: _zeros((), device) for k in ("tp", "fp", "fn")},
                "auc": {k: _zeros((n,), device)
                        for k in ("tp", "fp", "tn", "fn")}}
    return {"click": task(), "order": task(),
            "loss": {"total": _zeros((), device), "count": _zeros((), device)}}


def _auc_update(state, labels, preds, weights):
    n = state["tp"].shape[0]
    th = _thresholds(n, preds.device)
    pos = (labels > 0).float() * weights
    neg = (labels <= 0).float() * weights
    c = (th[None, :] < preds[:, None]).sum(dim=1)
    c = torch.where(torch.isnan(preds), torch.full_like(c, n), c)
    hist = _zeros((n + 1, 2), preds.device).index_add_(
        0, c, torch.stack([pos, neg], dim=-1))
    tail = torch.flip(torch.cumsum(torch.flip(hist, [0]), 0), [0])
    tp_inc, fp_inc = tail[1:, 0], tail[1:, 1]
    tot_pos, tot_neg = pos.sum(), neg.sum()
    return {"tp": state["tp"] + tp_inc, "fp": state["fp"] + fp_inc,
            "fn": state["fn"] + (tot_pos - tp_inc),
            "tn": state["tn"] + (tot_neg - fp_inc)}


def _prf_update(state, labels, pred_binary, weights):
    pos = (labels > 0).float() * weights
    neg = (labels <= 0).float() * weights
    p = (pred_binary > 0).float()
    return {"tp": state["tp"] + (p * pos).sum(),
            "fp": state["fp"] + (p * neg).sum(),
            "fn": state["fn"] + ((1 - p) * pos).sum()}


def task_metrics_update(state: dict, *, mask, p_ctr, p_cvr, loss,
                        weights) -> dict:
    """Both tasks' metrics and the mean loss; labels derive from the class
    mask as in the reference (click = classes 1..4 of the mask, order =
    classes 3 and 4)."""
    labels_clk = mask[:, 1:5].sum(dim=-1)
    labels_ord = mask[:, 3] + mask[:, 4]
    out = {}
    for name, labels, p in (("click", labels_clk, p_ctr),
                            ("order", labels_ord, p_cvr)):
        out[name] = {
            "prf": _prf_update(state[name]["prf"], labels,
                               (p > 0.5).float(), weights),
            "auc": _auc_update(state[name]["auc"], labels, p, weights)}
    out["loss"] = {"total": state["loss"]["total"] + loss,
                   "count": state["loss"]["count"] + 1.0}
    return out


def _ratio(num, den):
    return float(num / den) if float(den) > 0 else 0.0


def _auc_value(s) -> float:
    tpr = (s["tp"] + EPS) / (s["tp"] + s["fn"] + EPS)
    fpr = s["fp"] / (s["fp"] + s["tn"] + EPS)
    return float(((fpr[:-1] - fpr[1:]) * (tpr[:-1] + tpr[1:]) / 2.0).sum())


def task_metrics_values(state: dict) -> dict:
    out = {"loss": _ratio(state["loss"]["total"], state["loss"]["count"])}
    for name in ("click", "order"):
        prf = state[name]["prf"]
        out[f"{name}_precision"] = _ratio(prf["tp"], prf["tp"] + prf["fp"])
        out[f"{name}_recall"] = _ratio(prf["tp"], prf["tp"] + prf["fn"])
        out[f"{name}_auc"] = _auc_value(state[name]["auc"])
    return out
