"""Extended offline metrics: score-blend grid search, weighted grouped AUC,
per-head metrics, CSV dumps (the port's own copy of
``cikm2020_dmt_tpu/metrics/offline_ext.py``; the same numbers, and the
score dump written by the ``csv`` module instead of pandas).

Covers the reference's metrics2.py / metrics3.py feature set
(reference metrics/metrics2.py:196-497, metrics3.py:20-302):

- separate per-head P@N / MRR@N (click score scored against the click
  threshold, order score against the order threshold; metrics2.py:614-665)
- grid search over blended-score weights
  score = (wc*clk + wo*ord)/(wc+wo), the reference's weight ladder
  (metrics2.py:382), groups keyed by (uuid, sid) (metrics2.py:500-505);
  best cell selected by click P@4 (metrics2.py:409-412)
- mix (ungrouped) AUC, grouped AUC + clk/ord F1, and impression- /
  click-weighted grouped AUC (weight = group size / #(label>=1);
  metrics2.py:196-289)
- CSV dump of header/score detail (metrics3.save_to_local, :92-110)
"""

from __future__ import annotations

import csv
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np

from ..core.logging import log_to_file
from .offline import (AT_LIST, CLICK, ORDER, _auc_rank, _group_segments,
                      _grouped_prep, _segment_grouped_auc, _segment_pre_mrr,
                      _sort_groups, parse_headers)

# reference weight ladder (metrics2.py:382)
GRID_WEIGHTS = ((1.0, 0.05), (1.0, 0.1), (1.0, 0.25), (1.0, 0.5),
                (1.0, 1.0), (1.0, 2.0), (1.0, 4.0), (1.0, 8.0))


def precision_mrr_grouped(header_schema, headers, scores, *,
                          group_by="sid", at_list=AT_LIST) -> dict:
    """P@N / MRR@N with a configurable group key (sid / uuid / uuid+sid,
    the latter matching metrics2 split_group's composite)."""
    ph = parse_headers(header_schema, headers)
    labels = ph.labels
    codes = ph.codes(group_by)
    scores = np.asarray(scores, np.float64)
    order = _sort_groups(codes, scores, labels)
    starts, ends = _group_segments(codes, order)
    sorted_labels = labels[order]
    n_groups = len(starts)

    out = {}
    for action in (CLICK, ORDER):
        hits = (sorted_labels >= action).astype(np.float64)
        pre, mrr = _segment_pre_mrr(hits, starts, ends, at_list)
        out[action] = (pre / max(n_groups, 1), mrr / max(n_groups, 1))
    return out


def separate_metrics(header_schema, headers, clk_scores, ord_scores, *,
                     group_by=("uuid", "sid")) -> dict:
    """Per-head ranking metrics: each task ranked by its own score
    (reference separate_mrr, metrics2.py:614-665)."""
    clk = precision_mrr_grouped(header_schema, headers, clk_scores,
                                group_by=group_by)
    ordm = precision_mrr_grouped(header_schema, headers, ord_scores,
                                 group_by=group_by)
    return {CLICK: clk[CLICK], ORDER: ordm[ORDER]}


def mix_auc(header_schema, headers, scores) -> dict:
    """Ungrouped AUC over all rows (metrics2 get_offline_metrics_auc_mix)."""
    labels = parse_headers(header_schema, headers).labels
    scores = np.asarray(scores, np.float64)
    return {a: _auc_rank((labels >= a).astype(np.int8), scores)
            for a in (CLICK, ORDER)}


def weighted_grouped_auc(header_schema, headers, scores, *,
                         group_method: str = "uuid",
                         weight_method: str = "impression") -> dict:
    """Grouped AUC with per-group weights: group size ("impression") or
    #(label>=1) ("click"); normalized by total weight
    (reference metrics2.py:196-289)."""
    ph = parse_headers(header_schema, headers)
    labels = ph.labels
    codes = ph.codes(group_method)
    scores = np.asarray(scores, np.float64)
    any_click = (labels >= 1).astype(np.float64)

    prep = _grouped_prep(codes, scores) if len(codes) else None
    out = {}
    for action in (CLICK, ORDER):
        y = (labels >= action).astype(np.int8)
        auc, glen, gstarts, order = _segment_grouped_auc(codes, y, scores,
                                                         prep)
        if weight_method == "impression":
            w = glen.astype(np.float64)
        elif weight_method == "click":
            w = np.add.reduceat(any_click[order], gstarts)
        else:
            w = np.ones(len(glen))
        w = np.where(glen >= 2, w, 0.0)  # size-1 groups skipped
        total_w = float(w.sum())
        out[action] = float((auc * w).sum()) / total_w if total_w > 0 else 0.0
    return out


def _cell_grouped_aucs(ph, blended: np.ndarray) -> tuple[dict, dict, dict]:
    """grouped_auc + impression-/click-weighted grouped AUC for one blend
    cell, sharing a single ``_grouped_prep`` (the dominant O(n log n)
    lexsort) instead of re-sorting three times."""
    codes = ph.codes("uuid")
    labels = ph.labels
    any_click = (labels >= 1).astype(np.float64)
    prep = _grouped_prep(codes, blended) if len(codes) else None
    plain, w_imp, w_clk = {}, {}, {}
    for action in (CLICK, ORDER):
        y = (labels >= action).astype(np.int8)
        auc, glen, gstarts, order = _segment_grouped_auc(codes, y, blended,
                                                         prep)
        valid = glen >= 2
        plain[action] = float(auc[valid].sum()) / max(int(valid.sum()), 1)
        for out, w in ((w_imp, glen.astype(np.float64)),
                       (w_clk, np.add.reduceat(any_click[order], gstarts)
                        if len(glen) else np.zeros(0))):
            w = np.where(valid, w, 0.0)
            tw = float(w.sum())
            out[action] = float((auc * w).sum()) / tw if tw > 0 else 0.0
    return plain, w_imp, w_clk


def grid_search(header_schema, headers, clk_scores, ord_scores, *,
                weights: Sequence[tuple[float, float]] = GRID_WEIGHTS,
                out_file: Optional[str] = None, workers: int = 0) -> dict:
    """Blend-weight grid search (reference metrics2.get_offline_metrics,
    :347-497).  Returns per-weight metric dicts + the best cell by click
    P@4; optionally appends the reference-format report to ``out_file``.

    The weight cells are independent given the shared ``ParsedHeaders``,
    so they compute on a thread pool (numpy's lexsort/reduceat release
    the GIL; the reference forks a 0.7*ncpu process pool for the same
    job, metrics.py:134-160).  ``workers=1`` forces serial."""
    clk_scores = np.asarray(clk_scores, np.float64)
    ord_scores = np.asarray(ord_scores, np.float64)
    # parse once; the 8 weight cells x 5 metric families below all share
    # the same ParsedHeaders (and its memoized group codes)
    headers = parse_headers(header_schema, headers)

    results: dict = {"cells": {}, "separate": separate_metrics(
        header_schema, headers, clk_scores, ord_scores)}
    if out_file:
        sep = results["separate"]
        lines = ["separate_metric"]
        for action, (pre, mrr) in sep.items():
            for n, p in zip(AT_LIST, pre):
                lines.append(f"action_{action}_at_{n}: {p}")
        log_to_file("\n".join(lines), out_file)

    # memoize every group code the cells read BEFORE threading (the
    # ParsedHeaders codes cache is not locked; after this, cells only read)
    headers.codes(("uuid", "sid"))
    headers.codes("uuid")

    def one_cell(wc, wo):
        blended = (wc * clk_scores + wo * ord_scores) / (wc + wo)
        pm = precision_mrr_grouped(header_schema, headers, blended,
                                   group_by=("uuid", "sid"))
        gauc, gauc_imp, gauc_clk = _cell_grouped_aucs(headers, blended)
        cell = {
            "precision_mrr": pm,
            "mix_auc": mix_auc(header_schema, headers, blended),
            "grouped_auc": gauc,
            "grouped_auc_impression": gauc_imp,
            "grouped_auc_click": gauc_clk,
        }
        g = cell["grouped_auc"]
        denom = g[CLICK] + g[ORDER]
        cell["grouped_auc_f1"] = (2 * g[CLICK] * g[ORDER] / denom
                                  if denom > 0 else 0.0)
        return cell

    if workers != 1 and len(weights) > 1:
        nw = workers if workers > 0 else min(len(weights),
                                             os.cpu_count() or 4)
        with ThreadPoolExecutor(max_workers=nw) as ex:
            cells = list(ex.map(lambda w: one_cell(*w), weights))
    else:
        cells = [one_cell(*w) for w in weights]

    max_value, max_key = 0.0, ""
    for (wc, wo), cell in zip(weights, cells):
        key = f"{wc}_{wo}"
        pm = cell["precision_mrr"]
        g = cell["grouped_auc"]
        results["cells"][key] = cell
        # best by click P@4 (metrics2.py:409-412); AT_LIST[1] == 4
        p_at_4 = pm[CLICK][0][AT_LIST.index(4)]
        if p_at_4 > max_value:
            max_value, max_key = float(p_at_4), key
        if out_file:
            lines = ["+" * 100, key]
            for action, (pre, mrr) in pm.items():
                for n, p in zip(AT_LIST, pre):
                    lines.append(f"action_{action}_pre_at_{n}: {p}")
                for n, m in zip(AT_LIST, mrr):
                    lines.append(f"action_{action}_mrr_at_{n}: {m}")
            lines.append(f"mix_user_auc_clk: {cell['mix_auc'][CLICK]}")
            lines.append(f"mix_user_auc_ord: {cell['mix_auc'][ORDER]}")
            lines.append(f"group_user_auc_clk: {g[CLICK]}")
            lines.append(f"group_user_auc_ord: {g[ORDER]}")
            lines.append(f"group_user_auc_f1_clk_ord: {cell['grouped_auc_f1']}")
            gi = cell["grouped_auc_impression"]
            lines.append(f"group_weightImpression_user_auc_clk: {gi[CLICK]}")
            lines.append(f"group_weightImpression_user_auc_ord: {gi[ORDER]}")
            gc = cell["grouped_auc_click"]
            lines.append(f"group_weightClk_user_auc_clk: {gc[CLICK]}")
            lines.append(f"group_weightClk_user_auc_ord: {gc[ORDER]}")
            log_to_file("\n".join(lines), out_file)

    results["max_key"] = max_key
    results["max_value"] = max_value
    if out_file:
        log_to_file("+" * 100 + f"\nmax_key:{max_key}\nmax_value:{max_value}",
                    out_file)
    return results


def save_scores_csv(path: str, header_schema, headers, clk_scores,
                    ord_scores) -> None:
    """Tab-separated score dump (reference metrics3.save_to_local,
    :92-110): header fields + click/order scores, one row per example,
    under a header row, written as the JAX package's pandas dump is."""
    ph = parse_headers(header_schema, headers)
    cols = (ph.uuids, ph.sids, ph.labels, np.asarray(clk_scores),
            np.asarray(ord_scores))
    with open(path, "w", newline="") as f:
        w = csv.writer(f, delimiter="\t", lineterminator="\n")
        w.writerow(("uuid", "sid", "label", "click_score", "order_score"))
        w.writerows(zip(*cols))
