"""Evaluator and predict: the checkpoint-polling eval loop and the scoring
of test splits (``cikm2020_dmt_tpu/train/evaluate.py``).

- ``make_eval_step``: the forward with ``train=False`` (dropout off, batch
  norm on its moving statistics), the model family's loss
  (``losses.model_loss``), the scores (``rel_only`` drops the bias head;
  a single-task model gives one probability for both tasks) and the
  streaming metric update weighted by ``valid``; with ``collect_gates``
  (the MMoE family only) also the valid-weighted sum of the per-task
  expert-gate softmax, taken from the same forward.
- ``run_eval``: drains an eval split read from files by the C++ assembler
  (``train/loop.make_input_stream``: unshuffled, the last batch padded),
  or given batches; collects the valid rows' scores and their header
  lines (``metrics/offline.HeaderCollector``), optionally a per-row detail
  file and the mean gate softmax.
- ``validation``: the evaluator role.  It polls ``cfg.model_path`` for
  DONE-marked checkpoints (``core/checkpoint.py``), evaluates each new one
  on the validation split and appends the streaming metrics and the
  offline session metrics (P@N / MRR@N on sigma_clk + sigma_ord) to the
  validation result file.
- ``predict``: the test role.  It scores every test path with one
  checkpoint, relevance-only or bias-combined (``test_score_method``),
  and writes a result file (streaming metrics, gate lines, P@N / MRR@N,
  grouped and overall AUC, optionally the blend-weight grid search) and a
  detail file.

Every model of the zoo's registry evaluates; a paper baseline or an
unknown model type raises.  Every entry point runs on the card unless
asked for ``device="cpu"``, and raises where there is no card.
"""

from __future__ import annotations

import os
import re
import time
from typing import Iterable, Optional

import numpy as np
import torch

from ..core.checkpoint import CheckpointManager
from ..core.config import DMTConfig
from ..core.logging import SummaryWriter, log_line, log_to_file
from ..data.pipeline import Batch, device_batch, prefetch
from ..metrics import offline
from ..metrics.streaming import (task_metrics_init, task_metrics_update,
                                 task_metrics_values)
from ..models.base import float32_sums
from ..models.zoo import BaseModel, build_model, model_class
from ..nn.layers import tree_map
from .losses import model_loss, scores_from_logits

TASKS = ("click", "order")


def check_device(device, who: str) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without CUDA raises
    instead of falling back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}: device {device} requested but CUDA is "
                           "not available; pass device='cpu' to run on the "
                           "CPU")
    float32_sums(device)
    return device


def make_eval_step(cfg: DMTConfig, model: BaseModel, rel_only: bool = False,
                   collect_gates: bool = False):
    """``eval_step(params, metrics, batch, model_state=None) -> (metrics,
    p_ctr, p_cvr)`` on the device of ``batch``'s tensors (``model_state``
    defaults to a fresh model's); with ``collect_gates`` a fourth value,
    the valid-weighted sum of the gate softmax ``[T, E]``.  A model type
    outside the registry raises ``ValueError``, and so does
    ``collect_gates`` on a model without gates."""
    if not model_class(cfg.model_type).has_gates and collect_gates:
        raise ValueError(f"eval: model_type {cfg.model_type!r} has no "
                         "expert gates to collect")

    @torch.inference_mode()
    def eval_step(params, metrics, batch, model_state=None):
        out = model.apply(params, batch, train=False, is_predict=False,
                          state=model_state, return_gates=collect_gates)
        if collect_gates:
            out, gates = out
        loss = model_loss(cfg, model.num_tasks, out, params, batch,
                          train=False)
        p_ctr, p_cvr = scores_from_logits(cfg, out, rel_only=rel_only)
        metrics = task_metrics_update(
            metrics, mask=batch["mask"], p_ctr=p_ctr, p_cvr=p_cvr,
            loss=loss, weights=batch["valid"])
        if collect_gates:
            gate_sum = torch.einsum("tbe,b->te", gates, batch["valid"])
            return metrics, p_ctr, p_cvr, gate_sum
        return metrics, p_ctr, p_cvr

    return eval_step


def run_eval(cfg: DMTConfig, model: BaseModel, params,
             data_path: Optional[str], batch_size: int, *,
             rel_only: bool = False,
             data_iter: Optional[Iterable[Batch]] = None,
             collect_gates: bool = False, detail_file: Optional[str] = None,
             device="cuda", model_state: Optional[dict] = None,
             mesh=None):
    """Drains an eval split on ``device``; returns (metric values, headers,
    p_clk, p_ord), the scores float32 numpy arrays over the valid rows.

    The split is read from ``data_path`` in batches of ``batch_size``, or
    taken from ``data_iter`` (``Batch``es of numpy arrays or tensors,
    padded rows with ``valid`` 0 last).  ``headers`` is the list of raw
    lines, or a ``ParsedHeaders`` once the split crosses the collector's
    threshold; every offline metric takes either.  With ``detail_file``,
    "header\\tp_clk\\tp_ord" lines are appended batch by batch.  With
    ``collect_gates`` a fifth value: the valid-weighted mean gate softmax
    per task, ``[num_tasks, num_experts]`` float64 (the MMoE family
    only).  ``model_state`` is the checkpoint's (batch norm's moving
    statistics; default a fresh model's).  The default device is the
    card: without CUDA this raises.  Pass ``device="cpu"`` for the plain
    path.

    With ``mesh`` (``core.mesh.build_mesh``; every rank calls this on the
    same stream) each data shard scores its equal slice of every batch on
    the mesh's device (model peers the same slice), a full-mesh table's
    rows come from their owners and a model-split table's from the model
    group (``parallel/embedding_shard.make_engine``; ``params`` may hold
    the whole tables or the rank's shares), the scores are gathered in
    batch order and each data shard's metrics counted once; every rank
    returns the one-process result, and only rank 0 writes
    ``detail_file``."""
    if mesh is not None:
        from ..convert import shard_params
        from ..parallel.embedding_shard import make_engine
        device = mesh.device
        model.engine = make_engine(cfg, mesh)
        params = shard_params(cfg, params, mesh)
    device = check_device(device, "run_eval")
    step_fn = make_eval_step(cfg, model, rel_only, collect_gates)
    params = tree_map(lambda t: t.to(device), params)
    if model_state is not None:
        model_state = tree_map(lambda t: t.to(device), model_state)
    metrics = task_metrics_init(device)
    collector = offline.HeaderCollector(cfg.header_schema)
    clk_scores: list[np.ndarray] = []
    ord_scores: list[np.ndarray] = []
    gate_total: Optional[np.ndarray] = None
    n_total = 0
    own_iter = data_iter is None
    if own_iter:
        from .loop import make_input_stream
        data_iter = prefetch(make_input_stream(
            cfg, data_path, batch_size, epochs=1, shuffle=False,
            drop_remainder=False, pad_remainder=True))
    chief = mesh is None or mesh.rank == 0
    detail = open(detail_file, "a") if detail_file and chief else None
    try:
        for batch in data_iter:
            dev_batch = device_batch(batch, device)
            if mesh is not None:
                dev_batch = _rank_slice(dev_batch, mesh)
            out = step_fn(params, metrics, dev_batch, model_state)
            metrics, p_ctr, p_cvr = out[:3]
            if mesh is not None:
                p_ctr, p_cvr = (mesh.all_gather(p, axis="data").reshape(-1)
                                for p in (p_ctr, p_cvr))
            n_valid = int(batch["valid"].sum())
            pc = p_ctr[:n_valid].cpu().numpy()
            po = p_cvr[:n_valid].cpu().numpy()
            clk_scores.append(pc)
            ord_scores.append(po)
            lines = batch.headers[:n_valid]
            collector.extend(lines)
            if detail is not None:
                detail.writelines(
                    h.decode() + f"\t{sc}\t{so}\n"
                    for h, sc, so in zip(lines, pc, po))
            if collect_gates:
                gs = out[3].cpu().numpy().astype(np.float64)
                gate_total = gs if gate_total is None else gate_total + gs
                n_total += n_valid
    finally:
        if detail is not None:
            detail.close()
        if own_iter:
            data_iter.close()
    if mesh is not None:
        metrics = _sum_over_ranks(metrics, mesh)
        if gate_total is not None:
            gate_total = mesh.data_sum(
                torch.from_numpy(gate_total).to(device)).cpu().numpy()
    headers = collector.result()
    p_clk = np.concatenate(clk_scores) if clk_scores else np.zeros(
        0, np.float32)
    p_ord = np.concatenate(ord_scores) if ord_scores else np.zeros(
        0, np.float32)
    vals = task_metrics_values(metrics)
    if collect_gates:
        gate_mean = (gate_total / max(n_total, 1)
                     if gate_total is not None else None)
        return vals, headers, p_clk, p_ord, gate_mean
    return vals, headers, p_clk, p_ord


def _rank_slice(batch: dict, mesh) -> dict:
    """The data shard's equal slice of every array of a batch (rows
    [d * B / n, (d + 1) * B / n) of data index d of n)."""
    B = batch["valid"].shape[0]
    if B % mesh.data:
        raise ValueError(f"run_eval: batch of {B} rows does not split over "
                         f"{mesh.data} data ranks")
    n, d = B // mesh.data, mesh.data_index
    return {k: v[d * n:(d + 1) * n] for k, v in batch.items()}


def _sum_over_ranks(metrics: dict, mesh) -> dict:
    """The streaming metrics summed over the data shards."""
    return tree_map(lambda t: mesh.data_sum(t.reshape(-1)).view(t.shape),
                    metrics)


_ITER_RE = re.compile(r">> iter_steps:(\d+)")


def newest_result_step(result_path: str) -> int:
    """Reference get_validation_newest_step (run_dnn.py:391-406)."""
    if not os.path.exists(result_path):
        return 0
    step = 0
    with open(result_path) as f:
        for line in f:
            m = _ITER_RE.search(line)
            if m:
                step = max(step, int(m.group(1)))
    return step


def _write_offline_metrics(cfg: DMTConfig, headers, total_score,
                           out_path: str) -> dict:
    metric_sets = offline.precision_mrr_at_n(
        cfg.header_schema, headers, total_score)
    for action, (pre, mrr) in metric_sets.items():
        lines = []
        for n, p, m in zip(offline.AT_LIST, pre, mrr):
            lines.append(f"action_{action}_pre_at_{n}: {p}")
            lines.append(f"action_{action}_mrr_at_{n}: {m}")
        log_to_file("\n".join(lines), out_path)
    return metric_sets


def _restore_for_eval(ckpt: CheckpointManager, step: int
                      ) -> tuple[dict, dict]:
    """(params, model state) of ``model.ckpt-{step}`` on the host.  The
    port's checkpoint is one train state whatever the optimizer layout
    (``core/checkpoint.py``), so no template is needed; eval reads only
    these two (a checkpoint without a model state has the state ``{}``)."""
    state = ckpt.restore(step, "cpu")
    return state["params"], state.get("model_state", {})


def validation(cfg: DMTConfig, once: bool = False,
               poll_interval: float = 5.0, max_steps: Optional[int] = None,
               device="cuda") -> Optional[dict]:
    """Evaluator role: poll for new checkpoints, evaluate each
    (reference validation(), run_dnn.py:432-632); returns the last
    streaming metric values, or None when no checkpoint was evaluated."""
    device = check_device(device, "validation")
    model = build_model(cfg)
    ckpt = CheckpointManager(cfg.model_path)
    result_path = cfg.validation_result_path
    step = newest_result_step(result_path)
    limit = max_steps if max_steps is not None else cfg.max_iter_step
    summary = (SummaryWriter(cfg.summary_path, "validation")
               if cfg.summary_path else None)
    last_vals = None
    while step < limit:
        new_step = ckpt.newest_step_after(step)
        if new_step is None:
            if once:
                break
            time.sleep(poll_interval)
            continue
        step = new_step
        params, mstate = _restore_for_eval(ckpt, step)
        vals, headers, p_clk, p_ord = run_eval(
            cfg, model, params, cfg.validation_data_path,
            cfg.validation_batch_size, device=device, model_state=mstate)
        log_line(f"validation @ step {step}: " + " | ".join(
            f"{k} {v:.6f}" for k, v in vals.items()))
        lines = [f">> iter_steps:{step}"] + [
            f"validation_{k}:{v}" for k, v in vals.items()]
        log_to_file("\n".join(lines), result_path)
        if summary is not None:
            summary.scalars(step, vals)
        # offline session metrics on sigma_clk + sigma_ord (run_dnn.py:617-629)
        _write_offline_metrics(cfg, headers, p_clk + p_ord, result_path)
        last_vals = vals
        if once:
            break
    return last_vals


def _gate_lines(gate_mean: np.ndarray) -> list[str]:
    return [f"gate_{task}_expert_{e}: {gate_mean[t, e]}"
            for t, task in enumerate(TASKS[:gate_mean.shape[0]])
            for e in range(gate_mean.shape[1])]


def predict(cfg: DMTConfig, ckpt_step: int, test_tag: str = "",
            test_score_method: str = "rel", grid_search: bool = False,
            device="cuda") -> dict:
    """Test role (reference predict(), run_dnn.py:635-897): score every
    test path with ``model.ckpt-{ckpt_step}``, write the result and detail
    files, compute the offline metrics; returns them per path."""
    device = check_device(device, "predict")
    model = build_model(cfg)
    params, mstate = _restore_for_eval(CheckpointManager(cfg.model_path),
                                       ckpt_step)
    paths = (cfg.test_data_path_ord if test_tag == "ord"
             else cfg.test_data_path).split(",")
    rel_only = test_score_method == "rel"

    out_file = os.path.join(
        cfg.output_path or ".",
        f"{cfg.tag}.ckpt-{ckpt_step}.test_result_{test_tag}_{test_score_method}")
    detail_file = out_file + ".detail"
    for p in (out_file, detail_file):
        if os.path.exists(p):
            os.remove(p)

    results = {}
    for test_path in paths:
        test_path = test_path.strip()
        if not test_path:
            continue
        # the mmoe family's expert-gate distributions go into the result
        # file (the reference fetches the gate softmax by name each batch,
        # run_dnn.py:721-725,777-814)
        out = run_eval(
            cfg, model, params, test_path, cfg.test_batch_size,
            rel_only=rel_only, collect_gates=model.has_gates,
            detail_file=detail_file, device=device, model_state=mstate)
        vals, headers, p_clk, p_ord = out[:4]
        gate_mean = out[4] if model.has_gates else None
        log_line(f"test[{test_path}]: " + " | ".join(
            f"{k} {v:.6f}" for k, v in vals.items()))
        log_to_file("\n".join([f">> ckpt:{ckpt_step} path:{test_path}"] +
                              [f"test_{k}:{v}" for k, v in vals.items()]),
                    out_file)
        if gate_mean is not None:
            log_to_file("\n".join(_gate_lines(gate_mean)), out_file)
            log_line("mean gate softmax per task: " + "; ".join(
                f"{task} {np.array2string(gate_mean[t], precision=4)}"
                for t, task in enumerate(TASKS[:gate_mean.shape[0]])))
        total = p_clk + p_ord  # reference total score (run_dnn.py:833-849)
        # parse the header lines once; every metric below shares them
        parsed = offline.parse_headers(cfg.header_schema, headers)
        pm = _write_offline_metrics(cfg, parsed, total, out_file)
        gauc = offline.grouped_auc(cfg.header_schema, parsed, total)
        oauc_clk = offline.overall_auc(cfg.header_schema, parsed, p_clk)
        oauc_ord = offline.overall_auc(cfg.header_schema, parsed, p_ord)
        log_to_file(
            f"grouped_auc_click: {gauc[offline.CLICK]}\n"
            f"grouped_auc_order: {gauc[offline.ORDER]}\n"
            f"overall_auc_click: {oauc_clk[offline.CLICK]}\n"
            f"overall_auc_order: {oauc_ord[offline.ORDER]}", out_file)
        results[test_path] = {
            "streaming": vals, "precision_mrr": pm, "grouped_auc": gauc,
            "overall_auc": {"click": oauc_clk[offline.CLICK],
                            "order": oauc_ord[offline.ORDER]},
        }
        if gate_mean is not None:
            results[test_path]["gate_mean"] = gate_mean
        if grid_search:
            # metrics2-style blend-weight sweep + per-head/weighted AUCs
            from ..metrics.offline_ext import grid_search as run_grid
            results[test_path]["grid"] = run_grid(
                cfg.header_schema, parsed, p_clk, p_ord, out_file=out_file)
    return results
