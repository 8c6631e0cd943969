"""The ranks of the port's mesh tests: functions that
``core.mesh.run_ranks`` runs in spawned processes.  This module imports
``torch`` and the port only (the spawned ranks import it by name), so the
ranks hold no JAX.  A rank takes the rows of its data index of a global
batch; model peers take the same rows."""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from chip_smoke import replicated_leaves
from cikm2020_dmt_torch.convert import gather_state, shard_state
from cikm2020_dmt_torch.core.mesh import build_mesh
from cikm2020_dmt_torch.metrics.streaming import (task_metrics_init,
                                                  task_metrics_values)
from cikm2020_dmt_torch.nn.layers import tree_map
from cikm2020_dmt_torch.train.loop import Trainer


def rank_rows(batch: dict, rank: int, n: int) -> dict:
    """Rank ``rank``'s rows [r B / n, (r + 1) B / n) of a global batch
    (numpy arrays or tensors), as tensors."""
    B = next(iter(batch.values())).shape[0]
    k = B // n
    return {key: torch.as_tensor(np.ascontiguousarray(v[rank * k:
                                                        (rank + 1) * k])
                                 if isinstance(v, np.ndarray)
                                 else v[rank * k:(rank + 1) * k])
            for key, v in batch.items()}


def leaves(tree, prefix=""):
    """(path, leaf) of each leaf of a nested dict / list tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def train_steps(rank: int, cfg, state: dict, batches: list,
                env: dict) -> dict:
    """Steps of ``Trainer(cfg, mesh=)`` from the whole ``state`` over the
    global ``batches`` (dropout generator seeded 0).  Returns the global
    losses, the gathered state after each step (rank 0), the summed
    ``lazy_overflow``, the reduced metric values, the leaves every rank
    holds whole after each step and whether JAX was imported."""
    os.environ.update(env)
    mesh = build_mesh(cfg, device="cpu")
    tr = Trainer(cfg, mesh=mesh)
    st = shard_state(cfg, state, mesh)
    metrics = task_metrics_init()
    gen = torch.Generator().manual_seed(0)
    losses, states, same = [], [], []
    for b in batches:
        st, metrics, loss = tr.train_step(
            st, metrics, rank_rows(b, mesh.data_index, mesh.data), gen)
        same.append(replicated_leaves(tr, st))
        losses.append(tr.reduce_loss(loss))
        # copies: the lazy tables are updated in place by the next step
        whole = tree_map(lambda t: t.clone(), tr.whole_state(st))
        if rank == 0:
            states.append(whole)
    return {"losses": losses, "states": states,
            "overflow": tr.lazy_overflow(st),
            "metrics": task_metrics_values(tr.reduce_metrics(metrics)),
            "plan": [(t.name, t.full_mesh) for t in tr.lazy_plan],
            "sharded": [t.name for t in tr.lazy_plan if t.sharded],
            "share_rows": {k: int(v.shape[0])
                           for k, v in st["params"]["emb"].items()},
            "replicated": same,
            "jax": any(m.split(".")[0] in ("jax", "cikm2020_dmt_tpu")
                       for m in sys.modules)}


def mesh_shape(rank: int, cfg) -> dict:
    """``build_mesh`` on this rank and a ``Trainer`` on it: the mesh's
    (data, model, data index, model index), the model-group sum of rank +
    1 and the data-shard sum of 1."""
    from cikm2020_dmt_torch.core.mesh import model_axis_sum
    mesh = build_mesh(cfg, device="cpu")
    Trainer(cfg, mesh=mesh)
    one = torch.ones(1)
    return {"shape": (mesh.data, mesh.model, mesh.data_index,
                      mesh.model_index),
            "model_sum": float(model_axis_sum(one * (rank + 1), mesh)[0]),
            "data_sum": float(mesh.data_sum(one)[0])}


def dropout_masks(rank: int, cfg, state: dict, batch: dict) -> dict:
    """One training step with dropout on, the rank's generator seeded as
    ``Trainer.train`` seeds it: the loss, and the fused block's seed of
    each call on this rank."""
    from cikm2020_dmt_torch.ops import block
    from cikm2020_dmt_torch.train.loop import dropout_seed
    mesh = build_mesh(cfg, device="cpu")
    tr = Trainer(cfg, mesh=mesh)
    st = shard_state(cfg, state, mesh)
    seeds = []
    real = block._FusedBlock.apply

    def spy(enc_in, dec_in, seq_mask, seed, *rest):
        seeds.append(int(seed.reshape(-1)[0]))
        return real(enc_in, dec_in, seq_mask, seed, *rest)

    block._FusedBlock.apply = spy
    try:
        st, _, loss = tr.train_step(st, task_metrics_init(),
                                    rank_rows(batch, rank, mesh.size),
                                    torch.Generator().manual_seed(
                                        dropout_seed(cfg.seed, 0,
                                                     mesh.data_index)))
    finally:
        block._FusedBlock.apply = real
    return {"loss": tr.reduce_loss(loss), "seeds": seeds}


def round_trip(rank: int, cfg, state: dict) -> dict:
    """``shard_state`` then ``gather_state``: the rank's share sizes and
    the whole state again."""
    mesh = build_mesh(cfg, device="cpu")
    share = shard_state(cfg, state, mesh)
    return {"rows": {k: int(v.shape[0])
                     for k, v in share["params"]["emb"].items()},
            "bias_rows": {k: int(v.shape[0]) for k, v in
                          share["params"].get("bias_net", {}).get(
                              "emb", {}).items()},
            "opt_rows": {k: int(v.shape[0])
                         for k, v in share["opt"]["v"]["emb"].items()},
            "mv_rows": {k: int(v["mv"].shape[1])
                        for k, v in share["lazy_opt"].items()},
            "overflow": int(share["lazy_overflow"]),
            "whole": gather_state(cfg, share, mesh)}


def eval_split(rank: int, cfg, params: dict, model_state: dict,
               path: str, batch_size: int, detail: str) -> tuple:
    """``run_eval`` over the files of ``path`` on the data mesh."""
    from cikm2020_dmt_torch.models.zoo import build_model
    from cikm2020_dmt_torch.train.evaluate import run_eval
    mesh = build_mesh(cfg, device="cpu")
    vals, headers, p_clk, p_ord = run_eval(
        cfg, build_model(cfg), params, path, batch_size, mesh=mesh,
        model_state=model_state, detail_file=detail)
    return vals, len(headers), p_clk, p_ord


def train_save_eval(rank: int, cfg, batches: list, eval_batches: list
                    ) -> dict:
    """``Trainer.train`` on the mesh over the rank's rows of the global
    ``batches`` (a save at the end, in the shared ``model_path``), then
    ``run_eval(mesh=)`` of the state it ended with on ``eval_batches``.
    Returns the step reached and the eval's result."""
    from cikm2020_dmt_torch.data.pipeline import Batch
    from cikm2020_dmt_torch.train.evaluate import run_eval
    mesh = build_mesh(cfg, device="cpu")
    tr = Trainer(cfg, mesh=mesh)
    k = next(iter(batches[0].values())).shape[0] // mesh.data
    d = mesh.data_index
    mine = [Batch({key: np.ascontiguousarray(v[d * k:(d + 1) * k])
                   for key, v in b.items()}) for b in batches]
    tr.train(max_steps=len(batches), data_iter=iter(mine), log_every=100)
    n = next(iter(eval_batches[0].values())).shape[0]
    vals, _, p_clk, p_ord = run_eval(
        cfg, tr.model, tr.state["params"], None, n, mesh=mesh,
        model_state=tr.state["model_state"],
        data_iter=[Batch(b, [b""] * n) for b in eval_batches])
    return {"last_step": tr.last_step, "eval": (vals, p_clk, p_ord)}


def eval_batches(rank: int, cfg, params: dict, model_state: dict,
                 batches: list) -> tuple:
    """``run_eval`` of the whole ``params`` over global ``batches`` on the
    mesh: the metric values and the scores."""
    from cikm2020_dmt_torch.data.pipeline import Batch
    from cikm2020_dmt_torch.models.zoo import build_model
    from cikm2020_dmt_torch.train.evaluate import run_eval
    mesh = build_mesh(cfg, device="cpu")
    n = next(iter(batches[0].values())).shape[0]
    vals, _, p_clk, p_ord = run_eval(
        cfg, build_model(cfg), params, None, n, mesh=mesh,
        model_state=model_state,
        data_iter=[Batch(b, [b""] * n) for b in batches])
    return vals, p_clk, p_ord


def cli_train(rank: int, argv: list) -> dict:
    """``cli.train.main(argv + --process_id rank)``: the flags start the
    process group.  Returns the steps it saved and, on rank 0, the state
    the ranks ended with, gathered."""
    from cikm2020_dmt_torch.cli import train as cli
    tr = cli.main(argv + ["--process_id", str(rank)])
    whole = tr.whole_state(tr.state)
    return {"last_step": tr.last_step, "steps": tr.ckpt.all_steps(),
            "state": whole if rank == 0 else None,
            "jax": any(m.split(".")[0] in ("jax", "cikm2020_dmt_tpu")
                       for m in sys.modules)}


def train_own_dir(rank: int, cfg, dirs: list, batches: list,
                  resume_step) -> dict:
    """``Trainer.train`` on the data mesh over the rank's rows of the
    global ``batches``, with ``output_path`` ``dirs[rank]`` (the ranks do
    not share a ``model_path``).  Returns the step reached and the steps
    saved here."""
    import dataclasses
    from cikm2020_dmt_torch.data.pipeline import Batch
    cfg = dataclasses.replace(cfg, output_path=dirs[rank])
    mesh = build_mesh(cfg, device="cpu")
    tr = Trainer(cfg, mesh=mesh)
    k = next(iter(batches[0].values())).shape[0] // mesh.size
    mine = [Batch({key: np.ascontiguousarray(v[rank * k:(rank + 1) * k])
                   for key, v in b.items()}) for b in batches]
    tr.train(max_steps=len(batches), resume_step=resume_step,
             data_iter=iter(mine), log_every=100)
    return {"last_step": tr.last_step, "steps": tr.ckpt.all_steps()}


def card_collectives(rank: int) -> dict:
    """The mesh's collectives on two ranks sharing the card over gloo:
    bfloat16 ``all_to_all`` and ``all_gather`` (moved as bytes), float32
    ``all_reduce``, ``agree`` and ``from_chief``."""
    dev = torch.device("cuda", 0)
    from cikm2020_dmt_torch.core.config import DMTConfig
    mesh = build_mesh(DMTConfig(), device=dev)
    x = (torch.arange(8, device=dev, dtype=torch.float32) + 10 * rank)
    a2a = mesh.all_to_all(x.to(torch.bfloat16).reshape(4, 2))
    gathered = mesh.all_gather(x.to(torch.bfloat16))
    summed = mesh.all_reduce(x.clone())
    return {"a2a": a2a.float().cpu(), "gathered": gathered.float().cpu(),
            "sum": summed.cpu(), "agree": mesh.agree(rank == 1, False),
            "from_chief": mesh.from_chief(rank == 0, rank == 1),
            "device": str(a2a.device), "backend": mesh.backend}


def card_mesh_step(rank: int, cfg, batch: dict) -> dict:
    """One step of ``Trainer(cfg, mesh=)`` on the card from the seeded
    init, counted: the global loss, the rank's launches, its full-mesh and
    model-split tables and the leaves every rank holds whole."""
    import chip_smoke as cs
    dev = torch.device("cuda", 0)
    mesh = build_mesh(cfg, device=dev)
    tr = Trainer(cfg, mesh=mesh)
    st = tr.init_state(torch.Generator(device=dev).manual_seed(0))
    cs.reset_counts()
    st, _, loss = tr.train_step(
        st, task_metrics_init(dev),
        {k: v.to(dev) for k, v in
         rank_rows(batch, mesh.data_index, mesh.data).items()},
        torch.Generator(device=dev))
    torch.cuda.synchronize()
    return {"loss": tr.reduce_loss(loss), "counts": cs.read_counts(),
            "full_mesh": sorted(tr.full_mesh),
            "split": sorted(getattr(tr.model.engine, "split", ())),
            "replicated": {k: v.cpu()
                           for k, v in replicated_leaves(tr, st).items()}}


def engine_lookups(rank: int, cfg, cases: list) -> list:
    """Each case's lookup of a model-split table ``"T"`` through
    ``ShardedEmbeddingEngine`` on this rank's share and its data index's
    rows: ``pooled`` or ``seq`` of ``case["ids"]``, the loss sum((y -
    target)^2) differentiated into the share and summed over the data
    group.  Returns per case the global output (gathered over the data
    group), the whole gradient (gathered over the model group) and which
    seq lookups took the exchange."""
    import dataclasses
    from cikm2020_dmt_torch.convert import _whole
    from cikm2020_dmt_torch.parallel.embedding_shard import \
        ShardedEmbeddingEngine
    from cikm2020_dmt_torch.parallel.full_shard import share_rows
    mesh = build_mesh(cfg, device="cpu")
    out = []
    for c in cases:
        R, p = c["R"], c["p"]
        eng = ShardedEmbeddingEngine(
            dataclasses.replace(cfg, shard_seq_exchange=c["exchange"]),
            mesh, {}, {"T": (R, p)})
        took = []
        real = eng._exchange

        def spy(*a, real=real, took=took):
            got = real(*a)
            took.append(got is not None)
            return got

        eng._exchange = spy
        lo, hi = share_rows(R, p, mesh.model, mesh.model_index)
        share = torch.from_numpy(c["table"][lo:hi]).requires_grad_()
        rows = rank_rows({k: c[k] for k in ("ids", "wts", "lens", "target")
                          if k in c}, mesh.data_index, mesh.data)
        if c["kind"] == "pooled":
            y = eng.pooled("T", share, rows["ids"], rows["wts"],
                           rows["lens"], combiner=c["combiner"])
        else:
            y = eng.seq("T", share, rows["ids"])
        grad, = torch.autograd.grad(((y - rows["target"]) ** 2).sum(), share)
        mesh.all_reduce(grad, axis="data")
        lo0, hi0 = share_rows(R, p, mesh.model, 0)
        out.append({"y": mesh.all_gather(y.detach(), axis="data").reshape(
                        -1, *y.shape[1:]),
                    "grad": _whole(mesh, grad, 0, R, hi0 - lo0, "model"),
                    "exchange": took})
    return out
