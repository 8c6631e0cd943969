"""The training step (``cikm2020_dmt_tpu/train/loop.py`` ``step_fn`` and
its ``_lazy_step``), for every model of the zoo, on one device or on a
(data x model) mesh of one process per device (``core/mesh.py``).

One ``Trainer.train_step``:

1. ``collect`` the id union of every lazy-Adam table (``train/lazy.py``;
   under Adam without dense weight decay, tables of at least
   ``dedup_rows_threshold`` rows);
2. forward with those tables' lookups sliced from the union grid, the
   model family's loss (``losses.model_loss``, plus ``l2_regularization``
   where ``wnd_wd`` > 1e-5), and its backward.  With ``grid_bf16`` (or
   ``DMT_GRID_BF16=1`` when the trainer is built) the gathered rows of a
   float32 table are rounded to bfloat16 before they feed the grid, so
   the grid and its cotangent are bfloat16; the update reads the float32
   rows;
3. the dense optimizer (``train/optim.make_optimizer``) on every other
   leaf, the tables outside the plan included;
4. LazyAdam on the touched rows of each lazy table, in place;
5. the streaming AUC / precision / recall / mean-loss update.

The train state is a dict: ``params``, ``model_state`` (batch norm's
moving statistics, ``{}`` without ``is_bn``), the dense optimizer's state
``opt`` (Adam: ``m``, ``v``, ``count``), ``lazy_opt[table]["mv"]`` ([2,
R, D] float32 moments), ``step`` and ``lazy_overflow`` (distinct row
groups past the budget, cumulated; their gradient is skipped for that
step).  A batch is a dict of tensors on the trainer's device, keyed like
the reference's batch.

``Trainer.train`` is the chief's loop over files (JAX ``Trainer.train``):
epochs of the native batch stream, each batch packed into two pinned host
buffers and copied to the card on a side stream two batches ahead
(``device_batch``, ``device_prefetch``), a checkpoint with its DONE marker,
a result-file block and a summary line every ``validate_step`` steps, and
resume or warm start.

On a mesh (``Trainer(cfg, mesh=...)``) each data rank takes its own slice
of the global batch (``batch_size`` examples, its share of the files), the
model peers of a data index take the same slice, and the step is the JAX
package's on the global batch:

- each rank differentiates its local mean loss divided by the number of
  data ranks (the JAX loss is the global batch's mean); one float32
  ``all_reduce`` over every rank sums the replicated leaves' gradients
  with the gradient rows of the replicated and sharded lazy tables, whose
  union is the global batch's (``lazy.collect``), model index 0 giving
  its data shard's and the model peers zeros (``Mesh.data_sum``), so each
  data shard counts once, the sums are the data mesh's, and every rank
  holds the same bits; a model-split table's gradient (its rank's rows,
  through the model-group sum whose backward is the identity) is summed
  over the data group;
- a full-mesh table (``parallel/full_shard.py``) is split by rows over the
  ranks: the rank holds its share of the rows and moments, fetches its
  union's rows from their owners and pushes its gradient rows back;
- a model-split table (``parallel/embedding_shard.py``) is split by rows
  over the model group, its dense Adam moments alike; a sharded lazy
  table updates its rows with ``lazy.lazy_adam_rows_sharded``;
- batch norm takes the global batch's statistics (``core.mesh.active``);
  a rank of data index ``k > 0`` seeds its dropout generator with
  ``(seed + 1, step, k)``, so every dropout draw, the fused block's seed
  included, differs by data shard and model peers draw the same masks;
- the loss, ``lazy_overflow`` and the streaming metrics stay per rank
  and are reduced where they are read (log, save, ``train``'s result),
  each data shard counted once;
- a checkpoint is the one-process format: rank 0 writes the state gathered
  from the ranks (``convert.gather_state``), and every rank restores the
  whole state and keeps its share (``convert.shard_state``), so a
  checkpoint restores on any mesh;
- the ranks agree at each step boundary on a signal or the end of a
  rank's data, so none is left waiting in a collective.
"""

from __future__ import annotations

import collections
import math
import os
import signal
import time
from typing import Iterator, Optional

import numpy as np
import torch

from ..convert import gather_state, shard_params, shard_state
from ..core import mesh as meshlib
from ..core import tracing
from ..core.checkpoint import CheckpointManager
from ..core.config import DMTConfig
from ..core.logging import SummaryWriter, Throughput, log_line, log_to_file
from ..data import pipeline
from ..data.pipeline import Batch
from ..metrics.streaming import (task_metrics_init, task_metrics_update,
                                 task_metrics_values)
from ..models.base import float32_sums
from ..models.zoo import build_model
from ..parallel.full_shard import collect_fms, fms_adam_update
from .lazy import (build_lazy_plan, collect, lazy_adam_rows,
                   lazy_adam_rows_sharded, make_overlay)
from .losses import l2_regularization, model_loss, scores_from_logits
from .optim import make_optimizer, piecewise_constant


def make_input_stream(cfg: DMTConfig, path_spec: str, batch_size: int,
                      native: bool = True, **kw) -> Iterator[Batch]:
    """The batch stream the trainer reads: the C++ assembler's
    (``data/native.py``), whose library is built here, so a failed build
    raises now and not at the first batch.  There is no quiet fallback:
    the Python stream (``data/pipeline.batch_stream``, the same batches)
    runs only with ``native=False``."""
    if not native:
        kw.pop("with_headers", None)   # the native stream's knob
        return pipeline.batch_stream(cfg, path_spec, batch_size, **kw)
    from ..data.native import load_library, native_batch_stream
    load_library()
    return native_batch_stream(cfg, path_spec, batch_size, **kw)


_KINDS = {np.dtype(np.float32): ("f32", torch.float32),
          np.dtype(np.int32): ("i32", torch.int32)}


def pack_layout(arrays: dict) -> dict:
    """{kind: [(key, offset, shape), ...]}: where each array of a batch
    lies in the flat buffer of its dtype (``f32``, ``i32``), keys sorted.
    Each array is a contiguous run of its buffer, so the fields unpack as
    contiguous views."""
    layout: dict = {}
    for k in sorted(arrays):
        v = arrays[k]
        if v.dtype not in _KINDS:
            raise ValueError(f"batch array {k!r} has dtype {v.dtype}; the "
                             "packed transfer takes float32 and int32")
        fields = layout.setdefault(_KINDS[v.dtype][0], [])
        off = fields[-1][1] + math.prod(fields[-1][2]) if fields else 0
        fields.append((k, off, tuple(v.shape)))
    return layout


class Staging:
    """The host buffers of one packed batch and the event recorded after
    their last copy to the card: they are written again only once that
    event has completed."""

    def __init__(self):
        self.host: dict[str, torch.Tensor] = {}
        self.copied: Optional[torch.cuda.Event] = None


class _StepSignals:
    """SIGINT and SIGTERM (preemption) raise ``KeyboardInterrupt``, so the
    loop saves an emergency checkpoint, but never inside a step: a step
    updates the lazy tables in place, so a state cut in the middle of one
    is a state no step produced.  A signal that arrives during a step is
    raised when it ends (``step_done``).  Outside the main thread nothing
    is installed.  With ``defer`` (a data mesh) a signal is only recorded:
    the ranks agree on it at the next step boundary (``raise_pending``)."""

    def __init__(self, defer: bool = False):
        self.defer = defer
        self.in_step = False
        self.pending: Optional[int] = None
        self.previous: dict = {}

    def _handle(self, signum, frame):
        if self.in_step or self.defer:
            self.pending = signum
        else:
            raise KeyboardInterrupt(f"signal {signum}")

    def __enter__(self):
        for sig in (signal.SIGINT, signal.SIGTERM):
            try:
                self.previous[sig] = signal.signal(sig, self._handle)
            except ValueError:   # not the main thread
                pass
        return self

    def step_done(self) -> None:
        self.in_step = False
        if self.pending is not None and not self.defer:
            self.raise_pending()

    def raise_pending(self) -> None:
        sig, self.pending = self.pending, None
        raise KeyboardInterrupt(f"signal {sig}" if sig is not None
                                else "signal on another rank")

    def __exit__(self, *exc):
        for sig, handler in self.previous.items():
            signal.signal(sig, handler)
        return False


def dropout_seed(seed: int, step: int, data_index: int = 0) -> int:
    """The seed of step ``step``'s dropout generator, from ``(seed + 1,
    step)`` (the JAX loop folds the step into one key), and ``data_index``
    after them on data rank k > 0: a run resumed at step k draws the masks
    an uninterrupted run draws at step k."""
    key = [seed + 1, step] + ([data_index] if data_index else [])
    return int(np.random.SeedSequence(key).generate_state(1, np.uint64)[0])


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


def _detach(out):
    """Model logits (nested tuples of tensors) without their graph."""
    if isinstance(out, tuple):
        return tuple(_detach(t) for t in out)
    return out.detach()


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_rebuild(v, it) for v in tree]
    return next(it)


class Trainer:
    """Trains a model of the zoo on one device, or as one rank of a
    ``mesh`` (``core.mesh.build_mesh``; the rank's device is the mesh's).
    The default device is the card: without CUDA the constructor raises
    instead of training on the CPU.  Pass ``device="cpu"`` for the plain
    PyTorch path."""

    def __init__(self, cfg: DMTConfig, device="cuda", mesh=None):
        if mesh is not None:
            device = mesh.device
        self.mesh = mesh
        self.chief = mesh is None or mesh.rank == 0
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"Trainer: device {self.device} requested but CUDA is not "
                "available; pass device='cpu' to train on the CPU")
        float32_sums(self.device)
        self.cfg = cfg
        self._calls = 0
        # float32 lazy tables, bfloat16 union grid (JAX ``_lazy_step``,
        # which reads the variable at each step; here once, at
        # construction)
        self.grid_bf16 = (cfg.grid_bf16
                          or os.environ.get("DMT_GRID_BF16", "0") == "1")
        self.model = build_model(cfg)
        if mesh is not None:
            from ..parallel.embedding_shard import make_engine
            self.model.engine = make_engine(cfg, mesh)
        self.optimizer = make_optimizer(cfg)
        # mlp reads no table, whatever tables the config lists
        self.lazy_plan = build_lazy_plan(cfg, mesh) if self.model.has_tables \
            else ()
        # full-mesh tables: name -> (logical rows, group size)
        self.full_mesh = {t.name: (t.rows, t.group) for t in self.lazy_plan
                          if t.full_mesh}
        # lazy tables split over the model group: name -> (rows, group)
        self.sharded = {t.name: (t.rows, t.group) for t in self.lazy_plan
                        if t.sharded}
        self.schedule = piecewise_constant(cfg.step_boundary,
                                           cfg.learning_rate)
        self.ckpt = CheckpointManager(cfg.model_path)
        # how each dense gradient sums over a mesh (``_sum_over_ranks``)
        self._dense_over: Optional[list] = None
        self._pack_layout: Optional[dict] = None
        self._copy_stream = None
        self.save_seconds: dict[int, float] = {}

    def _dense(self, params: dict) -> dict:
        """The params minus the lazily updated tables (what the dense
        optimizer sees)."""
        if not self.lazy_plan:
            return params
        lazy = {t.name for t in self.lazy_plan}
        out = dict(params)
        out["emb"] = {k: v for k, v in params["emb"].items()
                      if k not in lazy}
        return out

    def init_state(self, gen: torch.Generator, whole: bool = False) -> dict:
        """Random params from ``gen`` (on the trainer's device), a fresh
        model state and zero optimizer state.  On a mesh every rank draws
        the same params from the same ``gen`` and keeps its share of the
        full-mesh tables, unless ``whole``."""
        params = self.model.init(gen)
        if self.mesh is not None and not whole:
            params = shard_params(self.cfg, params, self.mesh)
        state = {"params": params,
                 "model_state": self.model.init_state(params),
                 "opt": self.optimizer.init(self._dense(params)),
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
        tensors.  ``gen`` (on the trainer's device) drives dropout.  A
        packed batch (``device_batch``) is unpacked first.  Under
        ``core.tracing.recording()`` the call is a ``train.step`` span (id:
        the trainer's count of calls) whose four phases are
        ``train.collect``, ``train.forward``, ``train.backward`` and
        ``train.update``."""
        self._calls += 1
        with tracing.span("train.step", self._calls):
            with tracing.span("train.collect"):
                batch, cols = self._collect(state["params"], batch)
            with tracing.span("train.forward"):
                dense, leaves, rows_d, out, model_state, loss = \
                    self._forward(state, batch, cols, gen)
            with tracing.span("train.backward"):
                g_dense, g_rows = self._backward(dense, leaves, rows_d, loss)
            with tracing.span("train.update"), torch.no_grad():
                return self._update(state, metrics, batch, cols, dense,
                                    g_dense, g_rows, out, model_state, loss)

    def _collect(self, params: dict, batch: dict) -> tuple[dict, dict]:
        """The batch (unpacked) and each lazy table's id union."""
        if any(k.startswith("__packed_") for k in batch):
            batch = self.unpack_device_batch(batch, self._pack_layout)
        cols = {}
        for t in self.lazy_plan:
            table = params["emb"][t.name]
            cols[t.name] = (
                collect_fms(t, batch, table, self.mesh,
                            self.cfg.dedup_budget_div,
                            self.full_mesh[t.name][0]) if t.full_mesh
                else collect(t, batch, table, self.cfg.dedup_budget_div,
                             mesh=self.mesh))
        return batch, cols

    def _forward(self, state: dict, batch: dict, cols: dict,
                 gen: torch.Generator):
        """The diff leaves, the model's forward and the loss: (dense
        params, dense leaves, union-row leaves, logits, model state,
        loss)."""
        cfg, mesh = self.cfg, self.mesh
        params = state["params"]
        dense = self._dense(params)
        leaves = [t.detach().requires_grad_() for t in _flatten(dense, [])]
        dense_d = _rebuild(dense, iter(leaves))
        # the diff leaf; the update reads the rows as collected (c.rows)
        rows_d = {name: (c.rows.to(torch.bfloat16)
                         if self.grid_bf16 and c.rows.dtype == torch.float32
                         else c.rows).detach().requires_grad_()
                  for name, c in cols.items()}
        full = dict(dense_d)
        if cols:
            full["emb"] = dict(dense_d["emb"])
            for name in cols:
                full["emb"][name] = params["emb"][name]
        engine = self.model.engine
        # a full-mesh table has no exact-overflow fallback (JAX's neither)
        engine.overlay = {
            name: make_overlay(c, rows_d[name],
                               table=(params["emb"][name]
                                      if cfg.lazy_overflow_exact
                                      and name not in self.full_mesh
                                      else None),
                               shard=((mesh,) + self.sharded[name]
                                      if name in self.sharded else None))
            for name, c in cols.items()}
        try:
            with meshlib.active(mesh):
                out, model_state = self.model.apply(
                    full, batch, train=True, gen=gen,
                    state=state.get("model_state"), return_state=True)
                loss = model_loss(cfg, self.model.num_tasks, out, full,
                                  batch, train=True)
                if cfg.wnd_wd > 1e-5:   # the reference's gate
                    loss = loss + l2_regularization(cfg, full, batch, mesh)
        finally:
            engine.overlay = {}
        return dense, leaves, rows_d, out, model_state, loss

    def _backward(self, dense: dict, leaves: list, rows_d: dict,
                  loss: torch.Tensor) -> tuple[dict, dict]:
        """The gradients of the dense params (a tree like ``dense``) and of
        the union rows (by table), summed over the mesh's ranks."""
        mesh = self.mesh
        wrt = leaves + list(rows_d.values())
        # the global loss is the mean of the data ranks' local means
        objective = loss if mesh is None else loss * (1.0 / mesh.data)
        grads = torch.autograd.grad(objective, wrt, allow_unused=True)
        grads = [torch.zeros_like(w) if g is None else g
                 for w, g in zip(wrt, grads)]
        if mesh is not None:
            if self._dense_over is None:
                self._dense_over = [
                    "data" if p == "model_split" else "world"
                    for p in _flatten(meshlib.param_placement(
                        self.cfg, dense, mesh), [])]
            grads = self._sum_over_ranks(
                grads, self._dense_over
                + [None if name in self.full_mesh else "world"
                   for name in rows_d])
        return (_rebuild(dense, iter(grads[:len(leaves)])),
                dict(zip(rows_d, grads[len(leaves):])))

    def _update(self, state, metrics, batch, cols, dense, g_dense, g_rows,
                out, model_state, loss):
        """The dense optimizer, LazyAdam on each lazy table's rows and the
        streaming metrics: (state, metrics, loss)."""
        mesh = self.mesh
        params = state["params"]
        new_dense, opt = self.optimizer.update(dense, g_dense, state["opt"])
        count = state["step"] + 1
        new_params = dict(new_dense)
        if cols:
            new_params["emb"] = dict(new_dense["emb"])
        lazy_opt = {}
        overflow = state["lazy_overflow"]
        for name, c in cols.items():
            table, mv = params["emb"][name], state["lazy_opt"][name]["mv"]
            if name in self.full_mesh:
                table, mv = fms_adam_update(
                    mesh, table, mv, c, g_rows[name], count,
                    self.schedule, self.full_mesh[name][1],
                    self.cfg.fms_grad_bf16)
                # each rank's own union; model peers share theirs
                counts = mesh.model_index == 0
            elif name in self.sharded:
                table, mv = lazy_adam_rows_sharded(
                    mesh, table, mv, c.uids, c.rows, g_rows[name], count,
                    self.schedule, *self.sharded[name])
                counts = self.chief    # the global union: rank 0
            else:
                table, mv = lazy_adam_rows(table, mv, c.uids, c.rows,
                                           g_rows[name], count,
                                           self.schedule)
                counts = self.chief
            if counts:
                overflow = overflow + c.overflow
            new_params["emb"][name] = table
            lazy_opt[name] = {"mv": mv}
        new_state = {"params": new_params, "model_state": model_state,
                     "opt": opt, "step": count, "lazy_opt": lazy_opt,
                     "lazy_overflow": overflow}
        p_ctr, p_cvr = scores_from_logits(self.cfg, _detach(out))
        metrics = task_metrics_update(
            metrics, mask=batch["mask"], p_ctr=p_ctr, p_cvr=p_cvr,
            loss=loss.detach(), weights=batch["valid"])
        return new_state, metrics, loss.detach()

    def _sum_over_ranks(self, grads: list, over: list) -> list:
        """Each gradient summed by its entry in ``over``: ``"world"`` over
        the data shards by one float32 ``all_reduce`` over every rank
        (``Mesh.data_sum``: model peers hold the same batch rows, so model
        index 0 gives its shard's gradient and the others zeros; the same
        bits on every rank), ``"data"`` by one over the data group (a
        model-split table's rows); None as it is (a full-mesh table's union
        rows, pushed to their owners).  Each is cast back to its type."""
        out = list(grads)
        for axis in ("world", "data"):
            idx = [i for i, a in enumerate(over) if a == axis]
            if not idx:
                continue
            flat = torch.cat([grads[i].reshape(-1).float() for i in idx])
            if axis == "world":
                flat = self.mesh.data_sum(flat)
            else:
                self.mesh.all_reduce(flat, axis="data")
            off = 0
            for i in idx:
                n = grads[i].numel()
                out[i] = flat[off:off + n].view(grads[i].shape).to(
                    grads[i].dtype)
                off += n
        return out

    def reduce_metrics(self, metrics: dict) -> dict:
        """The streaming metrics summed over the data shards (one
        ``all_reduce``; every rank calls it), or ``metrics`` without a
        mesh."""
        if self.mesh is None:
            return metrics
        leaves = _flatten(metrics, [])
        flat = self.mesh.data_sum(
            torch.cat([t.reshape(-1).float() for t in leaves]))
        parts, off = [], 0
        for t in leaves:
            parts.append(flat[off:off + t.numel()].view(t.shape).to(t.dtype))
            off += t.numel()
        return _rebuild(metrics, iter(parts))

    def reduce_loss(self, loss: torch.Tensor) -> float:
        """The global batch's loss: the mean of the ranks' local means."""
        if self.mesh is None:
            return float(loss)
        return float(self.mesh.data_sum(loss.float().reshape(1))[0]
                      / self.mesh.data)

    def lazy_overflow(self, state: dict) -> int:
        """``lazy_overflow`` summed over the ranks."""
        ovf = state["lazy_overflow"]
        if self.mesh is None:
            return int(ovf)
        return int(self.mesh.reduce_sum(ovf.reshape(1))[0])

    def whole_state(self, state: dict) -> dict:
        """The one-process train state of a rank's ``state`` (every rank
        calls it), or ``state`` without a mesh."""
        if self.mesh is None:
            return state
        return gather_state(self.cfg, state, self.mesh)

    # ------------------------------------------------------------------
    def device_batch(self, batch: Batch, staging: Optional[Staging] = None,
                     stream=None) -> dict:
        """A host batch as tensors on the trainer's device.

        ``cfg.unit_weights`` drops the ``__wts`` arrays (the model rebuilds
        them from the lengths).  With ``cfg.packed_transfer`` (the default)
        the arrays are packed into one float32 and one int32 flat buffer
        (``pack_layout``), straight into pinned host memory, and each
        buffer goes to the card by one ``non_blocking`` copy on ``stream``
        (default: the current stream); ``train_step`` unpacks them.  The
        host buffers are ``staging``'s, reused once its last copy has
        completed, or new ones.  Without packing, ``pipeline.device_batch``
        copies each array."""
        arrays = batch.arrays
        if self.cfg.unit_weights:
            arrays = {k: v for k, v in arrays.items()
                      if not k.endswith(pipeline.WTS)}
        if not self.cfg.packed_transfer:
            return pipeline.device_batch(Batch(arrays, batch.headers),
                                         self.device)
        layout = pack_layout(arrays)
        if self._pack_layout is None:
            self._pack_layout = layout
        elif layout != self._pack_layout:
            raise ValueError("device_batch: the batch's arrays differ from "
                             "the first batch's (the packed layout)")
        cuda = self.device.type == "cuda"
        staging = staging or Staging()
        if staging.copied is not None:
            staging.copied.synchronize()
        out = {}
        stream = stream or (torch.cuda.current_stream(self.device)
                            if cuda else None)
        for kind, fields in layout.items():
            host = staging.host.get(kind)
            if host is None:
                k, off, shape = fields[-1]
                host = torch.empty(off + math.prod(shape),
                                   dtype=_KINDS[arrays[k].dtype][1],
                                   pin_memory=cuda)
                staging.host[kind] = host
            np.concatenate([arrays[k].reshape(-1) for k, _, _ in fields],
                           out=host.numpy())
            if cuda:
                with torch.cuda.stream(stream):
                    out["__packed_" + kind] = host.to(self.device,
                                                      non_blocking=True)
            else:
                out["__packed_" + kind] = host
        if cuda:
            staging.copied = torch.cuda.Event()
            staging.copied.record(stream)
            main = torch.cuda.current_stream(self.device)
            if stream != main:
                # allocated on the copy stream, read on the step's: the
                # allocator must not hand the memory out again before the
                # step's reads are done
                for t in out.values():
                    t.record_stream(main)
        return out

    @staticmethod
    def unpack_device_batch(batch: dict, layout: dict) -> dict:
        """The packed batch's fields as views of its buffers, keyed and
        typed as the unpacked batch (float32 and int32 tensors)."""
        out = {k: v for k, v in batch.items()
               if not k.startswith("__packed_")}
        for kind, fields in layout.items():
            buf = batch["__packed_" + kind]
            for k, off, shape in fields:
                out[k] = buf[off:off + math.prod(shape)].view(shape)
        return out

    def device_prefetch(self, data_iter: Iterator[Batch], depth: int = 2
                        ) -> Iterator[tuple[Batch, dict]]:
        """(host batch, device batch) pairs with ``depth`` batches in flight:
        on the card each batch is packed into one of ``depth`` pinned
        stagings and copied on a side stream, and the step's stream waits
        on the copy's event only when the batch is handed out, so a copy
        overlaps the steps before it."""
        cuda = self.device.type == "cuda"
        if cuda and self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        slots = [Staging() if cuda else None for _ in range(depth)]
        queue: collections.deque = collections.deque()

        def ready(item):
            batch, dev, copied = item
            if copied is not None:
                torch.cuda.current_stream(self.device).wait_event(copied)
            return batch, dev

        for i, batch in enumerate(data_iter):
            slot = slots[i % depth]
            dev = self.device_batch(batch, slot, self._copy_stream)
            queue.append((batch, dev, slot.copied if slot else None))
            if len(queue) >= depth:
                yield ready(queue.popleft())
        while queue:
            yield ready(queue.popleft())

    # ------------------------------------------------------------------
    def train(self, data_path: Optional[str] = None,
              max_steps: Optional[int] = None,
              resume_step: Optional[int] = None,
              log_every: int = 10,
              data_iter: Optional[Iterator[Batch]] = None,
              profile_dir: Optional[str] = None,
              profile_steps: tuple[int, int] = (10, 15)) -> dict:
        """The chief's loop; returns the final streaming metric values.

        Resumes from ``model.ckpt-{resume_step}`` when it is complete (the
        data restarts from the files' beginning), else starts from
        ``cfg.seed`` and warm-starts ``cfg.update_emb``.  Reads
        ``cfg.epoch_num`` shuffled epochs of ``data_path`` (default
        ``cfg.train_data_path``) through the native stream, or
        ``data_iter``, up to ``max_steps`` (default ``cfg.max_iter_step``).
        Logs every ``log_every`` steps; saves every ``cfg.validate_step``
        steps and at the end; saves at the step reached on Ctrl-C or
        SIGTERM, then re-raises.  Traces steps ``profile_steps`` (counted
        from the start) into ``profile_dir`` or ``$DMT_PROFILE_DIR`` as a
        Chrome trace, with the ``train.*`` spans of ``core.tracing`` among
        its host ranges.  Afterwards ``last_step`` and ``state`` hold the step
        reached and the train state."""
        cfg = self.cfg
        mesh = self.mesh
        data_path = data_path or cfg.train_data_path
        max_steps = max_steps if max_steps is not None else cfg.max_iter_step

        start_step = 0
        restore = resume_step is not None and self.ckpt.has_step(resume_step)
        if mesh is not None:
            # rank 0's checkpoint directory decides, and every rank must
            # read the same checkpoint: ranks that cannot all stop
            restore, = mesh.from_chief(restore)
            unseen, = mesh.agree(restore
                                 and not self.ckpt.has_step(resume_step))
            if unseen:
                raise RuntimeError(
                    f"model.ckpt-{resume_step} is complete in rank 0's "
                    f"model_path but missing on some rank's "
                    f"({cfg.model_path} here): every rank restores the "
                    "whole checkpoint, so the ranks need one shared "
                    "model_path")
        if restore:
            # every rank restores the whole state and keeps its share
            state = self.ckpt.restore(resume_step,
                                      "cpu" if mesh else self.device)
            start_step = resume_step
            self._log(f"resumed from model.ckpt-{resume_step}")
        else:
            state = self.init_state(
                torch.Generator(device=self.device).manual_seed(cfg.seed),
                whole=True)
            if cfg.update_emb:
                # warm-start pretrained tables (reference
                # run_dnn.py:298-299)
                from .warmstart import (parse_update_emb,
                                        warm_start_embeddings)
                state["params"] = warm_start_embeddings(
                    state["params"], parse_update_emb(cfg.update_emb))
                self._log(f"warm-started embeddings: {cfg.update_emb}")
        if mesh is not None:
            state = shard_state(cfg, state, mesh)

        own_iter = data_iter is None
        if own_iter:
            shards = {}
            if mesh is not None:
                # each data rank reads its own files (JAX: per process)
                files = pipeline.expand_files(data_path)
                if len(files) < mesh.data:
                    raise ValueError(
                        f"{len(files)} input files for {mesh.data} data "
                        "ranks: each rank reads files of its own")
                shards = dict(num_shards=mesh.data,
                              shard_index=mesh.data_index)
            # training never reads the row headers
            data_iter = pipeline.prefetch(make_input_stream(
                cfg, data_path, cfg.batch_size, epochs=cfg.epoch_num,
                shuffle=True, with_headers=False, **shards))

        metrics = task_metrics_init(self.device)
        meter = Throughput()
        summary = (SummaryWriter(cfg.summary_path, "train")
                   if cfg.summary_path and self.chief else None)
        gen = torch.Generator(device=self.device)
        data_index = mesh.data_index if mesh is not None else 0
        ranks = mesh.data if mesh is not None else 1
        profile_dir = profile_dir or os.environ.get("DMT_PROFILE_DIR")
        prof = None
        step = start_step
        self._saved_step = start_step
        eps = 0.0
        signals = _StepSignals(defer=mesh is not None)
        try:
            with signals:
                batches = self.device_prefetch(data_iter)
                while step < max_steps:
                    item = next(batches, None)
                    if mesh is not None:
                        # agreed at the boundary: a signal on any rank, or
                        # any rank's data at its end, stops every rank
                        end, sig = mesh.agree(item is None,
                                              signals.pending is not None)
                        if sig:
                            signals.raise_pending()
                        if end:
                            break
                    elif item is None:
                        break
                    batch, dev_batch = item
                    if profile_dir and step - start_step == profile_steps[0]:
                        prof = self._start_profile()
                    if prof is not None and \
                            step - start_step == profile_steps[1]:
                        self._stop_profile(prof, profile_dir, step)
                        prof = None
                    gen.manual_seed(dropout_seed(cfg.seed, step, data_index))
                    signals.in_step = True
                    state, metrics, loss = self.train_step(
                        state, metrics, dev_batch, gen)
                    step += 1
                    signals.step_done()
                    step_time, eps = meter.tick(batch.size * ranks)
                    if step % log_every == 0 or step == max_steps:
                        self._log_step(step, state, metrics, loss, eps,
                                       step_time)
                    if step % cfg.validate_step == 0 or step == max_steps:
                        vals = self._save(state, step, metrics)
                        if summary is not None:
                            vals["examples_per_sec"] = eps
                            summary.scalars(step, vals)
        except KeyboardInterrupt:
            # an interrupted run resumes from --model_ckpt model.ckpt-<step>
            if step != self._saved_step:
                self._log(f"interrupted at step {step}; saving emergency "
                          "ckpt")
                self._save(state, step, metrics)
            raise
        finally:
            if prof is not None:
                self._stop_profile(prof, profile_dir, step)
            if own_iter:
                data_iter.close()
        if step != self._saved_step:
            self._save(state, step, metrics)
        self.last_step = step
        self.state = state
        return task_metrics_values(self.reduce_metrics(metrics))

    def _log(self, msg: str) -> None:
        """A log line, from rank 0 only."""
        if self.chief:
            log_line(msg)

    def _log_step(self, step, state, metrics, loss, eps, step_time) -> None:
        """The JAX loop's metric line; the only place the loop waits for
        the card (``loss``, ``lazy_overflow``, the metrics, reduced over
        the ranks)."""
        vals = task_metrics_values(self.reduce_metrics(metrics))
        overflow = self.lazy_overflow(state)
        loss = self.reduce_loss(loss)
        ovf = ""
        if overflow > 0:
            ovf = (f" | LAZY-OVERFLOW {overflow} id-grads skipped (lower "
                   "dedup_budget_div)")
        self._log(
            f"step {step} | loss {loss:.6f} | "
            f"clk p/r/auc {vals['click_precision']:.4f}/"
            f"{vals['click_recall']:.4f}/{vals['click_auc']:.4f} | "
            f"ord p/r/auc {vals['order_precision']:.4f}/"
            f"{vals['order_recall']:.4f}/{vals['order_auc']:.4f} | "
            f"{eps:.0f} ex/s ({step_time * 1000:.0f} ms/step)" + ovf)

    def _start_profile(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        # the steps' spans show in the trace as record_function ranges
        self._profile_recording = tracing.recording()
        self._profile_recording.__enter__()
        return prof

    def _stop_profile(self, prof, profile_dir: str, step: int) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._profile_recording.__exit__(None, None, None)
        if not tracing.enabled():
            tracing.snapshot()   # the spans are in the trace; not kept
        prof.stop()
        os.makedirs(profile_dir, exist_ok=True)
        rank = f"-rank{self.mesh.rank}" if self.mesh is not None else ""
        path = os.path.join(profile_dir,
                            f"train-step{step}{rank}.trace.json")
        prof.export_chrome_trace(path)
        log_line(f"profiler trace written to {path}")

    def _save(self, state: dict, step: int, metrics) -> dict:
        """``model.ckpt-{step}`` with its DONE marker, and the train
        metrics appended to ``cfg.train_result_path``; returns the metric
        values.  On a mesh rank 0 writes the gathered state, and the DONE
        marker follows a barrier (every rank calls this)."""
        t0 = time.perf_counter()
        if self.mesh is None:
            self.ckpt.save(step, state)
        else:
            whole = gather_state(self.cfg, state, self.mesh)
            if self.chief:
                self.ckpt.write(step, whole)
            del whole
            self.mesh.barrier()
            if self.chief:
                self.ckpt.mark_done(step)
            self.mesh.barrier()
        self.save_seconds[step] = time.perf_counter() - t0
        # this run's last save: the ranks decide on the final save from it,
        # never from their view of the filesystem
        self._saved_step = step
        vals = task_metrics_values(self.reduce_metrics(metrics))
        if self.chief:
            lines = [f">> iter_steps:{step}"] + [
                f"train_{k}:{v}" for k, v in vals.items()]
            log_to_file("\n".join(lines), self.cfg.train_result_path)
        self._log(f"saved model.ckpt-{step} (+DONE marker) in "
                  f"{self.save_seconds[step]:.2f}s")
        return vals
