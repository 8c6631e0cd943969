"""Micro-batching scorer queue: concurrent rerank requests share one
forward (``cikm2020_dmt_tpu/serve/queue.py``).

The reference serves one TF SavedModel session per request
(reference saved_model/export_model.py:109-115, the Scores signature this
queue keeps).  A served request is host-bound: its launches cost more host
time than the card spends on them.  ``ScorerQueue`` drains whatever
requests are waiting (up to ``max_group``) into one
``Scorer.score_group_async`` pass, so under concurrent load the host work
of a launch is shared by the group, while a lone request is dispatched at
once: no request waits for a batching window.

Each request's layout (its keys, shapes and dtypes) is built once, by
``submit``; the dispatcher holds each request's layout against the first
request of the group and scores a request that differs alone.  The JAX
queue instead retries a failed group one request at a time; that helps
only for errors raised on the host, since a fault on the card stays with
the whole CUDA context.  The retry is kept for host errors.

Usage:
    q = ScorerQueue(scorer)
    fut = q.submit(batch_dict)        # batch from assemble(tile_uside=False)
    scores = fut.result()             # {"Scores": [B] tensor, ...}
    q.close()
"""

from __future__ import annotations

import queue as queuelib
import threading
from concurrent.futures import Future

import numpy as np

from ..core import tracing


_DTYPE_NAMES: dict = {}


def _dtype_name(dtype) -> str:
    """``str(dtype)``, built once per distinct dtype of the process (a
    NumPy or a torch dtype): stringifying one costs microseconds, and a
    request has dozens of arrays.  Two threads may both miss and store the
    same name."""
    name = _DTYPE_NAMES.get(dtype)
    if name is None:
        name = _DTYPE_NAMES[dtype] = str(dtype)
    return name


def _layout(batch: dict) -> frozenset:
    """(key, shape, dtype name) of every array of a request, in no order:
    two requests may share a group if and only if their layouts are
    equal.  The name keeps a torch tensor apart from a NumPy array of the
    same dtype (``'torch.float32'`` against ``'float32'``)."""
    return frozenset((k, tuple(v.shape), _dtype_name(v.dtype))
                     for k, v in batch.items())


def _wait(v) -> None:
    """Blocks until ``v`` (a tensor or an array) has its values."""
    if hasattr(v, "cpu"):
        v.cpu()
    else:
        np.asarray(v)


class ScorerQueue:
    """Adaptive micro-batching front end over ``serve.export.Scorer``.

    Requests of one group share one candidate count and one layout (pad
    thin candidate sets on the client; production rerank windows are of a
    fixed size).  ``groups`` lists the group sizes that are run; a drained
    group is padded to the next size by repeating its last request (the
    padded rows are scored and dropped), so only those few shapes ever
    reach the card.  Results are the scorer's device tensors, sliced per
    request; the dispatcher never waits for the card.

    Under ``core.tracing.recording()`` each request is a ``queue.wait``
    span from ``submit`` until the dispatcher drains it, and the
    dispatcher's time is ``queue.idle`` (waiting for a request) and
    ``queue.group`` spans (one drained group: ``queue.check``, the drain,
    the layout checks and the padding; the scorer call;
    ``queue.resolve``, the futures; ``attrs`` ``ids``, the ``seq`` of its
    requests' ``queue.wait`` spans, ``real`` and ``size``).  The counters
    ``queue.requests``, ``queue.groups``, ``queue.padded`` and
    ``queue.odd`` count the requests, the scorer calls, the padding rows'
    requests and the requests scored alone because their layout differs
    from their group's first."""

    def __init__(self, scorer, max_group: int = 8,
                 groups: tuple[int, ...] = (1, 2, 4, 8)):
        if max_group not in groups:
            raise ValueError(f"max_group {max_group} is not one of the "
                             f"group sizes {groups}")
        self.scorer = scorer
        self.groups = tuple(sorted(groups))
        self.max_group = max_group
        self._q: queuelib.Queue = queuelib.Queue()
        self._closed = False
        self._lock = threading.Lock()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="dmt-scorer-queue")
        self._thread.start()

    def warmup(self, example_batch: dict) -> None:
        """Runs every group size once, so the first burst pays no
        first-call costs (allocations, library loads)."""
        for g in self.groups:
            _wait(self.scorer.score_group_async(
                [example_batch] * g)["Scores"])

    def submit(self, batch: dict) -> Future:
        """Queues one request; resolves to {"Scores": [B], ...}.

        The request is taken as it is at this moment: its layout is built
        here, on the caller's thread, so arrays added, replaced or
        reshaped later are not seen by the grouping."""
        key = _layout(batch)
        fut: Future = Future()
        # the lock orders submit against close: a submit that passed the
        # closed check must enqueue before the shutdown marker, or its
        # future would never resolve
        with self._lock:
            if self._closed:
                raise RuntimeError("ScorerQueue is closed")
            self._q.put((batch, fut, tracing.begin("queue.wait"), key))
        return fut

    def close(self) -> None:
        """Scores what is queued, then stops the dispatcher; idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._q.put(None)
        self._thread.join()

    # ------------------------------------------------------------------

    def _next_group_size(self, n: int) -> int:
        for g in self.groups:
            if g >= n:
                return g
        return self.max_group

    def _alone(self, batch: dict, fut: Future) -> None:
        tracing.count("queue.groups")
        try:
            fut.set_result(self.scorer.score_async(batch))
        except Exception as e:  # noqa: BLE001 - the request's own error
            fut.set_exception(e)

    def _run(self) -> None:
        while True:
            with tracing.span("queue.idle"):
                item = self._q.get()
            if item is None:
                return
            with tracing.span("queue.group") as span:
                self._group(item, span)

    def _group(self, item: tuple, span) -> None:
        """Drains up to ``max_group`` requests after ``item`` and scores
        them."""
        with tracing.span("queue.check"):
            group = [item]
            while len(group) < self.max_group:
                try:
                    nxt = self._q.get_nowait()
                except queuelib.Empty:
                    break
                if nxt is None:
                    self._q.put(None)  # re-queue the shutdown marker
                    break
                group.append(nxt)
            if span:
                for _, _, wait, _ in group:
                    wait.end()
                ids = [w.seq for _, _, w, _ in group if w]
            first = group[0][3]
            same, odd = [], []
            for b, f, _, key in group:
                (same if key == first else odd).append((b, f))
            group = same
            batches = [b for b, _ in group]
            g = self._next_group_size(len(batches))
            padded = batches + [batches[-1]] * (g - len(batches))
        if span:
            span.attrs = {"ids": ids, "real": len(batches), "size": g}
            tracing.count("queue.requests", len(group) + len(odd))
            tracing.count("queue.groups")
            tracing.count("queue.padded", g - len(batches))
            tracing.count("queue.odd", len(odd))
        try:
            out = self.scorer.score_group_async(padded)
            # slices of the device tensors only: waiting for the card
            # here would stop the launches from overlapping
            per = out["Scores"].shape[0] // g
            with tracing.span("queue.resolve"):
                for i, (_, fut) in enumerate(group):
                    fut.set_result({k: v[i * per:(i + 1) * per]
                                    for k, v in out.items()})
        except Exception:  # noqa: BLE001
            # an error raised on the host fails no neighbour: each
            # request of the group is scored alone
            for b, fut in group:
                if not fut.done():
                    self._alone(b, fut)
        for b, fut in odd:
            self._alone(b, fut)
