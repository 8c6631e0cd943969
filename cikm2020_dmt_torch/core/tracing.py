"""Spans and counters inside the program, off by default.

An operator turns recording on around the calls to look at, then takes
what was recorded:

    from cikm2020_dmt_torch.core import tracing

    with tracing.recording():
        state, metrics, loss = trainer.train_step(state, metrics, b, gen)
    snap = tracing.snapshot()   # {"spans", "counters", "dropped", "clock"}

A span is a named stretch of one thread's host time: ``train.step`` and
its phases ``train.collect``, ``train.forward``, ``train.backward``,
``train.update`` (``train/loop.py``); ``queue.wait`` (a request in the
queue, from ``submit`` to the dispatcher draining it), ``queue.idle``
(the dispatcher waiting for a request), ``queue.group`` (one drained
group) with ``queue.check`` (the drain, checks and padding) and
``queue.resolve`` (its futures) (``serve/queue.py``); ``scorer.merge``
and ``scorer.forward`` (``serve/export.py``).  A counter is a host
integer: ``queue.requests``, ``queue.groups``, ``queue.padded``,
``queue.odd``, ``scorer.h2d_bytes``.

Span times are ``time.perf_counter_ns()``.  The snapshot's ``clock``
pairs that clock with the unix clock (``time.time_ns()``) at the start
and end of recording; the unix clock is the one ``torch.profiler``'s
Chrome traces use (``baseTimeNanoseconds`` plus ``ts`` in microseconds),
so ``trace_us`` places a span on such a trace, device events included.
While a profiler records on the span's thread, the span is also a
``torch.profiler.record_function`` of its name, so the phases show in
the trace itself (``Trainer.train``'s ``$DMT_PROFILE_DIR`` window turns
recording on for its steps).

A span is kept where it opens and closes inside one recording (the
dispatcher's wait that outlasts it is not).  At most ``MAX_SPANS`` spans
are kept between snapshots; later ones are counted in ``dropped``.  The
recording is the process's, not an object's, so the library's sites
need nothing passed to them; with it off every site costs one test of a
module flag: no clock read, no allocation."""

from __future__ import annotations

import contextlib
import itertools
import threading
import time

import torch

MAX_SPANS = 1 << 20

_on = False
_depth = 0
_gen = 0          # the recording a span opened in
_spans: list = []
_counters: dict = {}
_dropped = 0
_clock: list = []
_seq = itertools.count()
_local = threading.local()
_lock = threading.Lock()


def enabled() -> bool:
    """Whether spans and counters are being recorded."""
    return _on


def _stack() -> list:
    s = getattr(_local, "stack", None)
    if s is None:
        s = _local.stack = []
    return s


class _Off:
    """What every site gets while recording is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __bool__(self):
        return False

    def end(self) -> None:
        pass


OFF = _Off()


class Span:
    """One recorded span.  As a context manager it is the innermost span
    of its thread while open; ``begin`` opens one that another thread may
    ``end``."""

    __slots__ = ("name", "id", "attrs", "seq", "tid", "parent", "start",
                 "gen", "_rf")

    def __init__(self, name: str, id=None):
        self.name = name
        self.id = id
        self.attrs = None
        self.seq = next(_seq)
        self.tid = threading.get_native_id()
        stack = _stack()
        self.parent = stack[-1] if stack else None
        self.gen = _gen
        self._rf = None
        self.start = 0

    def __bool__(self):
        return True

    def __enter__(self):
        _stack().append(self.seq)
        self.start = time.perf_counter_ns()
        if torch.autograd._profiler_enabled():   # on this thread
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self._rf is not None:
            self._rf.__exit__(*exc)
        end = time.perf_counter_ns()
        _stack().pop()
        self._keep(end)
        return False

    def end(self) -> None:
        self._keep(time.perf_counter_ns())

    def _keep(self, end: int) -> None:
        global _dropped
        with _lock:
            if not _on or self.gen != _gen:
                return
            if len(_spans) >= MAX_SPANS:
                _dropped += 1
            else:
                _spans.append((self.name, self.tid, self.start, end,
                               self.seq, self.parent, self.id, self.attrs))


def span(name: str, id=None):
    """A context manager around a stretch of this thread's host time;
    ``id`` names a step or request.  Set ``attrs`` (a dict) on the value
    it yields to keep more; it is false while recording is off."""
    if not _on:
        return OFF
    return Span(name, id)


def begin(name: str, id=None):
    """A span opened now, closed by its ``end()`` on any thread."""
    if not _on:
        return OFF
    s = Span(name, id)
    s.start = time.perf_counter_ns()
    return s


def count(name: str, n: int = 1) -> None:
    """Adds ``n`` to the host counter ``name``."""
    if not _on:
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def _mark_clock() -> None:
    a = time.perf_counter_ns()
    w = time.time_ns()
    b = time.perf_counter_ns()
    _clock.append(((a + b) // 2, w))


@contextlib.contextmanager
def recording():
    """Records spans and counters inside the block (nested blocks share
    the outermost one's recording)."""
    global _on, _depth, _gen
    with _lock:
        _depth += 1
        if _depth == 1:
            _mark_clock()
            _gen += 1
            _on = True
    try:
        yield
    finally:
        with _lock:
            _depth -= 1
            if _depth == 0:
                _on = False
                _mark_clock()


def snapshot() -> dict:
    """What was recorded since the last snapshot, then cleared:
    ``spans`` (dicts of ``name``, ``tid``, ``start`` and ``end`` in
    perf-counter ns, ``seq``, ``parent`` (the enclosing span's ``seq`` on
    its thread), ``id``, ``attrs``), ``counters``, ``dropped`` and
    ``clock`` ([perf-counter ns, unix ns] pairs)."""
    global _dropped
    with _lock:
        if _on:
            _mark_clock()
        out = {"spans": [dict(name=n, tid=t, start=s, end=e, seq=q,
                              parent=p, id=i, attrs=a)
                         for n, t, s, e, q, p, i, a in _spans],
               "counters": dict(_counters), "dropped": _dropped,
               "clock": list(_clock)}
        _spans.clear()
        _counters.clear()
        _clock.clear()
        _dropped = 0
        if _on:
            _mark_clock()    # the start of what is recorded from now
    return out


def trace_us(snap: dict, t_ns: int, base_ns: int = 0) -> float:
    """``t_ns`` (perf-counter ns, as spans hold it) on a Chrome trace's
    clock: microseconds after ``base_ns`` (the trace's
    ``baseTimeNanoseconds``), mapped through the snapshot's clock pairs
    (the line through the first and the last; an offset with one)."""
    clock = snap["clock"]
    if not clock:
        raise ValueError("the snapshot holds no clock pair")
    (p0, w0), (p1, w1) = clock[0], clock[-1]
    slope = (w1 - w0) / (p1 - p0) if p1 > p0 else 1.0
    return (w0 + (t_ns - p0) * slope - base_ns) * 1e-3
