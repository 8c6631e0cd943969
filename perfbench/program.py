"""Program stretches: a cell's traced unit of work run again with the
program's own tracer on (``cikm2020_dmt_torch/core/tracing.py``), and the
helpers by which ``perfbench/metrics/`` reads its spans and counters.

``stretches(fn, sync, warm)`` runs ``warm()`` and then ``fn()`` twice,
each time followed by ``sync()``:

- ``program``: the tracer on and no profiler; host times and counters
  are read from it;
- ``program_trace``: the tracer on under ``torch.profiler`` with the
  device's activity only (kernels, copies, fills and the CUDA runtime's
  calls, which carry the host clock); the spans are placed on the
  trace's clock (``tracing.trace_us``) and the device's idle time is put
  down to the spans it falls in.

Each holds ``window_s`` (recording on to recording off, the closing
synchronise included) and ``spans`` (dicts of ``name``, ``tid``,
``start``, ``end`` in seconds from the window's start, ``seq``,
``parent``, ``id``, ``attrs``); ``program`` also ``counters`` and
``dropped``, ``program_trace`` also ``busy`` (the union of the device's
intervals, in seconds on the same axis).  The coverage of the spans is
logged on standard error.

A training entry would pass its ``traced(trace_steps, [])`` and
``traced(1, [])`` closures, the serving entry ``load(trace_seconds, [],
[])`` and its 0.2 s warm load, after their own traced stretches.  Until
the entries call it, this file runs a cell with the program stretches
put in front of the entry's device stretch, on the same closures, and
prints the program metrics of ``perfbench/metrics/`` as one JSON line:

    python3 perfbench/program.py --workload <cell> --seed <n> \\
        --seconds <s>
"""

from __future__ import annotations

import argparse
import bisect
import importlib
import json
import os
import re
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from perfbench import trace as tracelib  # noqa: E402

LAUNCH = re.compile(r"^cu(da)?LaunchKernel")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
METRICS = ("train.span.step_ms", "train.span.collect_ms",
           "train.span.forward_ms", "train.span.backward_ms",
           "train.span.update_ms", "device_idle.train.update",
           "serve.span.queue_wait_ms", "serve.span.group_requests",
           "serve.span.merge_ms", "serve.span.forward_ms",
           "serve.h2d_bytes_per_request", "device_idle.serve.queue_empty")


def _spans(snap: dict, to_s) -> list:
    return [dict(s, start=to_s(s["start"]), end=to_s(s["end"]))
            for s in snap["spans"]]


def _window(snap: dict) -> tuple[int, int]:
    """Recording's start and end, perf-counter ns."""
    return snap["clock"][0][0], snap["clock"][-1][0]


def run_program(fn, sync, warm=None) -> dict:
    """``fn()`` and ``sync()`` with the tracer on and no profiler."""
    from cikm2020_dmt_torch.core import tracing

    if warm is not None:
        warm()
    sync()
    tracing.snapshot()
    with tracing.recording():
        fn()
        sync()
    snap = tracing.snapshot()
    t0, t1 = _window(snap)
    return {"window_s": (t1 - t0) * 1e-9,
            "spans": _spans(snap, lambda t: (t - t0) * 1e-9),
            "counters": snap["counters"], "dropped": snap["dropped"]}


def run_program_trace(fn, sync, warm=None) -> dict:
    """``fn()`` and ``sync()`` with the tracer on under the profiler
    (device activity only); ``warm()`` runs in the profiler's warm-up,
    which records nothing."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from cikm2020_dmt_torch.core import tracing

    fd, path = tempfile.mkstemp(prefix="perfbench-program-", suffix=".json")
    os.close(fd)
    try:
        sync()
        tracing.snapshot()
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                     on_trace_ready=lambda p: p.export_chrome_trace(path)
                     ) as prof:
            if warm is not None:
                warm()
                sync()
            prof.step()
            with tracing.recording():
                fn()
                sync()
            prof.step()
        snap = tracing.snapshot()
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.unlink(path)
    base = int(trace.get("baseTimeNanoseconds", 0))
    t0, t1 = (tracing.trace_us(snap, t, base) for t in _window(snap))
    events = trace["traceEvents"]

    def rel(ts):
        return (float(ts) - t0) * 1e-6

    busy = tracelib._union(
        (rel(e["ts"]), rel(float(e["ts"]) + float(e["dur"])))
        for e in events if e.get("cat") in tracelib.DEVICE_CATS
        and "ts" in e and "dur" in e)
    if not busy:
        raise RuntimeError("the program stretch's trace holds no device "
                           "event")
    launches = [(e.get("tid"), rel(e["ts"])) for e in events
                if e.get("cat") in RUNTIME_CATS and "ts" in e
                and LAUNCH.match(e.get("name", ""))]
    return {"window_s": (t1 - t0) * 1e-6, "busy": busy,
            "spans": _spans(snap, lambda t: rel(
                tracing.trace_us(snap, t, base))),
            "launches": launches}


def stretches(fn, sync, warm=None) -> dict:
    """{"program", "program_trace"}: the two stretches, their coverage
    logged."""
    out = {"program": run_program(fn, sync, warm),
           "program_trace": run_program_trace(fn, sync, warm)}
    for line in coverage(out):
        print(line, file=sys.stderr, flush=True)
    return out


# ---- what the readers share ----------------------------------------

def mean_ms(rec: dict, entry: str, name: str):
    """Mean milliseconds of the ``name`` spans of the program stretch of an
    ``entry`` cell; None where there are none."""
    p = rec.get("program")
    if rec.get("entry") != entry or not p:
        return None
    d = [s["end"] - s["start"] for s in p["spans"] if s["name"] == name]
    return 1e3 * sum(d) / len(d) if d else None


def ratio(rec: dict, entry: str, num: str, den: str):
    """Counter ``num`` over counter ``den`` in the program stretch."""
    p = rec.get("program")
    if rec.get("entry") != entry or not p:
        return None
    c = p["counters"]
    return c[num] / c[den] if c.get(num) is not None and c.get(den) else None


def overlap(a: list, b: list) -> float:
    """Length of the intersection of two sorted lists of disjoint
    [start, end) intervals."""
    i = j = 0
    out = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            out += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def idle(pt: dict) -> list:
    """The device's idle intervals inside the window."""
    gaps, last = [], 0.0
    for s, e in pt["busy"]:
        if s > last:
            gaps.append([last, min(s, pt["window_s"])])
        last = max(last, e)
    if last < pt["window_s"]:
        gaps.append([last, pt["window_s"]])
    return [g for g in gaps if g[1] > g[0]]


def idle_share(rec: dict, entry: str, name: str):
    """Percent of the traced program stretch in which the device idles
    while a ``name`` span is open."""
    pt = rec.get("program_trace")
    if rec.get("entry") != entry or not pt or pt["window_s"] <= 0:
        return None
    spans = tracelib._union((s["start"], s["end"]) for s in pt["spans"]
                            if s["name"] == name)
    if not spans:
        return None
    return 100.0 * overlap(idle(pt), spans) / pt["window_s"]


def coverage(rec: dict) -> list:
    """Log lines: the share of the program stretch that the root spans
    cover and of the roots that their children cover (training), of the
    dispatcher thread's time that ``queue.idle`` and ``queue.group``
    cover (serving), and of the traced kernel launches that fall inside
    a span of work, overall and on the thread that launched most."""
    lines = []
    p, pt = rec["program"], rec["program_trace"]
    for tag, q in (("program", p), ("program_trace", pt)):
        steps = [s for s in q["spans"] if s["name"] == "train.step"]
        if steps:
            root = sum(s["end"] - s["start"] for s in steps)
            seqs = {s["seq"] for s in steps}
            kids = sum(s["end"] - s["start"] for s in q["spans"]
                       if s["parent"] in seqs)
            lines.append(f"# {tag} coverage: train.step "
                         f"{100 * root / q['window_s']:.2f}% of "
                         f"{q['window_s']:.4f} s; its phases "
                         f"{100 * kids / root:.2f}% of train.step")
        groups = [s for s in q["spans"] if s["name"] == "queue.group"]
        if groups:
            tid = groups[0]["tid"]
            mine = sum(s["end"] - s["start"] for s in q["spans"]
                       if s["tid"] == tid
                       and s["name"] in ("queue.idle", "queue.group"))
            lines.append(f"# {tag} coverage: queue.idle + queue.group "
                         f"{100 * mine / q['window_s']:.2f}% of the "
                         f"dispatcher's {q['window_s']:.4f} s")
    # a launch is the program's where it falls in a span of work (not a
    # request's wait, not the dispatcher's idle): the clients' own
    # launches need not, the busiest launching thread's should
    work = tracelib._union((s["start"], s["end"]) for s in pt["spans"]
                           if s["name"] not in ("queue.wait", "queue.idle"))
    starts = [w[0] for w in work]
    by: dict = {}
    for tid, t in pt["launches"]:
        i = bisect.bisect_right(starts, t) - 1
        n, k = by.get(tid, (0, 0))
        by[tid] = (n + 1, k + (i >= 0 and t <= work[i][1]))
    n = sum(v[0] for v in by.values())
    k = sum(v[1] for v in by.values())
    if n:
        top = max(by.values())
        lines.append(f"# program_trace launches inside a span of work: {k} "
                     f"of {n} ({100 * k / n:.2f}%); on the thread that "
                     f"launched most {top[1]} of {top[0]} "
                     f"({100 * top[1] / top[0]:.2f}%)")
    return lines


# ---- the cell run with the program stretches ----------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    from perfbench import run

    run._caches()
    import time

    import torch

    from perfbench import harness, modelconf

    if not torch.cuda.is_available():
        harness.log("the program stretches need the card")
        return 2
    cell = harness.load_cell(args.workload)
    entry = importlib.import_module(f"perfbench.entries.{cell['entry']}")
    conf = modelconf.load(cell["config"])
    ctx = harness.Context(cell=cell, conf=conf,
                          cfg=harness.program_config(conf),
                          device=torch.device("cuda", 0), seed=args.seed,
                          seconds=args.seconds, trace=True,
                          t_start=time.perf_counter())
    ctx.build_s = harness.prebuild(cell.get("prebuild", ()))
    print(json.dumps(run_cell(ctx, entry)), flush=True)
    return 0


def run_cell(ctx, entry) -> dict:
    """Runs the cell's ``entry`` with the program stretches in front of its
    device stretch: the line ``main`` prints."""
    from perfbench import harness

    cell = ctx.cell
    found: dict = {}
    own = entry.stretch

    def first_also_program(fn, sync, host=False, warm=None):
        if not found:
            found.update(stretches(fn, sync, warm))
        return own(fn, sync, host=host, warm=warm)

    entry.stretch = first_also_program
    try:
        out = entry.run(ctx)
    finally:
        entry.stretch = own
    rec = {"entry": cell["entry"], **found}
    p = rec["program"]
    if cell["entry"] == "train":
        done = (sum(1 for s in p["spans"] if s["name"] == "train.step")
                * int(cell["traffic"]["batch"]))
        window = out["e2e"]["examples_per_s"]
    else:
        done = p["counters"].get("queue.requests", 0)
        window = out["e2e"]["serve_requests_per_s"]
    return {"workload": cell["name"], "seed": ctx.seed,
            "correct": bool(out["correct"]),
            "metrics": {k: v["value"] for k, v in
                        harness.read_metrics(METRICS, rec).items()},
            "program_rate": done / p["window_s"], "window_rate": window,
            "program_window_s": p["window_s"],
            "trace_window_s": rec["program_trace"]["window_s"],
            "dropped": p["dropped"], "counters": p["counters"],
            "phases_ms": phase_split(rec), "idle_ms": idle_split(rec)}


def phase_split(rec: dict) -> dict:
    """Milliseconds of the program stretch by span name (the requests'
    waits left out), and as ``rest`` the stretch's time outside the root
    spans of the thread that opened the first (the training loop's or the
    queue's dispatcher)."""
    p = rec["program"]
    out: dict = {}
    for s in p["spans"]:
        if s["name"] == "queue.wait":
            continue
        out[s["name"]] = (out.get(s["name"], 0.0)
                          + 1e3 * (s["end"] - s["start"]))
    roots = [s for s in p["spans"] if s["parent"] is None
             and s["name"] != "queue.wait"]
    if roots:
        covered = sum(s["end"] - s["start"] for s in roots
                      if s["tid"] == roots[0]["tid"])
        out["rest"] = 1e3 * (p["window_s"] - covered)
    return out


def idle_split(rec: dict) -> dict:
    """Milliseconds of the device's idle time in the traced program
    stretch: in all (``window``), inside the spans of each name (the
    requests' waits left out), and inside no root span (``outside``)."""
    pt = rec["program_trace"]
    gaps = idle(pt)
    out = {"window": 1e3 * sum(e - s for s, e in gaps)}
    names = {s["name"] for s in pt["spans"]} - {"queue.wait"}
    for name in sorted(names):
        out[name] = 1e3 * overlap(gaps, tracelib._union(
            (s["start"], s["end"]) for s in pt["spans"]
            if s["name"] == name))
    roots = tracelib._union((s["start"], s["end"]) for s in pt["spans"]
                            if s["parent"] is None
                            and s["name"] != "queue.wait")
    out["outside"] = out["window"] - 1e3 * overlap(gaps, roots)
    return out


if __name__ == "__main__":
    sys.exit(main())
