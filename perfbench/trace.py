"""Device traces of a stretch of the run, from ``torch.profiler``.

``stretch(fn, sync, ...)`` runs ``fn`` under the profiler, synchronises,
writes the Chrome trace into ``TMPDIR``, reads it back and deletes it.
A trace in which no operation ran on the device raises: there is no
fallback to host timing.  Busy time is the union of the device's
intervals (kernels, copies, fills), not the sum of their durations, so
overlapping work counts once."""

from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _union(intervals):
    """Merged [start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def short_name(name: str) -> str:
    """A kernel's name without its return type, template arguments and
    parameters."""
    name = re.sub(r"^void\s+", "", name).replace("(anonymous namespace)::",
                                                  "")
    depth, out = 0, []
    for ch in name:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth = max(0, depth - 1)
        elif ch == "(" and depth == 0:
            break
        elif depth == 0:
            out.append(ch)
    return "".join(out).strip() or name


class Trace:
    """One traced stretch: device events (name, start, end) in seconds from
    the stretch's start, the stretch's length, and the host's ``cpu_op``
    events where they were recorded."""

    def __init__(self, events: list):
        dev = [e for e in events if e.get("cat") in DEVICE_CATS
               and "ts" in e and "dur" in e]
        if not dev:
            raise RuntimeError("the profiler's trace holds no device event: "
                               "no device time can be read")
        timed = [e for e in events if "ts" in e and e.get("ph") == "X"]
        t0 = min(float(e["ts"]) for e in timed)
        t1 = max(float(e["ts"]) + float(e.get("dur", 0)) for e in dev)
        self.window_s = (t1 - t0) * 1e-6
        self.kernels = [(e["name"], (float(e["ts"]) - t0) * 1e-6,
                         (float(e["ts"]) + float(e["dur"]) - t0) * 1e-6)
                        for e in dev if e.get("cat") == "kernel"]
        self.device = [((float(e["ts"]) - t0) * 1e-6,
                        (float(e["ts"]) + float(e["dur"]) - t0) * 1e-6)
                       for e in dev]
        self.busy = _union(self.device)
        self.busy_s = sum(e - s for s, e in self.busy)
        self.host = [(e["name"], (float(e["ts"]) - t0) * 1e-6,
                      (float(e["ts"]) + float(e.get("dur", 0)) - t0) * 1e-6)
                     for e in timed if e.get("cat") == "cpu_op"]

    def kernel_seconds(self, pattern: str) -> float:
        """Summed duration of the kernels whose short name matches
        ``pattern`` (a regular expression searched in it)."""
        rx = re.compile(pattern)
        return sum(e - s for n, s, e in self.kernels
                   if rx.search(short_name(n)))

    def device_ops(self, n: int = 10) -> list:
        """[name, seconds] of the ``n`` kernel names that took most time."""
        by: dict = {}
        for name, s, e in self.kernels:
            k = short_name(name)
            by[k] = by.get(k, 0.0) + (e - s)
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                ][:n]

    def idle_gaps(self, n: int = 10) -> list:
        """[host operation, seconds] of the device's idle time inside the
        stretch, each gap labelled by the innermost host operation running
        at its middle ("host: between operations" where none), summed by
        label: the ``n`` largest."""
        if not self.host:
            return []
        gaps, last = [], 0.0
        for s, e in self.busy:
            if s > last:
                gaps.append((last, s))
            last = max(last, e)
        ops = sorted(self.host, key=lambda h: h[1])
        starts = [h[1] for h in ops]
        by: dict = {}
        for s, e in gaps:
            mid = 0.5 * (s + e)
            label, best = "host: between operations", None
            i = bisect.bisect_right(starts, mid)
            for name, hs, he in ops[max(0, i - 400):i]:
                if hs <= mid <= he and (best is None or hs >= best):
                    label, best = name, hs
            by[label] = by.get(label, 0.0) + (e - s)
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                ][:n]


def stretch(fn, sync, host: bool = False, warm=None) -> Trace:
    """Runs ``fn()`` under the profiler, the device's activity only or, with ``host``, the host's
    operations too; ``sync()`` closes the stretch.  ``warm()``, where
    given, runs first under the profiler's warm-up, which records
    nothing, so the profiler's start-up costs stay out of the stretch."""
    from torch.profiler import ProfilerActivity, profile, schedule

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    fd, path = tempfile.mkstemp(prefix="perfbench-trace-", suffix=".json")
    os.close(fd)
    try:
        sync()
        with profile(activities=acts,
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                     on_trace_ready=lambda p: p.export_chrome_trace(path)
                     ) as prof:
            if warm is not None:
                warm()
                sync()
            prof.step()
            fn()
            sync()
            prof.step()
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return Trace(events)


def now() -> float:
    return time.perf_counter()
