"""The readers of the program's spans and counters
(``perfbench/metrics/`` over ``perfbench/program.py``) on hand-built
stretches: None where there is nothing to read, else the value computed
by hand; and a program stretch of the training entry's own closures on
the CPU."""

from __future__ import annotations

import importlib.util
import os

import pytest

from perfbench import harness, program

READERS = program.METRICS


def _reader(name):
    path = os.path.join(harness.BENCH_DIR, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "m_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _span(name, start, end, tid=1, seq=0, parent=None, attrs=None):
    return {"name": name, "tid": tid, "start": start, "end": end,
            "seq": seq, "parent": parent, "id": None, "attrs": attrs}


TRAIN = {"entry": "train",
         "program": {"window_s": 1.0, "counters": {}, "dropped": 0,
                     "spans": [
                         _span("train.step", 0.0, 0.4, seq=1),
                         _span("train.collect", 0.0, 0.05, parent=1),
                         _span("train.forward", 0.05, 0.15, parent=1),
                         _span("train.backward", 0.15, 0.3, parent=1),
                         _span("train.update", 0.3, 0.4, parent=1),
                         _span("train.step", 0.4, 1.0, seq=2),
                         _span("train.collect", 0.4, 0.45, parent=2),
                         _span("train.forward", 0.45, 0.65, parent=2),
                         _span("train.backward", 0.65, 0.8, parent=2),
                         _span("train.update", 0.8, 1.0, parent=2)]},
         "program_trace": {"window_s": 1.0,
                           # idle: [0.2, 0.35), [0.5, 0.9)
                           "busy": [[0.0, 0.2], [0.35, 0.5], [0.9, 1.0]],
                           "spans": [_span("train.update", 0.3, 0.4),
                                     _span("train.update", 0.8, 1.0)],
                           "launches": []}}

SERVE = {"entry": "serve",
         "program": {"window_s": 1.0, "dropped": 0,
                     "counters": {"queue.requests": 30, "queue.groups": 4,
                                  "queue.padded": 2,
                                  "scorer.h2d_bytes": 6000},
                     "spans": [
                         _span("queue.wait", 0.0, 0.01, tid=9),
                         _span("queue.wait", 0.0, 0.03, tid=9),
                         _span("queue.idle", 0.0, 0.2, tid=2),
                         _span("queue.group", 0.2, 0.6, tid=2, seq=5),
                         _span("scorer.merge", 0.2, 0.3, tid=2, parent=5),
                         _span("scorer.forward", 0.3, 0.55, tid=2, parent=5),
                         _span("scorer.merge", 0.6, 0.64, tid=2, parent=6),
                         _span("scorer.forward", 0.64, 0.69, tid=2,
                               parent=6)]},
         "program_trace": {"window_s": 2.0,
                           # idle: [0.1, 0.3), [1.5, 2.0)
                           "busy": [[0.0, 0.1], [0.3, 1.5]],
                           "spans": [_span("queue.idle", 0.0, 0.2, tid=2),
                                     _span("queue.idle", 1.4, 1.8, tid=2),
                                     _span("queue.group", 0.2, 1.4, tid=2)],
                           "launches": []}}

BY_HAND = {
    "train.span.step_ms": (TRAIN, 500.0),
    "train.span.collect_ms": (TRAIN, 50.0),
    "train.span.forward_ms": (TRAIN, 150.0),
    "train.span.backward_ms": (TRAIN, 150.0),
    "train.span.update_ms": (TRAIN, 150.0),
    # idle inside update: [0.3, 0.35) and [0.8, 0.9) of 1 s
    "device_idle.train.update": (TRAIN, 15.0),
    "serve.span.queue_wait_ms": (SERVE, 20.0),
    "serve.span.group_requests": (SERVE, 7.5),
    "serve.span.merge_ms": (SERVE, 70.0),
    "serve.span.forward_ms": (SERVE, 150.0),
    "serve.h2d_bytes_per_request": (SERVE, 200.0),
    # idle inside queue.idle: [0.1, 0.2) and [1.5, 1.8) of 2 s
    "device_idle.serve.queue_empty": (SERVE, 20.0),
}


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_nothing_from_nothing(name):
    mod = _reader(name)
    assert mod.read({}) is None
    other = SERVE if name.startswith("train") or ".train." in name else TRAIN
    assert mod.read(other) is None            # the other entry's stretch


@pytest.mark.parametrize("name", READERS)
def test_reader_value_by_hand(name):
    rec, want = BY_HAND[name]
    assert _reader(name).read(rec) == pytest.approx(want, rel=1e-9)


def test_readers_are_the_metric_files():
    assert set(BY_HAND) == set(READERS)
    for name in READERS:
        assert _reader(name).UNIT in ("ms", "%", "requests", "bytes")


def test_coverage_lines():
    rec = {"program": TRAIN["program"],
           "program_trace": dict(TRAIN["program_trace"],
                                 launches=[(7, 0.35), (7, 0.9), (8, 5.0)])}
    lines = program.coverage(rec)
    assert "train.step 100.00% of 1.0000 s; its phases 100.00%" in lines[0]
    assert lines[-1].startswith("# program_trace launches inside a span of "
                                "work: 2 of 3 (66.67%); on the thread that "
                                "launched most 2 of 2 (100.00%)")


def test_idle_split_by_hand():
    pt = dict(SERVE["program_trace"],
              spans=SERVE["program_trace"]["spans"]
              + [_span("queue.wait", 0.0, 2.0, tid=9)])
    got = program.idle_split({"program_trace": pt})
    # idle [0.1, 0.3) and [1.5, 2.0); the dispatcher's spans end at 1.8
    assert got == pytest.approx({"window": 700.0, "queue.idle": 400.0,
                                 "queue.group": 100.0, "outside": 200.0})


def test_program_stretch_of_a_cpu_training_entry():
    """``run_program`` on a CPU ``Trainer`` of the cell's configuration at
    a small size, with the training entry's kind of closures."""
    import torch

    from cikm2020_dmt_torch.metrics.streaming import task_metrics_init
    from cikm2020_dmt_torch.train.loop import Trainer
    from perfbench import weights
    from perfbench.tests.conftest import small_context
    from perfbench.traffic import batches as traffic

    ctx = small_context("dmt.train")
    tr = Trainer(ctx.cfg, device="cpu")
    state = tr.init_state(torch.Generator().manual_seed(0))
    weights.copy_into(state["params"], weights.make(ctx.conf, ctx.seed,
                                                    ctx.device))
    bs = traffic.make(ctx.conf, ctx.cell["traffic"], ctx.seed, ctx.device)
    gen = torch.Generator().manual_seed(1)
    box = {"state": state, "metrics": task_metrics_init("cpu")}

    def traced(n):
        def fn():
            for i in range(n):
                box["state"], box["metrics"], _ = tr.train_step(
                    box["state"], box["metrics"], bs[i % len(bs)], gen)
        return fn

    p = program.run_program(traced(2), lambda: None, warm=traced(1))
    rec = {"entry": "train", "program": p}
    steps = [s for s in p["spans"] if s["name"] == "train.step"]
    assert len(steps) == 2 and p["dropped"] == 0
    assert 0.0 <= steps[0]["start"] < steps[-1]["end"] <= p["window_s"]
    for name in ("train.span.step_ms", "train.span.update_ms"):
        assert _reader(name).read(rec) > 0.0
    parts = sum(_reader(f"train.span.{k}_ms").read(rec)
                for k in ("collect", "forward", "backward", "update"))
    assert parts <= _reader("train.span.step_ms").read(rec)
    assert parts >= 0.95 * _reader("train.span.step_ms").read(rec)
