"""The port's tracer (``cikm2020_dmt_torch/core/tracing.py``) on the CPU:
off it records nothing and changes no output; on, a training step is one
``train.step`` span partitioned by its four phases, each queued request
one ``queue.wait`` span drained by one ``queue.group``, the dispatcher's
time ``queue.idle`` and ``queue.group``; the buffer is bounded; spans
land on a ``torch.profiler`` trace's clock; ``Trainer.train``'s profile
window shows the ``train.*`` spans."""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import __graft_entry__ as g  # noqa: E402
import chip_smoke as cs  # noqa: E402
from cikm2020_dmt_torch.core import tracing  # noqa: E402
from cikm2020_dmt_torch.data import native  # noqa: E402
from cikm2020_dmt_torch.metrics.streaming import task_metrics_init  # noqa: E402
from cikm2020_dmt_torch.serve.export import Scorer, norm_constants  # noqa: E402
from cikm2020_dmt_torch.serve.queue import ScorerQueue  # noqa: E402
from cikm2020_dmt_torch.train.loop import Trainer  # noqa: E402
from test_torch_serve import SMALL, port_cfg  # noqa: E402

B = 16
KW = dict(sku_rows=4096, batch_size=B, validate_step=100,
          dedup_rows_threshold=1000, pack_rows_threshold=1000,
          table_bf16_threshold=0)
PHASES = ("train.collect", "train.forward", "train.backward", "train.update")
CANDIDATES = 6


@pytest.fixture(autouse=True)
def clean_tracer():
    tracing.snapshot()
    yield
    assert not tracing.enabled()
    tracing.snapshot()


@pytest.fixture(scope="module")
def cfg():
    return port_cfg(g._demo_config(**SMALL, **KW))


def _step(cfg, record: bool):
    tr = Trainer(cfg, device="cpu")
    state = tr.init_state(torch.Generator().manual_seed(0))
    batch = cs.synthetic_batch(cfg, B, 5, "cpu")
    gen = torch.Generator().manual_seed(7)
    if record:
        with tracing.recording():
            out = tr.train_step(state, task_metrics_init("cpu"), batch, gen)
    else:
        out = tr.train_step(state, task_metrics_init("cpu"), batch, gen)
    return out, tracing.snapshot()


def _flat(tree) -> dict:
    return dict(cs._leaves(tree))


def _scorer(cfg):
    from cikm2020_dmt_torch.models.zoo import build_model

    params = build_model(cfg).init(torch.Generator().manual_seed(1))
    rng = np.random.default_rng(2)
    scale, const = norm_constants(rng.normal(0.5, 1.0, cfg.feature_dimension),
                                  rng.uniform(0.1, 3.0, cfg.feature_dimension))
    return Scorer(cfg, params, scale, const, device="cpu")


def _queue_run(cfg, n: int, record: bool):
    """``n`` requests submitted at once to a queue of groups (1, 2, 4),
    each waited for: (their Scores, the snapshot)."""
    reqs = cs.make_requests(cfg, CANDIDATES, [(5, 3, 1)] * n, seed=4)
    q = ScorerQueue(_scorer(cfg), max_group=4, groups=(1, 2, 4))
    try:
        if record:
            with tracing.recording():
                futs = [q.submit(r) for r in reqs]
                out = [f.result()["Scores"].numpy() for f in futs]
                q.close()
        else:
            futs = [q.submit(r) for r in reqs]
            out = [f.result()["Scores"].numpy() for f in futs]
    finally:
        q.close()
    return out, tracing.snapshot()


def test_off_records_nothing_and_on_changes_no_output(cfg):
    (s_off, m_off, l_off), snap = _step(cfg, record=False)
    assert snap["spans"] == [] and snap["counters"] == {}
    (s_on, m_on, l_on), snap_on = _step(cfg, record=True)
    assert snap_on["spans"]
    assert torch.equal(l_off, l_on)
    a, b = _flat(s_off), _flat(s_on)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    ma, mb = _flat(m_off), _flat(m_on)
    assert all(torch.equal(ma[k], mb[k]) for k in ma)

    q_off, snap = _queue_run(cfg, 5, record=False)
    assert snap["spans"] == [] and snap["counters"] == {}
    q_on, snap_on = _queue_run(cfg, 5, record=True)
    assert snap_on["spans"]
    for x, y in zip(q_off, q_on):
        np.testing.assert_array_equal(x, y)


def test_train_step_is_partitioned_by_its_phases(cfg):
    _, snap = _step(cfg, record=True)
    steps = [s for s in snap["spans"] if s["name"] == "train.step"]
    assert len(steps) == 1
    step = steps[0]
    assert step["parent"] is None and step["id"] == 1
    kids = sorted((s for s in snap["spans"] if s["parent"] == step["seq"]),
                  key=lambda s: s["start"])
    assert [s["name"] for s in kids] == list(PHASES)
    assert step["start"] <= kids[0]["start"]
    assert kids[-1]["end"] <= step["end"]
    for a, b in zip(kids, kids[1:]):
        assert a["end"] <= b["start"]
    covered = sum(s["end"] - s["start"] for s in kids)
    assert covered >= 0.95 * (step["end"] - step["start"])
    assert all(s["tid"] == step["tid"] for s in kids)


def test_queue_spans_and_counters(cfg):
    n = 7
    _, snap = _queue_run(cfg, n, record=True)
    spans = snap["spans"]
    waits = [s for s in spans if s["name"] == "queue.wait"]
    groups = [s for s in spans if s["name"] == "queue.group"]
    idles = [s for s in spans if s["name"] == "queue.idle"]
    assert len(waits) == n
    ids = [i for grp in groups for i in grp["attrs"]["ids"]]
    assert sorted(ids) == sorted(w["seq"] for w in waits)
    by_seq = {w["seq"]: w for w in waits}
    for grp in groups:
        for i in grp["attrs"]["ids"]:
            # drained inside its group, after it was submitted
            assert by_seq[i]["start"] <= by_seq[i]["end"] <= grp["end"]
        assert grp["attrs"]["real"] == len(grp["attrs"]["ids"])
        assert grp["attrs"]["size"] in (1, 2, 4)
        assert grp["attrs"]["size"] >= grp["attrs"]["real"]
    c = snap["counters"]
    assert c["queue.requests"] == n
    assert c["queue.groups"] == len(groups)
    assert c["queue.padded"] == sum(grp["attrs"]["size"] - grp["attrs"]["real"]
                                    for grp in groups)
    assert "scorer.h2d_bytes" not in c      # a CPU scorer sends nothing
    group_seqs = {grp["seq"] for grp in groups}
    for name in ("queue.check", "scorer.merge", "scorer.forward",
                 "queue.resolve"):
        inner = [s for s in spans if s["name"] == name]
        assert len(inner) == len(groups), name
        assert {s["parent"] for s in inner} == group_seqs, name
    # the dispatcher's time: idle and group spans, one after another
    tid = groups[0]["tid"]
    mine = sorted(idles + groups, key=lambda s: s["start"])
    assert {s["tid"] for s in mine} == {tid}
    assert tid != waits[0]["tid"]
    for a, b in zip(mine, mine[1:]):
        assert a["end"] <= b["start"]


def test_uniform_traffic_scores_no_request_alone(cfg):
    """Requests of one layout all take the group path: ``queue.odd`` reads
    0 and ``queue.requests`` every request submitted."""
    n = 6
    _, snap = _queue_run(cfg, n, record=True)
    c = snap["counters"]
    assert c["queue.odd"] == 0
    assert c["queue.requests"] == n


def test_buffer_bound_counts_drops(monkeypatch):
    monkeypatch.setattr(tracing, "MAX_SPANS", 5)
    with tracing.recording():
        for i in range(8):
            with tracing.span("x", i):
                pass
        tracing.count("c", 3)
        tracing.count("c")
    snap = tracing.snapshot()
    assert [s["id"] for s in snap["spans"]] == [0, 1, 2, 3, 4]
    assert snap["dropped"] == 3 and snap["counters"] == {"c": 4}
    assert len(snap["clock"]) == 2
    again = tracing.snapshot()
    assert again["spans"] == [] and again["dropped"] == 0


def test_threads_lose_no_count_and_no_span():
    import sys
    import threading

    def work():
        for i in range(500):
            tracing.count("c")
            if i % 5 == 0:
                with tracing.span("s"):
                    tracing.count("c", 2)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with tracing.recording():
            threads = [threading.Thread(target=work) for _ in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    snap = tracing.snapshot()
    assert snap["counters"] == {"c": 16 * (500 + 2 * 100)}
    assert len(snap["spans"]) == 16 * 100
    assert len({s["seq"] for s in snap["spans"]}) == 16 * 100


def test_a_span_is_kept_only_inside_its_recording():
    with tracing.recording():
        outlives = tracing.begin("a")
        with tracing.span("b"):
            pass
    outlives.end()                  # closed after the recording
    with tracing.recording():
        stale = tracing.begin("c")
    with tracing.recording():
        stale.end()                 # closed in a later recording
        with tracing.span("d"):
            pass
    assert [s["name"] for s in tracing.snapshot()["spans"]] == ["b", "d"]


def test_mapped_span_encloses_the_profiled_call():
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(384, 384)
    torch.mm(x, x)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.recording():
            with tracing.span("probe.warm"):    # first-call costs
                pass
            with tracing.span("probe.mm"):
                torch.mm(x, x)
    snap = tracing.snapshot()
    trace = json.loads(_export(prof))
    base = trace.get("baseTimeNanoseconds", 0)
    ev = {e["name"]: e for e in trace["traceEvents"]
          if e.get("name") in ("aten::mm", "probe.mm") and "dur" in e}
    sp = snap["spans"][1]
    start = tracing.trace_us(snap, sp["start"], base)
    end = tracing.trace_us(snap, sp["end"], base)
    mm = ev["aten::mm"]
    assert start <= mm["ts"] + 50.0
    assert end >= mm["ts"] + mm["dur"] - 50.0
    # the span is also the profiler's own range of the same name, inside
    # it (the span's clock is read outside the range's own enter and exit)
    ann = ev["probe.mm"]
    assert start <= ann["ts"] + 50.0
    assert end >= ann["ts"] + ann["dur"] - 50.0


def _export(prof) -> str:
    import os
    import tempfile

    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return f.read()
    finally:
        os.unlink(path)


def test_profile_window_trace_holds_the_train_spans(cfg, tmp_path):
    d = tmp_path / "data"
    d.mkdir()
    cs.write_shards(cfg, str(d), 1, 2 * B, seed=3)
    run = dataclasses.replace(cfg, output_path=str(tmp_path / "out"))
    tr = Trainer(run, device="cpu")
    tr.train(max_steps=2,
             data_iter=iter(list(native.native_batch_stream(
                 run, str(d) + "/", B))),
             profile_dir=str(tmp_path / "prof"), profile_steps=(0, 1),
             log_every=100)
    traces = list((tmp_path / "prof").glob("*.trace.json"))
    assert len(traces) == 1
    names = [e["name"] for e in json.loads(traces[0].read_text())
             ["traceEvents"] if e.get("cat") == "user_annotation"]
    for name in ("train.step",) + PHASES:
        assert names.count(name) == 1, name
    assert tracing.snapshot()["spans"] == []    # the window keeps none
