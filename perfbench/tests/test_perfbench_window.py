"""Rates and tails are taken over the whole window: an injected stall
lowers them, and lowers them more than a median of chunks would."""

from __future__ import annotations

import statistics
import time

from perfbench.entries.serve import summarize
from perfbench.entries.train import closed_loop


def test_training_rate_counts_a_stall():
    calls = []

    def step():
        calls.append(1)
        time.sleep(0.25 if len(calls) == 10 else 0.005)

    spans, window = closed_loop(step, 0.6, lambda: None)
    rate = len(spans) / window
    chunks = [1.0 / s for s in spans]            # a rate per step
    assert max(spans) >= 0.25 and window >= 0.6
    assert rate < 0.75 * statistics.median(chunks)


def test_closed_loop_ends_with_the_synchronise():
    def sync():
        time.sleep(0.2)

    _, window = closed_loop(lambda: None, 0.05, sync)
    assert window >= 0.25


def test_tail_and_rate_over_all_requests():
    t0, recs = 100.0, []
    # 1,000 requests of 10 ms, 60 of them stalled to 500 ms in one second
    for i in range(1000):
        start = t0 + i * 0.009
        lat = 0.5 if 500 <= i < 560 else 0.01
        recs.append((start, start + lat, i))
    recs.append((t0 + 9.5, t0 + 10.5, -1))       # completes after the window
    done, rate, p95 = summarize(recs, t0, 10.0)
    assert len(done) == 1000 and rate == 100.0
    assert p95 >= 500.0
    chunk = [summarize([r for r in done if t0 + k <= r[1] < t0 + k + 1],
                       t0 + k, 1.0)[2] for k in range(10)]
    assert statistics.median(c for c in chunk if c == c) < 20.0
