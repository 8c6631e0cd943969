"""The serving entry: ``ScorerQueue.submit`` under a closed loop of
clients, each of which submits one request of the pool, waits for its
Scores on the host, and submits the next.  One thread drives every
client (the queue's dispatcher is the other), so the load takes little
of the interpreter's lock from the system under test.

Set-up builds a ``Scorer`` from the benchmark's seeded weights and
normalization constants, puts it behind the queue through a wrapper that
counts the requests of each forward and times the forward's host work,
and warms each of the queue's group sizes once and the clients' path.
The window's rate is the requests whose Scores reached their client
inside it, over its seconds; the latency of a request runs from its
submit to its Scores on the host in the client's thread, over every
request completed inside the window.  After the window a sample of those
requests, drawn from the seed, is scored by the plain reference and
compared with what the clients received."""

from __future__ import annotations

import gc
import math
from concurrent import futures

import numpy as np
import torch

from .. import harness, seeds, weights, work
from ..reference import compare, model
from ..reference import serve as ref_serve
from ..trace import now, stretch
from ..traffic import requests as traffic


class Counted:
    """The scorer as the queue sees it: each forward's start, host seconds
    and real requests (a padded group repeats its last request)."""

    def __init__(self, scorer, fault=None):
        self.scorer = scorer
        self.fault = fault
        self.forwards: list = []
        self.index: dict = {}

    def _note(self, t, batches):
        self.forwards.append((t, now() - t, len({id(b) for b in batches}),
                              [self.index.get(id(b)) for b in
                               {id(b): b for b in batches}.values()]))

    def _alter(self, out):
        if self.fault == "answer":
            out = dict(out)
            out["Scores"] = out["Scores"] + 1e-3
        return out

    def score_group_async(self, batches):
        t = now()
        out = self.scorer.score_group_async(batches)
        self._note(t, batches)
        return self._alter(out)

    def score_async(self, batch):
        t = now()
        out = self.scorer.score_async(batch)
        self._note(t, [batch])
        return self._alter(out)


def _request_lens(conf, req) -> dict:
    return {f.feature: int(req[f.feature + model.LEN][0])
            for f in conf.features}


def run(ctx, fault=None, control=False) -> dict:
    """One run of the cell; ``fault="answer"`` (tests only) alters every
    Scores where the scorer produces it.  ``control``
    (``perfbench/control.py``) also scores the sample by the reference
    with TF32 products."""
    from cikm2020_dmt_torch.serve.export import Scorer, norm_constants
    from cikm2020_dmt_torch.serve.queue import ScorerQueue

    conf, dev, cell, seed = ctx.conf, ctx.device, ctx.cell, ctx.seed
    tp = cell["traffic"]
    nrng = np.random.default_rng(seeds.derive(seed, seeds.NORM))
    mean = nrng.normal(0.5, 1.0, conf.feature_dimension)
    std = nrng.uniform(0.1, 3.0, conf.feature_dimension)
    scale, const = norm_constants(mean, std)
    scorer = Scorer(ctx.cfg, weights.make(conf, seed, dev), scale, const,
                    device=dev)
    gc.collect()
    counted = Counted(scorer, fault)
    queue = ScorerQueue(counted, max_group=int(tp["max_group"]),
                        groups=tuple(int(g) for g in tp["groups"]))
    pool = traffic.make(conf, tp, seed)
    for r in pool:
        r.pop("_lens")
    lens = [_request_lens(conf, r) for r in pool]
    ops = [work.request_ops(conf, l, int(tp["candidates"])) for l in lens]

    def submit(i, pending, c):
        req = dict(pool[i])
        counted.index[id(req)] = i
        t = now()
        pending[queue.submit(req)] = (c, i, t, id(req))

    def receive(fut, pending, records, errors):
        c, i, t, rid = pending.pop(fut)
        try:
            out = fut.result()
            host = torch.stack([out["Scores"], out["click_Scores"],
                                out["order_Scores"]]).cpu().numpy()
            records.append((t, now(), i, host))
        except Exception as e:  # noqa: BLE001 - counted as failed
            errors.append(repr(e))
        counted.index.pop(rid, None)
        return c

    def load(seconds, records, errors):
        """The clients' closed loop for ``seconds``, driven from this
        thread: each client has one request outstanding; when its Scores
        are on the host it submits its next, until the time is up.
        Returns the loop's start."""
        n = int(tp["clients"])
        rngs = [np.random.default_rng(seeds.derive(seed, seeds.CLIENTS, c))
                for c in range(n)]
        pending: dict = {}
        t0 = now()
        for c in range(n):
            submit(int(rngs[c].integers(len(pool))), pending, c)
        while pending:
            ready, _ = futures.wait(list(pending),
                                    return_when=futures.FIRST_COMPLETED)
            for fut in ready:
                c = receive(fut, pending, records, errors)
                if now() - t0 < seconds:
                    submit(int(rngs[c].integers(len(pool))), pending, c)
        return t0

    # ---- warm-up: every group size once, then the clients' path ----
    queue.warmup(pool[0])
    load(0.0, [], [])
    harness.sync(dev)
    counted.forwards.clear()
    ctx.setup_s = now() - ctx.t_start

    # ---- the window ----
    records, errors = [], []
    t0 = load(ctx.seconds, records, errors)
    end = t0 + ctx.seconds
    done, rate, p95 = summarize(records, t0, ctx.seconds)
    forwards = [f for f in counted.forwards if t0 <= f[0] <= end]
    memory = (torch.cuda.max_memory_allocated(dev)
              if dev.type == "cuda" else 0)
    rec = {"entry": "serve", "window_s": ctx.seconds,
           "requests": len(done), "requests_per_s": rate,
           "forwards": [(f[1], f[2]) for f in forwards],
           "ops_per_s": sum(ops[r[2]] for r in done) / ctx.seconds}
    host = sorted(f[1] for f in forwards) or [math.nan]
    harness.log(f"# window: {len(done)} requests, {len(forwards)} forwards, "
                f"p95 {p95:.3f} ms; host s a forward p50 "
                f"{host[len(host) // 2]:.4f} p90 {host[9 * len(host) // 10]:.4f}"
                f" max {host[-1]:.4f}")

    # ---- the traced stretch ----
    if ctx.trace:
        D, F = conf.d_model, conf.d_ff
        secs = float(cell.get("trace_seconds", 1.0))
        traced: list = []

        def warm():
            load(0.2, [], [])
            counted.forwards.clear()    # only the stretch's forwards count

        rec["trace"] = stretch(lambda: load(secs, traced, []),
                               lambda: harness.sync(dev), warm=warm)
        harness.log(f"# traced stretch: {len(traced)} requests in "
                    f"{secs:.3f} s, {len(traced) / secs:.1f} requests/s "
                    f"(window {rate:.1f})")
        least = 0.0
        for _, _, _, idx in counted.forwards:
            for i in idx:
                if i is None:
                    continue
                for g in conf.attention_pairs:
                    least += work.least_s(*work.block_serve_work(
                        lens[i][g[0][0]], int(tp["candidates"]), D, F))
        rec["trace_work"] = {"block_s": least}
        rec["trace_host"] = stretch(lambda: load(0.25, [], []),
                                    lambda: harness.sync(dev), host=True,
                                    warm=lambda: load(0.2, [], []))
    queue.close()

    # ---- the comparison, after the program's state is freed ----
    del scorer, queue, counted
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    model.exact_matmul(tf32=False)
    sample = _sample(done, int(cell["check_requests"]), lens, seed)
    r_scale, r_const = ref_serve.norm_constants(mean, std)
    params = weights.make(conf, seed, dev)
    asked = [pool[done[j][2]] for j in sample]
    ref = ref_serve.scores(conf, params, asked, r_scale, r_const, dev)
    gap = max((float(np.abs(done[j][3] - want).max())
               for j, want in zip(sample, ref)), default=math.nan)
    ok, checks = compare.check({"score_gap": gap}, cell["limits"])
    out = {"attempted": len(records) + len(errors), "failed": len(errors),
           "correct": ok and not errors and len(done) > 0,
           "checks": checks,
           "e2e": {"serve_requests_per_s": rec["requests_per_s"],
                   "request_p95_ms": p95},
           "memory": memory, "rec": rec}
    if control:
        model.exact_matmul(tf32=True)
        tf = ref_serve.scores(conf, params, asked, r_scale, r_const, dev)
        model.exact_matmul(tf32=False)
        out["control"] = {"tf32": {"score_gap": max(
            float(np.abs(a - b).max()) for a, b in zip(tf, ref))}}
    return out


def summarize(records: list, t0: float, seconds: float):
    """(the requests completed inside the window, their rate over the
    window's seconds, the 95th percentile of their latencies in ms, by
    nearest rank over all of them).  A record is (submit, done, ...)."""
    done = [r for r in records if t0 <= r[1] <= t0 + seconds]
    lat = sorted((r[1] - r[0]) * 1e3 for r in done)
    p95 = lat[max(0, math.ceil(0.95 * len(lat)) - 1)] if lat else math.nan
    return done, len(done) / seconds, p95


def _sample(done: list, n: int, lens: list, seed: int) -> list:
    """Indices into ``done`` of ``n`` completed requests drawn from the
    seed, the one with the longest histories among them."""
    if not done:
        return []
    rng = np.random.default_rng(seeds.derive(seed, seeds.SAMPLE))
    pick = set(rng.choice(len(done), min(n, len(done)), replace=False)
               .tolist())
    longest = max(range(len(done)),
                  key=lambda j: sum(lens[done[j][2]].values()))
    pick.add(longest)
    return sorted(pick)
