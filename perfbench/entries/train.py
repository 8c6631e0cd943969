"""The training entry: ``Trainer.train_step`` in a closed loop, one step
after another, on the cell's distinct device-resident batches in turn.

Set-up builds one trainer and its state from the benchmark's seeded
weights and drives it through its first steps (the cell's
``check_steps``) on distinct batches through the window's own call; they
warm every shape and give the readings that the plain reference is held
to: each step's loss, the first step's gradient by leaf (read from Adam's
first moment, ``(1 - b1) g`` after one step) and each leaf's change over
those steps.  The same trainer and state then run the window.  The window
ends with a synchronise on the whole device; its rate is the examples of
every step it ran over its seconds.  With ``--trace 1`` a stretch of
steps after the window is traced."""

from __future__ import annotations

import gc

import torch

from .. import harness, models, seeds, weights
from ..reference import compare, model
from ..reference import train as ref_train
from ..trace import now, stretch
from ..traffic import batches as traffic

B1 = 0.9


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_clone(v) for v in tree]
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def _norm(t) -> float:
    return float(t.float().norm())


def _grad_norms(state) -> dict:
    """The first step's gradient by leaf, from the optimizer's state."""
    out = {p: _norm(m) / (1.0 - B1)
           for p, m in ref_train.leaves(state["opt"]["m"])}
    for name, sub in state["lazy_opt"].items():
        out[("emb", name)] = _norm(sub["mv"][0]) / (1.0 - B1)
    return out


def _lens(conf, batch) -> dict:
    return {f.feature: batch[f.feature + model.LEN].cpu().numpy()
            for f in conf.features}


def run(ctx, fault=None, control=False) -> dict:
    """One run of the cell.  ``fault`` (tests only) breaks the timed path:
    ``"unchanged"`` makes every step return its state as it was,
    ``"half"`` feeds each step the first half of its batch.  ``control``
    (``perfbench/control.py``) also reads the reference in the program's
    place with TF32 products and with half of each batch."""
    from cikm2020_dmt_torch.metrics.streaming import task_metrics_init
    from cikm2020_dmt_torch.train.loop import Trainer

    conf, dev, cell = ctx.conf, ctx.device, ctx.cell
    mod = models.of(conf.model_type)
    tp = cell["traffic"]
    n_check = int(cell["check_steps"])
    tr = Trainer(ctx.cfg, device=dev)
    state = tr.init_state(torch.Generator(device=dev).manual_seed(0))
    weights.copy_into(state["params"], weights.make(conf, ctx.seed, dev))
    gc.collect()
    batches = traffic.make(conf, tp, ctx.seed, dev)
    lens = [_lens(conf, b) for b in batches]
    gen = torch.Generator(device=dev).manual_seed(
        seeds.derive(ctx.seed, seeds.DROPOUT))
    metrics = task_metrics_init(dev)

    def step(state, metrics, b):
        if fault == "unchanged":
            _, _, loss = tr.train_step(_clone(state), metrics, b, gen)
            return state, metrics, loss
        if fault == "half":
            n = b["mask"].shape[0] // 2
            b = {k: v[:n] for k, v in b.items()}
        return tr.train_step(state, metrics, b, gen)

    # ---- set-up: the first steps, read for the comparison ----
    p0 = dict(ref_train.leaves(state["params"]))
    for name in state["lazy_opt"]:
        p0[("emb", name)] = state["params"]["emb"][name].clone()
    prog = {"losses": []}
    for i in range(n_check):
        state, metrics, loss = step(state, metrics, batches[i % len(batches)])
        prog["losses"].append(float(loss))
        if i == 0:
            prog["grad_norms"] = _grad_norms(state)
    prog["change_norms"] = {p: _norm(t.float() - p0[p].float())
                            for p, t in ref_train.leaves(state["params"])}
    del p0
    harness.sync(dev)
    ctx.setup_s = now() - ctx.t_start

    # ---- the window ----
    B = int(tp["batch"])
    losses, used = [], []
    k = n_check

    def one():
        nonlocal state, metrics, k
        used.append(k % len(batches))
        state, metrics, loss = step(state, metrics, batches[used[-1]])
        losses.append(loss)
        k += 1

    spans, window_s = closed_loop(one, ctx.seconds, lambda: harness.sync(dev))
    steps = len(spans)
    q = sorted(spans)
    harness.log(f"# window: {steps} steps in {window_s:.4f} s; host s a call "
                f"first {[round(x, 4) for x in spans[:4]]}, p10 "
                f"{q[len(q) // 10]:.4f} p50 {q[len(q) // 2]:.4f} p90 "
                f"{q[9 * len(q) // 10]:.4f} max {q[-1]:.4f}")
    finite = torch.isfinite(torch.stack([l.float() for l in losses]))
    failed = int((~finite).sum())
    memory = (torch.cuda.max_memory_allocated(dev)
              if dev.type == "cuda" else 0)
    ops = {i: mod.train_step_ops(conf, lens[i]) for i in set(used)}
    rec = {"entry": "train", "window_s": window_s,
           "examples_per_s": steps * B / window_s,
           "spans": {"train_step": spans},
           "ops_per_s": sum(ops[i] for i in used) / window_s}

    # ---- the traced stretch ----
    if ctx.trace:
        n_trace = int(cell.get("trace_steps", 4))

        def traced(n, seen):
            def fn():
                nonlocal state, metrics, k
                for _ in range(n):
                    seen.append(k % len(batches))
                    state, metrics, _ = step(state, metrics, batches[seen[-1]])
                    k += 1
            return fn

        seen: list = []
        rec["trace"] = stretch(traced(n_trace, seen),
                               lambda: harness.sync(dev),
                               warm=traced(1, []))
        rec["trace_work"] = mod.train_kernel_s(conf, [lens[i] for i in seen])
        harness.log(f"# traced stretch: {n_trace} steps in "
                    f"{rec['trace'].window_s:.4f} s, "
                    f"{n_trace * B / rec['trace'].window_s:.1f} examples/s "
                    f"(window {rec['examples_per_s']:.1f})")
        rec["trace_host"] = stretch(traced(2, []), lambda: harness.sync(dev),
                                    host=True, warm=traced(1, []))

    # ---- the comparison, after the program's state is freed ----
    del state, metrics, tr, losses
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    model.exact_matmul(tf32=False)

    def reference(half=False):
        return ref_train.run(conf, weights.make(conf, ctx.seed, dev), batches,
                             torch.Generator(device=dev).manual_seed(
                                 seeds.derive(ctx.seed, seeds.DROPOUT)),
                             steps=n_check, half=half)

    ref = reference()
    numbers = compare.train_numbers(prog, ref)
    ok, checks = compare.check(numbers, cell["limits"])
    detail = compare.worst_leaves(prog, ref)
    harness.log(f"# worst leaves and step losses: {detail}")
    out = {"attempted": steps, "failed": failed,
           "correct": ok and failed == 0, "checks": checks,
           "e2e": {"examples_per_s": rec["examples_per_s"]},
           "memory": memory, "rec": rec, "detail": detail}
    if control:
        model.exact_matmul(tf32=True)
        out["control"] = {"tf32": compare.train_numbers(reference(), ref)}
        model.exact_matmul(tf32=False)
        out["control"]["half"] = compare.train_numbers(reference(half=True),
                                                       ref)
    return out


def closed_loop(fn, seconds: float, sync) -> tuple[list, float]:
    """Calls ``fn()`` one call after another until ``seconds`` have passed,
    then ``sync()``: (host seconds of each call, the window's seconds,
    which end with the synchronise).  A rate over the window counts every
    call and all of its time, stalls included."""
    spans = []
    t0 = now()
    while True:
        s = now()
        fn()
        spans.append(now() - s)
        if now() - t0 >= seconds:
            break
    sync()
    return spans, now() - t0


