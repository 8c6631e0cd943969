"""The port's bfloat16 training step against the JAX ``Trainer`` on the CPU,
with the benchmark's storage: ``compute_dtype="bfloat16"`` and every table
of at least 500 rows stored bfloat16 (``bench.py``'s config; Sku, Cid3,
Brand and Shopid under lazy Adam, Cid2 on the dense path).

The JAX side runs the path it runs on the TPU: the fused block kernel
(``DMT_FUSED_BLOCK=1``, Pallas interpret mode), whose rounding points the
port's fused block follows.  Off the TPU the JAX package otherwise takes
its per-op block, which rounds elsewhere.  The dense widths are the
flagship's (``DMTConfig``'s defaults: 615 features, experts of 512, 256
and 128, towers of 32), the tables shrunk.  At the narrow widths of the
other port tests (towers of 8 units) one ReLU whose bfloat16
pre-activation rounds to 0 on an example of class weight 400 moves the
whole gradient by tens of percent, on either side.

Each step is taken from the same state on both sides: step k of the port
starts from the JAX state after step k - 1 (``convert.train_state_from_jax``),
as does a float32 step of the port (compute float32, tables float32).
The bfloat16 rule (``chip_smoke.py`` holds the card to the CPU by it):

- the loss within twice the JAX bfloat16 loss's distance from the float32
  loss, plus 1e-5 relative;
- each leaf's gradient, read through Adam's first moment (``(m_k - B1
  m_{k-1}) / (1 - B1)``; the lazy tables on the rows the JAX step moved),
  norm-wise within ``BWD_BF16_FACTOR`` (2) times the JAX bfloat16
  gradient's distance from the float32 one, plus ``BWD_TOL_F32`` (1e-2).
  Leaves whose float32 gradient is below 1e-6 of the largest |value| of
  all leaves are zero in exact arithmetic (a key bias: a softmax ignores
  a constant added to every score) and are skipped;
- each param within 2 lr (Adam's sign flips, ``test_torch_train.py``)
  plus one bfloat16 step (2**-7) of the leaf's largest |value|.

The other files of the bfloat16 path reuse ``bf16_run`` and the checks:
``test_torch_grid_bf16*.py`` (float32 tables, bfloat16 union grid),
``test_torch_bf16_onehot.py`` (``onehot_bwd_bf16``) and
``test_torch_bf16_route.py`` (the lookups past ``onehot_bwd_rows_max``,
the eval forward)."""

import contextlib
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

import __graft_entry__ as g  # noqa: E402
from cikm2020_dmt_tpu.metrics.streaming import \
    task_metrics_init as j_metrics_init  # noqa: E402
from cikm2020_dmt_tpu.train.loop import Trainer as JTrainer  # noqa: E402
from cikm2020_dmt_torch.convert import train_state_from_jax  # noqa: E402
from cikm2020_dmt_torch.metrics.streaming import \
    task_metrics_init  # noqa: E402
from cikm2020_dmt_torch.nn.layers import tree_map  # noqa: E402
from cikm2020_dmt_torch.train.loop import Trainer  # noqa: E402
from cikm2020_dmt_torch.train.optim import B1  # noqa: E402
from chip_smoke import (BF16_STEP, BWD_BF16_FACTOR, BWD_TOL_F32,  # noqa: E402
                        LOSS_REL, float32_reference)
from test_torch_serve import port_cfg  # noqa: E402
from test_torch_train import (B, KW, LR, leaves, port_view,  # noqa: E402
                              to_numpy)

NOISE = 1e-6


@contextlib.contextmanager
def fused_block():
    """The JAX package's fused block off the TPU (read when a step is
    traced)."""
    old = os.environ.get("DMT_FUSED_BLOCK")
    os.environ["DMT_FUSED_BLOCK"] = "1"
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("DMT_FUSED_BLOCK")
        else:
            os.environ["DMT_FUSED_BLOCK"] = old


def bf16_config(**kw):
    """The flagship at its dense widths, tables shrunk, bfloat16 compute,
    dropout off."""
    cfg = g._demo_config(**{**KW, "compute_dtype": "bfloat16", **kw})
    return dataclasses.replace(cfg, transformer=dataclasses.replace(
        cfg.transformer, dropout_rate=0.0))


def widen(state):
    return tree_map(lambda t: t.float() if t.dtype == torch.bfloat16 else t,
                    state)


def bf16_run(cfg, n_steps=2):
    """JAX states after 0..n steps and losses; per step k, the port's
    bfloat16 step and its float32 step from the JAX state after k - 1:
    (state, loss)."""
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    jt = JTrainer(cfg, mesh=mesh)
    ts = jt.shard_state(jt.init_state())
    step = jt._train_step()
    batches = [g.synthetic_batch(cfg, B, seed=s) for s in range(n_steps)]
    jstates, jlosses = [to_numpy(ts)], []
    rng = jax.random.key(0, impl="rbg")
    with fused_block():
        for i, b in enumerate(batches):
            ts, _, loss = step(ts, j_metrics_init(),
                               jt.device_batch(g._as_batch(b)),
                               jax.random.fold_in(rng, i))
            jstates.append(to_numpy(ts))
            jlosses.append(float(loss))
    pcfg = port_cfg(cfg)
    port, ref = Trainer(pcfg, device="cpu"), Trainer(float32_reference(pcfg),
                                                      device="cpu")
    steps = []
    for k, b in enumerate(batches):
        tb = {key: torch.from_numpy(v) for key, v in b.items()}
        out = {}
        for name, tr, fn in (("port", port, lambda s: s),
                             ("f32", ref, widen)):
            s, _, loss = tr.train_step(
                fn(train_state_from_jax(pcfg, jstates[k])),
                task_metrics_init(), tb, torch.Generator().manual_seed(0))
            out[name] = (s, float(loss))
        steps.append(out)
    return dict(cfg=cfg, pcfg=pcfg, jstates=jstates, jlosses=jlosses,
                steps=steps, batches=batches, lazy=len(port.lazy_plan))


def _np(tree):
    return tree_map(lambda t: t.float().numpy(), tree)


def check_loss(run, step):
    jl = run["jlosses"][step - 1]
    pl = run["steps"][step - 1]["port"][1]
    fl = run["steps"][step - 1]["f32"][1]
    tol = BWD_BF16_FACTOR * abs(jl - fl) + LOSS_REL * abs(jl)
    assert abs(pl - jl) <= tol, (step, pl, jl, fl, tol)


def _grads(run, state, step):
    """Path -> the step's gradient as Adam's first moment carries it:
    (m_k - B1 m_{k-1}) / (1 - B1), m_{k-1} the JAX state's; lazy tables
    on the rows the JAX step moved."""
    before = port_view(run["pcfg"], run["jstates"][step - 1])
    after = port_view(run["pcfg"], run["jstates"][step])
    prev = dict(leaves(before["opt"]["m"]))
    out = {p: (np.asarray(m, np.float64) - B1 * prev[p]) / (1.0 - B1)
           for p, m in leaves(state["opt"]["m"])}
    for t, sub in state["lazy_opt"].items():
        m0 = np.asarray(before["lazy_opt"][t]["mv"][0], np.float64)
        moved = (after["lazy_opt"][t]["mv"][0] != m0).any(-1)
        m = np.asarray(sub["mv"][0], np.float64)
        out["lazy/" + t] = ((m - B1 * m0) / (1.0 - B1))[moved]
    return out


def check_grads(run, step):
    want = _grads(run, port_view(run["pcfg"], run["jstates"][step]), step)
    got = _grads(run, _np(run["steps"][step - 1]["port"][0]), step)
    ref = _grads(run, _np(run["steps"][step - 1]["f32"][0]), step)
    assert sorted(got) == sorted(want) == sorted(ref)
    top = max(np.abs(r).max(initial=0.0) for r in ref.values())
    checked = 0
    for path, w in want.items():
        r = ref[path]
        if np.abs(r).max(initial=0.0) < NOISE * top:
            continue
        own = np.linalg.norm(w - r) / np.linalg.norm(r)
        err = np.linalg.norm(got[path] - w) / np.linalg.norm(w)
        tol = BWD_BF16_FACTOR * own + BWD_TOL_F32
        assert err <= tol, (step, path, err, own, tol)
        checked += 1
    assert checked > 0.9 * len(want)


def check_params(run, step):
    want = port_view(run["pcfg"], run["jstates"][step])["params"]
    got = dict(leaves(_np(run["steps"][step - 1]["port"][0]["params"])))
    want = dict(leaves(want))
    assert sorted(got) == sorted(want)
    for path, b in want.items():
        a = got[path]
        assert a.shape == b.shape, path
        atol = 2 * LR + BF16_STEP * np.abs(b).max()
        np.testing.assert_allclose(a, b, rtol=0, atol=atol,
                                   err_msg=f"step {step} {path}")


CHECKS = {"loss": check_loss, "grads": check_grads, "params": check_params}


@pytest.fixture(scope="module")
def run():
    return bf16_run(bf16_config(table_bf16_threshold=500))


@pytest.mark.parametrize("check", sorted(CHECKS))
@pytest.mark.parametrize("step", [1, 2])
def test_bf16_step_matches_jax(run, step, check):
    CHECKS[check](run, step)


def test_bf16_tables_and_plan(run):
    """bfloat16 storage on both sides for the tables of at least 500 rows,
    the four lazy tables, and the lazy moments float32."""
    state = run["steps"][1]["port"][0]
    emb = state["params"]["emb"]
    assert {k for k, v in emb.items() if v.dtype == torch.bfloat16} == {
        "Sku", "Cid2", "Cid3", "Brand", "Shopid"}
    assert run["lazy"] == 4
    assert all(s["mv"].dtype == torch.float32
               for s in state["lazy_opt"].values())
    assert int(state["lazy_overflow"]) == int(
        run["jstates"][2]["lazy_overflow"]) == 0
