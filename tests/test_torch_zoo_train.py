"""Two ``Trainer`` steps of the port against the JAX ``Trainer`` for five
representatives of the model lattice, on the CPU: the JAX init carried
across by ``convert.train_state_from_jax``, the same numpy batches,
dropout off on both sides.  Loss, params, the optimizer state and the
model state (batch norm's moving statistics) are compared after each
step.  This file runs the first three; ``test_torch_zoo_train_seq.py``
runs the other two with these tests.

- ``mlp`` with batch norm: no table, a model state;
- ``embed_mlp_unbias``: the single-task unbias loss, lazy tables;
- ``multi_task`` with ``propensity_em``: the per-example sample weight
  (the batches carry weights other than 1);
- ``transformer``: one sequence group, the combiner's ``skip_seq``;
- ``mmoe`` with batch norm: the per-expert path."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

import __graft_entry__ as g  # noqa: E402
from cikm2020_dmt_tpu.train.loop import Trainer as JTrainer  # noqa: E402
from cikm2020_dmt_torch.convert import train_state_from_jax  # noqa: E402
from cikm2020_dmt_torch.metrics.streaming import \
    task_metrics_init  # noqa: E402
from cikm2020_dmt_torch.train.loop import Trainer  # noqa: E402
from test_torch_serve import SMALL, port_cfg  # noqa: E402
from test_torch_train import jax_metrics, leaves, to_numpy  # noqa: E402

B = 64
LR = 1e-3
BASE = dict(sku_rows=4096, batch_size=B, validate_step=10**9,
            dedup_rows_threshold=1000, pack_rows_threshold=1000,
            table_bf16_threshold=0, dropout_rate_bias=(0.0, 0.0),
            hidden_units=(32, 16), learning_rate=(LR,), bn_decay=0.9)
NO_TABLES = dict(embeddings=(), embeddings_bias=(), attention_pairs=(),
                 attention_ts=())
CASES = {
    "mlp_bn": dict(model_type="mlp", is_bn=True, **NO_TABLES),
    "embed_mlp_unbias": dict(model_type="embed_mlp_unbias"),
    "transformer": dict(model_type="transformer"),
    "mmoe_bn": dict(model_type="mmoe", is_bn=True),
    "multi_task_propensity": dict(model_type="multi_task",
                                  propensity_em=True),
    # test_torch_zoo_train_knobs.py: elements past the budget read zeros;
    # the weights from the position propensity model
    "lazy_overflow_inexact": dict(model_type="embed_mlp_unbias",
                                  lazy_overflow_exact=False,
                                  dedup_budget_div=64),
    "multi_task_propensity_position": dict(
        model_type="multi_task", propensity_em=True,
        propensity_em_type="position"),
}


def config(**kw):
    cfg = g._demo_config(**{**SMALL, **BASE, **kw})
    if kw["model_type"] == "transformer":
        # one sequence group: the click history
        cfg = dataclasses.replace(
            cfg, attention_pairs=cfg.attention_pairs[:1],
            attention_ts=cfg.attention_ts[:1])
    return dataclasses.replace(cfg, transformer=dataclasses.replace(
        cfg.transformer, dropout_rate=0.0))


def batches(cfg, n):
    out = []
    for s in range(n):
        b = g.synthetic_batch(cfg, B, seed=s)
        rng = np.random.default_rng(100 + s)
        if cfg.propensity_em_type == "position":
            b.update(position_weights(b, rng))
        else:
            b["propensity_weight_mul"] = rng.uniform(0.3, 4.0, B).astype(
                np.float32)
        out.append(b)
    return out


def position_weights(b, rng):
    """The propensity fields from a position propensity model with a
    random table, as the data pipeline makes them; the port's model and
    the JAX package's give the same arrays."""
    from cikm2020_dmt_tpu.data.propensity import \
        PropensityModel as JPropensity
    from cikm2020_dmt_torch.data.propensity import (MAX_POSITION,
                                                    PropensityModel)
    table = rng.uniform(0.05, 1.0, MAX_POSITION + 1).astype(np.float32)
    args = (b["em_position"], b["em_page"], b["label"])
    got = PropensityModel("position", table).weights(*args)
    want = JPropensity("position", table).weights(*args)
    for a, w in zip(got, want):
        np.testing.assert_array_equal(a, w)
    assert np.ptp(got[3]) > 0
    return dict(zip(("propensity", "propensity_weight",
                     "propensity_weight_positive", "propensity_weight_mul"),
                    got))


def run_pair(cfg, n_steps=2):
    """(JAX states after 0..n steps, JAX losses, port states after 1..n
    steps, port losses, port config)."""
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    jt = JTrainer(cfg, mesh=mesh)
    ts = jt.shard_state(jt.init_state())
    step = jt._train_step()
    bs = batches(cfg, n_steps)
    jstates, jlosses = [to_numpy(ts)], []
    jm = jax_metrics(jt)
    rng = jax.random.key(0, impl="rbg")
    for i, b in enumerate(bs):
        ts, jm, loss = step(ts, jm, jt.device_batch(g._as_batch(b)),
                            jax.random.fold_in(rng, i))
        jstates.append(to_numpy(ts))
        jlosses.append(float(loss))
    pcfg = port_cfg(cfg)
    tr = Trainer(pcfg, device="cpu")
    state = train_state_from_jax(pcfg, jstates[0])
    tm = task_metrics_init()
    pstates, plosses = [], []
    for b in bs:
        state, tm, loss = tr.train_step(
            state, tm, {k: torch.from_numpy(v) for k, v in b.items()},
            torch.Generator().manual_seed(0))
        pstates.append(jax.tree_util.tree_map(
            lambda t: t.detach().clone(), state))
        plosses.append(float(loss))
    return dict(jstates=jstates, jlosses=jlosses, pstates=pstates,
                plosses=plosses, pcfg=pcfg, lazy=len(tr.lazy_plan))


RUNS: dict = {}


def cached_run(name):
    if name not in RUNS:
        RUNS[name] = run_pair(config(**CASES[name]))
    return name, RUNS[name]


@pytest.fixture(params=["embed_mlp_unbias", "mlp_bn",
                        "multi_task_propensity"])
def run(request):
    return cached_run(request.param)


def view(pcfg, jstate):
    """A JAX state in the port's layout, numpy leaves."""
    return jax.tree_util.tree_map(lambda t: t.numpy(),
                                  train_state_from_jax(pcfg, jstate))


def test_losses_match_jax(run):
    name, r = run
    np.testing.assert_allclose(r["plosses"], r["jlosses"], rtol=1e-5,
                               err_msg=name)
    # the lazy path where the case has tables of 1,000 rows or more
    assert (r["lazy"] > 0) == (name not in ("mlp_bn",)), name


@pytest.mark.parametrize("step", [1, 2])
def test_params_match_jax(run, step):
    """Within 2 lr a step (Adam moves an element whose gradient is zero in
    exact arithmetic by up to lr either way under another summation
    order), the median far closer."""
    name, r = run
    want = view(r["pcfg"], r["jstates"][step])["params"]
    got = jax.tree_util.tree_map(lambda t: t.numpy(),
                                 r["pstates"][step - 1]["params"])
    w, gl = dict(leaves(want)), dict(leaves(got))
    assert sorted(w) == sorted(gl), name
    diffs = []
    for path, b in w.items():
        np.testing.assert_allclose(gl[path], b, rtol=0,
                                   atol=2 * LR * step,
                                   err_msg=f"{name} {path}")
        diffs.append(np.abs(gl[path] - b).ravel())
    assert np.median(np.concatenate(diffs)) < 1e-6, name


@pytest.mark.parametrize("step", [1, 2])
def test_optimizer_and_model_state_match_jax(run, step):
    """Adam's m and v and the lazy moments within 1e-4 of each leaf's
    largest |value|, the counts exactly.  A leaf whose gradient is zero in
    exact arithmetic is rounding noise on both sides (the dense bias
    before a batch norm, which subtracts the batch mean): floors of 1e-5
    of the largest |value| of all leaves of the moment, and 1e-8 (m) and
    1e-12 (v).  The moving statistics after step 1 within 1e-5 of each
    leaf's largest |value|.  From step 2 they average batch statistics
    taken after the params moved, and the params are held only to 2 lr a
    step (the rule above; the noise bias before each batch norm moves by
    about lr either way): within 1e-3 of each leaf's largest |value|, and
    the moving mean also within (1 - decay) times 4 lr a step before it
    (the noise bias it averages, 2 lr, and as much again for the product
    before it)."""
    name, r = run
    want = view(r["pcfg"], r["jstates"][step])
    got = jax.tree_util.tree_map(lambda t: t.numpy(),
                                 r["pstates"][step - 1])
    assert int(got["step"]) == int(want["step"]) == step
    assert sorted(got["opt"]) == sorted(want["opt"]) == ["count", "m", "v"]
    assert int(got["opt"]["count"]) == int(want["opt"]["count"]) == step
    pairs = [(leaves(got["opt"][k]), dict(leaves(want["opt"][k])), f)
             for k, f in (("m", 1e-8), ("v", 1e-12))]
    assert sorted(got["lazy_opt"]) == sorted(want["lazy_opt"])
    for t, sub in want["lazy_opt"].items():
        mv = got["lazy_opt"][t]["mv"]
        pairs += [([(t, mv[0])], {t: sub["mv"][0]}, 1e-8),
                  ([(t, mv[1])], {t: sub["mv"][1]}, 1e-12)]
    for got_leaves, want_leaves, floor in pairs:
        top = max(np.abs(b).max() for b in want_leaves.values())
        for path, a in got_leaves:
            b = want_leaves[path]
            atol = max(1e-4 * np.abs(b).max(), 1e-5 * top, floor)
            np.testing.assert_allclose(a, b, rtol=0, atol=atol,
                                       err_msg=f"{name} {path}")
    ws, gs = dict(leaves(want["model_state"])), dict(
        leaves(got["model_state"]))
    assert sorted(ws) == sorted(gs), name
    assert bool(ws) == name.endswith("_bn"), name
    bias_noise = (1 - r["pcfg"].bn_decay) * 4 * LR * (step - 1)
    rel = 1e-5 if step == 1 else 1e-3
    for path, b in ws.items():
        atol = rel * np.abs(b).max() + (
            bias_noise if path.endswith("moving_mean") else 0.0)
        np.testing.assert_allclose(gs[path], b, rtol=0, atol=atol,
                                   err_msg=f"{name} {path}")
