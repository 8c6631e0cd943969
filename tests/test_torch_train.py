"""The port's training step (``Trainer`` on the CPU) against the JAX
``Trainer`` on a one-device mesh: the flagship model with shrunken tables,
the same numpy batches, the JAX init carried across by
``convert.train_state_from_jax``, dropout off on both sides (the two draw
different random bits), two steps.

The JAX side stores every table of at least 1,000 rows 128-lane packed,
and its lazy Adam updates whole packed rows (several logical rows); the
port updates the same groups of logical rows, so at the second step both
move the rows that share a packed row with a touched one
(``test_packed_neighbours``)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

import __graft_entry__ as g  # noqa: E402
from cikm2020_dmt_tpu.core.mesh import replicated  # noqa: E402
from cikm2020_dmt_tpu.data.pipeline import IDS  # noqa: E402
from cikm2020_dmt_tpu.metrics.streaming import \
    task_metrics_init as j_metrics_init  # noqa: E402
from cikm2020_dmt_tpu.train.loop import Trainer as JTrainer  # noqa: E402
from cikm2020_dmt_torch.convert import train_state_from_jax  # noqa: E402
from cikm2020_dmt_torch.metrics.streaming import \
    task_metrics_init  # noqa: E402
from cikm2020_dmt_torch.train.loop import Trainer  # noqa: E402
from test_torch_serve import SMALL, port_cfg  # noqa: E402

B = 64
LR = 1e-3
KW = dict(sku_rows=4096, batch_size=B, validate_step=10**9,
          dedup_rows_threshold=1000, pack_rows_threshold=1000,
          table_bf16_threshold=0, dropout_rate_bias=(0.0, 0.0))
LAZY = ("Sku", "Cid3", "Brand", "Shopid")


def no_dropout_config(**kw):
    cfg = g._demo_config(**{**SMALL, **KW, **kw})
    return dataclasses.replace(cfg, transformer=dataclasses.replace(
        cfg.transformer, dropout_rate=0.0))


def to_numpy(tree):
    # copies: the JAX step donates its state buffers
    return jax.tree_util.tree_map(np.array, tree)


def jax_metrics(jt):
    """The JAX metric state placed as ``jt``'s step returns it (replicated
    on its mesh): an unplaced one makes the step compile again at step 2."""
    return jax.device_put(j_metrics_init(), replicated(jt.mesh))


def run_both(cfg, n_steps=2):
    """(JAX states after 0..n steps, JAX metrics, JAX losses, port states
    after 1..n steps, port metrics, port losses, batches)."""
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    jt = JTrainer(cfg, mesh=mesh)
    ts = jt.shard_state(jt.init_state())
    step = jt._train_step()
    batches = [g.synthetic_batch(cfg, B, seed=s) for s in range(n_steps)]
    jstates, jlosses = [to_numpy(ts)], []
    jm = jax_metrics(jt)
    rng = jax.random.key(0, impl="rbg")
    for i, b in enumerate(batches):
        ts, jm, loss = step(ts, jm, jt.device_batch(g._as_batch(b)),
                            jax.random.fold_in(rng, i))
        jstates.append(to_numpy(ts))
        jlosses.append(float(loss))
    pcfg = port_cfg(cfg)
    tr = Trainer(pcfg, device="cpu")
    state = train_state_from_jax(pcfg, jstates[0])
    tm = task_metrics_init()
    gen = torch.Generator().manual_seed(0)
    pstates, plosses = [], []
    for b in batches:
        state, tm, loss = tr.train_step(
            state, tm, {k: torch.from_numpy(v) for k, v in b.items()}, gen)
        pstates.append(jax.tree_util.tree_map(
            lambda t: t.detach().clone(), state))
        plosses.append(float(loss))
    return dict(jstates=jstates, jmetrics=to_numpy(jm), jlosses=jlosses,
                pstates=pstates, pmetrics=tm, plosses=plosses,
                batches=batches, pcfg=pcfg, jcompiles=step._cache_size())


@pytest.fixture(scope="module")
def f32_run():
    return run_both(no_dropout_config())


def port_view(pcfg, jstate):
    """A JAX state in the port's layout (numpy; bfloat16 as float32)."""
    return jax.tree_util.tree_map(
        lambda t: (t.float() if t.dtype == torch.bfloat16 else t).numpy(),
        train_state_from_jax(pcfg, jstate))


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, np.asarray(tree, np.float64)


def touched(cfg, batch, table):
    ids = [batch[s.feature + IDS].reshape(-1) for s in cfg.embeddings
           if s.table == table]
    return np.unique(np.concatenate(ids))


def neighbour_rows(cfg, batches, table):
    """Rows that move at step 2 only because they share a packed row with a
    touched one: touched at step 1 (nonzero moments), not at step 2, on a
    packed row touched at step 2."""
    dim = next(s.dim for s in cfg.embeddings if s.table == table)
    p = 128 // dim
    t1, t2 = touched(cfg, batches[0], table), touched(cfg, batches[1], table)
    rows = np.setdiff1d(t1, t2)
    return rows[np.isin(rows // p, np.unique(t2 // p))]


def test_loss_matches_jax(f32_run):
    """Float32 on both sides; sums run in another order (the fused block
    against the reference's per-op jnp path)."""
    np.testing.assert_allclose(f32_run["plosses"], f32_run["jlosses"],
                               rtol=1e-5)


# Adam moves each element by about lr per step whatever the gradient's
# size, so a gradient element near zero whose sign flips under another
# summation order moves its parameter by up to 2 lr the other way; the
# tolerance is that bound.  Elements with a clear gradient agree far closer
# (asserted on the median).
PARAM_TOL = 2 * LR


@pytest.mark.parametrize("step", [1, 2])
def test_params_match_jax(f32_run, step):
    want = port_view(f32_run["pcfg"], f32_run["jstates"][step])["params"]
    got = jax.tree_util.tree_map(lambda t: t.numpy(),
                                 f32_run["pstates"][step - 1]["params"])
    diffs = []
    for (path, a), (_, b) in zip(leaves(got), leaves(want)):
        assert a.shape == b.shape, path
        np.testing.assert_allclose(a, b, rtol=0, atol=PARAM_TOL,
                                   err_msg=path)
        diffs.append(np.abs(a - b).ravel())
    assert np.median(np.concatenate(diffs)) < 1e-6


@pytest.mark.parametrize("step", [1, 2])
def test_optimizer_state_matches_jax(f32_run, step):
    """Dense m, v and the lazy [2, R, D] moments.  m and v are averages
    of the gradient and of its square, so they carry the gradient's own
    rounding: 1e-4 of each leaf's largest |value|, and at least 1e-8 for m
    and 1e-12 for v, for leaves whose gradient is zero in exact arithmetic
    and rounding noise in both (the key bias: a softmax ignores a constant
    added to every score)."""
    want = port_view(f32_run["pcfg"], f32_run["jstates"][step])
    got = jax.tree_util.tree_map(lambda t: t.numpy(),
                                 f32_run["pstates"][step - 1])
    assert int(got["step"]) == int(want["step"]) == step
    assert int(got["opt"]["count"]) == int(want["opt"]["count"]) == step
    pairs = [(a, b, 1e-8) for a, b in zip(leaves(got["opt"]["m"]),
                                          leaves(want["opt"]["m"]))]
    pairs += [(a, b, 1e-12) for a, b in zip(leaves(got["opt"]["v"]),
                                            leaves(want["opt"]["v"]))]
    for t in LAZY:
        a, b = got["lazy_opt"][t]["mv"], want["lazy_opt"][t]["mv"]
        pairs += [((f"{t}/m", a[0]), (t, b[0]), 1e-8),
                  ((f"{t}/v", a[1]), (t, b[1]), 1e-12)]
    for (path, a), (_, b), floor in pairs:
        atol = max(1e-4 * np.abs(b).max(), floor)
        np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=path)


def test_packed_neighbours(f32_run):
    """At step 2 the reference moves the rows that share a packed row with
    a touched one, and decays their moments; the port moves the same rows
    to the same values (within ``PARAM_TOL``) and the same moments."""
    moved = 0
    before = port_view(f32_run["pcfg"], f32_run["jstates"][1])
    after = port_view(f32_run["pcfg"], f32_run["jstates"][2])
    for t in LAZY:
        rows = neighbour_rows(f32_run["pcfg"], f32_run["batches"], t)
        port = [s["params"]["emb"][t].numpy() for s in f32_run["pstates"]]
        ref_moved = (after["params"]["emb"][t][rows]
                     != before["params"]["emb"][t][rows]).any(-1)
        port_moved = (port[1][rows] != port[0][rows]).any(-1)
        np.testing.assert_array_equal(port_moved, ref_moved, err_msg=t)
        np.testing.assert_allclose(port[1][rows],
                                   after["params"]["emb"][t][rows], rtol=0,
                                   atol=PARAM_TOL, err_msg=t)
        mv = f32_run["pstates"][1]["lazy_opt"][t]["mv"].numpy()
        want = after["lazy_opt"][t]["mv"]
        for i, floor in ((0, 1e-8), (1, 1e-12)):  # as in the test above
            np.testing.assert_allclose(
                mv[i, rows], want[i, rows], rtol=0,
                atol=max(1e-4 * np.abs(want[i]).max(), floor), err_msg=t)
        moved += int(ref_moved.sum())
    assert moved > 0


def test_metrics_match_jax(f32_run):
    want = dict(leaves(f32_run["jmetrics"]))
    got = dict(leaves(jax.tree_util.tree_map(lambda t: t.numpy(),
                                             f32_run["pmetrics"])))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_no_overflow_at_the_default_budget(f32_run):
    for s in (f32_run["jstates"][-1], f32_run["pstates"][-1]):
        assert int(np.asarray(s["lazy_overflow"])) == 0


def test_jax_step_compiles_once(f32_run):
    """Two JAX steps, one compile: the metric state goes in placed as the
    step returns it (``jax_metrics``)."""
    assert f32_run["jcompiles"] == 1
