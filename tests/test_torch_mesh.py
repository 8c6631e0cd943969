"""The port's data mesh (``core/mesh.py``, ``parallel/full_shard.py``,
``Trainer(mesh=)``) against the JAX ``Trainer`` on a ``(n, 1)`` mesh of the
virtual CPU devices: the flagship model with shrunken tables and widths,
the same numpy global batches (rank r takes rows [r B / n, (r + 1) B / n)),
the JAX init carried across by ``convert.train_state_from_jax``, dropout
off on both sides, two steps.

Packed Sku (4,096 rows of 32, groups of 4: 1,024 groups) splits over the
ranks (full mesh); Cid3, Brand and Shopid (128-256 groups, under the 512
of ``shard_rows_threshold``) stay replicated and take the global union.
The port's ranks are ``gloo`` processes (``core.mesh.run_ranks``) that
import ``torch`` and the port only (``tests/torch_mesh_workers.py``)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
from jax.sharding import Mesh as JMesh  # noqa: E402

import __graft_entry__ as g  # noqa: E402
import torch_mesh_workers as workers  # noqa: E402
from cikm2020_dmt_tpu.metrics.streaming import \
    task_metrics_values as j_metrics_values  # noqa: E402
from cikm2020_dmt_tpu.parallel.full_shard import \
    fms_table_rows as j_fms_table_rows  # noqa: E402
from cikm2020_dmt_tpu.train.loop import Trainer as JTrainer  # noqa: E402
from cikm2020_dmt_torch.convert import train_state_from_jax  # noqa: E402
from cikm2020_dmt_torch.core.mesh import (Mesh, build_mesh,  # noqa: E402
                                          param_placement, run_ranks)
from cikm2020_dmt_torch.metrics.streaming import (  # noqa: E402
    task_metrics_init, task_metrics_values)
from cikm2020_dmt_torch.parallel.full_shard import fms_table_rows  # noqa: E402
from cikm2020_dmt_torch.train.lazy import build_lazy_plan  # noqa: E402
from cikm2020_dmt_torch.train.loop import Trainer  # noqa: E402
from test_torch_serve import SMALL, port_cfg  # noqa: E402
from test_torch_train import jax_metrics, leaves, port_view  # noqa: E402

B = 64
LR = 1e-3
# the JAX full-mesh tests' settings (tests/test_lazy_adam.py FKW) at the
# port tests' widths: budget div 1 (no overflow), float32 tables
KW = dict(sku_rows=4096, batch_size=B, validate_step=10**9,
          dedup_rows_threshold=1000, pack_rows_threshold=1000,
          table_bf16_threshold=0, dropout_rate_bias=(0.0, 0.0),
          shard_rows_threshold=512, dedup_budget_div=1)
PARAM_TOL = 2 * LR       # as tests/test_torch_train.py: Adam's sign flips
SPAWN_TIMEOUT = 240.0


def mesh_config(**kw):
    cfg = g._demo_config(**{**SMALL, **KW, **kw})
    return dataclasses.replace(cfg, transformer=dataclasses.replace(
        cfg.transformer, dropout_rate=0.0))


def jax_mesh(n: int) -> JMesh:
    return JMesh(np.array(jax.devices()[:n]).reshape(n, 1),
                 ("data", "model"))


def to_numpy(tree):
    return jax.tree_util.tree_map(np.array, tree)


def run_jax(cfg, n: int, batches: list) -> dict:
    """The JAX ``Trainer`` on an (n, 1) mesh: states after 0..k steps,
    losses, metric values."""
    jt = JTrainer(cfg, mesh=jax_mesh(n))
    ts = jt.shard_state(jt.init_state())
    step = jt._train_step()
    states, losses = [to_numpy(ts)], []
    jm = jax_metrics(jt)
    rng = jax.random.key(0, impl="rbg")
    for i, b in enumerate(batches):
        ts, jm, loss = step(ts, jm, jt.device_batch(g._as_batch(b)),
                            jax.random.fold_in(rng, i))
        states.append(to_numpy(ts))
        losses.append(float(loss))
    return {"states": states, "losses": losses,
            "metrics": j_metrics_values(jm),
            "plan": [(t.name, t.full_mesh) for t in jt.lazy_plan]}


def run_port(cfg, n: int, jstate0, batches: list, env=None) -> list:
    pcfg = port_cfg(cfg)
    return run_ranks(workers.train_steps, n, pcfg,
                     train_state_from_jax(pcfg, jstate0), batches,
                     env or {}, timeout_s=SPAWN_TIMEOUT, threads=1)


def run_one_process(cfg, jstate0, batches: list) -> dict:
    pcfg = port_cfg(cfg)
    tr = Trainer(pcfg, device="cpu")
    state = train_state_from_jax(pcfg, jstate0)
    metrics = task_metrics_init()
    gen = torch.Generator().manual_seed(0)
    losses = []
    for b in batches:
        state, metrics, loss = tr.train_step(
            state, metrics, {k: torch.from_numpy(v) for k, v in b.items()},
            gen)
        losses.append(float(loss))
    return {"state": state, "losses": losses,
            "metrics": task_metrics_values(metrics)}


def check_state(pcfg, got: dict, want: dict, lazy=("Sku", "Cid3", "Brand",
                                                   "Shopid"),
                m_noise: float = 0.0) -> None:
    """Params within ``PARAM_TOL`` (median below 1e-6), m and v within 1e-4
    of each leaf's largest value (tests/test_torch_train.py's tolerances),
    counts equal.  ``m_noise`` > 0 also lets m differ by that share of the
    largest |m| of all leaves: the rounding noise of a gradient that is
    zero in exact arithmetic (a bias in front of batch norm)."""
    got = jax.tree_util.tree_map(
        lambda t: (t.float() if t.dtype == torch.bfloat16 else t).numpy(),
        got)
    assert int(got["step"]) == int(want["step"])
    diffs = []
    for (path, a), (_, b) in zip(leaves(got["params"]),
                                 leaves(want["params"])):
        assert a.shape == b.shape, path
        np.testing.assert_allclose(a, b, rtol=0, atol=PARAM_TOL,
                                   err_msg=path)
        diffs.append(np.abs(a - b).ravel())
    assert np.median(np.concatenate(diffs)) < 1e-6
    pairs = [(a, b, 1e-8) for a, b in zip(leaves(got["opt"]["m"]),
                                          leaves(want["opt"]["m"]))]
    pairs += [(a, b, 1e-12) for a, b in zip(leaves(got["opt"]["v"]),
                                            leaves(want["opt"]["v"]))]
    for t in lazy:
        a, b = got["lazy_opt"][t]["mv"], want["lazy_opt"][t]["mv"]
        pairs += [((f"{t}/m", a[0]), (t, b[0]), 1e-8),
                  ((f"{t}/v", a[1]), (t, b[1]), 1e-12)]
    top_m = max(np.abs(b).max() for (p, _), (_, b), f in pairs
                if f == 1e-8)
    for (path, a), (_, b), floor in pairs:
        if floor == 1e-8:
            floor = max(floor, m_noise * top_m)
        atol = max(1e-4 * np.abs(b).max(), floor)
        np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=path)


def check_metrics(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# The plan
# ---------------------------------------------------------------------------


def leaves_of(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves_of(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves_of(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _mesh(n: int) -> Mesh:
    return Mesh(n, 1, 0, torch.device("cpu"), "gloo")


@pytest.mark.parametrize("n", [2, 4])
def test_plan_matches_jax(n):
    cfg = mesh_config()
    pcfg = port_cfg(cfg)
    assert fms_table_rows(pcfg, n) == j_fms_table_rows(cfg, n) == \
        {"Sku": 1024}
    jt = JTrainer(cfg, mesh=jax_mesh(n))
    want = [(t.name, t.full_mesh) for t in jt.lazy_plan]
    got = [(t.name, t.full_mesh) for t in build_lazy_plan(pcfg, _mesh(n))]
    assert got == want
    by_name = dict(got)
    # packed Sku: 1,024 groups -> full mesh; packed Cid3: 128 -> replicated
    assert by_name["Sku"] and not by_name["Cid3"]
    # the leaves' placement: the Sku table alone splits
    params = Trainer(pcfg, device="cpu").init_state(
        torch.Generator().manual_seed(0))["params"]
    place = dict(leaves_of(param_placement(pcfg, params, _mesh(n))))
    assert place.pop("/emb/Sku") == "full_mesh"
    assert set(place.values()) == {"replicated"}
    # one device: no full-mesh table
    assert fms_table_rows(pcfg, 1) == {}
    assert not any(t.full_mesh for t in build_lazy_plan(pcfg, _mesh(1)))


def test_plan_gates_like_jax():
    """A group count that the ranks do not divide, the flag off, or
    another optimizer leave Sku on the replicated plan, as in JAX."""
    for kw, n in ((dict(sku_rows=4092), 8), (dict(full_mesh_tables=False), 2),
                  (dict(optimizer="adagrad"), 2),
                  (dict(shard_rows_threshold=2048), 2)):
        cfg = mesh_config(**kw)
        assert fms_table_rows(port_cfg(cfg), n) == \
            j_fms_table_rows(cfg, n), kw


def test_mesh_model_refused():
    """Nothing refuses the model axis now: ``mesh_model = 2`` builds on two
    ranks (with its groups) and a ``Trainer`` takes it; a mesh that does
    not cover the processes still raises."""
    cfg = port_cfg(mesh_config(mesh_model=2))
    out = run_ranks(workers.mesh_shape, 2, cfg, timeout_s=SPAWN_TIMEOUT,
                    threads=1)
    assert [o["shape"] for o in out] == [(1, 2, 0, 0), (1, 2, 0, 1)]
    assert all(o["model_sum"] == 3.0 and o["data_sum"] == 1.0 for o in out)
    Trainer(cfg, mesh=Mesh(1, 2, 0, torch.device("cpu"), "gloo"))
    with pytest.raises(ValueError, match="does not cover"):
        build_mesh(port_cfg(mesh_config(mesh_model=3)), world=2,
                   device="cpu", rank=0)


def test_mesh_must_cover_the_world():
    cfg = port_cfg(mesh_config(mesh_data=3))
    with pytest.raises(ValueError, match="does not cover"):
        build_mesh(cfg, world=2, device="cpu", rank=0)


# ---------------------------------------------------------------------------
# Two ranks against JAX's (2, 1) mesh and the port's one process
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def two_ranks():
    cfg = mesh_config()
    batches = [g.synthetic_batch(cfg, B, seed=s) for s in range(2)]
    jax_run = run_jax(cfg, 2, batches)
    ranks = run_port(cfg, 2, jax_run["states"][0], batches)
    one = run_one_process(cfg, jax_run["states"][0], batches)
    return dict(cfg=cfg, pcfg=port_cfg(cfg), batches=batches, jax=jax_run,
                ranks=ranks, one=one)


def test_ranks_hold_no_jax_and_share_sku(two_ranks):
    for r in two_ranks["ranks"]:
        assert not r["jax"]
        assert r["plan"] == two_ranks["jax"]["plan"]
        assert r["share_rows"]["Sku"] == 2048
        assert r["share_rows"]["Cid3"] == 2048      # replicated


def test_loss_matches_jax(two_ranks):
    for r in two_ranks["ranks"]:
        np.testing.assert_allclose(r["losses"], two_ranks["jax"]["losses"],
                                   rtol=1e-5)
    np.testing.assert_allclose(two_ranks["one"]["losses"],
                               two_ranks["jax"]["losses"], rtol=1e-5)


@pytest.mark.parametrize("step", [1, 2])
def test_state_matches_jax(two_ranks, step):
    """Dense params, the Sku share gathered and the replicated tables,
    every optimizer moment, after each step."""
    want = port_view(two_ranks["pcfg"], two_ranks["jax"]["states"][step])
    check_state(two_ranks["pcfg"],
                two_ranks["ranks"][0]["states"][step - 1], want)


def test_state_matches_one_process(two_ranks):
    """The same two steps at the global batch in one process."""
    one = jax.tree_util.tree_map(
        lambda t: (t.float() if t.dtype == torch.bfloat16 else t).numpy(),
        two_ranks["one"]["state"])
    check_state(two_ranks["pcfg"], two_ranks["ranks"][0]["states"][-1], one)


def test_overflow_and_metrics_match_jax(two_ranks):
    want_ovf = int(np.asarray(two_ranks["jax"]["states"][-1]["lazy_overflow"]))
    for r in two_ranks["ranks"]:
        assert r["overflow"] == want_ovf == 0
        check_metrics(r["metrics"], two_ranks["jax"]["metrics"])
    check_metrics(two_ranks["one"]["metrics"], two_ranks["jax"]["metrics"])


def test_gathered_state_counts(two_ranks):
    s = two_ranks["ranks"][0]["states"][-1]
    assert int(s["step"]) == 2 and int(s["lazy_overflow"]) == 0
    assert tuple(s["params"]["emb"]["Sku"].shape) == (4096, 32)
    assert tuple(s["lazy_opt"]["Sku"]["mv"].shape) == (2, 4096, 32)


def test_dropout_seeds_differ_by_rank():
    """Dropout on: a finite loss, and each rank's fused-block seeds are
    its own generator's draws (``loop.dropout_seed`` of its data index),
    so they differ."""
    cfg = g._demo_config(**{**SMALL, **KW})
    pcfg = port_cfg(cfg)
    batch = g.synthetic_batch(cfg, B, seed=5)
    tr = Trainer(pcfg, device="cpu")
    state = tr.init_state(torch.Generator().manual_seed(0))
    out = run_ranks(workers.dropout_masks, 2, pcfg, state, batch,
                    timeout_s=SPAWN_TIMEOUT, threads=1)
    assert all(np.isfinite(o["loss"]) for o in out)
    assert out[0]["loss"] == out[1]["loss"]
    s0, s1 = out[0]["seeds"], out[1]["seeds"]
    assert len(s0) == len(s1) == len(cfg.attention_pairs)
    assert all(a != b for a, b in zip(s0, s1))


@pytest.mark.parametrize("knob", [dict(grid_bf16=True)], ids=["grid_bf16"])
def test_knob_ranks_match_one_process(two_ranks, knob):
    """A config knob on the (2, 1) mesh against one process, one step from
    the same JAX init and batch (no JAX step of its own; a second step
    starts from states that differ by the rounding below, and the port's
    float32 ReLU ties then move single elements by a few percent).
    ``grid_bf16``: the
    full-mesh Sku's union grid, and the replicated tables', in bfloat16;
    each rank rounds its gradient rows to bfloat16 before the owners sum
    them, one process rounds their sum once, so the lazy moments are held
    to one bfloat16 step of the gradient (2**-6 of their largest |value|,
    as ``tests/test_torch_train_bf16.py``) and the rest to
    ``check_state``'s rules; the tables stay float32."""
    cfg = dataclasses.replace(two_ranks["cfg"], **knob)
    pcfg = port_cfg(cfg)
    batches = two_ranks["batches"][:1]
    ranks = run_port(cfg, 2, two_ranks["jax"]["states"][0], batches)
    one = run_one_process(cfg, two_ranks["jax"]["states"][0], batches)
    for r in ranks:
        assert not r["jax"]
        np.testing.assert_allclose(r["losses"], one["losses"], rtol=1e-5)
    got = ranks[0]["states"][0]
    assert got["params"]["emb"]["Sku"].dtype == torch.float32
    want = jax.tree_util.tree_map(lambda t: t.numpy(), one["state"])
    check_state(pcfg, got, want, lazy=())
    for t, sub in want["lazy_opt"].items():
        a = got["lazy_opt"][t]["mv"].numpy()
        for i in (0, 1):
            np.testing.assert_allclose(
                a[i], sub["mv"][i], rtol=0,
                atol=2.0 ** -6 * np.abs(sub["mv"][i]).max(),
                err_msg=f"{t}/{i}")
