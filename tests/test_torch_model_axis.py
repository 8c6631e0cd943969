"""The port's model-split lookups (``parallel/embedding_shard.py``
``ShardedEmbeddingEngine``) against the JAX ``ShardedEmbeddingEngine`` on
the same mesh shape, ``(1, 2)`` and ``(2, 2)`` (and ``(1, 4)`` for a
bucket's skew): ``pooled`` (mean and sum) and ``seq`` (the deduplicated
exchange, its fallback past the budget, ``shard_seq_exchange = false``
and a packed table), forward and the table's gradient of sum((y -
target)^2), within 1e-5.  The settings are ``tests/test_sharding.py``'s
at four devices or fewer.  The port's ranks are ``gloo`` processes that
import no JAX (``tests/torch_mesh_workers.py``); each takes its share of
the table and its data index's rows."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh as JMesh  # noqa: E402

import torch_mesh_workers as workers  # noqa: E402
from cikm2020_dmt_tpu.nn.embedding import pack_table  # noqa: E402
from cikm2020_dmt_tpu.parallel.embedding_shard import \
    ShardedEmbeddingEngine as JEngine  # noqa: E402
from cikm2020_dmt_torch.core.mesh import Mesh, run_ranks  # noqa: E402
from cikm2020_dmt_torch.parallel.embedding_shard import (  # noqa: E402
    FullMeshEngine, ShardedEmbeddingEngine, make_engine, model_split_tables,
    should_shard_table)
from conftest import make_demo_config  # noqa: E402
from test_torch_serve import port_cfg  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
SPAWN_TIMEOUT = 240.0


def lookup_cases(rng, data: int) -> list:
    """(name, case) pairs: a 256 x 8 table for ``pooled``, 2,048 x 8 ones
    for ``seq`` (B = 16, L = 64), a packed 100,000 x 32 one."""
    out = []
    table = rng.normal(size=(256, 8)).astype(np.float32)
    B, L = 8, 6
    ids = rng.integers(0, 256, (B, L)).astype(np.int32)
    lens = rng.integers(0, L + 1, B).astype(np.int32)
    wts = ((rng.random((B, L)) + 0.25)
           * (np.arange(L)[None] < lens[:, None])).astype(np.float32)
    for combiner in ("mean", "sum"):
        out.append((f"pooled_{combiner}", dict(
            kind="pooled", combiner=combiner, table=table, ids=ids, wts=wts,
            lens=lens, target=rng.normal(size=(B, 8)).astype(np.float32),
            R=256, p=1, exchange=True)))
    big = rng.normal(size=(2048, 8)).astype(np.float32)
    B, L = 16, 64
    seqs = {
        # ~60 distinct ids: the exchange's budget holds them
        "seq_exchange": (rng.integers(0, 60, (B, L)) * 31 % 2048, True),
        # every id distinct: past the budget U = 256, the grid sum
        "seq_overflow": (rng.permutation(2048)[:B * L].reshape(B, L), True),
        "seq_grid_sum": (rng.integers(0, 60, (B, L)) * 31 % 2048, False),
    }
    for name, (sid, exchange) in seqs.items():
        out.append((name, dict(
            kind="seq", table=big, ids=sid.astype(np.int32),
            target=rng.normal(size=(B, L, 8)).astype(np.float32),
            R=2048, p=1, exchange=exchange)))
    logical = rng.normal(size=(100_000, 32)).astype(np.float32)
    pid = (rng.zipf(1.3, (8, 50)) % 100_000).astype(np.int32)
    out.append(("seq_packed", dict(
        kind="seq", table=logical, ids=pid,
        target=rng.normal(size=(8, 50, 32)).astype(np.float32),
        R=100_000, p=4, exchange=True)))
    return out


def jax_lookup(cfg, mesh, case):
    """The JAX engine's output and the logical table's gradient."""
    eng = JEngine(cfg, mesh)
    ids, target = jnp.asarray(case["ids"]), jnp.asarray(case["target"])
    packed = case["p"] > 1
    name = "Sku" if packed else "T"

    def run(t):
        if case["kind"] == "pooled":
            return eng.pooled(name, t, ids, jnp.asarray(case["wts"]),
                              jnp.asarray(case["lens"]),
                              combiner=case["combiner"])
        return eng.seq(name, t, ids, False)

    table = pack_table(jnp.asarray(case["table"])) if packed \
        else jnp.asarray(case["table"])
    def loss(t):
        y = run(t)
        return jnp.sum((y - target) ** 2), y

    with jax.sharding.set_mesh(mesh):
        (_, y), grad = jax.jit(jax.value_and_grad(loss, has_aux=True))(table)
    grad = np.asarray(grad)
    if packed:
        grad = grad.reshape(-1, 32)[:case["R"]]
    return np.asarray(y), grad


def compare(data: int, model: int, names=None) -> dict:
    rng = np.random.default_rng(data * 10 + model)
    cases = [(n, c) for n, c in lookup_cases(rng, data)
             if names is None or n in names]
    results = {}
    for exchange in (True, False):
        jcfg = make_demo_config(mesh_data=data, mesh_model=model,
                                shard_rows_threshold=64,
                                pack_rows_threshold=50_000,
                                shard_seq_exchange=exchange)
        jmesh = JMesh(np.array(jax.devices()[:data * model]).reshape(
            data, model), ("data", "model"))
        for n, c in cases:
            if c["exchange"] == exchange:
                results[n] = jax_lookup(jcfg, jmesh, c)
    pcfg = port_cfg(make_demo_config(mesh_model=model,
                                     shard_rows_threshold=64))
    got = run_ranks(workers.engine_lookups, data * model, pcfg,
                    [c for _, c in cases], timeout_s=SPAWN_TIMEOUT,
                    threads=1)
    return {n: (results[n], [r[i] for r in got])
            for i, (n, _) in enumerate(cases)}


def check(runs: dict, exchanged: dict) -> None:
    for name, ((y, grad), ranks) in runs.items():
        for r in ranks:
            np.testing.assert_allclose(r["y"].numpy(), y, err_msg=name, **TOL)
            np.testing.assert_allclose(r["grad"].numpy(), grad,
                                       err_msg=name, **TOL)
            assert r["exchange"] == exchanged.get(name, []), name


EXCHANGED = {"seq_exchange": [True], "seq_overflow": [False],
             "seq_packed": [True]}


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_lookups_match_jax(shape):
    check(compare(*shape), EXCHANGED)


def test_bucket_skew_takes_the_grid_sum():
    """(1, 4): 200 distinct ids in the first model shard's 512 rows fit
    the budget (U = 256) but not the shard's bucket (C = 128)."""
    rng = np.random.default_rng(3)
    table = rng.normal(size=(2048, 8)).astype(np.float32)
    pick = rng.permutation(512)[:200]
    ids = pick[rng.integers(0, 200, (16, 64))].astype(np.int32)
    case = dict(kind="seq", table=table, ids=ids, exchange=True,
                target=rng.normal(size=(16, 64, 8)).astype(np.float32),
                R=2048, p=1)
    jcfg = make_demo_config(mesh_data=1, mesh_model=4,
                            shard_rows_threshold=64)
    jmesh = JMesh(np.array(jax.devices()[:4]).reshape(1, 4),
                  ("data", "model"))
    want = jax_lookup(jcfg, jmesh, case)
    got = run_ranks(workers.engine_lookups, 4, port_cfg(make_demo_config(
        mesh_model=4, shard_rows_threshold=64)), [case],
        timeout_s=SPAWN_TIMEOUT, threads=1)
    check({"skew": (want, [r[0] for r in got])}, {"skew": [False]})


def test_policy_and_dispatch():
    """``should_shard_table`` is JAX's; ``model_split_tables`` names the
    demo config's split tables; ``make_engine`` picks the engine by the
    model axis."""
    cfg = port_cfg(make_demo_config(mesh_model=2, shard_rows_threshold=64))
    assert should_shard_table(cfg, 2, 256)
    assert not should_shard_table(cfg, 2, 32)
    assert not should_shard_table(cfg, 2, 129)
    assert not should_shard_table(cfg, 1, 256)
    split = model_split_tables(cfg, 8, 2)
    assert split["Brand"] == (190_000, 1) and split["Cid2"] == (500, 1)
    assert split["Sku"] == (100_000, 1) and split["bias:Cid3"] == (12_000, 1)
    assert model_split_tables(cfg, 8, 1) == {}
    # a lazy Sku splits over all eight ranks (full mesh) instead
    lazy = port_cfg(make_demo_config(mesh_model=2, shard_rows_threshold=64,
                                     dedup_rows_threshold=50_000))
    assert "Sku" not in model_split_tables(lazy, 8, 2)
    assert "Sku" in model_split_tables(lazy, 6, 2)   # 100,000 % 6 != 0
    cpu = torch.device("cpu")
    assert isinstance(make_engine(cfg, Mesh(4, 2, 0, cpu, "gloo")),
                      ShardedEmbeddingEngine)
    assert type(make_engine(cfg, Mesh(8, 1, 0, cpu, "gloo"))) is \
        FullMeshEngine
