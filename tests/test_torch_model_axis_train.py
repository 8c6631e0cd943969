"""The port's model axis (``Trainer(cfg, mesh=)`` with ``mesh_model`` 2)
against the JAX ``Trainer`` on a ``(1, 2)`` mesh of the virtual CPU
devices: the flagship model with shrunken tables and widths, the same
numpy global batches (data index d takes rows [d B / n, (d + 1) B / n),
model peers the same rows), the JAX init carried across by
``convert.train_state_from_jax``, dropout off, two steps.

The tables (packed where they reach 1,000 rows, split where their
physical rows reach 200) cover every placement:

- Sku (8,192 x 32, 2,048 groups of 4) and Brand (4,112 x 16, 514 groups
  of 8): lazy and full-mesh, the model peers slicing their requests;
- Shopid (2,048 x 16), Cid2 (500 x 8) and the bias net's Cid3 and Cid2:
  dense and model-split (the seq exchange for Shopid);
- Cid3 (2,064 x 8, 129 groups, odd): dense and replicated.

``tests/test_torch_model_axis_train4.py`` runs the ``(2, 2)`` mesh, where
Brand (514 groups, not a multiple of 4) is a sharded lazy table, and
``tests/test_torch_model_axis_train_sharded.py`` turns the full mesh off.
The port's ranks are ``gloo`` processes that import no JAX
(``tests/torch_mesh_workers.py``)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
from jax.sharding import Mesh as JMesh  # noqa: E402

import __graft_entry__ as g  # noqa: E402
import torch_mesh_workers as workers  # noqa: E402
from cikm2020_dmt_tpu.core.mesh import param_shardings  # noqa: E402
from cikm2020_dmt_torch.convert import train_state_from_jax  # noqa: E402
from cikm2020_dmt_torch.core.mesh import Mesh, param_placement  # noqa: E402
from cikm2020_dmt_torch.core.mesh import run_ranks  # noqa: E402
from cikm2020_dmt_torch.train.lazy import build_lazy_plan  # noqa: E402
from cikm2020_dmt_torch.train.loop import Trainer  # noqa: E402
from test_torch_mesh import (check_metrics, check_state,  # noqa: E402
                             to_numpy)
from test_torch_serve import SMALL, port_cfg  # noqa: E402
from test_torch_train import jax_metrics, port_view  # noqa: E402
from cikm2020_dmt_tpu.metrics.streaming import \
    task_metrics_values as j_metrics_values  # noqa: E402
from cikm2020_dmt_tpu.train.loop import Trainer as JTrainer  # noqa: E402

B = 64
KW = dict(sku_rows=8192, brand_rows=4112, cid3_rows=2064, batch_size=B,
          validate_step=10**9, dedup_rows_threshold=4096,
          pack_rows_threshold=1000, table_bf16_threshold=0,
          dropout_rate_bias=(0.0, 0.0), shard_rows_threshold=200,
          dedup_budget_div=1)
SPAWN_TIMEOUT = 240.0


def axis_config(model: int, **kw):
    cfg = g._demo_config(**{**SMALL, **KW, **kw, "mesh_model": model})
    return dataclasses.replace(cfg, transformer=dataclasses.replace(
        cfg.transformer, dropout_rate=0.0))


def jax_mesh(data: int, model: int) -> JMesh:
    return JMesh(np.array(jax.devices()[:data * model]).reshape(data, model),
                 ("data", "model"))


def run_jax(cfg, data: int, model: int, batches: list) -> dict:
    """The JAX ``Trainer`` on a (data, model) mesh: states after 0..k
    steps, losses, metric values, the plan and the params' row split."""
    jt = JTrainer(cfg, mesh=jax_mesh(data, model))
    ts = jt.shard_state(jt.init_state())
    split = {}
    for path, sh in jax.tree_util.tree_leaves_with_path(
            param_shardings(cfg, ts["params"], jt.mesh)):
        keys = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in path)
        if sh.spec and sh.spec[0] is not None:
            split[keys] = sh.spec[0]
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
            "metrics": j_metrics_values(jm), "split": split,
            "plan": [(t.name, t.full_mesh, t.sharded) for t in jt.lazy_plan]}


def run_port(cfg, data: int, model: int, jstate0, batches: list) -> list:
    pcfg = port_cfg(cfg)
    return run_ranks(workers.train_steps, data * model, pcfg,
                     train_state_from_jax(pcfg, jstate0), batches, {},
                     timeout_s=SPAWN_TIMEOUT, threads=1)


def compare(cfg, data: int, model: int, steps: int = 2) -> dict:
    batches = [g.synthetic_batch(cfg, B, seed=s) for s in range(steps)]
    jax_run = run_jax(cfg, data, model, batches)
    return dict(pcfg=port_cfg(cfg), jax=jax_run,
                ranks=run_port(cfg, data, model, jax_run["states"][0],
                               batches))


def placement_split(pcfg, data: int, model: int) -> dict:
    """The port's placement of each split leaf (path -> label)."""
    params = Trainer(pcfg, device="cpu").init_state(
        torch.Generator().manual_seed(0))["params"]
    mesh = Mesh(data, model, 0, torch.device("cpu"), "gloo")
    place = dict(workers.leaves(param_placement(pcfg, params, mesh)))
    return {k.lstrip("/"): v for k, v in place.items() if v != "replicated"}


def check_run(run: dict, lazy: tuple) -> None:
    """Losses within 1e-5 relative, the gathered state after each step by
    ``check_state``, metrics, ``lazy_overflow`` against JAX's, and the
    replicated leaves the same bits on every rank after each step."""
    pcfg, jr, ranks = run["pcfg"], run["jax"], run["ranks"]
    want_ovf = int(np.asarray(jr["states"][-1]["lazy_overflow"]))
    for r in ranks:
        assert not r["jax"]
        np.testing.assert_allclose(r["losses"], jr["losses"], rtol=1e-5)
        assert r["overflow"] == want_ovf
        check_metrics(r["metrics"], jr["metrics"])
    for step in range(len(jr["losses"])):
        check_state(pcfg, ranks[0]["states"][step],
                    port_view(pcfg, jr["states"][step + 1]), lazy=lazy)
        mine = ranks[0]["replicated"][step]
        for r in ranks[1:]:
            other = r["replicated"][step]
            assert set(other) == set(mine)
            unequal = [k for k in mine if not torch.equal(mine[k], other[k])]
            assert not unequal, f"step {step + 1}: {unequal}"


# ---------------------------------------------------------------------------
# (1, 2)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def one_by_two():
    return compare(axis_config(2), 1, 2)


def test_plan_and_placement_match_jax(one_by_two):
    """The lazy plan (full-mesh, sharded) and the split leaves are JAX's:
    ``P((data, model))`` full-mesh, ``P(model)`` model-split."""
    pcfg, jr = one_by_two["pcfg"], one_by_two["jax"]
    plan = [(t.name, t.full_mesh, t.sharded) for t in build_lazy_plan(
        pcfg, Mesh(1, 2, 0, torch.device("cpu"), "gloo"))]
    assert plan == jr["plan"] == [("Sku", True, False),
                                  ("Brand", True, False)]
    want = {k: ("full_mesh" if v == ("data", "model") else "model_split")
            for k, v in jr["split"].items()}
    assert placement_split(pcfg, 1, 2) == want
    assert want == {"emb/Sku": "full_mesh", "emb/Brand": "full_mesh",
                    "emb/Shopid": "model_split", "emb/Cid2": "model_split",
                    "bias_net/emb/Cid2": "model_split",
                    "bias_net/emb/Cid3": "model_split"}


def test_ranks_hold_their_shares(one_by_two):
    for r in one_by_two["ranks"]:
        assert r["share_rows"]["Sku"] == 4096       # 8,192 / 2
        assert r["share_rows"]["Shopid"] == 1024    # 2,048 / 2
        assert r["share_rows"]["Cid3"] == 2064      # replicated


def test_two_steps_match_jax(one_by_two):
    check_run(one_by_two, lazy=("Sku", "Brand"))

