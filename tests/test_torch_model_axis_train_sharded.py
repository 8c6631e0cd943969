"""The model axis without full-mesh tables (``full_mesh_tables = false``)
on a ``(1, 2)`` mesh against the JAX ``Trainer``: Sku and Brand are
sharded lazy tables (their union's rows fetched once over the model
group, ``lazy_adam_rows_sharded`` writing back each rank's own rows).
``dedup_budget_div`` 64 leaves the global union 256 slots, so both tables
overflow: the exact fallback reads the missed rows over the model group
(``shard_take_rows``) and ``lazy_overflow`` counts them as JAX does."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_torch_model_axis_train import (axis_config, check_run,  # noqa: E402
                                         compare)


@pytest.fixture(scope="module")
def sharded():
    return compare(axis_config(2, full_mesh_tables=False,
                               dedup_budget_div=64), 1, 2)


def test_plan_matches_jax(sharded):
    assert sharded["jax"]["plan"] == [("Sku", False, True),
                                      ("Brand", False, True)]
    for r in sharded["ranks"]:
        assert r["sharded"] == ["Sku", "Brand"]
        assert r["share_rows"]["Sku"] == 4096


def test_two_steps_match_jax(sharded):
    assert int(np.asarray(
        sharded["jax"]["states"][-1]["lazy_overflow"])) > 0
    check_run(sharded, lazy=("Sku", "Brand"))
