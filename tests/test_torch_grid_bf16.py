"""``grid_bf16`` against the JAX package: float32 lazy tables whose union
grid (the diff leaf of the lazy step, ``[N, D]``) is rounded to bfloat16,
so the grid and its cotangent are bfloat16 while Adam reads the float32
rows and writes float32 rows and moments (JAX ``train/loop.py``
``_lazy_step``).  Two ``Trainer`` steps of the flagship with bfloat16
compute and ``table_bf16_threshold=0``, at a budget that holds every id
(``dedup_budget_div`` 1) under the bfloat16 rule of
``test_torch_bf16_train.py``; ``test_torch_grid_bf16_overflow.py`` runs
the budget that overflows."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_torch_bf16_train import CHECKS, bf16_config, bf16_run  # noqa: E402

GRID = dict(grid_bf16=True, table_bf16_threshold=0)


def grid_run(**kw):
    return bf16_run(bf16_config(**{**GRID, **kw}))


def check_tables_stay_float32(run):
    """The lazy tables and their moments stay float32 on both sides; the
    overflow count is JAX's."""
    for k, st in enumerate(run["steps"]):
        state = st["port"][0]
        for t, sub in state["lazy_opt"].items():
            assert state["params"]["emb"][t].dtype == torch.float32, t
            assert sub["mv"].dtype == torch.float32, t
            assert run["jstates"][k + 1]["params"]["emb"][t].dtype.name == \
                "float32", t
        assert int(state["lazy_overflow"]) == int(
            run["jstates"][k + 1]["lazy_overflow"])
    assert run["lazy"] == 4


@pytest.fixture(scope="module")
def run():
    return grid_run(dedup_budget_div=1)


@pytest.mark.parametrize("check", sorted(CHECKS))
@pytest.mark.parametrize("step", [1, 2])
def test_grid_bf16_step_matches_jax(run, step, check):
    CHECKS[check](run, step)


def test_tables_stay_float32(run):
    check_tables_stay_float32(run)
    assert int(run["jstates"][2]["lazy_overflow"]) == 0
