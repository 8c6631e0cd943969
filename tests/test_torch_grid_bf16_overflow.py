"""``grid_bf16`` with a budget that overflows (``dedup_budget_div`` 64, as
``tests/test_torch_train_bf16.py``): ids past the budget skip their
gradient for the step and their forward reads the true float32 rows,
rounded to the grid's bfloat16 (JAX ``train/lazy.py`` ``make_overlay``'s
``fb.astype(g.dtype)``).  The checks of ``test_torch_grid_bf16.py``."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_torch_bf16_train import CHECKS  # noqa: E402
from test_torch_grid_bf16 import (check_tables_stay_float32,  # noqa: E402
                                  grid_run)


@pytest.fixture(scope="module")
def run():
    return grid_run(dedup_budget_div=64)


@pytest.mark.parametrize("check", sorted(CHECKS))
@pytest.mark.parametrize("step", [1, 2])
def test_grid_bf16_overflow_step_matches_jax(run, step, check):
    CHECKS[check](run, step)


def test_overflow_counted_and_tables_stay_float32(run):
    check_tables_stay_float32(run)
    assert int(run["jstates"][2]["lazy_overflow"]) > 0
