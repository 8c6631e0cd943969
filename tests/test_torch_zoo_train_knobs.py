"""Two ``Trainer`` steps of the port against the JAX ``Trainer`` for two
config values no other case sets: the tests of ``test_torch_zoo_train.py``
on

- ``lazy_overflow_exact = false`` (``embed_mlp_unbias``,
  ``dedup_budget_div`` 64): elements past the lazy budget read the zero
  row instead of their true row, and skip their gradient;
- ``propensity_em_type = "position"`` (``multi_task`` with
  ``propensity_em``): the per-example weights from a position propensity
  model, as the data pipeline makes them."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_torch_zoo_train import (  # noqa: E402,F401
    cached_run, test_losses_match_jax,
    test_optimizer_and_model_state_match_jax, test_params_match_jax)


@pytest.fixture(params=["lazy_overflow_inexact",
                        "multi_task_propensity_position"])
def run(request):
    return cached_run(request.param)


def test_overflow_counted_like_jax():
    """The budget overflows at both steps on both sides."""
    _, r = cached_run("lazy_overflow_inexact")
    want = int(np.asarray(r["jstates"][-1]["lazy_overflow"]))
    assert want > 0
    assert int(r["pstates"][-1]["lazy_overflow"]) == want
