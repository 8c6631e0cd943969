"""Two ``Trainer`` steps of the port against the JAX ``Trainer`` for the
lattice's ``transformer`` (one sequence group, the combiner's
``skip_seq``) and ``mmoe`` with batch norm (the per-expert path): the
tests of ``test_torch_zoo_train.py`` on these two cases."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_torch_zoo_train import (  # noqa: E402,F401
    cached_run, test_losses_match_jax,
    test_optimizer_and_model_state_match_jax, test_params_match_jax)


@pytest.fixture(params=["mmoe_bn", "transformer"])
def run(request):
    return cached_run(request.param)
