"""Two ``Trainer`` steps of the port against the JAX ``Trainer`` for
``dien`` (the GRU scans under lazy Adam) and ``wnd`` with ``wnd_wd``
1e-3 (no lazy table, the dense weight decay): the tests of
``test_torch_baselines_train.py`` on these two cases."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_torch_baselines_train import (  # noqa: E402,F401
    cached_run, test_losses_match_jax,
    test_optimizer_and_model_state_match_jax, test_params_match_jax)


@pytest.fixture(params=["dien", "wnd_wd"])
def run(request):
    return cached_run(request.param)
