"""Two ``Trainer`` steps of the port against the JAX ``Trainer`` for the
paper baselines, on the CPU, as ``tests/test_torch_zoo_train.py`` holds
the lattice (the JAX init carried across by
``convert.train_state_from_jax``, the same numpy batches, dropout off):
loss, params, the optimizer state and the model state after each step.
This file runs two cases; ``test_torch_baselines_train_seq.py`` the
other two with these tests.

- ``din`` with batch norm: the attention units' moving statistics, the
  sum combiner over the lazy tables' union grids (Sku, Cid3, Brand and
  Shopid under lazy Adam);
- ``dcn``: the cross layers' list of params under lazy Adam;
- ``dien``: the GRU scans under lazy Adam;
- ``wnd`` with ``wnd_wd`` 1e-3: no lazy table, the dense weight decay."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402

from test_torch_zoo_train import (  # noqa: E402,F401
    config, run_pair, test_optimizer_and_model_state_match_jax,
    test_params_match_jax)

CASES = {
    "din_bn": dict(model_type="din", is_bn=True),
    "dcn": dict(model_type="dcn"),
    "dien": dict(model_type="dien"),
    "wnd_wd": dict(model_type="wnd", wnd_wd=1e-3),
}
RUNS: dict = {}


def cached_run(name):
    if name not in RUNS:
        RUNS[name] = run_pair(config(**CASES[name]))
    return name, RUNS[name]


@pytest.fixture(params=["dcn", "din_bn"])
def run(request):
    return cached_run(request.param)


def test_losses_match_jax(run):
    """Loss within 1e-5 at both steps; the four tables of 1,000 rows or
    more under lazy Adam, none with the dense weight decay on."""
    name, r = run
    np.testing.assert_allclose(r["plosses"], r["jlosses"], rtol=1e-5,
                               err_msg=name)
    assert r["lazy"] == (0 if name == "wnd_wd" else 4), name
