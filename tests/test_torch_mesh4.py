"""Four ``gloo`` ranks of the port's data mesh against the JAX ``Trainer``
on a (4, 1) mesh: ``tests/test_torch_mesh.py``'s two steps of the
flagship at the same global batch of 64 (16 rows a rank), Sku split in
four shares of 1,024 rows."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import __graft_entry__ as g  # noqa: E402
from test_torch_mesh import (B, check_metrics, check_state,  # noqa: E402
                             mesh_config, port_cfg, run_jax, run_port)
from test_torch_train import port_view  # noqa: E402

N = 4


@pytest.fixture(scope="module")
def four_ranks():
    cfg = mesh_config()
    batches = [g.synthetic_batch(cfg, B, seed=s) for s in range(2)]
    jax_run = run_jax(cfg, N, batches)
    return dict(pcfg=port_cfg(cfg), jax=jax_run,
                ranks=run_port(cfg, N, jax_run["states"][0], batches))


def test_ranks_share_sku(four_ranks):
    for r in four_ranks["ranks"]:
        assert not r["jax"]
        assert r["plan"] == four_ranks["jax"]["plan"]
        assert r["share_rows"]["Sku"] == 1024


def test_loss_matches_jax(four_ranks):
    for r in four_ranks["ranks"]:
        np.testing.assert_allclose(r["losses"], four_ranks["jax"]["losses"],
                                   rtol=1e-5)


@pytest.mark.parametrize("step", [1, 2])
def test_state_matches_jax(four_ranks, step):
    want = port_view(four_ranks["pcfg"], four_ranks["jax"]["states"][step])
    check_state(four_ranks["pcfg"],
                four_ranks["ranks"][0]["states"][step - 1], want)


def test_overflow_and_metrics_match_jax(four_ranks):
    for r in four_ranks["ranks"]:
        assert r["overflow"] == 0
        check_metrics(r["metrics"], four_ranks["jax"]["metrics"])
