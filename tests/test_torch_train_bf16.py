"""The port's training step against the JAX ``Trainer`` with the default
table storage (bfloat16 for every table of at least 500 rows) and a small
lazy-Adam budget (``dedup_budget_div=64``), so that ids overflow it: their
gradient is skipped for the step and their forward reads the true table
rows.  Tables stay logical on the JAX side (``pack_rows_threshold`` above
every table), so both sides update the same lazy-Adam rows.  Setup as in
``test_torch_train.py``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from test_torch_train import (LR, leaves, no_dropout_config,  # noqa: E402
                              port_view, run_both)


@pytest.fixture(scope="module")
def bf16_run():
    return run_both(no_dropout_config(table_bf16_threshold=500,
                                      pack_rows_threshold=10**9,
                                      dedup_budget_div=64))


def test_overflow_counted_like_jax(bf16_run):
    """Distinct ids past the budget of U = 256 slots per table, summed over
    the lazy tables and the two steps."""
    want = int(bf16_run["jstates"][-1]["lazy_overflow"])
    assert want > 0
    assert int(bf16_run["pstates"][-1]["lazy_overflow"]) == want


def test_loss_matches_jax(bf16_run):
    """Both sides gather the same bfloat16 rows; the trunk is float32."""
    np.testing.assert_allclose(bf16_run["plosses"], bf16_run["jlosses"],
                               rtol=1e-5)


@pytest.mark.parametrize("step", [1, 2])
def test_params_match_jax(bf16_run, step):
    """The float32 bound of ``test_torch_train`` (2 lr) plus one bfloat16
    rounding of the table value (2**-7 of its size): a bfloat16 table adds
    the update rounded to its type, so an update that differs in its last
    bits can round the sum to the neighbouring bfloat16 value."""
    want = port_view(bf16_run["pcfg"], bf16_run["jstates"][step])["params"]
    got = jax.tree_util.tree_map(lambda t: t.float().numpy(),
                                 bf16_run["pstates"][step - 1]["params"])
    assert got["emb"]["Sku"].dtype == np.float32  # compared in float32
    assert bf16_run["pstates"][0]["params"]["emb"]["Sku"].dtype == \
        torch.bfloat16
    for (path, a), (_, b) in zip(leaves(got), leaves(want)):
        assert a.shape == b.shape, path
        atol = 2 * LR + 2.0 ** -7 * np.abs(b).max()
        np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=path)


def test_lazy_moments_match_jax(bf16_run):
    """Float32 moments of the bfloat16 tables.  Their gradient is rounded
    to bfloat16 once (as in the reference), so a sum that lands near a
    rounding tie can round to the neighbouring value: one bfloat16 step
    (2**-7 relative) in g moves m and v by at most 2**-6 of their largest
    |value|."""
    want = port_view(bf16_run["pcfg"], bf16_run["jstates"][2])["lazy_opt"]
    got = bf16_run["pstates"][1]["lazy_opt"]
    assert set(got) == {"Sku", "Cid3", "Brand", "Shopid"}
    for t in got:
        a, b = got[t]["mv"].numpy(), want[t]["mv"]
        assert a.dtype == np.float32 and a.shape == b.shape
        for i in (0, 1):
            atol = 2.0 ** -6 * np.abs(b[i]).max()
            np.testing.assert_allclose(a[i], b[i], rtol=0, atol=atol,
                                       err_msg=f"{t}/{i}")
