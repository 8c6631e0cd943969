"""``onehot_bwd_bf16`` against the JAX package: under bfloat16 compute a
lookup of a small float32 table that the reference routes to its one-hot
backward (``take_onehot(..., bf16_grad=True)``: ``dedup_grads``, fewer
logical rows than ``dedup_rows_threshold``, at most
``onehot_bwd_rows_max`` physical rows) rounds its float32 cotangent to
bfloat16 before the float32 sum.

- Two ``Trainer`` steps of the flagship with float32 tables
  (``table_bf16_threshold=0``; Cid2, TimeClick and the bias tables are
  the small ones), under the bfloat16 rule of
  ``test_torch_bf16_train.py``.
- The lookups alone, where a step's bfloat16 noise does not hide the
  rounding: ``EmbeddingEngine(cfg)`` of both packages on the same table,
  ids and float32 cotangent, the table's gradient within float32 sum
  order (1e-6 relative) of the JAX one.  Mutation: with the rounding
  taken out of the port (``bf16_cotangent`` returning False, or
  ``_Bf16Cotangent`` the identity in its backward) the gradient is the
  unrounded sum, 1e-3 relative away, and ``test_lookup_gradient_matches_
  jax[onehot]`` fails; a Sku-sized table, a model-split lookup and float32
  compute keep the unrounded sum on both sides."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cikm2020_dmt_tpu.parallel.embedding_shard import \
    EmbeddingEngine as JEngine  # noqa: E402
from cikm2020_dmt_torch.parallel.embedding_shard import (  # noqa: E402
    EmbeddingEngine, bf16_cotangent)
from test_torch_bf16_train import CHECKS, bf16_config, bf16_run  # noqa: E402
from test_torch_serve import port_cfg  # noqa: E402

ROUTE_TOL = 1e-6


@pytest.fixture(scope="module")
def run():
    return bf16_run(bf16_config(onehot_bwd_bf16=True))


@pytest.mark.parametrize("check", sorted(CHECKS))
@pytest.mark.parametrize("step", [1, 2])
def test_onehot_bf16_step_matches_jax(run, step, check):
    CHECKS[check](run, step)


def test_small_tables_round_their_cotangent(run):
    """The config routes the small float32 tables, and only those."""
    pcfg = run["pcfg"]
    emb = run["steps"][0]["port"][0]["params"]["emb"]
    rounded = {k for k, v in emb.items() if bf16_cotangent(pcfg, v)}
    assert rounded == {k for k, v in emb.items() if v.shape[0] <= 4096
                       and v.shape[0] < pcfg.dedup_rows_threshold}
    assert "Cid2" in rounded and "Sku" not in rounded


# (cfg overrides, rows) of the lookup: the one-hot route, a table past
# onehot_bwd_rows_max, the knob off, float32 compute
CASES = {
    "onehot": (dict(onehot_bwd_bf16=True), 500, True),
    "past_rows_max": (dict(onehot_bwd_bf16=True, onehot_bwd_rows_max=256),
                      500, False),
    "knob_off": (dict(), 500, False),
    "float32": (dict(onehot_bwd_bf16=True, compute_dtype="float32"), 500,
                False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_lookup_gradient_matches_jax(case):
    kw, rows, rounds = CASES[case]
    cfg = bf16_config(**kw)
    rng = np.random.default_rng(3)
    table = rng.normal(size=(rows, 8)).astype(np.float32)
    ids = rng.integers(0, rows, (64, 50)).astype(np.int32)
    g = rng.normal(size=(64, 50, 8)).astype(np.float32)
    _, vjp = jax.vjp(lambda t: JEngine(cfg)._take("Cid2", t, jnp.asarray(ids)),
                     jnp.asarray(table))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    t = torch.from_numpy(table).requires_grad_()
    EmbeddingEngine(port_cfg(cfg))._take(
        "Cid2", t, torch.from_numpy(ids), "item_c2").backward(
            torch.from_numpy(g))
    got = t.grad.numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=ROUTE_TOL * scale)
    # the rounding moves the sum by far more than the tolerance
    plain = np.zeros_like(table)
    np.add.at(plain, ids.reshape(-1), g.reshape(-1, 8))
    moved = np.abs(plain - want).max() / scale
    assert (moved > 100 * ROUTE_TOL) == rounds, moved
