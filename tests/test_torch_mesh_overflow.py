"""Overflow on the port's data mesh against the JAX ``Trainer`` on a
(2, 1) mesh, one step each (``tests/test_torch_mesh.py``'s setup):

- the budget: ``dedup_budget_div`` 64 leaves each rank's Sku union 256
  group slots for its ~2,300 elements, so groups past them read zeros and
  skip their gradient (a full-mesh table has no exact fallback), counted
  in ``lazy_overflow``;
- the bucket capacity: ``DMT_FMS_CAP_MULT=0.01`` on the JAX test's skewed
  batch (``tests/test_lazy_adam.py`` ``test_capacity_overflow_counted_and_
  forward_exact``: 65,536 Sku rows, 70% of the ids in rank 0's rows), so
  the requests past a bucket's 144 slots take the exact fetch and skip
  their gradient."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import __graft_entry__ as g  # noqa: E402
from test_torch_mesh import (B, check_state, mesh_config,  # noqa: E402
                             port_cfg, run_jax, run_port)
from test_torch_train import port_view  # noqa: E402


def compare(cfg, batches, env=None):
    old = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    try:
        jax_run = run_jax(cfg, 2, batches)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    ranks = run_port(cfg, 2, jax_run["states"][0], batches, env)
    return jax_run, ranks


def test_budget_overflow_matches_jax():
    cfg = mesh_config(dedup_budget_div=64)
    batches = [g.synthetic_batch(cfg, B, seed=3)]
    jax_run, ranks = compare(cfg, batches)
    want_ovf = int(np.asarray(jax_run["states"][1]["lazy_overflow"]))
    assert want_ovf > 0
    for r in ranks:
        assert r["overflow"] == want_ovf
        np.testing.assert_allclose(r["losses"], jax_run["losses"],
                                   rtol=1e-5)
    check_state(port_cfg(cfg), ranks[0]["states"][0],
                port_view(port_cfg(cfg), jax_run["states"][1]))


def skewed_batch(cfg):
    """The JAX capacity test's batch: ~70% of the Sku ids in [0, 8192)."""
    batch = g.synthetic_batch(cfg, B)
    rng = np.random.default_rng(7)
    for k in list(batch):
        if "sku" in k and k.endswith("__ids"):
            n = batch[k].size
            n0 = int(0.7 * n)
            ids = np.concatenate([
                rng.permutation(8192)[:n0],
                8192 + rng.permutation(65536 - 8192)[:n - n0]])
            ids = rng.permutation(ids)
            batch[k] = (ids.reshape(batch[k].shape)
                        * (batch[k] != 0)).astype(np.int32)
    return batch


def test_capacity_drop_matches_jax():
    cfg = mesh_config(sku_rows=65536)
    batches = [skewed_batch(cfg)]
    jax_run, ranks = compare(cfg, batches, {"DMT_FMS_CAP_MULT": "0.01"})
    want_ovf = int(np.asarray(jax_run["states"][1]["lazy_overflow"]))
    assert want_ovf > 0
    for r in ranks:
        assert r["overflow"] == want_ovf
        # the forward stays exact: the exact fetch serves the step
        np.testing.assert_allclose(r["losses"], jax_run["losses"],
                                   rtol=1e-5)
    check_state(port_cfg(cfg), ranks[0]["states"][0],
                port_view(port_cfg(cfg), jax_run["states"][1]))
