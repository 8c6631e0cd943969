"""Capacity drops of the full-mesh exchange with the model peers slicing
their requests, on a ``(1, 2)`` mesh against the JAX ``Trainer``: one
step of ``tests/test_torch_model_axis_train.py``'s flagship at 65,536 Sku
rows on the JAX capacity test's skewed batch
(``tests/test_torch_mesh_overflow.py``), with ``DMT_FMS_CAP_MULT=0.01``.
Each peer's slice overflows its buckets: the step takes the exact fetch
(the forward stays exact), the dropped groups skip their gradient, and
``lazy_overflow`` counts what JAX counts."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_torch_mesh_overflow import skewed_batch  # noqa: E402
from test_torch_model_axis_train import (axis_config, check_run,  # noqa: E402
                                         run_jax, run_ranks, workers)
from test_torch_serve import port_cfg  # noqa: E402
from cikm2020_dmt_torch.convert import train_state_from_jax  # noqa: E402

ENV = {"DMT_FMS_CAP_MULT": "0.01"}


def test_capacity_drop_matches_jax():
    cfg = axis_config(2, sku_rows=65536)
    batches = [skewed_batch(cfg)]
    old = os.environ.get("DMT_FMS_CAP_MULT")
    os.environ.update(ENV)
    try:
        jax_run = run_jax(cfg, 1, 2, batches)
    finally:
        if old is None:
            os.environ.pop("DMT_FMS_CAP_MULT")
        else:
            os.environ["DMT_FMS_CAP_MULT"] = old
    pcfg = port_cfg(cfg)
    ranks = run_ranks(workers.train_steps, 2, pcfg,
                      train_state_from_jax(pcfg, jax_run["states"][0]),
                      batches, ENV, timeout_s=240.0, threads=1)
    assert int(np.asarray(jax_run["states"][1]["lazy_overflow"])) > 0
    check_run(dict(pcfg=pcfg, jax=jax_run, ranks=ranks),
              lazy=("Sku", "Brand"))
