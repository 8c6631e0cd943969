"""Shared set-up of the benchmark's CPU tests: the repository root on the
import path, and a cell's context at a small size."""

from __future__ import annotations

import copy
import os
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# tables cut so that a CPU step takes a second; Sku keeps lazy Adam in
# groups of 4 rows (thresholds below its rows)
SMALL_TABLES = {"Sku": 40000, "Brand": 4000, "Shopid": 4000, "Cid3": 2000}
SMALL_SETTINGS = {"dedup_rows_threshold": 10000,
                  "pack_rows_threshold": 10000, "batch_size": 64}


def small_context(cell_name: str, seed: int = 2 ** 33 + 17,
                  seconds: float = 0.5, device: str = "cpu"):
    """The cell's context at a small size: batch 64 (training) or 4
    clients of 30-candidate requests (serving), on ``device``."""
    import torch

    from perfbench import harness, modelconf

    cell = copy.deepcopy(harness.load_cell(cell_name))
    if cell["entry"] == "train":
        cell["traffic"]["batch"] = 64
    else:
        cell["traffic"].update(clients=4, pool=16, candidates=30)
        cell["check_requests"] = 8
    conf = modelconf.with_tables(
        modelconf.load(cell["config"], **SMALL_SETTINGS), SMALL_TABLES)
    return harness.Context(cell=cell, conf=conf,
                           cfg=harness.program_config(conf),
                           device=torch.device(device), seed=seed,
                           seconds=seconds, trace=False,
                           t_start=time.perf_counter())


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
