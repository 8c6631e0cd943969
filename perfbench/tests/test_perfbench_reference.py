"""The plain reference against the port, through the benchmark's own
entries at a small size on the CPU (the port's plain path), and the runs
with the timed path broken underneath, which must come out not correct:
a step that returns its state unchanged, half of each batch left out,
an answer altered where the scorer produces it.  On the card, the
control (the reference with TF32 products in the program's place) must
fail the cell's limits."""

from __future__ import annotations

import pytest

from .conftest import small_context


def _entry(name):
    from perfbench.entries import serve, train
    return serve if name.endswith("serve") else train


@pytest.mark.parametrize("cell", ["dmt.train", "dmt_2block.train",
                                  "dmt.serve"])
def test_the_port_agrees_with_the_reference(cell):
    out = _entry(cell).run(small_context(cell))
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0


@pytest.mark.parametrize("cell,fault", [
    ("dmt.train", "unchanged"), ("dmt.train", "half"),
    ("dmt_2block.train", "unchanged"), ("dmt_2block.train", "half"),
    ("dmt.serve", "answer")])
def test_a_broken_timed_path_is_not_correct(cell, fault):
    out = _entry(cell).run(small_context(cell), fault=fault)
    assert not out["correct"], out["checks"]


def test_the_reference_follows_the_seed():
    import torch

    from perfbench import modelconf, weights
    from perfbench.traffic import batches, requests

    conf = small_context("dmt.train").conf
    a = weights.make(conf, 2 ** 40 + 3, "cpu")
    b = weights.make(conf, 2 ** 40 + 3, "cpu")
    c = weights.make(conf, 2 ** 40 + 4, "cpu")
    assert torch.equal(a["emb"]["Sku"], b["emb"]["Sku"])
    assert not torch.equal(a["emb"]["Sku"], c["emb"]["Sku"])
    tp = {"batch": 8, "batches": 2, "zipf": 1.3, "labels": [0, 1, 4]}
    x, y = (batches.make(conf, tp, 5, "cpu") for _ in range(2))
    assert all(torch.equal(x[1][k], y[1][k]) for k in x[1])
    rp = {"pool": 32, "candidates": 3, "lens": [50, 50, 10]}
    lens = sorted(r["_lens"][0] for r in requests.make(conf, rp, 9))
    assert lens == sorted(r["_lens"][0] for r in requests.make(conf, rp, 10))
    assert modelconf.load("dmt").lazy_tables() == {"Sku": 4}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["dmt.train", "dmt_2block.train",
                                  "dmt.serve"])
def test_the_control_fails_the_limits(cell, card):
    ctx = small_context(cell, device="cuda")
    ctx.cell["traffic"].update(batch=1024) if "batch" in \
        ctx.cell["traffic"] else ctx.cell["traffic"].update(candidates=300)
    out = _entry(cell).run(ctx, control=True)
    assert out["correct"], out["checks"]
    tf32 = out["control"]["tf32"]
    assert any(v > ctx.cell["limits"][k] for k, v in tf32.items()), tf32
