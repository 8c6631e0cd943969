"""The port's model axis on a ``(2, 2)`` mesh of four ``gloo`` ranks
against the JAX ``Trainer`` on the same mesh shape
(``tests/test_torch_model_axis_train.py``'s tables and two steps at a
global batch of 64, 32 rows a data index).  Sku (2,048 groups) is
full-mesh over the four ranks, the model peers slicing their requests;
Brand (514 groups: a multiple of 2, not of 4) is a sharded lazy table
(``lazy_adam_rows_sharded``); Shopid, Cid2 and the bias net's tables are
dense and model-split; Cid3 is replicated."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_torch_model_axis_train import (axis_config, check_run,  # noqa: E402
                                         compare, placement_split)


@pytest.fixture(scope="module")
def two_by_two():
    return compare(axis_config(2), 2, 2)


def test_plan_and_placement_match_jax(two_by_two):
    jr = two_by_two["jax"]
    assert jr["plan"] == [("Sku", True, False), ("Brand", False, True)]
    want = {k: ("full_mesh" if v == ("data", "model") else "model_split")
            for k, v in jr["split"].items()}
    assert placement_split(two_by_two["pcfg"], 2, 2) == want
    assert want["emb/Brand"] == "model_split"
    for r in two_by_two["ranks"]:
        assert r["sharded"] == ["Brand"]
        assert r["share_rows"]["Sku"] == 2048       # 8,192 / 4
        assert r["share_rows"]["Brand"] == 2056     # 257 groups of 8


def test_two_steps_match_jax(two_by_two):
    check_run(two_by_two, lazy=("Sku", "Brand"))
