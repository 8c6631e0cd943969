"""The benchmark's model seam (``perfbench/models/``): a second model type,
the port's ``embed_mlp``, joins through files of its own alone (a plain
model, a configuration and a cell under ``perfbench/tests/fixtures/``),
runs through the training entry at a small size on the CPU and agrees
with its plain reference, and the runs with the timed path broken
underneath come out not correct; a ``model_type`` without a module is
refused at load, naming the file to add."""

from __future__ import annotations

import os
import shutil

import pytest

from .conftest import small_context

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")


@pytest.fixture
def fixture_dirs(monkeypatch):
    """The loaders pointed at the fixture's models, configurations and
    cells."""
    from perfbench import harness, modelconf, models
    monkeypatch.setattr(models, "MODEL_DIR", os.path.join(FIXTURES, "models"))
    monkeypatch.setattr(modelconf, "CONFIG_DIR",
                        os.path.join(FIXTURES, "configs"))
    monkeypatch.setattr(harness, "CELL_DIR", os.path.join(FIXTURES, "cells"))


def test_a_second_model_type_agrees_with_its_reference(fixture_dirs):
    from perfbench.entries import train
    ctx = small_context("embed_mlp.train")
    assert type(ctx.conf).__module__ == "perfbench.models.embed_mlp"
    assert ctx.conf.lazy_tables() == {"Sku": 4}
    out = train.run(ctx)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0


@pytest.mark.parametrize("fault", ["unchanged", "half"])
def test_a_broken_timed_path_of_a_second_model_type_is_not_correct(
        fixture_dirs, fault):
    from perfbench.entries import train
    out = train.run(small_context("embed_mlp.train"), fault=fault)
    assert not out["correct"], out["checks"]


def test_a_model_type_without_a_module_is_refused(tmp_path, monkeypatch):
    from perfbench import modelconf
    src = os.path.join(FIXTURES, "configs")
    shutil.copy(os.path.join(src, "embed_mlp.json"), tmp_path)
    with open(os.path.join(src, "embed_mlp.conf")) as f:
        text = f.read().replace("model_type = embed_mlp",
                                "model_type = no_such_model")
    (tmp_path / "embed_mlp.conf").write_text(text)
    monkeypatch.setattr(modelconf, "CONFIG_DIR", str(tmp_path))
    with pytest.raises(ValueError, match=r"add perfbench/models/"
                       r"no_such_model\.py"):
        modelconf.load("embed_mlp")
