"""Every file the benchmark finds by name parses and keeps to the
contract's names, units and cross references."""

from __future__ import annotations

import importlib.util
import json
import os
import re

import pytest

from perfbench import harness, modelconf

BENCH = harness.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def _reader(name):
    path = os.path.join(harness.BENCH_DIR, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("m_" + name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"]
                         + METRICS, ids=lambda e: e["name"])
def test_names_and_units(entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for key in entry.get("reduced", ()):
        assert NAME.match(key)
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key]


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_configuration_files(cfg):
    meta = modelconf.meta(cfg["name"])
    assert cfg["file"] == f"perfbench/configs/{cfg['name']}.json"
    assert meta["reduced"] == cfg["reduced"] and meta["source"] == cfg["source"]
    conf = modelconf.load(cfg["name"])
    assert conf.d_model == 80 and conf.d_ff == 320 and conf.num_heads == 4
    assert harness.program_config(conf).batch_size == conf.settings["batch_size"]


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_files(cell):
    f = harness.load_cell(cell["name"])
    assert (f["config"], f["chips"], f["why"]) == (cell["config"],
                                                   cell["chips"], cell["why"])
    assert os.path.isfile(os.path.join(harness.BENCH_DIR, "entries",
                                       f["entry"] + ".py"))
    assert f["limits"] and all(isinstance(v, float) and v > 0
                               for v in f["limits"].values())


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_readers(metric):
    mod = _reader(metric["name"])
    assert mod.UNIT == metric["unit"]
    assert mod.read({}) is None          # nothing to read: no number


def test_every_cell_reports_what_its_metrics_move():
    cells = {c["name"] for c in BENCH["workloads"]}
    e2e = {m["name"]: set(m.get("workloads", cells))
           for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["per_layer"]:
        assert set(m["workloads"]) <= e2e[m["moves"]], m["name"]
    for c in cells:
        assert sum(c in w for n, w in e2e.items() if n != "setup_s") >= 1
        assert any(c in m["workloads"] for m in BENCH["per_layer"])


def test_layers_are_named_alike():
    by_layer = {}
    for m in BENCH["per_layer"]:
        by_layer.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())


def test_pairs_of_configuration_and_traffic_are_distinct():
    pairs = [(c["config"], c["traffic"]) for c in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
