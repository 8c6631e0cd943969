"""Nothing under perfbench/ imports JAX, the JAX package or the JAX
package's scripts (top-level module names compared whole), and nothing
under perfbench/reference/ names the program under test."""

from __future__ import annotations

import ast
import glob
import os

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = {"jax", "jaxlib", "flax", "cikm2020_dmt_tpu", "__graft_entry__",
             "chip_smoke", "scripts"} | {
    os.path.basename(p)[:-3] for p in glob.glob(os.path.join(ROOT, "bench*.py"))}
SOURCES = sorted(glob.glob(os.path.join(BENCH, "**", "*.py"), recursive=True))


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_the_forbidden_names_include_the_root_benches():
    assert "bench" in FORBIDDEN and "bench_serve" in FORBIDDEN


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax_import(path):
    found = set(_imports(path)) & FORBIDDEN
    assert not found, f"{path} imports {found}"


@pytest.mark.parametrize("path", [p for p in SOURCES
                                  if os.sep + "reference" + os.sep in p],
                         ids=os.path.basename)
def test_reference_names_nothing_of_the_program(path):
    assert "cikm2020_dmt_torch" not in open(path).read()
    assert not {m for m in _imports(path)} - {"torch", "numpy", "math",
                                              "typing", "statistics",
                                              "__future__"}


def test_run_refuses_jax_in_the_process(monkeypatch):
    import sys
    import types

    from perfbench import run
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    assert run.forbidden_modules() == ["jax"]
    monkeypatch.delitem(sys.modules, "jax.numpy")
    monkeypatch.setitem(sys.modules, "jaxtyping", types.ModuleType("x"))
    assert run.forbidden_modules() == []
