"""Boundaries of the port's native data path: its C++ source lies inside
the package, no module of the port names a path under the root
``native/`` (the JAX package's copy and build directory), and git ignores
the port's build directory."""

import ast
import fnmatch
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "cikm2020_dmt_torch"


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_native_source_and_build_dir_inside_the_package():
    from cikm2020_dmt_torch.data import native
    assert native.SRC == PORT / "native" / "dmtdata.cc"
    assert native.SRC.is_file()
    assert native.BUILD_DIR == PORT / "_build"
    assert native.library_path().parent == native.BUILD_DIR


def _path_literals(path: Path):
    """Every string constant of ``path`` that is neither a docstring nor a
    piece of an f-string."""
    tree = ast.parse(path.read_text(), filename=str(path))
    docs = {id(v) for node in ast.walk(tree)
            if isinstance(node, ast.JoinedStr) for v in node.values}
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and isinstance(
                    first.value, ast.Constant):
                docs.add(id(first.value))
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and id(node) not in docs:
            yield node.value


# a path into the root native/ directory ("native/...", "../native", the
# JAX package's build directory there), or a step up out of the package
# (how the JAX package reaches it: "..", "..", "native")
ROOT_NATIVE = re.compile(r"^native[/\\]|\.\.[/\\]+native|native[/\\]build|^\.\.$")


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_path_under_root_native(path):
    bad = [s for s in _path_literals(path) if ROOT_NATIVE.search(s)]
    assert not bad, f"{path.relative_to(ROOT)} names {bad}"


def test_gitignore_covers_the_build_dir():
    patterns = [line.strip() for line in
                (ROOT / ".gitignore").read_text().splitlines()
                if line.strip() and not line.startswith("#")]
    built = "cikm2020_dmt_torch/_build/libdmtdata-0123456789abcdef.so"
    assert any(fnmatch.fnmatch(built, p.rstrip("/") + "/*")
               for p in patterns), patterns
