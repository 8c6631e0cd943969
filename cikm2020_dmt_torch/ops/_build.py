"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C interface: a launcher ``<name>``
that returns a CUDA error code, and ``<name>_error_string``.  It is
compiled with ``nvcc`` for ``sm_90a`` into a shared library at first use,
into ``cikm2020_dmt_torch/_build/`` (listed in ``.gitignore``), under a name
keyed by a hash of the source, the shared headers and the flags, so an
edited source is rebuilt and an unchanged one is loaded as it is.  The
library is bound with ``ctypes``.

A missing ``nvcc`` or a failed build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(candidate):
        return candidate
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME or /usr/local/cuda): "
                       "the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    # the shared headers are part of every kernel's key
    src = b"".join(p.read_bytes() for p in
                   [CSRC_DIR / f"{name}.cu"] + sorted(CSRC_DIR.glob("*.cuh")))
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{key}.so"


def build(names) -> dict[str, float]:
    """Compile every kernel of ``names`` whose library is not built yet, one
    ``nvcc`` process per source, all started together.  Returns the wall
    seconds spent on each name (0.0 where the library was already there).
    The compiler's output (``-Xptxas=-v``: registers, shared memory,
    spills) is kept beside each library as ``<lib>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, out, tmp, time.perf_counter())
    seconds = {name: 0.0 for name in names}
    failures = []
    for name, (proc, out, tmp, t0) in started.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        out.with_suffix(".so.log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return seconds


def build_log(name: str) -> str:
    log = library_path(name).with_suffix(".so.log")
    return log.read_text() if log.exists() else ""


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built first if needed."""
    build([name])
    return ctypes.CDLL(str(library_path(name)))


@functools.cache
def bind(name: str, argtypes: tuple):
    """The launcher ``name`` of kernel library ``name`` with its ctypes
    argument types (``c_void_p`` for pointers and the stream)."""
    lib = load(name)
    fn = getattr(lib, name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    err = getattr(lib, name + "_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn


def check(name: str, err: int, what: str) -> None:
    """Raises if a launch returned a CUDA error: a refused launch never
    runs, and a later synchronise would not report it."""
    if err != 0:
        msg = getattr(load(name), name + "_error_string")(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({msg}) "
                           f"at {what}")
