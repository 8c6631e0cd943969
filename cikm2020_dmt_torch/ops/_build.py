"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C interface: a launcher ``<name>``
that returns a CUDA error code, and ``<name>_error_string``.  It is
compiled with ``nvcc`` for ``sm_90a`` into a shared library at first use,
into ``cikm2020_dmt_torch/_build/`` (listed in ``.gitignore``), under a name
keyed by a hash of the source, the shared headers, the flags and the
compile-time defines, so an edited source is rebuilt and an unchanged one
is loaded as it is.  A library is named by a *spec*: the source's name, or
``(name, defines)`` with ``defines`` a tuple of ``"NAME=value"`` strings
(the block kernels are built once for each width, ``-DBLOCK_D=...``).
The library is bound with ``ctypes``.

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


def _spec(spec) -> tuple[str, tuple[str, ...]]:
    """(name, defines) of a library spec."""
    if isinstance(spec, str):
        return spec, ()
    name, defines = spec
    return name, tuple(defines)


def library_path(spec) -> Path:
    name, defines = _spec(spec)
    # the shared headers are part of every kernel's key
    src = b"".join(p.read_bytes() for p in
                   [CSRC_DIR / f"{name}.cu"] + sorted(CSRC_DIR.glob("*.cuh")))
    flags = " ".join(NVCC_FLAGS + tuple(f"-D{d}" for d in defines))
    key = hashlib.sha256(src + flags.encode()).hexdigest()[:16]
    tag = "".join(f"-{d.replace('=', '')}" for d in defines)
    return BUILD_DIR / f"lib{name}{tag}-{key}.so"


def build(specs) -> dict[str, float]:
    """Compile every library of ``specs`` (names or ``(name, defines)``)
    that is not built yet, one ``nvcc`` process per library, all started
    together.  Returns the wall seconds spent on each, keyed by the
    library's file stem (0.0 where it was already there).  The compiler's
    output (``-Xptxas=-v``: registers, shared memory, spills) is kept beside
    each library as ``<lib>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    seconds = {}
    for spec in specs:
        name, defines = _spec(spec)
        out = library_path(spec)
        label = name + "".join(f"-{d.replace('=', '')}" for d in defines)
        seconds[label] = 0.0
        if out.exists() or label in started:
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, *(f"-D{d}" for d in defines),
               "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        started[label] = (proc, out, tmp, time.perf_counter())
    failures = []
    for label, (proc, out, tmp, t0) in started.items():
        log, _ = proc.communicate()
        seconds[label] = time.perf_counter() - t0
        out.with_suffix(".so.log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"{label}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return seconds


def build_log(spec) -> str:
    log = library_path(spec).with_suffix(".so.log")
    return log.read_text() if log.exists() else ""


@functools.cache
def load(spec) -> ctypes.CDLL:
    """The kernel library of ``spec``, built first if needed."""
    build([spec])
    return ctypes.CDLL(str(library_path(spec)))


@functools.cache
def bind(spec, argtypes: tuple, fn_name: str | None = None):
    """The function ``fn_name`` (default: the launcher, named as the
    source) of library ``spec`` with its ctypes argument types
    (``c_void_p`` for pointers and the stream); it returns a CUDA error
    code, except ``*_workspace`` sizes, which return a 64-bit count."""
    name, _ = _spec(spec)
    fn = getattr(load(spec), fn_name or name)
    fn.argtypes = list(argtypes)
    fn.restype = (ctypes.c_longlong if (fn_name or "").endswith("_workspace")
                  else ctypes.c_int)
    return fn


def check(spec, err: int, what: str) -> None:
    """Raises if a launch returned a CUDA error: a refused launch never
    runs, and a later synchronise would not report it."""
    if err != 0:
        name, _ = _spec(spec)
        fn = getattr(load(spec), name + "_error_string")
        fn.argtypes = [ctypes.c_int]
        fn.restype = ctypes.c_char_p
        raise RuntimeError(f"{name} launch failed: CUDA error {err} "
                           f"({fn(err).decode()}) at {what}")
