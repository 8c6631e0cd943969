"""What every entry of the benchmark shares: the run's context, the
program's configuration from the benchmark's files, the kernel builds,
the synchronisation that closes a window, and the metric readers."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
from dataclasses import dataclass

import torch

from . import modelconf

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_DIR = os.path.join(ROOT, "perfbench")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


@dataclass
class Context:
    cell: dict                 # the cell's file
    conf: object               # modelconf.ModelConf
    cfg: object                # the program's configuration
    device: torch.device
    seed: int
    seconds: float
    trace: bool
    t_start: float             # process start, on the perf_counter clock
    setup_s: float = 0.0
    build_s: float = 0.0


def load_cell(name: str) -> dict:
    path = os.path.join(BENCH_DIR, "cells", name + ".json")
    if not os.path.isfile(path):
        raise SystemExit(f"no cell {name!r} ({path})")
    with open(path) as f:
        cell = json.load(f)
    if cell.get("name") != name:
        raise SystemExit(f"{path} names the cell {cell.get('name')!r}")
    return cell


def program_config(conf):
    """The program's configuration: its loader on the frozen config file,
    the configuration's ``settings`` as overrides, and the tables of
    ``conf`` (a test may have cut their rows)."""
    from cikm2020_dmt_torch.core.config import DMTConfig

    cfg = DMTConfig.from_ini(modelconf.conf_path(conf.name),
                             **conf.settings)
    rows = {s.feature: s.rows for s in conf.embeddings + conf.embeddings_bias}

    def cut(specs):
        return tuple(dataclasses.replace(s, id_size=rows.get(s.feature,
                                                             s.id_size))
                     for s in specs)
    return cfg.replace(embeddings=cut(cfg.embeddings),
                       embeddings_bias=cut(cfg.embeddings_bias))


def prebuild(specs) -> float:
    """Builds the program's kernel libraries of the cell (``prebuild`` in
    its file: a name, or [name, [defines]]) in parallel, those whose
    source is there; returns the seconds it took.  The program builds
    any other library at its first use, in the warm-up."""
    import time

    from cikm2020_dmt_torch.ops import _build

    wanted = []
    for s in specs:
        name, defines = (s, ()) if isinstance(s, str) else (s[0], tuple(s[1]))
        if (_build.CSRC_DIR / f"{name}.cu").exists():
            wanted.append(name if not defines else (name, defines))
    t0 = time.perf_counter()
    if wanted:
        _build.build(wanted)
    return time.perf_counter() - t0


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def read_metrics(names, rec: dict) -> dict:
    """Each named per-layer metric from its reader
    ``perfbench/metrics/<name>.py`` (``read(rec)`` -> a number or None);
    None leaves the metric out."""
    out = {}
    for name in names:
        path = os.path.join(BENCH_DIR, "metrics", name + ".py")
        spec = importlib.util.spec_from_file_location(
            "perfbench_metric_" + name.replace(".", "_").replace("-", "_"),
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        value = mod.read(rec)
        if value is not None:
            out[name] = {"value": float(value), "unit": mod.UNIT}
    return out


def load_benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)
