"""One run of one benchmark cell of the PyTorch and CUDA port
(``cikm2020_dmt_torch``), from the root of a checkout:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is ``perfbench/cells/<cell>.json``: its configuration
(``perfbench/configs/<config>.json`` and the frozen ``.conf`` it names),
its entry (``perfbench/entries/<entry>.py``), its traffic, the kernel
libraries to build first, and its correctness limits.  The run builds
what is not built, makes weights and inputs from the seed, warms up,
measures for ``--seconds``, compares what the timed path produced with
the plain reference (``perfbench/reference/`` and the configuration's
plain model, ``perfbench/models/<model_type>.py``) and prints one JSON line
last: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones, read by
``perfbench/metrics/<metric>.py``), ``device``, ``breakdown`` with
``--trace 1``, and last ``checks``: each compared number beside its
limit, also printed as the last lines on standard error.

It exits non-zero without a result where CUDA is missing or has fewer
devices than the cell asks for, and where JAX or the JAX package was
loaded into the process.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time

T_START = time.perf_counter()


def _process_age() -> float:
    """Seconds since this process started (Linux), else 0."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".perfbench_cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "cikm2020_dmt_tpu")


def _caches() -> None:
    """The kernel caches of this checkout, at fixed paths inside it."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(CACHE, sub)
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()
    sys.path.insert(0, ROOT)

    import torch

    from perfbench import harness, modelconf

    cell = harness.load_cell(args.workload)
    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        harness.log(f"needs {chips} CUDA device(s); found "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    entry = importlib.import_module(f"perfbench.entries.{cell['entry']}")
    conf = modelconf.load(cell["config"])
    ctx = harness.Context(cell=cell, conf=conf,
                          cfg=harness.program_config(conf),
                          device=torch.device("cuda", 0), seed=args.seed,
                          seconds=args.seconds, trace=bool(args.trace),
                          t_start=T_START - _process_age())
    torch.cuda.reset_peak_memory_stats()
    ctx.build_s = harness.prebuild(cell.get("prebuild", ()))
    out = entry.run(ctx)
    found = forbidden_modules()
    if found:
        harness.log(f"the run loaded {', '.join(found)}: the port's runs "
                    "must not load JAX or the JAX package")
        return 3
    return emit(ctx, cell, out)


def emit(ctx, cell, out) -> int:
    """Prints the result line (and the checks on standard error)."""
    import torch

    from perfbench import harness

    bench = harness.load_benchmark()
    if ctx.trace:
        names = [m["name"] for m in bench["per_layer"]
                 if cell["name"] in m.get("workloads", [cell["name"]])]
        metrics = harness.read_metrics(names, out["rec"])
    else:
        metrics = {"setup_s": {"value": ctx.setup_s, "unit": "s"}}
        units = {m["name"]: m["unit"] for m in bench["end_to_end"]}
        for name, value in out["e2e"].items():
            metrics[name] = {"value": value, "unit": units[name]}
    dev = ctx.device
    device = {"platform": "gpu",
              "kind": torch.cuda.get_device_name(dev),
              "count": int(cell["chips"]),
              "memory_peak_bytes": int(out["memory"])}
    result = {"correct": bool(out["correct"]),
              "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics,
              "device": device}
    if ctx.trace:
        tr = out["rec"]["trace"]
        device["busy_s"] = tr.busy_s
        device["window_s"] = tr.window_s
        result["breakdown"] = {
            "device_ops": tr.device_ops(),
            "idle_gaps": out["rec"]["trace_host"].idle_gaps()}
    result["checks"] = out["checks"]
    harness.log(f"# build_s {ctx.build_s:.3f} setup_s {ctx.setup_s:.3f}")
    for name, c in out["checks"].items():
        harness.log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
