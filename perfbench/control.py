"""Readings that set a cell's correctness limits, on the card: for each
seed, the program's numbers (a run of the cell with a short window) and
the control's, the plain reference put in the program's place and
computed with TF32 products, the nearest precision below the float32 the
configurations state; for a training cell also the reference fed half of
each batch (a planted fault).  Not part of a benchmark run:

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 \
        [--seconds 2]

One JSON line per seed: {"seed", "program": {...}, "control": {...}}."""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    from perfbench import run

    run._caches()
    import torch

    from perfbench import harness, modelconf

    if not torch.cuda.is_available():
        harness.log("control readings need the card")
        return 2
    cell = harness.load_cell(args.workload)
    entry = importlib.import_module(f"perfbench.entries.{cell['entry']}")
    conf = modelconf.load(cell["config"])
    cfg = harness.program_config(conf)
    harness.prebuild(cell.get("prebuild", ()))
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        ctx = harness.Context(cell=cell, conf=conf, cfg=cfg,
                              device=torch.device("cuda", 0), seed=seed,
                              seconds=args.seconds, trace=False,
                              t_start=t)
        out = entry.run(ctx, control=True)
        print(json.dumps({"seed": seed, "correct": out["correct"],
                          "program": {k: v["value"] for k, v in
                                      out["checks"].items()},
                          "control": out["control"],
                          "detail": out.get("detail"),
                          "seconds": time.perf_counter() - t}), flush=True)
        del out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
