"""Where one training step's time goes, for the PyTorch port on one card.

Run from the repo root on a machine with a CUDA card:

    python3 scripts/profile_train_torch.py

Builds the kernels and, for each of ``conf/dmt.conf`` (the flagship, with
dropout on) and ``conf/dmt_2block.conf`` (two encoder and two decoder
blocks per sequence, dropout 0), runs ``chip_smoke.train_phase``: the
model at full width, trained at its batch size (2048), whose step time
(CUDA events over 10 steps after 3 warm-up steps) is the one
``chip_smoke.py`` prints.  Then it traces 3 more steps with
``torch.profiler`` and prints, per step: the device time of the kernels by
group (the port's kernels, matrix products, gathers and scatters, sorts,
other kernels, copies), the number of kernels launched and of PyTorch
operators called, the device's busy share of the unprofiled step, and the
ten kernels with the most device time.

The last line is one JSON object with these numbers for both configs; the
Chrome traces go to ``chiprun_out/profile_train_torch_<config>.json``.
"""

from __future__ import annotations

import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from torch_profile import breakdown, print_breakdown  # noqa: E402

PROFILED_STEPS = 3


def profile_config(name: str, conf: str, dev) -> dict:
    """``chip_smoke.train_phase`` on ``conf``, then 3 traced steps; prints
    the breakdown and returns its numbers."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from cikm2020_dmt_torch.core.config import DMTConfig

    cfg = DMTConfig.from_ini(conf)
    run = chip_smoke.train_phase(cfg, dev,
                                 chip_smoke.EXPECTED_PER_STEP[name])
    tr, state, metrics = run["trainer"], run["state"], run["metrics"]
    batches, step_ms = run["batches"], run["step_ms"]

    n = PROFILED_STEPS
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            with record_function("step"):
                state, metrics, _ = tr.train_step(
                    state, metrics, batches[i % len(batches)], run["gen"])
        torch.cuda.synchronize()
    b = breakdown(prof, n, "step")
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(
        os.path.join(out_dir, f"profile_train_torch_{name}.json"))

    batch = chip_smoke.TRAIN_BATCH
    print(f"{name}: step at batch {batch} (chip_smoke.train_phase, "
          f"unprofiled): {step_ms:.3f} ms, {run['examples_per_s']:.1f} "
          "examples/s")
    print(f"device time per step: {b['device_ms']:.3f} ms "
          f"({100 * b['device_ms'] / step_ms:.1f}% of the step)")
    print(f"kernels per step: {b['kernels']:.1f}; aten operators per step: "
          f"{b['aten_ops']:.1f}")
    print_breakdown(b)
    return {"config": name, "profiled_steps": n, "batch": batch,
            "step_ms": step_ms, "examples_per_s": run["examples_per_s"],
            "device_ms_per_step": b["device_ms"],
            "device_busy_share": b["device_ms"] / step_ms,
            "device_ms_by_group": b["by_group"],
            "kernels_per_step": b["kernels"],
            "aten_ops_per_step": b["aten_ops"]}


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_train_torch: no CUDA card", file=sys.stderr)
        return 2
    from cikm2020_dmt_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    _build.build(chip_smoke.build_specs())
    print(f"card: {torch.cuda.get_device_name(0)}")
    out = [profile_config("dmt", chip_smoke.CONF, dev)]
    torch.cuda.empty_cache()
    out.append(profile_config("dmt_2block", chip_smoke.CONF_2BLOCK, dev))
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "configs": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
