"""Where one serving request's time goes, for the PyTorch port on one card.

Run from the repo root on a machine with a CUDA card:

    python3 scripts/profile_serve_torch.py

Builds the kernels, inits the flagship model of ``conf/dmt.conf`` at full
width from a seed and scores the three 300-candidate requests of
``chip_smoke.py`` in turn.  It prints, per request:

- the host-clock latency without the profiler (median of 20 requests);
- from a ``torch.profiler`` trace of 20 more requests: the device time of
  the kernels by group (the fused block kernel, matrix products, gathers
  and scatters, other kernels, copies), the number of kernels launched and
  of PyTorch operators called, and the device's busy share of the
  unprofiled latency;
- the ten kernels with the most device time.

The last line is one JSON object with these numbers; the Chrome trace goes
to ``chiprun_out/profile_serve_torch.json``.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from torch_profile import breakdown, print_breakdown  # noqa: E402

REQUESTS = 20


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_serve_torch: no CUDA card", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile, record_function

    from cikm2020_dmt_torch.core.config import DMTConfig
    from cikm2020_dmt_torch.models.zoo import build_model
    from cikm2020_dmt_torch.ops import _build, block
    from cikm2020_dmt_torch.serve.export import Scorer, norm_constants

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    _build.build([block.library(block.KERNEL, 80, 320, 4)])
    cfg = DMTConfig.from_ini(chip_smoke.CONF)
    params = build_model(cfg).init(
        torch.Generator(device=dev).manual_seed(chip_smoke.SEED))
    rng = np.random.default_rng(chip_smoke.SEED)
    mean = rng.normal(0.5, 1.0, cfg.feature_dimension)
    std = rng.uniform(0.1, 3.0, cfg.feature_dimension)
    scorer = Scorer(cfg, params, *norm_constants(mean, std))
    reqs = chip_smoke.make_requests(cfg, chip_smoke.CANDIDATES,
                                    chip_smoke.REQUEST_LENS, chip_smoke.SEED)
    n = REQUESTS
    for i in range(5):
        scorer(reqs[i % len(reqs)])
    lat = []
    for i in range(n):
        t0 = time.perf_counter()
        scorer(reqs[i % len(reqs)])
        lat.append((time.perf_counter() - t0) * 1e3)
    wall_ms = statistics.median(lat)

    block.fused_encode_decode.launches = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            with record_function("request"):
                scorer(reqs[i % len(reqs)])
        torch.cuda.synchronize()
    launches = block.fused_encode_decode.launches
    b = breakdown(prof, n, "request")
    device_ms = b["device_ms"]
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, "profile_serve_torch.json"))

    print(f"card: {torch.cuda.get_device_name(0)}")
    print(f"request latency (unprofiled, median of {n}): {wall_ms:.3f} ms")
    print(f"device time per request: {device_ms:.3f} ms "
          f"({100 * device_ms / wall_ms:.1f}% of the latency)")
    print(f"kernels per request: {b['kernels']:.1f}; aten operators per "
          f"request: {b['aten_ops']:.1f}; fused_block_fwd launches "
          f"{launches / n:.1f}")
    print_breakdown(b)
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "requests": n,
        "latency_ms_p50": wall_ms, "device_ms_per_request": device_ms,
        "device_busy_share": device_ms / wall_ms,
        "device_ms_by_group": b["by_group"],
        "kernels_per_request": b["kernels"],
        "aten_ops_per_request": b["aten_ops"],
        "fused_block_fwd_per_request": launches / n}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
