"""Where one serving request's time goes, for the PyTorch port on one card.

Run from the repo root on a machine with a CUDA card:

    python3 scripts/profile_serve_torch.py [--requests 20] [--seed 0]

Builds the kernels, inits the flagship model of ``conf/dmt.conf`` at full
width from a seed and scores the three 300-candidate requests of
``chip_smoke.py`` in turn.  It prints, per request:

- the host-clock latency without the profiler (median of ``--requests``);
- from a ``torch.profiler`` trace of ``--requests`` more requests: the
  device time of the kernels by group (the fused block kernel, matrix
  products, gathers, other kernels, copies), the number of kernels
  launched and of PyTorch operators called, and the device's busy share of
  the unprofiled latency;
- the ten kernels with the most device time.

The last line is one JSON object with these numbers; the Chrome trace goes
to ``chiprun_out/profile_serve_torch.json``.
"""

from __future__ import annotations

import argparse
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

GROUPS = (
    ("fused_block_fwd", ("fused_block_fwd",)),
    ("matmul", ("gemm", "gemv", "cutlass", "matmul", "dot_kernel")),
    ("gather", ("index", "gather", "embedding")),
    ("copy", ("memcpy", "memset")),
)


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
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
    _build.build([block.KERNEL])
    cfg = DMTConfig.from_ini(chip_smoke.CONF)
    params = build_model(cfg).init(
        torch.Generator(device=dev).manual_seed(args.seed))
    rng = np.random.default_rng(args.seed)
    mean = rng.normal(0.5, 1.0, cfg.feature_dimension)
    std = rng.uniform(0.1, 3.0, cfg.feature_dimension)
    scorer = Scorer(cfg, params, *norm_constants(mean, std))
    reqs = chip_smoke.make_requests(cfg, chip_smoke.CANDIDATES,
                                    chip_smoke.REQUEST_LENS, args.seed)
    n = args.requests
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
    # device-side events, less the "request" range the annotation mirrors
    # onto the device timeline
    kernels = [e for e in prof.events()
               if str(getattr(e, "device_type", "")).endswith("CUDA")
               and e.name != "request"]
    by_group: dict[str, float] = {}
    by_name: dict[str, list] = {}
    for e in kernels:
        us = float(e.time_range.elapsed_us())
        g = group_of(e.name)
        by_group[g] = by_group.get(g, 0.0) + us
        acc = by_name.setdefault(e.name, [0.0, 0])
        acc[0] += us
        acc[1] += 1
    if not kernels:
        # fall back to the operator table's device columns
        for evt in prof.key_averages():
            us = device_us(evt)
            if us > 0:
                g = group_of(evt.key)
                by_group[g] = by_group.get(g, 0.0) + us
                by_name[evt.key] = [us, evt.count]
    device_ms = sum(by_group.values()) / 1e3 / n
    ops = sum(1 for e in prof.events()
              if str(getattr(e, "device_type", "")).endswith("CPU")
              and e.name.startswith("aten::"))
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, "profile_serve_torch.json"))

    print(f"card: {torch.cuda.get_device_name(0)}")
    print(f"request latency (unprofiled, median of {n}): {wall_ms:.3f} ms")
    print(f"device time per request: {device_ms:.3f} ms "
          f"({100 * device_ms / wall_ms:.1f}% of the latency)")
    for g, us in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"  {g:16s} {us / 1e3 / n:8.3f} ms")
    print(f"kernels per request: {len(kernels) / n:.1f}; aten operators per "
          f"request: {ops / n:.1f}; fused_block_fwd launches "
          f"{launches / n:.1f}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    for name, (us, cnt) in top:
        print(f"  {us / 1e3 / n:8.3f} ms  x{cnt / n:5.1f}  {name[:90]}")
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "requests": n,
        "latency_ms_p50": wall_ms, "device_ms_per_request": device_ms,
        "device_busy_share": device_ms / wall_ms,
        "device_ms_by_group": {g: us / 1e3 / n for g, us in by_group.items()},
        "kernels_per_request": len(kernels) / n,
        "aten_ops_per_request": ops / n,
        "fused_block_fwd_per_request": launches / n}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
