"""What the process-group backends do with ranks that share one card.

Run from the repo root on a machine with one CUDA card:

    python3 scripts/probe_mesh_backends_torch.py

Two ranks (``core.mesh.run_ranks``) share ``cuda:0``:

- over gloo: ``all_reduce``, ``all_to_all_single`` and ``all_gather`` on
  float32 card tensors, and on the uint8 bytes of bfloat16 ones, each
  with the result checked;
- over nccl: one ``all_reduce``, which NCCL is expected to refuse (two
  ranks on one device); the refusal's text is printed.

Prints one JSON line per probe.  Exits 2 without a card, 1 if a gloo
collective fails or NCCL accepts two ranks on one device.
"""

from __future__ import annotations

import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def gloo_rank(rank: int) -> dict:
    import torch.distributed as dist
    dev = torch.device("cuda", 0)
    out = {}
    x = torch.arange(4, dtype=torch.float32, device=dev) + 10 * rank
    other = torch.arange(4, dtype=torch.float32) + 10 * (1 - rank)
    for dtype in (torch.float32, torch.bfloat16):
        src = x.to(dtype)
        wire = src.view(torch.uint8) if dtype == torch.bfloat16 else src

        def back(t):
            return (t.view(dtype) if dtype == torch.bfloat16 else t
                    ).float().cpu()

        red = x.clone()
        dist.all_reduce(red)
        a2a = torch.empty_like(wire)
        dist.all_to_all_single(a2a, wire)
        parts = [torch.empty_like(wire) for _ in range(2)]
        dist.all_gather(parts, wire)
        torch.cuda.synchronize()
        mine, theirs = x.cpu(), other
        by_rank = [mine, theirs] if rank == 0 else [theirs, mine]
        half = slice(2 * rank, 2 * rank + 2)
        out[str(dtype)] = {
            "all_reduce": bool(torch.equal(red.cpu(), mine + theirs)),
            "all_to_all_single": bool(torch.equal(
                back(a2a), torch.cat([t[half] for t in by_rank]))),
            "all_gather": bool(torch.equal(
                torch.stack([back(p) for p in parts]),
                torch.stack(by_rank))),
            "on_card": all(t.is_cuda for t in (red, a2a, *parts))}
    return out


def nccl_rank(rank: int) -> float:
    import torch.distributed as dist
    t = torch.ones(4, device="cuda:0")
    dist.all_reduce(t)
    torch.cuda.synchronize()
    return float(t[0])


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_mesh_backends_torch: no CUDA card", file=sys.stderr)
        return 2
    from cikm2020_dmt_torch.core.mesh import run_ranks
    gloo = run_ranks(gloo_rank, 2, backend="gloo", timeout_s=120)
    print(json.dumps({"gloo_card_tensors": gloo}))
    ok = all(all(v for v in d.values()) for r in gloo for d in r.values())
    try:
        run_ranks(nccl_rank, 2, backend="nccl", timeout_s=120)
        refusal = None
    except RuntimeError as e:
        lines = [ln for ln in str(e).splitlines() if "NCCL" in ln
                 or "Duplicate" in ln]
        refusal = lines[:3]
    print(json.dumps({"nccl_two_ranks_one_card": refusal or "accepted",
                      "torch": torch.__version__,
                      "nccl": ".".join(map(str, torch.cuda.nccl.version()))}))
    return 0 if ok and refusal else 1


if __name__ == "__main__":
    sys.exit(main())
