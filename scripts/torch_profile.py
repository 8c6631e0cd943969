"""Device time of a ``torch.profiler`` trace by kernel group, shared by
``profile_serve_torch.py`` and ``profile_train_torch.py``."""

from __future__ import annotations

GROUPS = (
    ("fused_block_fwd", ("fused_block_fwd",)),
    ("fused_block_bwd", ("block_bwd_kernel", "wgrad_kernel")),
    # the weight fragments, packed by both block kernels' calls
    ("fused_block_pack", ("pack_kernel",)),
    ("sorted_segsum", ("segsum_",)),
    ("update_rows", ("update_rows_kernel",)),
    ("attention_fwd", ("attention_fwd_kernel", "attention_fwd_rows")),
    ("attention_bwd", ("attention_bwd_kernel", "attention_bwd_rows",
                       "attention_bwd_cols")),
    ("matmul", ("gemm", "gemv", "cutlass", "matmul", "dot_kernel")),
    ("sort", ("sort", "radix", "scan")),
    ("gather_scatter", ("index", "gather", "scatter", "embedding")),
    ("copy", ("memcpy", "memset")),
)


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def breakdown(prof, n: int, marker: str) -> dict:
    """Per unit of work (``n`` units were profiled, each inside a
    ``record_function(marker)`` range): device ms by group, the ten
    kernels with the most device time, the kernel and ``aten::`` operator
    counts."""
    # device-side events, less the marker range the annotation mirrors onto
    # the device timeline
    kernels = [e for e in prof.events()
               if str(getattr(e, "device_type", "")).endswith("CUDA")
               and e.name != marker]
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
            us = _device_us(evt)
            if us > 0:
                g = group_of(evt.key)
                by_group[g] = by_group.get(g, 0.0) + us
                by_name[evt.key] = [us, evt.count]
    ops = sum(1 for e in prof.events()
              if str(getattr(e, "device_type", "")).endswith("CPU")
              and e.name.startswith("aten::"))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    return {"device_ms": sum(by_group.values()) / 1e3 / n,
            "by_group": {g: us / 1e3 / n for g, us in by_group.items()},
            "top": [(name, us / 1e3 / n, cnt / n) for name, (us, cnt) in top],
            "kernels": len(kernels) / n, "aten_ops": ops / n}


def print_breakdown(b: dict) -> None:
    for g, ms in sorted(b["by_group"].items(), key=lambda kv: -kv[1]):
        print(f"  {g:16s} {ms:8.3f} ms")
    for name, ms, cnt in b["top"]:
        print(f"  {ms:8.3f} ms  x{cnt:5.1f}  {name[:90]}")
