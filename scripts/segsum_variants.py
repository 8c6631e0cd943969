"""Split the sorted segment-sum kernel's time by launch on one card.

Run from the root of a checkout on a machine with one CUDA card:

    python3 scripts/segsum_variants.py [--tree DIR]

Each variant is a copy of the ``cikm2020_dmt_torch`` package of ``DIR``
(default: this checkout) in a temporary directory whose
``csrc/sorted_segsum.cu`` skips one part of its work; the copies build
their own libraries, all at once, and then, one variant at a time, a fresh
process times ``ops/scatter_rows.sorted_segment_sum_rows`` at the
flagship's shape: the Sku union of ``chip_smoke.synthetic_batch`` at batch
2048 (``conf/dmt.conf``, N = 2048 x 111 sorted rows, D = 32, as
``chip_smoke.segsum_phase`` builds it), bfloat16 and float32, CUDA-event
means from ``chip_smoke.cuda_ms``.  The variants:

- ``pass1``: the first launch alone (the per-chunk or per-tile sums);
- ``stitch``: the second launch alone (the runs cut by chunk or tile
  edges; on inputs the first launch did not write, so only its time
  counts);
- ``no_zeroing``, ``no_run_sums``: both launches, the second without its
  zeroing of the slots no run names, or without its sums of the runs cut
  by tile edges (sources with the ``SEGSUM_SKIP`` mask only);

and ``source``, the unchanged source, first and last: the spread between
its two readings bounds the noise.  Variants that skip a launch compute
wrong sums on purpose.  The ``source`` process also times what the
wrapper and its caller spend around the kernel: ``torch.zeros`` of the
[num_out, 32] float32 output (the wrapper before the redesign zeroed it),
the cast of that output to bfloat16 (``_TakeRowsSparseSorted.backward``),
the plain version and ``index_add_``.

A source that defines ``SEGSUM_SKIP`` is cut by that compile-time mask
(``SKIP_BITS``: bit 1 skips the first launch, bit 2 the second, bit 4 the
second's zeroing, bit 8 its sums); the earlier two-pass source,
which has none, by replacing a few of its lines (``OLD_SUBS``).  One line
per variant: ``<name> RESULT {json}`` with ptxas's register lines, the
union's shape and, for each type, the ms and the largest |error| against
the plain version.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = "cikm2020_dmt_torch/csrc/sorted_segsum.cu"
SKIP_DEFINE = "#define SEGSUM_SKIP 0"
SKIP_BITS = {"pass1": 2, "stitch": 1, "no_zeroing": 4, "no_run_sums": 8}
OLD_SUBS = {
    "pass1": (("  segsum_stitch<<<grid, kWarps * 32, 0, s>>>"
               "(sg, N, D, out_f, h, t);",
               "  (void)sg;"),),
    "stitch": (("  if (is_bf16) {\n    segsum_chunks",
                "  if (N < 0) {\n    segsum_chunks"),
               ("  } else {\n    segsum_chunks",
                "  } else if (N < 0) {\n    segsum_chunks")),
}
VARIANTS = ("source", *SKIP_BITS, "source_again")

# the flagship's union, in either tree (both have chip_smoke.synthetic_batch
# and train/lazy.py collect); scripts/compare_trees.py runs it too
FLAGSHIP_UNION = r'''
import torch
import chip_smoke as cs
from cikm2020_dmt_torch.core.config import DMTConfig
from cikm2020_dmt_torch.train.lazy import build_lazy_plan, collect


def flagship_union(dev):
    """(order, seg_sorted, pos, num_out) of the Sku union of
    chip_smoke.synthetic_batch at 2048, the first case of
    chip_smoke.segsum_phase."""
    cfg = DMTConfig.from_ini(cs.CONF)
    spec = next(t for t in build_lazy_plan(cfg) if t.name == "Sku")
    table = torch.zeros((spec.fields[0][1], spec.dim), dtype=torch.bfloat16,
                        device=dev)
    batch = cs.synthetic_batch(cfg, cs.TRAIN_BATCH, cs.SEED + 100, dev)
    col = collect(spec, batch, table, cfg.dedup_budget_div)
    return col.order, col.seg_sorted, col.pos, col.uids.numel() + 1
'''

# run with the variant's name as its argument
TIMING = FLAGSHIP_UNION + r'''
import json, sys
from cikm2020_dmt_torch.ops import _build, scatter_rows as sr
dev = torch.device("cuda")
_build.build(["sorted_segsum"])
out = {"ptxas": sorted({l.split(":", 1)[-1].strip() for l in
                        _build.build_log("sorted_segsum").splitlines()
                        if "registers" in l or "spill" in l})}
order, seg, pos, num = flagship_union(dev)
N = order.numel()
lens = torch.unique_consecutive(seg, return_counts=True)[1]
out["shape"] = {"N": N, "D": 32, "num_out": num, "runs": lens.numel(),
                "longest_run": int(lens.max())}
gen = torch.Generator(device=dev).manual_seed(0)
g32 = torch.randn(N, 32, generator=gen, device=dev)
for name, g in (("bf16", g32.to(torch.bfloat16)), ("f32", g32)):
    got = sr.sorted_segment_sum_rows(g, order, seg, num)
    want = sr.sorted_segment_sum_rows_ref(g, order, seg, num)
    rec = {"err": float((got - want).abs().max()),
           "ms": cs.cuda_ms(
               lambda: sr.sorted_segment_sum_rows(g, order, seg, num), 50)}
    if sys.argv[1] == "source":
        gf = g.float()
        rec["plain_ms"] = cs.cuda_ms(
            lambda: sr.sorted_segment_sum_rows_ref(g, order, seg, num), 20)
        rec["index_add_ms"] = cs.cuda_ms(
            lambda: torch.zeros(num, 32, device=dev).index_add_(0, pos, gf),
            20)
        rec["zeros_ms"] = cs.cuda_ms(
            lambda: torch.zeros((num, 32), dtype=torch.float32, device=dev),
            50)
        rec["cast_bf16_ms"] = cs.cuda_ms(lambda: got.to(torch.bfloat16), 50)
    out[name] = rec
print("RESULT", json.dumps(out), flush=True)
'''


def cut(src: str, name: str) -> str:
    """The source with the part of variant ``name`` skipped."""
    if name.startswith("source"):
        return src
    if SKIP_DEFINE in src:
        return src.replace(SKIP_DEFINE,
                           f"#define SEGSUM_SKIP {SKIP_BITS[name]}")
    for old, new in OLD_SUBS[name]:
        if src.count(old) != 1:
            raise ValueError(f"{name}: {old!r} is not in {SRC} exactly once")
        src = src.replace(old, new)
    return src


def prepare(name: str, tree: str, root: str) -> subprocess.Popen:
    """Copies the package with variant ``name``'s cut and starts building
    its library (the builds of all variants run together)."""
    d = os.path.join(root, name)
    shutil.copytree(os.path.join(tree, "cikm2020_dmt_torch"),
                    os.path.join(d, "cikm2020_dmt_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copytree(os.path.join(tree, "conf"), os.path.join(d, "conf"))
    shutil.copy(os.path.join(tree, "chip_smoke.py"), d)
    path = os.path.join(d, SRC)
    with open(path) as f:
        src = f.read()
    with open(path, "w") as f:
        f.write(cut(src, name))
    return subprocess.Popen(
        [sys.executable, "-c", "from cikm2020_dmt_torch.ops import _build; "
         "_build.build(['sorted_segsum'])"], cwd=d,
        env=dict(os.environ, PYTHONPATH=d), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def run_variant(name: str, root: str) -> str:
    d = os.path.join(root, name)
    r = subprocess.run([sys.executable, "-c", TIMING, name], cwd=d,
                       env=dict(os.environ, PYTHONPATH=d),
                       capture_output=True, text=True, timeout=600)
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("RESULT")]
    if r.returncode != 0 or not lines:
        raise RuntimeError(f"{name} failed:\n{r.stdout[-2000:]}"
                           f"{r.stderr[-4000:]}")
    return lines[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=REPO,
                    help="root of the checkout whose package is timed")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("segsum_variants: no CUDA card", file=sys.stderr)
        return 2
    tree = os.path.abspath(args.tree)
    with open(os.path.join(tree, SRC)) as f:
        masked = SKIP_DEFINE in f.read()
    variants = [v for v in VARIANTS if masked or v in OLD_SUBS
                or v.startswith("source")]
    with tempfile.TemporaryDirectory() as root:
        builds = {name: prepare(name, tree, root) for name in variants}
        for name, proc in builds.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"{name}: build failed\n{out[-4000:]}")
        for name in variants:
            print(name, run_variant(name, root), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
