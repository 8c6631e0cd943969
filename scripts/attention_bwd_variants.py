"""Time variants of the attention-backward kernel side by side on one card.

Run from the root of a checkout on a machine with one CUDA card:

    python3 scripts/attention_bwd_variants.py

Each variant is a copy of ``cikm2020_dmt_torch`` in a temporary directory
whose ``csrc/attention_bwd.cu`` has a few strings replaced; the copy builds
its own library, and a fresh process times ``fused_attention_bwd`` at the
four (Tq, Tk) of the ``dmt_2block`` training step (B=2048, float32, D=80,
4 heads; CUDA-event means from ``chip_smoke.cuda_ms``) and checks it
against the plain version.  The variants that skip a phase compute wrong
gradients on purpose: their times split the kernel's time by phase.  The
unchanged source runs first and last, so the spread between the two
readings bounds the noise.  One line per variant: ``<name> RESULT {json}``
with the registers ptxas reported, each shape's ms and largest error
relative to each output's largest |value|, and the step's 12 launches.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = "cikm2020_dmt_torch/csrc/attention_bwd.cu"
LOAD = "for (int i0 = t; i0 < n_load; i0 += kLoadBatch * kBwdThreads) {"
PHASE1 = "for (int base = 0; base + warp_g0 < n_items; base += groups) {"
PHASE2 = "for (int it = t; it < units * per_unit; it += kBwdThreads) {"
VARIANTS = (
    ("source", ()),
    ("no_load", ((LOAD, LOAD.replace("i0 < n_load", "i0 < 0")),)),
    ("no_phase1", ((PHASE1, PHASE1.replace("< n_items", "< 0")),)),
    ("no_phase2", ((PHASE2, PHASE2.replace("< units", "< 0 * units")),)),
    ("source_again", ()),
)

TIMING = r'''
import json, torch, chip_smoke as cs
from cikm2020_dmt_torch.ops import attention as att, _build
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda")
_build.build(["attention_bwd"])
out = {"registers": sorted({l.split(":")[-1].strip() for l in
                            _build.build_log("attention_bwd").splitlines()
                            if "registers" in l})}
gen = torch.Generator(device=dev).manual_seed(0)
step = 0.0
for part, Tq, Tk, n in cs.ATTENTION_SHAPES:
    q, k, v, qm, km, do = cs._attention_inputs(2048, Tq, Tk, torch.float32,
                                               gen, dev)
    got = att.fused_attention_bwd(q, k, v, qm, km, do, 4)
    err = cs._max_rel(got, att.fused_attention_bwd_ref(q, k, v, qm, km, do, 4))
    ms = cs.cuda_ms(lambda: att.fused_attention_bwd(q, k, v, qm, km, do, 4),
                    20)
    step += n * ms
    out[f"{Tq}x{Tk}"] = {"ms": ms, "err": err}
out["step_ms"] = step
print("RESULT", json.dumps(out), flush=True)
'''


def run_variant(name: str, subs, root: str) -> str:
    d = os.path.join(root, name)
    shutil.copytree(os.path.join(REPO, "cikm2020_dmt_torch"),
                    os.path.join(d, "cikm2020_dmt_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), d)
    path = os.path.join(d, SRC)
    with open(path) as f:
        src = f.read()
    for old, new in subs:
        if old not in src:
            raise ValueError(f"{name}: {old!r} not in {SRC}")
        src = src.replace(old, new)
    with open(path, "w") as f:
        f.write(src)
    r = subprocess.run([sys.executable, "-c", TIMING], cwd=d,
                       env=dict(os.environ, PYTHONPATH=d),
                       capture_output=True, text=True, timeout=900)
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("RESULT")]
    if r.returncode != 0 or not lines:
        raise RuntimeError(f"{name} failed:\n{r.stdout[-2000:]}"
                           f"{r.stderr[-4000:]}")
    return lines[0]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("attention_bwd_variants: no CUDA card", file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory() as root:
        for name, subs in VARIANTS:
            print(name, run_variant(name, subs, root), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
