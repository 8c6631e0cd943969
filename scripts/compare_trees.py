"""Time the block and attention kernels of checkouts side by side on one
card.

Run from the root of a checkout on a machine with one CUDA card:

    python3 scripts/compare_trees.py OLD_DIR [NEW_DIR ...]

``OLD_DIR`` and each ``NEW_DIR`` (default: this checkout) are roots of
checkouts, for example one unpacked from ``git archive`` of an earlier
commit.  All build the block kernels at the model's widths and the
attention kernels at once; then, in turns (old, new, ..., new, old), a
fresh process of each tree times at the main paths' shapes, float32
(CUDA-event means from ``chip_smoke.cuda_ms``):

- ``fused_encode_decode`` at B=300 (serving, T=50 and 10) and B=2048
  (training, dropout 0.1), and ``fused_block_bwd`` at B=2048;
- ``fused_attention`` and ``fused_attention_bwd`` at B=2048 and (Tq, Tk)
  in (50, 50), (10, 10), (1, 50), (1, 10);
- ``sorted_segment_sum_rows`` at the flagship's Sku union (N = 2048 x 111
  sorted rows, D = 32; ``scripts/segsum_variants.py`` ``FLAGSHIP_UNION``),
  bfloat16 and float32;
- the flagship's training step at batch 2048 (``chip_smoke.train_phase``
  on ``conf/dmt.conf``: CUDA events over 10 steps after 3 warm-up steps).

It prints ptxas's register and spill lines of each tree's block backward,
one ``<tree> RESULT {json}`` line a turn (trees named old, new, new2,
...), and a last ``SUMMARY {json}`` line with, for each timing, every
tree's two readings.  The spread between a tree's two readings bounds the
noise of the comparison.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

from segsum_variants import FLAGSHIP_UNION

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the build spec of a block kernel at the model's widths in either tree:
# trees from before the block kernels took other widths have one library
SPEC = ("(block.library(k, 80, 320, 4) if hasattr(block, 'library') "
        "else k)")

BUILD = f'''
from cikm2020_dmt_torch.ops import _build, block
specs = [{SPEC} for k in (block.KERNEL, block.BWD_KERNEL)]
_build.build(specs + ["attention_fwd", "attention_bwd", "sorted_segsum",
                      "update_rows"])
for line in _build.build_log(specs[1]).splitlines():
    if "registers" in line or "spill" in line:
        print("ptxas", line.strip())
'''

TIMING = FLAGSHIP_UNION + r'''
import json, torch
import chip_smoke as cs
from cikm2020_dmt_torch.core.config import TransformerConfig
from cikm2020_dmt_torch.nn.transformer import transformer_init
from cikm2020_dmt_torch.ops import attention as att, block
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda")
gen = torch.Generator(device=dev).manual_seed(0)
seed = torch.tensor([3], dtype=torch.int32, device=dev)
out = {}
for B, T, train in ((300, 50, False), (300, 10, False), (2048, 50, True),
                    (2048, 10, True)):
    p = transformer_init(gen, TransformerConfig(maxlen_k=T))
    ep, dp = p["enc"][0], p["dec"][0]
    kw = cs.block_inputs(T, torch.float32, gen, dev, B=B)
    if train:
        kw.update(train=True, rate=0.1, seed=seed)
    with torch.no_grad():
        out[f"block_fwd_B{B}_T{T}"] = cs.cuda_ms(
            lambda: block.fused_encode_decode(ep, dp, **kw), 20)
    if train:
        ew, dw = block.pack_weights(ep), block.pack_weights(dp)
        g = torch.randn(B, 80, generator=gen, device=dev)
        out[f"block_bwd_B{B}_T{T}"] = cs.cuda_ms(
            lambda: block.fused_block_bwd(ew, dw, g=g, **kw), 10)
for Tq, Tk in ((50, 50), (10, 10), (1, 50), (1, 10)):
    q, k, v, qm, km, do = cs._attention_inputs(2048, Tq, Tk, torch.float32,
                                               gen, dev)
    out[f"att_fwd_{Tq}x{Tk}"] = cs.cuda_ms(
        lambda: att.fused_attention(q, k, v, qm, km, 4), 20)
    out[f"att_bwd_{Tq}x{Tk}"] = cs.cuda_ms(
        lambda: att.fused_attention_bwd(q, k, v, qm, km, do, 4), 10)
from cikm2020_dmt_torch.ops import scatter_rows as sr
order, seg, pos, num = flagship_union(dev)
g32 = torch.randn(order.numel(), 32, generator=gen, device=dev)
for name, g in (("bf16", g32.to(torch.bfloat16)), ("f32", g32)):
    out[f"segsum_{name}"] = cs.cuda_ms(
        lambda: sr.sorted_segment_sum_rows(g, order, seg, num), 50)
del order, seg, pos, g32, g
torch.cuda.empty_cache()
out["flagship_step"] = cs.train_phase(
    DMTConfig.from_ini(cs.CONF), dev, cs.EXPECTED_PER_STEP["dmt"])["step_ms"]
print("RESULT " + json.dumps(out))
'''


def run(tree: str, code: str) -> str:
    return subprocess.run([sys.executable, "-c", code], cwd=tree,
                          env=dict(os.environ, PYTHONPATH=tree),
                          capture_output=True, text=True, check=True).stdout


def main() -> int:
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    news = sys.argv[2:] or [REPO]
    trees = {"old": os.path.abspath(sys.argv[1])}
    for i, d in enumerate(news):
        trees["new" + (str(i + 1) if i else "")] = os.path.abspath(d)
    builds = {name: subprocess.Popen(
        [sys.executable, "-c", BUILD], cwd=tree,
        env=dict(os.environ, PYTHONPATH=tree), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for name, tree in trees.items()}
    for name, proc in builds.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(f"{name} build failed:\n{log}")
            return 1
        for line in log.splitlines():
            print(f"{name} {line}")
    readings: dict = {}
    order = list(trees)
    for name in order + order[::-1]:
        line = next(s for s in run(trees[name], TIMING).splitlines()
                    if s.startswith("RESULT "))
        print(f"{name} {line}", flush=True)
        for key, ms in json.loads(line[7:]).items():
            readings.setdefault(key, {}).setdefault(name, []).append(ms)
    print("SUMMARY " + json.dumps(readings))
    return 0


if __name__ == "__main__":
    sys.exit(main())
