"""Time variants of the fused-block backward kernel side by side on one card.

Run from the root of a checkout on a machine with one CUDA card:

    python3 scripts/block_bwd_variants.py [--tree DIR]

Each variant is a copy of the ``cikm2020_dmt_torch`` package of ``DIR``
(default: this checkout) in a temporary directory whose
``csrc/fused_block_bwd.cu`` skips one phase; the copies build their own
libraries, all at once, and then, one variant at a time, a fresh process
times ``fused_block_bwd`` at the flagship's
training shapes (B=2048, T=50 and T=10, D=80, F=320, 4 heads, float32,
dropout 0.1; CUDA-event means from ``chip_smoke.cuda_ms``) and prints its
norm-wise error against the plain version.  The phases:

- ``no_replay``: the forward replay (encoder and decoder);
- ``no_dec_bwd``: the decoder's backward (FF, layer norms, attention,
  ``d_dec`` and the gradient reaching the encoder's output);
- ``no_enc_ffln``: the encoder's FF and layer-norm backward;
- ``no_enc_att``: the encoder's attention backward;
- ``no_wgrad``: the weight-gradient accumulation;

and ``saved``, the unchanged source in the save mode (``DMT_BLOCK_SAVE``):
given the encoder's Q, K, V and attention context that the forward kernel
saved, the backward skips the encoder's projection and attention in its
replay (a tree without the save mode has no such variant).

Variants that skip a phase compute wrong gradients on purpose: their times
split the kernel's time by phase.  The unchanged source runs first and
last, so the spread between the two readings bounds the noise.  A source
that defines ``BLOCK_BWD_SKIP`` is cut by that compile-time mask (its bits
are ``SKIP_BITS``); the earlier source, which has none (one block an
SM with per-block partial weight grads), by replacing a few of its lines
(``OLD_SUBS``).  One line per variant: ``<name> RESULT
{json}`` with ptxas's register and spill lines, and for each T the ms and
the largest norm-wise error over the outputs.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = "cikm2020_dmt_torch/csrc/fused_block_bwd.cu"
SKIP_DEFINE = "#define BLOCK_BWD_SKIP 0"
SKIP_BITS = {"no_replay": 1, "no_dec_bwd": 2, "no_enc_ffln": 4,
             "no_enc_att": 8, "no_wgrad": 16}

_MARK = "    // ================= {} =================\n"
_ENC_HEADS = ("    for (int h = 0; h < H; ++h) {\n"
              "      head_probs(QKV + h * dh, LQ, QKV + D + h * dh, LQ, T, T, "
              "dh, km, km,\n"
              "                 scale, drop, kSiteEncProbs * 16 + h, b, S0, "
              "S1);\n"
              "      for (int idx = threadIdx.x; idx < T * dh; "
              "idx += blockDim.x) {\n"
              "        const int k = idx / dh;")
OLD_SUBS = {
    "no_replay": ((_MARK.format("replay: encoder"), "    if (b < 0) {\n"),
                  (_MARK.format("backward: decoder FF and LNs"),
                   "    }\n" + _MARK.format("backward: decoder FF and LNs"))),
    "no_dec_bwd": ((_MARK.format("backward: decoder FF and LNs"),
                    "    if (b < 0) {\n"),
                   (_MARK.format("backward: encoder FF and LNs"),
                    "    }\n")),
    "no_enc_ffln": ((_MARK.format("backward: encoder FF and LNs"),
                     "    if (b < 0) {\n"),
                    (_MARK.format("backward: encoder attention"), "    }\n")),
    "no_enc_att": ((_ENC_HEADS, _ENC_HEADS.replace("h < H", "h < 0")),),
    "no_wgrad": (("  const int groups = (M + RI - 1) / RI;",
                  "  const int groups = 0;"),
                 ("  for (int j = threadIdx.x; j < N; j += blockDim.x) {",
                  "  for (int j = threadIdx.x; j < 0; j += blockDim.x) {")),
}
VARIANTS = ("source", "saved", *SKIP_BITS, "source_again")

# run with the variant's name as its argument
TIMING = r'''
import json, sys, torch, chip_smoke as cs
from cikm2020_dmt_torch.core.config import TransformerConfig
from cikm2020_dmt_torch.nn.transformer import transformer_init
from cikm2020_dmt_torch.ops import block, _build
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda")
# the width-keyed library of this tree, or the source's one library in
# trees from before the block kernels took other widths
spec = (block.library(block.BWD_KERNEL, 80, 320, 4)
        if hasattr(block, "library") else "fused_block_bwd")
_build.build([spec])
out = {"ptxas": sorted({l.split(":", 1)[-1].strip() for l in
                        _build.build_log(spec).splitlines()
                        if "registers" in l or "spill" in l})}
gen = torch.Generator(device=dev).manual_seed(0)
seed = torch.tensor([3], dtype=torch.int32, device=dev)
for T in (50, 10):
    p = transformer_init(gen, TransformerConfig(maxlen_k=T))
    ew, dw = block.pack_weights(p["enc"][0]), block.pack_weights(p["dec"][0])
    kw = cs.block_inputs(T, torch.float32, gen, dev, B=2048)
    kw.update(train=True, rate=cs.DROPOUT, seed=seed)
    g = torch.randn(2048, 80, generator=gen, device=dev)
    if sys.argv[1] == "saved":
        kw["saved"] = block._fwd_kernel(
            ew, dw, kw["enc_in"], kw["dec_in"], kw["seq_mask"], 4, True,
            cs.DROPOUT, seed, save=True)[1]
    got = block.fused_block_bwd(ew, dw, g=g, **kw)
    err = cs._bwd_err(got, block.fused_block_bwd_ref(ew, dw, g=g, **kw))[0]
    ms = cs.cuda_ms(lambda: block.fused_block_bwd(ew, dw, g=g, **kw), 10,
                    warmup=2)
    out[f"T{T}"] = {"ms": ms, "err": err}
print("RESULT", json.dumps(out), flush=True)
'''


def cut(src: str, name: str) -> str:
    """The source with the phase of variant ``name`` skipped."""
    if name.startswith("source") or name == "saved":
        return src
    if SKIP_DEFINE in src:
        return src.replace(SKIP_DEFINE,
                           f"#define BLOCK_BWD_SKIP {SKIP_BITS[name]}")
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
    shutil.copy(os.path.join(tree, "chip_smoke.py"), d)
    path = os.path.join(d, SRC)
    with open(path) as f:
        src = f.read()
    with open(path, "w") as f:
        f.write(cut(src, name))
    # the saved variant also runs the forward kernel, in its save mode
    kernels = "(block.BWD_KERNEL, block.KERNEL)" if name == "saved" \
        else "(block.BWD_KERNEL,)"
    return subprocess.Popen(
        [sys.executable, "-c", "from cikm2020_dmt_torch.ops import _build, "
         "block; _build.build([block.library(k, 80, 320, 4) "
         "if hasattr(block, 'library') else k for k in " + kernels + "])"],
        cwd=d,
        env=dict(os.environ, PYTHONPATH=d), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def run_variant(name: str, root: str) -> str:
    d = os.path.join(root, name)
    r = subprocess.run([sys.executable, "-c", TIMING, name], cwd=d,
                       env=dict(os.environ, PYTHONPATH=d),
                       capture_output=True, text=True, timeout=900)
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
        print("block_bwd_variants: no CUDA card", file=sys.stderr)
        return 2
    tree = os.path.abspath(args.tree)
    with open(os.path.join(tree, "cikm2020_dmt_torch/ops/block.py")) as f:
        has_save = "def save_wanted" in f.read()
    variants = [v for v in VARIANTS if v != "saved" or has_save]
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
