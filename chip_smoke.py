"""On-card smoke run of the PyTorch/CUDA port (``cikm2020_dmt_torch``).

Run from the root of a checkout on a machine with one CUDA card (H100):

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``cikm2020_dmt_torch/csrc``,
inits the flagship model of ``conf/dmt.conf`` at full width
(mmoe_transformer_unbias, Sku 5,000,000 x 32 in bf16, d_model 80) from a
seeded ``torch.Generator``, and serves three requests of 300 candidates
through ``serve.export.Scorer`` on the card.  It then

- checks that the main path launched the fused-block kernel three times
  per request (one per behavior sequence);
- holds the kernel against its plain PyTorch version on the card at the
  main path's shapes (B=300, T=50 and T=10) in float32 and bfloat16, with
  sequence lengths 0..T;
- holds the card's Scores against the same Scorer on the CPU;
- times the requests, the kernel, its plain version and the bound.

Every check raises on failure.  Before the last line it prints the card's
name and power limit (``nvidia-smi``) and one JSON line ``{"kernels":
[...]}``; the last line is ``{"ok": true, "device": {...}}``.  Without a
CUDA card it exits with code 2 and prints no result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

CONF = os.path.join(os.path.dirname(os.path.abspath(__file__)), "conf",
                    "dmt.conf")
SEED = 0
CANDIDATES = 300
# u-side sequence lengths (click, order, cart) of the three requests:
# full histories, a user with no order history, a user with no click or
# cart history
REQUEST_LENS = ((50, 50, 10), (17, 0, 3), (0, 33, 0))
# float32 peak outside the tensor cores and HBM rate of one H100 SXM
# (NVIDIA data sheet, 700 W)
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
# card vs CPU Scores: float32 on both sides, but sums run in another order
# in the kernel and in cuBLAS than on the CPU
SCORES_TOL = 1e-4
# kernel vs plain version on the same card: float32 differs only in the
# order of f32 sums; bfloat16 rounds the same operands at the same points,
# so a sum-order difference can at most flip the rounding of an
# intermediate or of the bf16 output (one ulp is 2**-6 at |x| in [2, 4))
KERNEL_TOL = {torch.float32: 1e-4, torch.bfloat16: 6.25e-2}


def log(msg: str) -> None:
    print(msg, flush=True)


def make_requests(cfg, n_candidates: int, lens_per_request, seed: int):
    """Assembled index batches with ``[1, L]`` u-side rows, made from a
    numpy seed: random raw dense features, random i-side ids, and u-side
    sequences of the given (click, order, cart) lengths."""
    from cikm2020_dmt_torch.data.pipeline import IDS, LEN, WTS
    from cikm2020_dmt_torch.data.schema import FeatureSchema

    rng = np.random.default_rng(seed)
    schema = FeatureSchema.from_config(cfg)
    ts_feats = set(cfg.attention_ts)
    group_of = {u: gi for gi, group in enumerate(cfg.attention_pairs)
                for u, _ in group}
    for gi, ts in enumerate(cfg.attention_ts):
        group_of[ts] = gi
    requests = []
    for lens in lens_per_request:
        req = {"raw_features": rng.uniform(
                   -1.0, 6.0, (n_candidates, cfg.feature_dimension)
               ).astype(np.float32),
               "valid": np.ones((n_candidates,), np.float32)}
        for f in schema.id_features:
            if f.side == "u":
                k = (min(lens[group_of[f.name]], f.max_len)
                     if f.name in group_of
                     else int(rng.integers(0, f.max_len + 1)))
                ids = np.zeros((1, f.max_len), np.int32)
                hi = 10**7 if f.name in ts_feats else f.id_size
                ids[0, :k] = rng.integers(1, hi, k)
                wts = (np.arange(f.max_len) < k).astype(np.float32)[None]
                lens_arr = np.array([k], np.int32)
            else:
                ids = np.zeros((n_candidates, f.max_len), np.int32)
                ids[:, 0] = rng.integers(1, f.id_size, n_candidates)
                wts = np.zeros((n_candidates, f.max_len), np.float32)
                wts[:, 0] = 1.0
                lens_arr = np.ones((n_candidates,), np.int32)
            req[f.name + IDS] = ids
            req[f.name + WTS] = wts
            req[f.name + LEN] = lens_arr
        requests.append(req)
    return requests


def check_scores(out: dict, n: int) -> None:
    for k in ("Scores", "click_Scores", "order_Scores"):
        v = out[k]
        if v.shape != (n,) or not np.isfinite(v).all():
            raise AssertionError(f"{k}: shape {v.shape}, finite "
                                 f"{bool(np.isfinite(v).all())}")
        if not ((v > 0) & (v < 1)).all():
            raise AssertionError(f"{k}: probabilities outside (0, 1)")


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean milliseconds of ``fn`` on the card over ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def block_inputs(T: int, dtype, gen, device):
    """Standard-normal enc_in [300, T, 80] and dec_in [300, 80], sequence
    lengths cycling through 0..T."""
    B, D = CANDIDATES, 80
    enc = (torch.randn(B, T, D, generator=gen, device=device)).to(dtype)
    dec = (torch.randn(B, D, generator=gen, device=device)).to(dtype)
    lens = torch.arange(B, device=device) % (T + 1)
    mask = (torch.arange(T, device=device)[None] < lens[:, None]).float()
    return dict(enc_in=enc, dec_in=dec, seq_mask=mask, num_heads=4)


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES
    if t_ops >= t_bytes:
        return t_ops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False); nothing was run", file=sys.stderr)
        return 2
    from cikm2020_dmt_torch.core.config import DMTConfig
    from cikm2020_dmt_torch.models.zoo import build_model
    from cikm2020_dmt_torch.ops import _build, block
    from cikm2020_dmt_torch.serve.export import Scorer, norm_constants

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    # ---- build every kernel of the path, in parallel ----
    t0 = time.perf_counter()
    seconds = _build.build([block.KERNEL])
    log(f"build: {json.dumps(seconds)} wall {time.perf_counter() - t0:.2f}s")
    for line in _build.build_log(block.KERNEL).splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log(f"  ptxas: {line.strip()}")

    # ---- the flagship model at full width, random weights from a seed ----
    cfg = DMTConfig.from_ini(CONF)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = build_model(cfg).init(gen)
    torch.cuda.synchronize()
    log(f"init: {cfg.model_type}, Sku "
        f"{tuple(params['emb']['Sku'].shape)} {params['emb']['Sku'].dtype}, "
        f"{time.perf_counter() - t0:.2f}s")
    nrng = np.random.default_rng(SEED)
    mean = nrng.normal(0.5, 1.0, cfg.feature_dimension)
    std = nrng.uniform(0.1, 3.0, cfg.feature_dimension)
    scale, const_vec = norm_constants(mean, std)
    scorer = Scorer(cfg, params, scale, const_vec)
    requests = make_requests(cfg, CANDIDATES, REQUEST_LENS, SEED)

    # ---- the main path: three requests, counted ----
    block.fused_encode_decode.launches = 0
    card = [scorer(r) for r in requests]
    torch.cuda.synchronize()
    launches = block.fused_encode_decode.launches
    log(f"main path: {len(requests)} requests of {CANDIDATES}, "
        f"fused_block_fwd launches {launches}")
    want = 3 * len(requests)
    if launches != want:
        raise AssertionError(f"fused_block_fwd launched {launches} times "
                             f"on the main path, expected {want}")
    for out in card:
        check_scores(out, CANDIDATES)

    # grouped scoring of the same requests gives the same Scores
    grouped = scorer.score_group(requests)
    g_err = float(np.abs(grouped["Scores"] - np.concatenate(
        [o["Scores"] for o in card])).max())
    log(f"score_group vs single requests: max |diff| {g_err:.3e}")
    if g_err > SCORES_TOL:
        raise AssertionError(f"grouped Scores differ by {g_err}")

    # ---- the card's Scores against the plain path on the CPU ----
    t0 = time.perf_counter()
    cpu_scorer = Scorer(cfg, params, scale, const_vec, device="cpu")
    s_err = 0.0
    for out, req in zip(card, requests):
        ref = cpu_scorer(req)
        for k in ref:
            s_err = max(s_err, float(np.abs(out[k] - ref[k]).max()))
    del cpu_scorer
    log(f"card vs CPU Scores: max |diff| {s_err:.3e} (tol {SCORES_TOL}), "
        f"{time.perf_counter() - t0:.2f}s")
    if not s_err <= SCORES_TOL:
        raise AssertionError(f"card Scores differ from the CPU by {s_err}")

    # ---- request latency (host clock, ends in the device-to-host copy) ----
    lat = []
    for i in range(30):
        t0 = time.perf_counter()
        scorer(requests[i % len(requests)])
        lat.append((time.perf_counter() - t0) * 1e3)
    lat = lat[5:]
    p50 = statistics.median(lat)
    p90 = sorted(lat)[int(0.9 * len(lat)) - 1]
    t0 = time.perf_counter()
    for _ in range(5):
        scorer.score_group(requests)
    group_ms = (time.perf_counter() - t0) * 1e3 / 5
    log(f"request latency over {len(lat)} requests of {CANDIDATES}: p50 "
        f"{p50:.3f} ms, p90 {p90:.3f} ms; group of {len(requests)}: "
        f"{group_ms:.3f} ms")

    # ---- the kernel against its plain version, and its times ----
    trans = params["trans"]
    seq_of_T = {50: trans["seq0"], 10: trans["seq2"]}
    kgen = torch.Generator(device=dev).manual_seed(SEED + 1)
    max_err = 0.0
    shapes = []
    for T, p in seq_of_T.items():
        ep, dp = p["enc"][0], p["dec"][0]
        for dtype in (torch.float32, torch.bfloat16):
            kw = block_inputs(T, dtype, kgen, dev)
            got = block.fused_encode_decode(ep, dp, **kw)
            ref = block.fused_encode_decode_ref(ep, dp, **kw)
            torch.cuda.synchronize()
            err = float((got.float() - ref.float()).abs().max())
            tol = KERNEL_TOL[dtype]
            dname = str(dtype).split(".")[-1]
            log(f"fused_block_fwd vs plain: B={CANDIDATES} T={T} {dname} "
                f"max |diff| {err:.3e} (tol {tol})")
            if not (torch.isfinite(got.float()).all() and err <= tol):
                raise AssertionError(f"fused_block_fwd disagrees at T={T} "
                                     f"{dname}: {err}")
            max_err = max(max_err, err)
            if dtype != torch.float32:
                continue  # the main path runs float32 (compute_dtype)
            ms = cuda_ms(lambda: block.fused_encode_decode(ep, dp, **kw), 50)
            plain = cuda_ms(
                lambda: block.fused_encode_decode_ref(ep, dp, **kw), 20)
            flops = block.block_flops(CANDIDATES, T, 80, 320)
            nbytes = block.block_bytes(CANDIDATES, T, 80, 320, 4)
            b_ms, by = bound(flops, nbytes)
            shapes.append({"B": CANDIDATES, "T": T, "dtype": dname,
                           "per_request": 2 if T == 50 else 1, "ms": ms,
                           "plain_ms": plain, "bound_ms": b_ms,
                           "bound_by": by, "flop": flops, "bytes": nbytes})
            log(f"fused_block_fwd B={CANDIDATES} T={T} f32: kernel {ms:.4f} "
                f"ms, plain {plain:.4f} ms, bound {b_ms:.4f} ms ({by}), "
                f"{flops / ms / 1e9:.2f} TFLOP/s")

    def per_request(key):
        return sum(s[key] * s["per_request"] for s in shapes)

    b_ops = sum(s["flop"] * s["per_request"] for s in shapes)
    b_bytes = sum(s["bytes"] * s["per_request"] for s in shapes)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"request p50 {p50:.3f} ms")
    print(smi)
    print(json.dumps({"kernels": [{
        "name": "fused_block_fwd",
        "route": "cuda",
        "source": "cikm2020_dmt_torch/csrc/fused_block_fwd.cu",
        "replaces": "cikm2020_dmt_tpu/ops/block.py:318",
        "launches": launches,
        "max_abs_err": max_err,
        # one request's launches: 2 at T=50 and 1 at T=10, B=300, f32
        "ms": per_request("ms"),
        "plain_ms": per_request("plain_ms"),
        "bound_ms": bound(b_ops, b_bytes)[0],
        "bound_by": bound(b_ops, b_bytes)[1],
        "library_ms": None,
        "library_note": "no single PyTorch call computes the encoder plus "
                        "decoder block (projections, masked attention, "
                        "LN, FF)",
        "unit": "ms per request: 2 launches at T=50 + 1 at T=10, B=300",
        "shapes": shapes,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
