"""On-card smoke run of the PyTorch/CUDA port (``cikm2020_dmt_torch``).

Run from the root of a checkout on a machine with one CUDA card (H100):

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``cikm2020_dmt_torch/csrc``
(one ``nvcc`` per source, all started together) and drives the port's
paths at full width, random weights from a seeded ``torch.Generator``, on
two configurations:

``conf/dmt.conf``, the flagship (mmoe_transformer_unbias, Sku 5,000,000 x
32 in bf16, d_model 80, one encoder and one decoder block per sequence,
which run the fused block kernels):

- serving: three requests of 300 candidates through ``serve.export.Scorer``;
  checks 3 fused-block forward launches per request, the card's Scores
  against the same Scorer on the CPU, and times the requests;
- training: ``train.loop.Trainer`` at batch 2048 with dropout on; checks
  one step at batch 256 (dropout off) against the same step on the CPU,
  exactly 3 block-forward, 3 block-backward, 1 segment-sum, 1 update_rows
  and 1 update_rows_3d launches per step, a finite loss that falls over 20
  steps on one batch, and times the steps (examples/s);
- the dense Adam (``adam_phase``): the multi-tensor kernel, 3 launches a
  training step (counted with the others above), on the flagship's dense
  leaves with one real step's gradients, the same bits as the plain step
  leaf by leaf (``adam_exact``; the 2+2 blocks' tree too, after their
  training phase), timed beside its bound and the plain path's time and
  kernels.

``conf/dmt_2block.conf`` (the same model with two encoder and two decoder
blocks per sequence and no transformer dropout, which run the per-op path
and its attention kernels):

- serving: as above, 12 attention-forward launches per request;
- eval: ``train.evaluate.run_eval`` on 4 batches of 4096, 12
  attention-forward launches per batch, one batch against the CPU;
- training: as above at dropout 0, 12 attention-forward and 12
  attention-backward launches per step besides the lazy update's three.

Each path is driven with every launch count set to 0 just before it and
read just after.  Then every kernel is held against its plain PyTorch
version on the card at the paths' shapes, and timed beside its bound and,
where one PyTorch call computes the same function, that call (and beside
its time in PR 5, ``*_PR5_MS``).  Besides the paths' shapes:

- the FF pre-activations that the block forward kernel formed must equal,
  bit for bit, those that the backward kernel's replay formed (T = 1, 10,
  50, 55, 128, float32 and bfloat16, dropout 0.1; ``check_replay``);
- the block kernels at other widths (``WIDTH_CASES``: a head of 12
  columns, two heads of 32 past 50 keys, T=200 spilling into the
  workspace, T=300 past the encoder attention's register tilings) and the
  attention kernels past 64 keys and with heads of 72 columns
  (``ATT_WIDTH_CASES``), each against its plain version with the main
  path's tolerances.

The save mode of the fused block (``DMT_BLOCK_SAVE=1``; every phase above
runs with it off): the forward kernel also writes the encoder's Q, K, V
and attention context and the backward reads them instead of forming them
again.  The phase checks

- at T = 1, 10, 50, 55, 128 (B=300) and at widths (36, 100, 3, 7), and at
  the flagship's training shapes (B=2048, T=50 and 10), float32 and
  bfloat16, dropout 0.1: the forward's output and the backward's 12
  outputs the same bits with the saved tensors as without them, and the
  saved tensors within ``KERNEL_TOL`` of the plain version's
  (``check_save``, ``save_block_phase``); at the training shapes, float32,
  both kernels timed in either mode beside their save-mode bounds;
- the flagship's ``Trainer`` at batch 2048 with the switch on: one step's
  loss the same bits as without it, and every parameter leaf that two runs
  without it produce bit-equal the same bits with it; per step exactly the
  launches of the path, 3 forward and 3 backward of them in the save mode;
  the step timed with the switch on and off in turns
  (``save_train_phase``).

The Python data path (``data_phase``, after the save mode): two TFRecord
shards of 2048 flagship-schema examples each (Zipf(1.3) ids as strings,
headers with pos and page), written with the port's ``encode_example``
and ``write_records`` into a temporary directory and read back through
``batch_stream`` and ``prefetch``; every batch held against what was
written (ids the port's ``VocabSet`` lookups of the written strings);
moved to the card by ``device_batch`` and trained on for 3 counted steps.
It prints the pipeline's host examples/s beside the step's.

Training from files as a user runs it (``files_phase``, after the data
phase): four shards of 2048 examples read back through the C++ assembler
(``data/native.py``, built with ``g++``; its host examples/s beside the
Python path's and the step's), every batch as written and equal to the
Python path's; the packed ``Trainer.device_batch`` timed and checked
against the unpacked copy; ``cli.train.main`` on ``conf/dmt.conf``'s
model for 4 steps with a save every 2 (exactly the training path's
launches per step, finite losses, every checkpoint with its DONE marker,
the result-file and summary lines), ``model.ckpt-4`` restored bit-equal
to the state the run ended with, and two runs resumed from
``model.ckpt-2`` under ``deterministic`` bit-equal to each other.

Evaluating, testing and serving that checkpoint as a user runs them
(``eval_serve_phase``, after the files phase, on its shards and its
``model.ckpt-4``): ``cli.valid --once`` and ``cli.test --grid_search``
with their result files checked, ``run_eval`` over the files timed and
one of its batches held against the port's CPU path, ``cli.export`` of a
float32 and an int8 bundle, ``load_scorer`` of each scoring the three
requests assembled from raw strings by ``ServingPreprocessor`` (float32
against a ``Scorer`` over the checkpoint, int8 against float32), request
latency through the preprocessor, and ``ScorerQueue`` under 4 threads;
exactly 3 block-forward launches per eval batch and per forward of a
request or a queue's group, and nothing else.

The rest of the model lattice and the paper baselines (``zoo_phase``,
after ``dmt_2block``): thirteen paths at full width with 1 + 1 blocks of
(80, 320, 4), the four demo configs as written (``conf/mlp_demo.conf``,
``embed_mlp_demo.conf``, ``transformer_demo.conf``,
``mmoe_transformer_demo.conf``), and ``multi_task``, ``mmoe``,
``multi_task_transformer``, ``embed_mlp_unbias`` and the baselines
``lr``, ``wnd``, ``dcn``, ``din`` and ``dien`` on ``conf/dmt.conf``.  Each
path: one step at batch 256 against the CPU (``card_vs_cpu_step``, batch
norm's moving statistics too), 5 timed steps at batch 2048 with exactly
``EXPECTED_PER_STEP[path]`` launches a step, ``run_eval`` over 2 batches
of 4096 and 25 requests of 300 through ``Scorer``, one block forward per
sequence group a batch or a request and nothing else.  The baselines run
no block: each training step launches exactly one segment sum, one
``update_rows`` and one ``update_rows_3d`` (Sku under lazy Adam), and
their eval and serving launch nothing.  Batch norm once
(``mmoe_transformer_demo`` with ``is_bn``: the card-vs-CPU step, and a
float32 bundle scoring as a ``Scorer`` over its checkpoint); ``din`` once
more as a user runs it (``din_files_check``: shards, ``cli.train`` with
the lazy update's three launches a step, ``cli.export`` of a float32 and
an int8 bundle, ``load_scorer`` of each scoring the three requests); and
the dense optimizers sgd, adadelta, adagrad, rmsprop and ftrl once each
(one step of ``embed_mlp_demo`` against the CPU, no kernel launched).

The data mesh (``mesh_phase``, after the eval/serve phase, on its shards):
ranks spawned by ``core.mesh.run_ranks``, the flagship at full width.
Two ranks sharing the card over gloo (Sku split, 2,500,000 rows a rank)
against one process at batch 4096 from the same seeded init: ``run_eval``
over 2 batches of 4096, then 3 steps of 2048 a rank with dropout off
(each loss within 1e-4, the state after the first and the last step by
``card_vs_cpu_step``'s rules, ``lazy_overflow``, the metric values;
exactly the training path's launches a step on each rank), then 2 steps
with dropout on (finite losses, the ranks' block masks differ), the row
fetch, the gradient push and the gradient ``all_reduce`` timed; one rank
over nccl, its step the same bits as the step without a mesh; and
``cli.train --num_processes 2`` for 2 steps and a save, whose checkpoint
restores in one process and evaluates as the ranks' gathered state.

The segment sum (``segsum_phase``) is also launched twice on each of its
inputs: the two results must be the same bits.

The block kernels are built for each width the run uses; every library is
built in one parallel batch first (``build_specs``).

Every check raises on failure.  The speed targets of the redesigned
kernels (the row writes no slower than ``index_put_``; the attention
backward and forward against SDPA and their time limits; the block
backward's time limits) are printed and recorded under ``targets``, not
enforced.  Before the last line it prints
the card's name and power limit (``nvidia-smi``) and one JSON line
``{"kernels": [...]}`` (the seven ported kernels and the dense Adam;
the two block kernels carry a ``save`` record of the save mode); the
last line is ``{"ok": true, "device": {...}}``.  Without a CUDA card it exits with code 2 and prints
no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

CONF = os.path.join(os.path.dirname(os.path.abspath(__file__)), "conf",
                    "dmt.conf")
CONF_2BLOCK = os.path.join(os.path.dirname(CONF), "dmt_2block.conf")
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
# the block backward against its plain version, norm-wise: ||a - b|| over
# ||b|| of each output.  A ReLU whose pre-activation lies within rounding
# of 0 can take the other branch in the kernel's replay than in the plain
# version's, which moves a few elements of a weight grad by a whole term
# (seen: 6.7e-3 of the output's largest |value| at T=10 in one run, 6.5e-7
# in another, and up to 5.0e-4 norm-wise; in one run at T=10, 4.6e-4
# norm-wise on the encoder's w1 where the float32 plain version stood
# 5.0e-7 from the float64 one, the worst element's unit had a live
# pre-activation of 5.6e-8: bwd_rounding_report prints this on every run);
# 1e-2 norm-wise bounds that with room, where a wrong product or mask
# gives errors of order 1.  In bfloat16 every product operand is rounded,
# and a sum in another order flips roundings that add up over the batch,
# so there both are held against the float32 plain version on the same
# inputs: the kernel may be off by at most twice the plain version's error
# (plus the float32 tolerance)
BWD_TOL_F32 = 1e-2
BWD_BF16_FACTOR = 2.0
TRAIN_BATCH = 2048          # conf/dmt.conf batch_size
CHECK_BATCH = 256           # the card-vs-CPU step
DROPOUT = 0.1               # conf/dmt.conf transformer_dropout_rate
KERNELS = ("fused_block_fwd", "fused_block_bwd", "sorted_segsum",
           "update_rows", "attention_fwd", "attention_bwd", "adam_dense")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_name_and_limit() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


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


def check_scores(out: dict, n: int, closed: bool = False) -> None:
    """Each score of the request finite and a probability in (0, 1), or
    with ``closed`` in [0, 1]: a paper baseline trained a few steps on
    ``conf/dmt.conf``'s class weights (400 for an order) reaches logits
    past 16, where float32's sigmoid is 1 (the reference's arithmetic;
    such paths are also held to the CPU's Scores)."""
    for k in ("Scores", "click_Scores", "order_Scores"):
        v = out[k]
        if v.shape != (n,) or not np.isfinite(v).all():
            raise AssertionError(f"{k}: shape {v.shape}, finite "
                                 f"{bool(np.isfinite(v).all())}")
        inside = ((v >= 0) & (v <= 1)) if closed else ((v > 0) & (v < 1))
        if not inside.all():
            raise AssertionError(f"{k}: probabilities outside "
                                 f"{'[0, 1]' if closed else '(0, 1)'}")


@functools.cache
def _sleep_cycles_per_ms() -> float:
    """Cycles of ``torch.cuda._sleep`` per device millisecond, measured
    once."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    torch.cuda._sleep(10 ** 7)
    end.record()
    torch.cuda.synchronize()
    return 10 ** 7 / start.elapsed_time(end)


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device milliseconds of ``fn`` over ``iters`` calls.  The timed
    calls are queued behind a device-side sleep that outlasts the host's
    time to issue them (measured on an untimed pass), so the events time
    the device's work back to back, not the host's launch overhead; a call
    that synchronises falls back to the host's pace from there on."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(_sleep_cycles_per_ms() * (1.5 * host_ms + 1.0)))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def block_inputs(T: int, dtype, gen, device, B: int = CANDIDATES):
    """Standard-normal enc_in [B, T, 80] and dec_in [B, 80], sequence
    lengths cycling through 0..T."""
    D = 80
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


def serve_path(cfg, dev, per_request: dict) -> dict:
    """The serving path on ``cfg`` at full width: three requests, counted,
    launching exactly ``per_request`` kernels per request and nothing
    else; their Scores against the same Scorer on the CPU; request
    latency.  Returns the params and the path's numbers."""
    from cikm2020_dmt_torch.models.zoo import build_model
    from cikm2020_dmt_torch.serve.export import Scorer, norm_constants

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
    reset_counts()
    card = [scorer(r) for r in requests]
    torch.cuda.synchronize()
    counts = read_counts()
    log(f"serving path: {len(requests)} requests of {CANDIDATES}, "
        f"launches {json.dumps(counts)}")
    want = {k: per_request.get(k, 0) * len(requests) for k in counts}
    if counts != want:
        raise AssertionError(f"serving launched {counts}, expected {want}")
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
    return {"params": params, "counts": counts, "p50": p50, "p90": p90,
            "group_ms": group_ms, "scores_err": s_err}


def serve_phase(cfg, dev) -> tuple[dict, dict]:
    """The flagship's serving path (3 fused-block forward launches per
    request): the fused block forward's entry of the kernels line, and the
    path's numbers."""
    from cikm2020_dmt_torch.ops import block

    serve = serve_path(cfg, dev, {"fused_block_fwd": 3})
    params, launches = serve["params"], serve["counts"]["fused_block_fwd"]
    p50 = serve["p50"]

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
                continue  # conf/dmt.conf serves in float32 (bf16: bf16_phase)
            ms = cuda_ms(lambda: block.fused_encode_decode(ep, dp, **kw), 50)
            plain = cuda_ms(
                lambda: block.fused_encode_decode_ref(ep, dp, **kw), 20)
            flops = block.block_flops(CANDIDATES, T, 80, 320)
            nbytes = block.block_bytes(CANDIDATES, T, 80, 320, 4)
            b_ms, by = bound(flops, nbytes)
            tc = block.block_tc_bound_ms(flops, dtype)
            shapes.append({"B": CANDIDATES, "T": T, "dtype": dname,
                           "per_request": 2 if T == 50 else 1, "ms": ms,
                           "plain_ms": plain, "bound_ms": b_ms,
                           "bound_by": by, "tc_bound_ms": tc, "flop": flops,
                           "bytes": nbytes})
            log(f"fused_block_fwd B={CANDIDATES} T={T} f32: kernel {ms:.4f} "
                f"ms (PR 5: {FWD_PR5_MS[(CANDIDATES, T)]}), plain "
                f"{plain:.4f} ms, bound {b_ms:.4f} ms ({by}) at the f32 FMA "
                f"peak, {tc:.4f} ms at the TF32 tensor-core peak for "
                f"3xTF32, {flops / ms / 1e9:.2f} TFLOP/s")

    def per_request(key):
        return sum(s[key] * s["per_request"] for s in shapes)

    b_ops = sum(s["flop"] * s["per_request"] for s in shapes)
    b_bytes = sum(s["bytes"] * s["per_request"] for s in shapes)
    log(f"request p50 {p50:.3f} ms")
    t50 = next(s for s in shapes if s["T"] == 50)
    targets = {"T50_below_plain": t50["ms"] < t50["plain_ms"]}
    log(f"fused_block_fwd targets at B={CANDIDATES} f32: "
        f"{json.dumps(targets)} (T=50 {t50['ms']:.4f} ms, plain "
        f"{t50['plain_ms']:.4f})")
    return {
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
        "targets": targets,
        "tc_bound_ms": per_request("tc_bound_ms"),
        "tc_bound_note": TC_BOUND_NOTE,
    }, serve


def _counted():
    from cikm2020_dmt_torch.ops import adam, attention, block, scatter_rows
    return {"fused_block_fwd": block.fused_encode_decode,
            "fused_block_bwd": block.fused_block_bwd,
            "attention_fwd": attention.fused_attention,
            "attention_bwd": attention.fused_attention_bwd,
            "sorted_segsum": scatter_rows.sorted_segment_sum_rows,
            "update_rows": scatter_rows.update_rows,
            "update_rows_3d": scatter_rows.update_rows_3d,
            "adam_dense": adam.adam_dense}


def reset_counts() -> None:
    for fn in _counted().values():
        fn.launches = 0
        if hasattr(fn, "save_launches"):
            fn.save_launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in _counted().items()}


def read_save_counts() -> dict:
    """The block kernels' launches in the save mode, a part of their
    launches (``read_counts``)."""
    return {name: fn.save_launches for name, fn in _counted().items()
            if hasattr(fn, "save_launches")}


def synthetic_batch(cfg, n: int, seed: int, device) -> dict:
    """A training batch from a numpy seed: normal dense features, a one-hot
    class mask, lengths 1..max_len and Zipf(1.3) ids (ranking traffic is
    heavy-tailed), timestamps uniform up to 10**7."""
    from cikm2020_dmt_torch.data.pipeline import IDS, LEN, WTS
    from cikm2020_dmt_torch.data.schema import FeatureSchema

    rng = np.random.default_rng(seed)
    classes = sorted(c for c, _ in cfg.train_weight)
    label = rng.choice([0, 0, 0, 1, 2, 4, 5], n)
    mask = np.zeros((n, len(classes)), np.float32)
    mask[np.arange(n), [classes.index(int(c)) for c in label]] = 1.0
    b = {"features": rng.normal(size=(n, cfg.feature_dimension)
                                ).astype(np.float32),
         "valid": np.ones((n,), np.float32), "mask": mask}
    ts_feats = set(cfg.attention_ts)
    for f in FeatureSchema.from_config(cfg).id_features:
        lens = rng.integers(1, f.max_len + 1, n).astype(np.int32)
        if f.name in ts_feats:
            ids = rng.integers(1, 10**7, (n, f.max_len))
        else:
            z = rng.zipf(1.3, (n, f.max_len)).astype(np.int64)
            ids = (z * 2654435761) % max(1, f.id_size)
        present = np.arange(f.max_len)[None, :] < lens[:, None]
        b[f.name + IDS] = (ids * present).astype(np.int32)
        b[f.name + WTS] = present.astype(np.float32)
        b[f.name + LEN] = lens
    return {k: torch.from_numpy(v).to(device) for k, v in b.items()}


SESSION = 12          # examples of one session in synthetic headers
USER_SESSIONS = 3     # sessions of one user


def synthetic_examples(cfg, n: int, seed: int) -> list[dict]:
    """``n`` Examples of ``cfg``'s schema (feature name -> values, as
    ``data/example.py`` ``encode_example`` takes them) from a numpy seed:
    normal dense features, a label and its one-hot mask, a tab-separated
    header of ``cfg.header_schema``'s fields whose pos and page run past
    the propensity tables' last entries, whose label is the example's,
    whose sid numbers sessions of ``SESSION`` consecutive examples and
    whose uuid numbers users of ``USER_SESSIONS`` sessions (``seed`` keeps
    them apart between calls; the offline metrics group by them), and per
    id feature the lengths ``synthetic_batch`` draws (1..max_len) of
    Zipf(1.3) ids written as decimal strings; timestamp features carry raw
    values below 10**7."""
    from cikm2020_dmt_torch.data.schema import FeatureSchema

    rng = np.random.default_rng(seed)
    schema = FeatureSchema.from_config(cfg)
    classes = sorted(c for c, _ in cfg.train_weight)
    labels = rng.choice([0, 0, 0, 1, 2, 4, 5], n)
    dense = rng.normal(size=(n, cfg.feature_dimension)).astype(np.float32)
    pos = rng.integers(0, 500, n)
    page = rng.integers(0, 120, n)
    where = schema.header_index
    ts_feats = set(cfg.attention_ts)
    cols = {}
    for f in schema.id_features:
        lens = rng.integers(1, f.max_len + 1, n)
        vals = (rng.integers(1, 10**7, (n, f.max_len))
                if f.name in ts_feats else rng.zipf(1.3, (n, f.max_len)))
        cols[f.name] = (lens, vals)
    out = []
    for i in range(n):
        header = [b"%s%d" % (name.encode(), i) for name in cfg.header_schema]
        header[where["pos"]] = b"%d" % pos[i]
        header[where["page"]] = b"%d" % page[i]
        session = seed * n + i // SESSION
        header[where["label"]] = b"%d" % labels[i]
        header[where["sid"]] = b"s%d" % session
        header[where["uuid"]] = b"u%d" % (session // USER_SESSIONS)
        mask = [0.0] * len(classes)
        mask[classes.index(int(labels[i]))] = 1.0
        ex = {"features": dense[i].tolist(), "label": [float(labels[i])],
              "mask": mask, "header": [b"\t".join(header)]}
        for name, (lens, vals) in cols.items():
            ex[name] = [b"%d" % v for v in vals[i, :lens[i]]]
        out.append(ex)
    return out


def write_shards(cfg, directory: str, shards: int, per_shard: int,
                 seed: int) -> list[list[dict]]:
    """Writes ``shards`` TFRecord files ``part-r-00000``, ... of
    ``per_shard`` ``synthetic_examples`` each into ``directory`` with the
    port's ``encode_example`` and ``write_records``; returns the examples,
    shard by shard."""
    from cikm2020_dmt_torch.data.example import encode_example
    from cikm2020_dmt_torch.data.tfrecord import write_records

    parts = []
    for s in range(shards):
        exs = synthetic_examples(cfg, per_shard, seed + s)
        write_records(os.path.join(directory, f"part-r-{s:05d}"),
                      (encode_example(e) for e in exs))
        parts.append(exs)
    return parts


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def replicated_leaves(tr, st: dict) -> dict:
    """Path -> a copy of each leaf of a rank's train state that every rank
    holds whole: the replicated params and their dense optimizer state,
    the model state, the replicated lazy tables and their moments, the
    step."""
    from cikm2020_dmt_torch.core.mesh import param_placement
    cfg, mesh = tr.cfg, tr.mesh
    out = {"/step": st["step"]}
    trees = [("/params", st["params"])] + [
        (f"/optimizer/{k}", v) for k, v in st["opt"].items()
        if isinstance(v, dict) and "emb" in v]
    for prefix, tree in trees:
        place = dict(_leaves(param_placement(cfg, tree, mesh)))
        out.update((prefix + path, leaf) for path, leaf in _leaves(tree)
                   if place[path] == "replicated")
    out.update(_leaves(st["model_state"], "/model_state"))
    for t in tr.lazy_plan:
        if not (t.full_mesh or t.sharded):
            out[f"/lazy_opt/{t.name}/mv"] = st["lazy_opt"][t.name]["mv"]
    return {k: v.detach().clone() for k, v in out.items()}


def card_vs_cpu_step(cfg, dev) -> dict:
    """One step at batch 256 with dropout off, on the card and on a CPU
    copy of the same state.  Adam's first m is 0.1 g, so the gradients are
    compared through it, norm-wise per leaf (a ReLU at the edge of 0 can
    take the other branch on the card, which moves a few elements by a
    whole term: see BWD_TOL_F32; the largest elementwise error is
    printed): 1e-2 for float32 leaves, one bfloat16 step (2**-7) for the
    bf16 tables, whose gradient is rounded to bf16 once after a float32 sum
    taken in another order; leaves whose gradient is zero in exact
    arithmetic (rounding noise only, below 1e-6 of the largest |g| of all
    leaves) are skipped.  Params within 2 lr (the most one Adam step moves
    an element whose near-zero gradient flips sign under another sum
    order) plus, for bf16 tables, one bf16 step of the largest |value|;
    and, since one Adam step moves an element by about lr whatever its
    gradient (so a skipped, halved or doubled update would pass 2 lr),
    the median |card - CPU| over the elements the CPU step moved below
    1e-6, per leaf with a clear gradient.  v (0.001 g**2) within twice the
    gradient's tolerance."""
    from cikm2020_dmt_torch.metrics.streaming import task_metrics_init
    from cikm2020_dmt_torch.nn.layers import tree_map
    from cikm2020_dmt_torch.train.loop import Trainer

    cfg0 = no_dropout(cfg)
    t0 = time.perf_counter()
    card, cpu = Trainer(cfg0, device=dev), Trainer(cfg0, device="cpu")
    state = card.init_state(torch.Generator(device=dev).manual_seed(SEED))
    state_cpu = tree_map(lambda t: t.cpu().clone(), state)
    # the lazy tables are updated in place: keep the params before the step
    before = tree_map(lambda t: t.clone(), state_cpu["params"])
    batch = synthetic_batch(cfg, CHECK_BATCH, SEED + 10, dev)
    s1, _, loss = card.train_step(state, task_metrics_init(dev), batch,
                                  torch.Generator(device=dev))
    s2, _, loss_cpu = cpu.train_step(
        state_cpu, task_metrics_init(),
        {k: v.cpu() for k, v in batch.items()}, torch.Generator())
    torch.cuda.synchronize()
    loss_err = abs(float(loss) - float(loss_cpu)) / abs(float(loss_cpu))
    lr = cfg.learning_rate[0]
    dtype_of = dict((p, t.dtype) for p, t in _leaves(s2["params"]))

    def tol(path):
        key = ("/emb/" + path.split("/")[1] if path.startswith("lazy/")
               else path)
        return 2.0 ** -7 if dtype_of[key] == torch.bfloat16 else BWD_TOL_F32

    grads = [(p, a, b) for (p, a), (_, b) in zip(_leaves(s1["opt"]["m"]),
                                                  _leaves(s2["opt"]["m"]))]
    for name, sub in s1["lazy_opt"].items():
        rows = torch.unique(batch_ids(cfg, batch, name)).cpu()
        grads.append((f"lazy/{name}/m", sub["mv"][0].cpu()[rows],
                      s2["lazy_opt"][name]["mv"][0][rows]))
    top = max(float(b.abs().max()) for _, _, b in grads)
    noise = set()
    g_err = g_max = 0.0
    for path, a, b in grads:
        if float(b.abs().max()) < 1e-6 * top:
            noise.add(path)
            continue
        d = a.cpu().float() - b.float()
        err = float(d.norm() / b.float().norm())
        g_err = max(g_err, err)
        g_max = max(g_max, float(d.abs().max() / b.abs().max()))
        if not err <= tol(path):
            raise AssertionError(f"card vs CPU gradient {path}: norm-wise "
                                 f"{err:.3e} (tol {tol(path)})")
    p_err = p_med = 0.0
    before = dict(_leaves(before))
    for (path, a), (_, b) in zip(_leaves(s1["params"]),
                                 _leaves(s2["params"])):
        bf16 = b.dtype == torch.bfloat16
        a, b = a.cpu().float(), b.float()
        p_tol = 2 * lr + (2.0 ** -7 * float(b.abs().max()) if bf16
                          else 0.0)
        d = (a - b).abs()
        err = float(d.max())
        p_err = max(p_err, err / p_tol)
        if not err <= p_tol:
            raise AssertionError(f"card vs CPU param {path}: {err:.3e} "
                                 f"(tol {p_tol:.3e})")
        parts = path.split("/")
        grad_path = (f"lazy/{parts[2]}/m" if parts[1] == "emb"
                     and parts[2] in s1["lazy_opt"] else path)
        moved = b != before[path].float()
        if grad_path in noise or int(moved.sum()) == 0:
            continue
        med = float(d[moved].median())
        p_med = max(p_med, med)
        if not med <= 1e-6:
            raise AssertionError(f"card vs CPU param {path}: median |diff| "
                                 f"{med:.3e} over the moved elements "
                                 "(tol 1e-6)")
    # batch norm's moving statistics (0.001 of the batch's after one step
    # from zero): norm-wise per leaf, as the float32 gradients
    st_err = 0.0
    for (path, a), (_, b) in zip(_leaves(s1["model_state"]),
                                 _leaves(s2["model_state"])):
        err = float((a.cpu().float() - b.float()).norm()
                    / b.float().norm().clamp(min=1e-30))
        st_err = max(st_err, err)
        if not err <= BWD_TOL_F32:
            raise AssertionError(f"card vs CPU model state {path}: "
                                 f"norm-wise {err:.3e}")
    v_pairs = [(p, a, b) for (p, a), (_, b) in zip(_leaves(s1["opt"]["v"]),
                                                    _leaves(s2["opt"]["v"]))]
    v_pairs += [(f"lazy/{n}/v", s["mv"][1].cpu(), s2["lazy_opt"][n]["mv"][1])
                for n, s in s1["lazy_opt"].items()]
    v_top = max(float(b.abs().max()) for _, _, b in v_pairs)
    v_err = 0.0
    for path, a, b in v_pairs:
        if float(b.abs().max()) < 1e-6 * v_top:
            continue
        err = float((a.cpu() - b).norm() / b.norm())
        v_err = max(v_err, err)
        if not err <= 2 * tol(path):
            raise AssertionError(f"card vs CPU moment {path}: {err:.3e}")
    out = {"loss_rel_err": loss_err, "grad_err": g_err,
           "grad_err_max": g_max, "param_err_over_tol": p_err,
           "param_median_err": p_med, "v_err": v_err,
           "model_state_err": st_err, "seconds": time.perf_counter() - t0}
    log(f"card vs CPU step, batch {CHECK_BATCH}, dropout off: loss "
        f"{float(loss):.6f} vs {float(loss_cpu):.6f} (rel {loss_err:.2e}, "
        f"tol 1e-4); grads norm-wise {g_err:.2e} (tol 1e-2 f32, 2**-7 bf16 "
        f"tables), largest element {g_max:.2e} of its leaf's max; params "
        f"{p_err:.3f} of 2 lr (+ bf16 step), largest per-leaf median "
        f"{p_med:.2e} (tol 1e-6); v norm-wise {v_err:.2e}; moving "
        f"statistics norm-wise {st_err:.2e}; {out['seconds']:.1f}s")
    if not loss_err <= 1e-4:
        raise AssertionError(f"card vs CPU loss: {loss_err}")
    return out


def batch_ids(cfg, batch, table):
    from cikm2020_dmt_torch.data.pipeline import IDS
    return torch.cat([batch[s.feature + IDS].reshape(-1).long()
                      for s in cfg.embeddings if s.table == table])


# launches per training step, by config: the flagship's 1+1 stacks run the
# fused block; the 2+2 stacks run the per-op path, whose attention core is
# the attention kernel at dropout 0: 3 sequences x (2 encoder + 2 decoder
# blocks); the dense Adam one launch per ops/adam.py MAX_LEAVES (63) dense
# leaves: 138 leaves in 3, 222 in 4
LAZY_PER_STEP = {"sorted_segsum": 1, "update_rows": 1, "update_rows_3d": 1}
EXPECTED_PER_STEP = {
    "dmt": {"fused_block_fwd": 3, "fused_block_bwd": 3, **LAZY_PER_STEP,
            "adam_dense": 3},
    "dmt_2block": {"attention_fwd": 12, "attention_bwd": 12,
                   **LAZY_PER_STEP, "adam_dense": 4},
}


def timed_steps(tr, state, metrics, batches, gen, steps):
    """``steps`` training steps over ``batches`` in turn, every launch
    count set to 0 just before them and read just after: (state, metrics,
    losses, counts, step ms by CUDA events, step ms by the host clock)."""
    reset_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    losses = []
    for i in range(steps):
        state, metrics, loss = tr.train_step(state, metrics,
                                             batches[i % len(batches)], gen)
        losses.append(loss)
    end.record()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    counts = read_counts()
    return (state, metrics, [float(x) for x in losses], counts,
            start.elapsed_time(end) / steps, wall_ms)


def train_phase(cfg, dev, expected: dict, batch: int = None,
                steps: int = 10) -> dict:
    """The training path at ``batch`` (default ``TRAIN_BATCH``) with the
    config's dropout: 3 warm-up steps, ``steps`` timed steps (counted:
    exactly ``expected`` launches per step, every other kernel none), then
    20 steps on one batch whose loss must fall.  Returns the step's
    numbers, and the trainer with its state, metrics, dropout generator
    and batches for what runs after it."""
    from cikm2020_dmt_torch.metrics.streaming import (task_metrics_init,
                                                      task_metrics_values)
    from cikm2020_dmt_torch.train.loop import Trainer

    batch = batch or TRAIN_BATCH
    tr = Trainer(cfg, device=dev)
    state = tr.init_state(torch.Generator(device=dev).manual_seed(SEED))
    batches = [synthetic_batch(cfg, batch, SEED + 100 + i, dev)
               for i in range(4)]
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    metrics = task_metrics_init(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    for i in range(3):
        state, metrics, _ = tr.train_step(state, metrics, batches[i % 4], gen)
    torch.cuda.synchronize()

    # ---- the main path: timed steps, counted ----
    state, metrics, losses, counts, step_ms, wall_ms = timed_steps(
        tr, state, metrics, batches, gen, steps)
    eps = batch / (step_ms / 1e3)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    log(f"training path: {steps} steps at batch {batch}, dropout "
        f"{cfg.transformer.dropout_rate}: launches {json.dumps(counts)}")
    log(f"training step: {step_ms:.3f} ms (CUDA events; host clock "
        f"{wall_ms:.3f} ms), {eps:.1f} examples/s, peak memory "
        f"{peak_gb:.2f} GB, losses {losses[0]:.4f}..{losses[-1]:.4f}, "
        f"metrics {json.dumps(task_metrics_values(metrics))}")
    for name, n in counts.items():
        per = expected.get(name, 0)
        if n != per * steps:
            raise AssertionError(f"{name} launched {n} times in {steps} "
                                 f"steps, expected {per} per step")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training loss: {losses}")

    # ---- 20 steps on one batch: the loss falls ----
    rep = []
    for _ in range(20):
        state, metrics, loss = tr.train_step(state, metrics, batches[0], gen)
        rep.append(float(loss))
    log(f"one batch, 20 steps: loss {rep[0]:.4f} -> {rep[-1]:.4f}")
    if not (np.isfinite(rep).all() and np.mean(rep[-3:]) < rep[0]):
        raise AssertionError(f"the loss did not fall on one batch: {rep}")
    return {"counts": counts, "step_ms": step_ms, "wall_ms": wall_ms,
            "examples_per_s": eps, "peak_gb": peak_gb, "trainer": tr,
            "state": state, "metrics": metrics, "gen": gen,
            "batches": batches}


DATA_SHARDS = 2


def check_file_batch(cfg, batch, examples, vocabs) -> None:
    """A batch that ``batch_stream`` assembled against the examples it was
    read from: dense features, label, mask and headers as written; every
    id feature's length as written, weights 1 over it and 0 past it, ids
    the port's ``VocabSet`` lookups of the written strings (timestamps
    their values) and 0 past the length; pos and page clipped to the
    propensity tables, every weight 1 (no propensity file)."""
    from cikm2020_dmt_torch.data.pipeline import IDS, LEN, WTS
    from cikm2020_dmt_torch.data.propensity import MAX_PAGE, MAX_POSITION
    from cikm2020_dmt_torch.data.schema import FeatureSchema

    n = len(examples)
    if batch.size != n or not batch["valid"].all():
        raise AssertionError(f"file batch of {batch.size}, want {n} valid")
    want = {"features": np.array([e["features"] for e in examples],
                                 np.float32),
            "label": np.array([e["label"][0] for e in examples], np.float32),
            "mask": np.array([e["mask"] for e in examples], np.float32)}
    where = FeatureSchema.from_config(cfg).header_index
    fields = [e["header"][0].split(b"\t") for e in examples]
    want["em_position"] = np.minimum(
        [int(h[where["pos"]]) for h in fields], MAX_POSITION)
    want["em_page"] = np.minimum([int(h[where["page"]]) for h in fields],
                                 MAX_PAGE)
    for k in ("propensity", "propensity_weight",
              "propensity_weight_positive", "propensity_weight_mul"):
        want[k] = np.ones(n, np.float32)
    ts_feats = set(cfg.attention_ts)
    for f in FeatureSchema.from_config(cfg).id_features:
        lens = np.array([len(e[f.name]) for e in examples])
        ids = np.zeros((n, f.max_len), np.int64)
        look = {}
        for i, e in enumerate(examples):
            for j, v in enumerate(e[f.name]):
                if v not in look:
                    look[v] = (int(v) if f.name in ts_feats
                               else vocabs.by_feature[f.name].lookup_one(v))
                ids[i, j] = look[v]
        want[f.name + IDS] = ids
        want[f.name + LEN] = lens
        want[f.name + WTS] = (np.arange(f.max_len)[None]
                              < lens[:, None]).astype(np.float32)
    for k, v in want.items():
        if not np.array_equal(batch[k], v):
            raise AssertionError(f"file batch: {k} differs from what was "
                                 "written")
    if batch.headers != [e["header"][0] for e in examples]:
        raise AssertionError("file batch: headers differ from what was "
                             "written")


def data_phase(cfg, tr, state, gen, dev, expected: dict) -> dict:
    """The Python data path at the flagship's full width: two TFRecord
    shards of ``TRAIN_BATCH`` ``synthetic_examples`` each, written into a
    temporary directory and read back through ``batch_stream`` and
    ``prefetch`` (host clock: the pipeline's examples/s); each batch held
    against what was written (``check_file_batch``); the batches moved to
    the card (``device_batch``: the dtypes and shapes of
    ``synthetic_batch``) and 3 ``Trainer`` steps run from them, counted
    (exactly ``expected`` launches per step) and timed by CUDA events."""
    from cikm2020_dmt_torch.data.pipeline import (batch_stream,
                                                  device_batch, prefetch)
    from cikm2020_dmt_torch.data.vocab import VocabSet
    from cikm2020_dmt_torch.metrics.streaming import task_metrics_init

    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        parts = write_shards(cfg, d, DATA_SHARDS, TRAIN_BATCH, SEED + 300)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        batches = list(prefetch(batch_stream(cfg, d + "/", TRAIN_BATCH)))
        read_s = time.perf_counter() - t0
    n = DATA_SHARDS * TRAIN_BATCH
    host_eps = n / read_s
    if len(batches) != DATA_SHARDS:
        raise AssertionError(f"{len(batches)} batches read back, want "
                             f"{DATA_SHARDS}")
    vocabs = VocabSet(cfg.embeddings + cfg.embeddings_bias, cfg.vocab_path)
    for b, exs in zip(batches, parts):
        check_file_batch(cfg, b, exs, vocabs)
    t0 = time.perf_counter()
    dbs = [device_batch(b, dev) for b in batches]
    torch.cuda.synchronize()
    xfer_ms = (time.perf_counter() - t0) * 1e3 / len(dbs)
    like = synthetic_batch(cfg, TRAIN_BATCH, SEED, dev)
    for k, v in like.items():
        got = dbs[0][k]
        if got.dtype != v.dtype or got.shape != v.shape or \
                got.device != v.device:
            raise AssertionError(f"device_batch {k}: {got.dtype} "
                                 f"{tuple(got.shape)} on {got.device}, "
                                 f"synthetic_batch {v.dtype} "
                                 f"{tuple(v.shape)} on {v.device}")
    steps = 3
    state, _, losses, counts, step_ms, wall_ms = timed_steps(
        tr, state, task_metrics_init(dev), dbs, gen, steps)
    for name, k in counts.items():
        if k != expected.get(name, 0) * steps:
            raise AssertionError(f"data phase: {name} launched {k} times "
                                 f"in {steps} steps, expected "
                                 f"{expected.get(name, 0)} per step")
    if not np.isfinite(losses).all():
        raise AssertionError(f"data phase: non-finite loss {losses}")
    step_eps = TRAIN_BATCH / (step_ms / 1e3)
    log(f"data phase: {DATA_SHARDS} shards of {TRAIN_BATCH} examples "
        f"written in {write_s:.2f}s, read back through batch_stream + "
        f"prefetch in {read_s:.3f}s: {host_eps:.1f} examples/s on the host; "
        f"batches as written; device_batch {xfer_ms:.3f} ms a batch (host "
        f"clock, synchronised); {steps} steps from them: {step_ms:.3f} ms "
        f"(CUDA events; host clock {wall_ms:.3f} ms), {step_eps:.1f} "
        f"examples/s, losses {losses}, launches {json.dumps(counts)}; the "
        f"pipeline feeds {host_eps / step_eps:.4f} of what the step takes")
    return {"host_examples_per_s": host_eps, "step_examples_per_s": step_eps,
            "step_ms": step_ms, "read_s": read_s, "write_s": write_s,
            "device_batch_ms": xfer_ms, "counts": counts, "state": state}


FILE_SHARDS = 4
FILE_STEPS = 4
FILE_SAVE_EVERY = 2


def write_conf(cfg, path: str, data_path: str, output_path: str,
               **paths) -> None:
    """``conf/dmt.conf`` with ``cfg``'s model type, widths, tables, batch
    norm, optimizer, batch sizes, save cadence, transformer dropout and
    int8 export threshold, its training data read from ``data_path``, its
    output (checkpoints, result files, summaries) under ``output_path`` and
    any other ``[path]`` entry set by ``paths``: a config file that the
    CLIs read as ``cfg``."""
    import configparser

    cp = configparser.ConfigParser()
    cp.read(CONF)
    model = {"model_type": cfg.model_type,
             "feature_dimension": cfg.feature_dimension,
             "hidden_units": cfg.hidden_units,
             "hidden_units_bottom": cfg.hidden_units_bottom,
             "hidden_units_task": cfg.hidden_units_task,
             "num_experts": cfg.num_experts, "is_bn": cfg.is_bn,
             "optimizer": cfg.optimizer, "batch_size": cfg.batch_size,
             "validation_batch_size": cfg.validation_batch_size,
             "test_batch_size": cfg.test_batch_size,
             "validate_step": cfg.validate_step,
             "transformer_dropout_rate": cfg.transformer.dropout_rate}
    for k, v in model.items():
        cp["model"][k] = (",".join(map(str, v)) if isinstance(v, tuple)
                          else str(v))

    def specs(s):
        return "#".join(f"{e.table}:{e.id_size}:{e.dim}:{e.feature}:{e.side}"
                        for e in s)

    cp["embedding"]["emb"] = specs(cfg.embeddings)
    cp["embedding"]["emb_bias"] = specs(cfg.embeddings_bias)
    cp["embedding"]["attention_embed"] = "|".join(
        "#".join(f"{a}:{b}" for a, b in group)
        for group in cfg.attention_pairs)
    cp["embedding"]["attention_embed_seq_ts"] = "|".join(cfg.attention_ts)
    cp["path"]["output_path"] = output_path
    cp["path"]["summary_path"] = os.path.join(output_path, "summary")
    cp["path"]["train_data_path"] = data_path
    cp["path"]["train_data_stat_path"] = ""
    for k, v in paths.items():
        cp["path"][k] = v
    cp["export_model"]["export_int8_rows"] = str(cfg.export_int8_rows)
    with open(path, "w") as f:
        cp.write(f)


def _same_bits(a: dict, b: dict, what: str) -> int:
    """Raises unless the two states hold the same leaves, dtypes and bits;
    returns the number of leaves."""
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    bad = [k for k in la if k not in lb or la[k].dtype != lb[k].dtype
           or not torch.equal(la[k], lb[k])]
    if bad or set(la) != set(lb):
        raise AssertionError(f"{what}: leaves differ: {bad[:5]} "
                             f"(of {len(la)}; keys {set(la) ^ set(lb)})")
    return len(la)


def files_phase(cfg, dev, expected: dict, python_eps: float,
                unpacked_ms: float, step_eps: float, d: str) -> dict:
    """Training from files as a user runs it, at ``cfg``'s width:

    - ``FILE_SHARDS`` TFRecord shards of ``TRAIN_BATCH`` examples written
      and read back through the C++ assembler (``native_batch_stream``;
      host clock, the library's build apart): every batch as written
      (``check_file_batch``) and equal, array for array and header for
      header, to the Python path's batches of the same files;
    - ``Trainer.device_batch`` with the packed transfer: ms a batch on the
      host clock, synchronised, one pinned staging reused as the loop
      reuses it; unpacked on the card it equals ``pipeline.device_batch``;
    - ``cli.train.main`` for ``FILE_STEPS`` steps with a save every
      ``FILE_SAVE_EVERY``, into a temporary output directory, counted:
      exactly ``expected`` launches per step; finite losses; every
      checkpoint with its DONE marker; the result-file blocks and summary
      lines of each save;
    - ``model.ckpt-4`` restored onto the card: the bits of the state the
      run ended with;
    - two runs resumed from ``model.ckpt-2`` to step 4 under
      ``deterministic``, counted: the same bits.

    Everything is written under the directory ``d`` (a few GB of
    checkpoints at the flagship's width), which the caller removes; the
    eval and serving phase reads the shards and checkpoints from there.
    Returns the numbers and the paths (``data``, ``conf``)."""
    from cikm2020_dmt_torch.cli import train as cli_train
    from cikm2020_dmt_torch.core.checkpoint import CheckpointManager
    from cikm2020_dmt_torch.core.config import DMTConfig
    from cikm2020_dmt_torch.data import native
    from cikm2020_dmt_torch.data.pipeline import batch_stream, device_batch
    from cikm2020_dmt_torch.data.vocab import VocabSet
    from cikm2020_dmt_torch.train.loop import Staging, Trainer

    cfg = dataclasses.replace(cfg, validate_step=FILE_SAVE_EVERY)
    out = {}
    data = os.path.join(d, "data")
    os.makedirs(data)
    t0 = time.perf_counter()
    parts = write_shards(cfg, data, FILE_SHARDS, TRAIN_BATCH, SEED + 400)
    out["write_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    native.load_library()
    out["build_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    batches = list(native.native_batch_stream(cfg, data + "/",
                                              TRAIN_BATCH))
    out["read_s"] = time.perf_counter() - t0
    n = FILE_SHARDS * TRAIN_BATCH
    out["host_examples_per_s"] = n / out["read_s"]
    if len(batches) != FILE_SHARDS:
        raise AssertionError(f"{len(batches)} native batches, want "
                             f"{FILE_SHARDS}")
    vocabs = VocabSet(cfg.embeddings + cfg.embeddings_bias,
                      cfg.vocab_path)
    for b, exs in zip(batches, parts):
        check_file_batch(cfg, b, exs, vocabs)
    t0 = time.perf_counter()
    py = list(batch_stream(cfg, data + "/", TRAIN_BATCH))
    out["python_read_s"] = time.perf_counter() - t0
    for b, p in zip(batches, py):
        bad = [k for k, v in p.arrays.items()
               if not np.array_equal(v, b[k]) or v.dtype != b[k].dtype]
        if bad or set(b.arrays) != set(p.arrays) or \
                b.headers != p.headers:
            raise AssertionError(f"native batch differs from the Python "
                                 f"path's: {bad}")
    del parts, py

    # ---- the packed transfer ----
    tr = Trainer(cfg, device=dev)
    staging = Staging()
    for b in batches:
        got = Trainer.unpack_device_batch(tr.device_batch(b, staging),
                                          tr._pack_layout)
        want = device_batch(b, dev)
        bad = [k for k, v in want.items()
               if got[k].dtype != v.dtype or not torch.equal(got[k], v)]
        if bad or set(got) != set(want):
            raise AssertionError(f"packed device_batch differs: {bad}")
    torch.cuda.synchronize()
    rounds = 3
    t0 = time.perf_counter()
    for _ in range(rounds):
        for b in batches:
            tr.device_batch(b, staging)
    torch.cuda.synchronize()
    out["device_batch_ms"] = ((time.perf_counter() - t0) * 1e3
                              / (rounds * len(batches)))
    del tr, staging, got, want

    # ---- cli.train over the files ----
    output = os.path.join(d, "out")
    conf = os.path.join(d, "dmt.conf")
    write_conf(cfg, conf, data + "/", output)
    read = DMTConfig.from_ini(conf)
    if dataclasses.replace(read, output_path="", summary_path="",
                           train_data_path="",
                           train_data_stat_path="") != dataclasses.replace(
            cfg, output_path="", summary_path="", train_data_path="",
            train_data_stat_path=""):
        raise AssertionError("the written config does not read back as "
                             "the phase's config")
    argv = ["--conf_file", conf, "--log_every", "1", "--device",
            str(dev)]

    def run(extra, steps):
        reset_counts()
        t0 = time.perf_counter()
        trainer = cli_train.main(argv + extra)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        want = {k: expected.get(k, 0) * steps for k in counts}
        if counts != want:
            raise AssertionError(f"files phase: launches {counts}, want "
                                 f"{want} ({steps} steps)")
        return trainer, counts, wall

    tr, out["counts"], out["train_s"] = run(
        ["--max_steps", str(FILE_STEPS)], FILE_STEPS)
    mgr = CheckpointManager(read.model_path)
    saves = list(range(FILE_SAVE_EVERY, FILE_STEPS + 1, FILE_SAVE_EVERY))
    if tr.last_step != FILE_STEPS or mgr.all_steps() != saves or \
            not all(mgr.has_step(s) for s in saves):
        raise AssertionError(f"files phase: last step {tr.last_step}, "
                             f"checkpoints {mgr.all_steps()}, want "
                             f"{saves} with DONE markers")
    with open(read.train_result_path) as f:
        blocks = [line for line in f.read().splitlines()
                  if line.startswith(">> iter_steps:")]
    with open(os.path.join(read.summary_path, "train.jsonl")) as f:
        summary = [json.loads(line) for line in f]
    values = [v for s in summary for k, v in s.items()
              if k not in ("step", "time")]
    if blocks != [f">> iter_steps:{s}" for s in saves] or \
            [s["step"] for s in summary] != saves or \
            not np.isfinite(values).all():
        raise AssertionError(f"files phase: result blocks {blocks}, "
                             f"summary {summary}")
    out["save_s"] = dict(tr.save_seconds)
    out["losses"] = [s["loss"] for s in summary]
    out["metrics"] = summary[-1]

    # ---- restore: the bits of the state the run ended with ----
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restored = mgr.restore(FILE_STEPS, dev)
    torch.cuda.synchronize()
    out["restore_s"] = time.perf_counter() - t0
    out["leaves"] = _same_bits(restored, tr.state,
                               f"model.ckpt-{FILE_STEPS} restored")
    del restored, tr
    torch.cuda.empty_cache()

    # ---- two resumed runs: the same bits ----
    states, out["resume_s"] = [], []
    for _ in range(2):
        with deterministic():
            t, counts, wall = run(
                ["--max_steps", str(FILE_STEPS), "--model_ckpt",
                 f"model.ckpt-{FILE_SAVE_EVERY}"],
                FILE_STEPS - FILE_SAVE_EVERY)
        states.append(t.state)
        out["resume_s"].append(wall)
        del t
    _same_bits(states[0], states[1], "two resumed runs")
    out["resume_counts"] = counts
    del states
    torch.cuda.empty_cache()
    card = (card_name_and_limit() if torch.device(dev).type == "cuda"
            else "the CPU")
    log(f"files phase on {card} ({os.cpu_count()} host cores, "
        f"{len(os.sched_getaffinity(0))} available to this process): "
        f"{FILE_SHARDS} shards "
        f"of {TRAIN_BATCH} examples written in {out['write_s']:.2f}s; the "
        f"C++ assembler built in {out['build_s']:.2f}s, read them in "
        f"{out['read_s']:.3f}s: {out['host_examples_per_s']:.1f} examples/s "
        f"on the host (the Python path: {python_eps:.1f} in the data phase, "
        f"{n / out['python_read_s']:.1f} on these files; the step: "
        f"{step_eps:.1f}), batches as written and equal to the Python "
        f"path's; packed device_batch {out['device_batch_ms']:.3f} ms a "
        f"batch (host clock, synchronised; unpacked {unpacked_ms:.3f} ms in "
        f"the data phase)")
    log(f"files phase on {card}: cli.train {FILE_STEPS} steps in "
        f"{out['train_s']:.2f}s, launches {json.dumps(out['counts'])}, "
        f"losses {out['losses']}, saves {json.dumps(out['save_s'])} s; "
        f"restore {out['restore_s']:.2f}s, {out['leaves']} leaves bit-equal "
        f"to the run's state; two runs resumed from "
        f"model.ckpt-{FILE_SAVE_EVERY} in "
        f"{', '.join(f'{s:.2f}' for s in out['resume_s'])}s, bit-equal")
    out["python_file_examples_per_s"] = n / out["python_read_s"]
    out.update(data=data + "/", output=output)
    return out


INT8_ROWS = 500_000         # export_int8_rows of the int8 bundle: Sku only
INT8_TOL = 0.05             # int8 Scores against float32 (tests/test_export.py)
# tables with a vocab file in the serving phase (logical rows "v1"...
# "v{n-1}"; the others hash their ids)
VOCAB_ROWS = {"Cid2": 300, "Cid3": 6000}
QUEUE_THREADS = 4
QUEUE_CHECK = 4             # requests a thread submits in the checked run
QUEUE_LOAD = 25             # requests a thread submits in a timed run
TIMED_EVALS = 3


def raw_request(cfg, req) -> dict:
    """A ``make_requests`` request as the raw string ids a client sends:
    ``v<index>`` for the tables of ``VOCAB_ROWS`` (vocab hits below their
    vocab's size, out-of-vocabulary buckets above it), the decimal index
    for hashed tables, the raw value for timestamps; u-side features keep
    their lengths."""
    from cikm2020_dmt_torch.data.pipeline import IDS, LEN
    from cikm2020_dmt_torch.data.schema import FeatureSchema

    table = {e.feature: e.table for e in cfg.embeddings}
    out = {}
    for f in FeatureSchema.from_config(cfg).id_features:
        ids = req[f.name + IDS]
        vals = (ids[0, :int(req[f.name + LEN][0])] if f.side == "u"
                else ids[:, 0])
        fmt = b"v%d" if table.get(f.name) in VOCAB_ROWS else b"%d"
        out[f.name] = [fmt % v for v in vals]
    return out


class CountingScorer:
    """A scorer that counts its forward passes: one per ``score_async``
    or ``score_group_async`` call (three block-forward launches each)."""

    def __init__(self, scorer):
        self.scorer = scorer
        self.n = 0

    def score_async(self, batch):
        self.n += 1
        return self.scorer.score_async(batch)

    def score_group_async(self, batches):
        self.n += 1
        return self.scorer.score_group_async(batches)


def _under_load(queue, requests, per_thread: int) -> tuple[float, list]:
    """``QUEUE_THREADS`` threads each submit ``per_thread`` requests
    (cycling through ``requests``) and then wait for their Scores; returns
    the wall seconds and [(request index, Scores)]."""
    import threading

    got, errors = [], []

    def client(t):
        try:
            futs = [((t + i) % len(requests),
                     queue.submit(requests[(t + i) % len(requests)]))
                    for i in range(per_thread)]
            got.extend((k, f.result(timeout=120)["Scores"].cpu().numpy())
                       for k, f in futs)
        except Exception as e:  # raised below, in the caller
            errors.append(e)

    threads = [threading.Thread(target=client, args=(t,))
               for t in range(QUEUE_THREADS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    return wall, got


def _latency(fn, n: int = 30, warmup: int = 5) -> tuple[float, float]:
    """p50 and p90 ms of ``fn(i)`` on the host clock after ``warmup``
    calls."""
    lat = []
    for i in range(n):
        t0 = time.perf_counter()
        fn(i)
        lat.append((time.perf_counter() - t0) * 1e3)
    lat = sorted(lat[warmup:])
    return statistics.median(lat), lat[int(0.9 * len(lat)) - 1]


def eval_serve_phase(cfg, dev, files: dict, d: str) -> dict:
    """Evaluating, testing and serving the files phase's checkpoint as a
    user runs them, at ``cfg``'s width, from the files phase's shards
    (``files["data"]``) and its ``model.ckpt-4`` (under ``files["output"]``):

    - ``cli.valid --once``: the result file's ``>> iter_steps:4`` block
      with every streaming metric and the P@N / MRR@N lines, finite;
    - ``cli.test --test_score_method rel --grid_search``: the gate lines
      (each task's mean softmax sums to 1), a detail row for every example
      written, finite AUCs, the grid search's best cell; ``cli.plot``'s
      CSV of the summaries;
    - ``run_eval`` over the files at the config's validation batch size
      (4096), timed (host
      clock, from the files to the scores on the host), with the gates;
      one batch from the files on the card against the port's CPU path
      within ``SCORES_TOL`` (scores, metric values, gate means);
    - ``cli.export`` of a float32 bundle and of an int8 one
      (``export_int8_rows`` ``INT8_ROWS``: Sku), each read back by
      ``load_scorer`` (seconds of each);
    - ``make_requests``' three requests as raw strings, assembled by
      ``ServingPreprocessor`` through a vocab the phase writes: the float32
      bundle's Scores within ``SCORES_TOL`` of a ``Scorer`` over the
      restored checkpoint's params, the int8 bundle's within ``INT8_TOL``
      of the float32 one's; request p50 / p90 through the preprocessor and
      each bundle;
    - ``ScorerQueue`` over the float32 bundle: 16 requests from 4 threads
      each within ``SCORES_TOL`` of the request scored alone; requests/s
      under the 4-thread load with groups of 1 only and with groups of
      1, 2, 4, 8.

    Every path is counted: exactly 3 block-forward launches per eval batch
    (also with the gates) and per forward of a request or a queue's
    group, and no other kernel.  Returns the numbers."""
    from cikm2020_dmt_torch.cli import export as cli_export
    from cikm2020_dmt_torch.cli import test as cli_test
    from cikm2020_dmt_torch.cli import valid as cli_valid
    from cikm2020_dmt_torch.cli.plot import load_runs, write_csv
    from cikm2020_dmt_torch.core.checkpoint import CheckpointManager
    from cikm2020_dmt_torch.core.config import DMTConfig
    from cikm2020_dmt_torch.metrics.offline import AT_LIST
    from cikm2020_dmt_torch.models.zoo import build_model
    from cikm2020_dmt_torch.nn.layers import tree_map
    from cikm2020_dmt_torch.serve.export import (Scorer, ServingPreprocessor,
                                                 load_scorer, norm_constants)
    from cikm2020_dmt_torch.serve.queue import ScorerQueue
    from cikm2020_dmt_torch.train.evaluate import run_eval
    from cikm2020_dmt_torch.train.loop import make_input_stream

    def sync():
        if torch.device(dev).type == "cuda":
            torch.cuda.synchronize()

    def counted(what, forwards):
        counts = read_counts()
        want = {k: 3 * forwards if k == "fused_block_fwd" else 0
                for k in counts}
        if counts != want:
            raise AssertionError(f"{what}: launches {counts}, want {want}")
        return counts["fused_block_fwd"]

    out = {"launches": {}}
    data, n_examples = files["data"], FILE_SHARDS * TRAIN_BATCH
    nrng = np.random.default_rng(SEED)
    mean = nrng.normal(0.5, 1.0, cfg.feature_dimension)
    std = nrng.uniform(0.1, 3.0, cfg.feature_dimension)
    stats = {}
    for name, vals in (("mean", mean), ("std", std)):
        stats[name] = os.path.join(d, f"{name}.txt")
        with open(stats[name], "w") as f:
            f.write("\t".join(repr(float(v)) for v in vals) + "\n")
    vocab = os.path.join(d, "vocab")
    os.makedirs(vocab)
    for table, rows in VOCAB_ROWS.items():
        ids = ["unknow"] + [f"v{i}" for i in range(1, rows)]
        with open(os.path.join(vocab, f"{table}.py"), "w") as f:
            f.write(f"ID_TABLES = {{{table!r}: {ids!r}}}\n")
    confs = {}
    for kind, rows in (("f32", 0), ("int8", INT8_ROWS)):
        confs[kind] = os.path.join(d, kind, "dmt.conf")
        os.makedirs(os.path.dirname(confs[kind]))
        write_conf(dataclasses.replace(
            cfg, validate_step=FILE_SAVE_EVERY, export_int8_rows=rows),
            confs[kind], data, files["output"], validation_data_path=data,
            test_data_path=data, test_data_path_ord=data,
            train_data_mean_path=stats["mean"],
            train_data_std_path=stats["std"])
    ecfg = DMTConfig.from_ini(confs["f32"])
    if not CheckpointManager(ecfg.model_path).has_step(FILE_STEPS):
        raise AssertionError(f"no model.ckpt-{FILE_STEPS} under "
                             f"{ecfg.model_path}")
    argv = ["--conf_file", confs["f32"], "--device", str(dev)]
    batch_size = out["batch"] = ecfg.validation_batch_size
    n_batches = -(-n_examples // batch_size)

    # ---- cli.valid --once ----
    reset_counts()
    t0 = time.perf_counter()
    vals = cli_valid.main(argv + ["--once"])
    sync()
    out["valid_s"] = time.perf_counter() - t0
    out["launches"]["valid"] = counted("cli.valid", n_batches)
    lines = open(ecfg.validation_result_path).read().splitlines()
    got = dict(line.split(":", 1) for line in lines[1:])
    want = {f"validation_{k}" for k in vals} | {
        f"action_{a}_{m}_at_{n}" for a in (2, 5) for m in ("pre", "mrr")
        for n in AT_LIST}
    if lines[0] != f">> iter_steps:{FILE_STEPS}" or set(got) != want or \
            not np.isfinite([float(v) for v in got.values()]).all():
        raise AssertionError(f"validation result file: {lines[:3]} ..., "
                             f"keys {sorted(set(got) ^ want)}")

    # ---- cli.test --test_score_method rel --grid_search ----
    reset_counts()
    t0 = time.perf_counter()
    res = cli_test.main(argv + ["--model_ckpt", f"model.ckpt-{FILE_STEPS}",
                                "--test_score_method", "rel",
                                "--grid_search"])
    sync()
    out["test_s"] = time.perf_counter() - t0
    out["launches"]["test"] = counted("cli.test", n_batches)
    result = os.path.join(ecfg.output_path,
                          f"{ecfg.tag}.ckpt-{FILE_STEPS}.test_result__rel")
    got = dict(line.split(":", 1) for line in open(result).read().splitlines()
               if ":" in line and not line.startswith(">>"))
    gates = np.array([[float(got[f"gate_{t}_expert_{e}"])
                       for e in range(ecfg.num_experts)]
                      for t in ("click", "order")])
    aucs = [float(got[f"{g}_auc_{t}"]) for g in ("grouped", "overall")
            for t in ("click", "order")]
    with open(result + ".detail") as f:
        detail_rows = sum(1 for _ in f)
    r = res[data]
    if not (np.abs(gates.sum(axis=1) - 1.0).max() < 1e-4
            and detail_rows == n_examples and np.isfinite(aucs).all()
            and r["grid"]["max_key"] in r["grid"]["cells"]):
        raise AssertionError(f"test result: gates {gates}, {detail_rows} "
                             f"detail rows of {n_examples}, AUCs {aucs}, "
                             f"best cell {r['grid']['max_key']!r}")
    runs = load_runs(ecfg.summary_path)
    write_csv(runs, os.path.join(d, "summary.csv"))
    if sorted(runs) != ["train", "validation"]:
        raise AssertionError(f"summaries: {sorted(runs)}")
    out.update(gates=gates.tolist(), aucs=aucs)

    # ---- run_eval over the files, timed; one batch against the CPU ----
    model = build_model(ecfg)
    params = CheckpointManager(ecfg.model_path).restore(FILE_STEPS,
                                                        "cpu")["params"]
    card = tree_map(lambda t: t.to(dev), params)
    run_eval(ecfg, model, card, data, batch_size, device=dev)  # warm-up
    times = []
    out["launches"]["eval"] = 0
    for _ in range(TIMED_EVALS):
        reset_counts()
        t0 = time.perf_counter()
        run_eval(ecfg, model, card, data, batch_size, collect_gates=True,
                 device=dev)
        times.append(time.perf_counter() - t0)
        out["launches"]["eval"] += counted("run_eval", n_batches)
    out["eval_s"] = times
    out["eval_examples_per_s"] = n_examples / statistics.median(times)
    stream = make_input_stream(ecfg, data, batch_size, shuffle=False,
                               drop_remainder=False, pad_remainder=True)
    batch = next(stream)
    stream.close()
    t0 = time.perf_counter()
    reset_counts()
    one = run_eval(ecfg, model, card, None, batch_size, data_iter=[batch],
                   collect_gates=True, device=dev)
    out["launches"]["eval"] += counted("one eval batch", 1)
    ref = run_eval(ecfg, model, params, None, batch_size, data_iter=[batch],
                   collect_gates=True, device="cpu")
    s_err = max(float(np.abs(a - b).max()) for a, b in zip(one[2:], ref[2:]))
    m_err = max(abs(one[0][k] - ref[0][k]) for k in ref[0])
    if not (s_err <= SCORES_TOL and m_err <= SCORES_TOL
            and one[1] == ref[1]):
        raise AssertionError(f"eval from files, card vs CPU: scores and "
                             f"gates {s_err}, metrics {m_err}")
    out["eval_card_vs_cpu"] = max(s_err, m_err)
    out["eval_card_vs_cpu_s"] = time.perf_counter() - t0
    del params, ref

    # ---- cli.export, float32 and int8; load_scorer ----
    scorers = {}
    out["export_s"], out["load_s"] = {}, {}
    for kind, conf in confs.items():
        t0 = time.perf_counter()
        bundle = cli_export.main(["--conf_file", conf, "--model_ckpt",
                                  f"model.ckpt-{FILE_STEPS}"])
        out["export_s"][kind] = time.perf_counter() - t0
        with open(os.path.join(bundle, "descriptor.json")) as f:
            int8 = json.load(f)["int8_tables"]
        if int8 != [] if kind == "f32" else "Sku" not in int8:
            raise AssertionError(f"{kind} bundle: int8 tables {int8}")
        t0 = time.perf_counter()
        scorers[kind] = load_scorer(DMTConfig.from_ini(conf), bundle,
                                    device=dev)
        sync()
        out["load_s"][kind] = time.perf_counter() - t0

    # ---- requests through the preprocessor and each bundle ----
    prep = ServingPreprocessor(dataclasses.replace(ecfg, vocab_path=vocab))
    raws = [(raw_request(ecfg, q), q["raw_features"])
            for q in make_requests(ecfg, CANDIDATES, REQUEST_LENS, SEED)]

    def assemble(i):
        ids, raw = raws[i % len(raws)]
        return prep.assemble(CANDIDATES, ids, raw_features=raw,
                             tile_uside=False)

    requests = [assemble(i) for i in range(len(raws))]
    reference = Scorer(ecfg, card, *norm_constants(mean, std), device=dev)
    want = [reference(q) for q in requests]
    del reference, card
    scores, errs = {}, {}
    for kind, scorer in scorers.items():
        reset_counts()
        scores[kind] = [scorer(q) for q in requests]
        sync()
        out["launches"][f"serve_{kind}"] = counted(f"{kind} bundle",
                                                   len(requests))
        for o in scores[kind]:
            check_scores(o, CANDIDATES)
        base = want if kind == "f32" else scores["f32"]
        errs[kind] = max(float(np.abs(o[k] - b[k]).max())
                         for o, b in zip(scores[kind], base) for k in b)
    if not (errs["f32"] <= SCORES_TOL and errs["int8"] <= INT8_TOL):
        raise AssertionError(f"bundle Scores: float32 vs the checkpoint's "
                             f"Scorer {errs['f32']}, int8 vs float32 "
                             f"{errs['int8']}")
    out["scores_err"] = errs
    for kind, scorer in scorers.items():
        reset_counts()
        out[f"p50_{kind}"], out[f"p90_{kind}"] = _latency(
            lambda i: scorer(assemble(i)))
        sync()
        out["launches"][f"serve_{kind}"] += counted(f"{kind} latency", 30)

    # ---- ScorerQueue over the float32 bundle ----
    single = [o["Scores"] for o in scores["f32"]]
    fwd = CountingScorer(scorers["f32"])
    reset_counts()
    q = ScorerQueue(fwd)
    q.warmup(requests[0])
    _, got = _under_load(q, requests, QUEUE_CHECK)
    q_err = max(float(np.abs(s - single[k]).max()) for k, s in got)
    if len(got) != QUEUE_THREADS * QUEUE_CHECK or q_err > SCORES_TOL:
        raise AssertionError(f"queue: {len(got)} results, max |diff| "
                             f"{q_err} from the requests scored alone")
    rates = {}
    for groups in ((1,), (1, 2, 4, 8)):
        queue = q if len(groups) > 1 else ScorerQueue(fwd, 1, groups)
        queue.warmup(requests[0])
        n0 = fwd.n
        wall, _ = _under_load(queue, requests, QUEUE_LOAD)
        n_req = QUEUE_THREADS * QUEUE_LOAD
        rates[groups[-1]] = {"requests_per_s": n_req / wall,
                             "forwards": fwd.n - n0}
        queue.close()
    sync()
    out["launches"]["queue"] = counted("the queue", fwd.n)
    out.update(queue_err=q_err, queue=rates)
    del scorers, scores, q
    torch.cuda.empty_cache()
    smi = (card_name_and_limit() if torch.device(dev).type == "cuda"
           else "the CPU")
    log(f"eval/serve phase on {smi}: cli.valid {out['valid_s']:.2f}s, "
        f"cli.test {out['test_s']:.2f}s ({n_batches} batches of "
        f"{batch_size} each, with a restore of the "
        f"checkpoint); run_eval from files {out['eval_examples_per_s']:.1f} "
        f"examples/s ({n_examples} examples in "
        f"{', '.join(f'{t:.3f}' for t in times)}s, host clock, from the "
        f"files to the scores on the host); card vs CPU one batch "
        f"{out['eval_card_vs_cpu']:.3e} (tol {SCORES_TOL}); gates "
        f"{np.round(gates, 4).tolist()}; AUCs {np.round(aucs, 4).tolist()}")
    log(f"eval/serve phase on {smi}: export float32 "
        f"{out['export_s']['f32']:.2f}s, int8 {out['export_s']['int8']:.2f}s;"
        f" load_scorer {out['load_s']['f32']:.2f}s / "
        f"{out['load_s']['int8']:.2f}s; Scores float32 bundle vs checkpoint "
        f"{errs['f32']:.3e}, int8 vs float32 {errs['int8']:.3e}; request "
        f"through the preprocessor at {CANDIDATES} candidates: float32 p50 "
        f"{out['p50_f32']:.3f} ms p90 {out['p90_f32']:.3f} ms, int8 p50 "
        f"{out['p50_int8']:.3f} ms p90 {out['p90_int8']:.3f} ms; queue "
        f"({QUEUE_THREADS} threads x {QUEUE_LOAD} requests): groups of 1 "
        f"{rates[1]['requests_per_s']:.1f} requests/s, groups up to 8 "
        f"{rates[8]['requests_per_s']:.1f} requests/s in "
        f"{rates[8]['forwards']} forwards; queue vs alone "
        f"{q_err:.3e}; launches {json.dumps(out['launches'])}")
    return out


def _entry(name, source, replaces, launches, err, ms, plain, b, lib, **kw):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain, "bound_ms": b[0], "bound_by": b[1],
            "library_ms": lib, **kw}


def _flat(bwd):
    return (bwd[0], bwd[1]) + tuple(bwd[2])


def _bwd_err(got, want):
    """(largest norm-wise error ||a - b|| / ||b||, largest absolute error)
    over the backward's outputs."""
    pairs = [(a.float(), b.float()) for a, b in zip(_flat(got), _flat(want))]
    rel = max(float((a - b).norm() / b.norm()) for a, b in pairs)
    return rel, max(float((a - b).abs().max()) for a, b in pairs)


BWD_OUTPUTS = ("d_enc", "d_dec") + tuple(
    f"{side}.{w}" for side in ("enc", "dec")
    for w in ("wqkv", "vecs", "w1", "b1", "w2"))


def _ff_pre(ew, dw, kw, dtype):
    """The ReLU pre-activations of the encoder's and the decoder's FF,
    [B, T, F] and [B, F], and their inputs (the LN outputs h1, [B, T, D]
    and [B, D]), replayed by the plain version in ``dtype`` with the same
    dropout masks."""
    from cikm2020_dmt_torch.ops import block

    B, T, D = kw["enc_in"].shape
    masks = block._masks(B, T, D, kw["num_heads"], kw["train"], kw["rate"],
                         kw["seed"], kw["enc_in"].device)
    e, d = (tuple(w.to(dtype) for w in ws) for ws in (ew, dw))
    out = block._replay(e, d, kw["enc_in"].to(dtype), kw["dec_in"].to(dtype),
                        kw["seq_mask"], kw["num_heads"], masks)
    h1_e, h1_d = out[3][3], out[5][3][:, 0]
    return h1_e @ e[2] + e[3], h1_d @ d[2] + d[3], h1_e, h1_d


def _worst(A, B):
    """(output, element, |A - B| there over the output's largest |B|) of
    the largest such difference over the backward's outputs."""
    rel = [float((a.double() - b.double()).abs().max() / b.double().abs().max())
           for a, b in zip(A, B)]
    i = max(range(len(rel)), key=rel.__getitem__)
    j = int((A[i].double() - B[i].double()).abs().argmax())
    return i, tuple(int(x) for x in torch.unravel_index(torch.tensor(j),
                                                        A[i].shape)), rel[i]


def _one_gate(A, B, i, idx, ff):
    """A ReLU that takes the other branch in one replay than in the other
    moves column u of the FF layer's dw1 by exactly one row's term
    h1[row] * d(b1)[u].  For a worst element in w1 or b1 (unit u): how far
    the A - B difference of that column is from the one row's term that
    explains it best (relative to the difference), and that row's
    pre-activation on u.  None elsewhere."""
    name = BWD_OUTPUTS[i]
    if name[4:] not in ("w1", "b1"):
        return None
    side = 0 if name.startswith("enc.") else 1
    unit = idx[-1]
    h1, pre = ff[side]
    dcol = A[4 + 5 * side][:, unit].double() - B[4 + 5 * side][:, unit].double()
    db = float(A[5 + 5 * side][unit].double() - B[5 + 5 * side][unit].double())
    res = (dcol[None] - h1 * db).norm(dim=1)
    r = int(res.argmin())
    return float(res[r] / dcol.norm()), float(pre[r, unit])


def bwd_rounding_report(ew, dw, kw, g, gb, rb) -> dict:
    """Where the float32 backward kernel and its plain version part: both
    against the plain version in float64 on the same inputs and masks
    (norm-wise); how many live ReLUs lie on the other side of 0 in the
    float32 replay than in the float64 one; and for each pair (kernel vs
    float32 plain, float32 plain vs float64 plain) its worst element with
    the values and, where it is in an FF layer's w1 or b1, the single ReLU
    gate that explains it (``_one_gate``)."""
    from cikm2020_dmt_torch.ops import block

    kw64 = dict(kw, enc_in=kw["enc_in"].double(),
                dec_in=kw["dec_in"].double())
    r64 = block.fused_block_bwd_ref(tuple(w.double() for w in ew),
                                    tuple(w.double() for w in dw),
                                    g=g.double(), **kw64)
    K, P, R = _flat(gb), _flat(rb), _flat(r64)
    pre_e, pre_d, h1_e, h1_d = _ff_pre(ew, dw, kw, torch.float64)
    pre_e32, pre_d32 = _ff_pre(ew, dw, kw, torch.float32)[:2]
    live = kw["seq_mask"] > 0
    ff = ((h1_e[live], pre_e[live]), (h1_d, pre_d))
    out = {"kernel_vs_f64": _bwd_err(gb, r64)[0],
           "plain_vs_f64": _bwd_err(rb, r64)[0],
           "flips": int(((pre_e > 0) != (pre_e32 > 0))[live].sum()
                        + ((pre_d > 0) != (pre_d32 > 0)).sum()),
           "live_relus": int(live.sum()) * pre_e.shape[-1] + pre_d.numel()}
    msg = (f"  backward rounding: norm-wise vs the float64 plain version, "
           f"kernel {out['kernel_vs_f64']:.3e}, float32 plain "
           f"{out['plain_vs_f64']:.3e}; live ReLUs on the other side of 0 "
           f"in float32 than in float64: {out['flips']} of "
           f"{out['live_relus']}")
    for key, A, B in (("kernel_vs_plain", K, P), ("plain_vs_f64", P, R)):
        i, idx, rel = _worst(A, B)
        gate = _one_gate(A, B, i, idx, ff)
        out[key + "_worst"] = {
            "output": BWD_OUTPUTS[i], "index": idx, "rel": rel,
            "values": [float(t[i][idx]) for t in (K, P, R)],
            "one_gate_residual": gate and gate[0],
            "gate_pre": gate and gate[1]}
        msg += (f"\n    {key.replace('_', ' ')}: worst element "
                f"{BWD_OUTPUTS[i]}{list(idx)}, {rel:.3e} of its output's "
                f"max (kernel, plain, float64: "
                f"{', '.join(f'{v:.7e}' for v in out[key + '_worst']['values'])})")
        if gate is not None:
            msg += (f"; one row's gate term explains its dw1 column to "
                    f"{gate[0]:.3e}, that row's pre-activation {gate[1]:.3e}")
    log(msg)
    return out


def block_train_phase(params, counts, dev):
    """The block forward (training mode) and backward kernels against their
    plain versions at B=2048, T=50 and 10, float32 and bfloat16, dropout
    0.1, lengths 0..T; float32 (the main path's type) timed.  Returns the
    forward's training shapes and the backward's entry."""
    from cikm2020_dmt_torch.ops import block

    kgen = torch.Generator(device=dev).manual_seed(SEED + 2)
    seed = torch.tensor([SEED + 3], dtype=torch.int32, device=dev)
    fwd_shapes, bwd_shapes = [], []
    fwd_err = bwd_err = 0.0
    rounding = {}
    for T, p in ((50, params["trans"]["seq0"]), (10, params["trans"]["seq2"])):
        ep, dp = p["enc"][0], p["dec"][0]
        ew, dw = block.pack_weights(ep), block.pack_weights(dp)
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            kw = block_inputs(T, dtype, kgen, dev, B=TRAIN_BATCH)
            kw.update(train=True, rate=DROPOUT, seed=seed)
            with torch.no_grad():
                got = block.fused_encode_decode(ep, dp, **kw)
                ref = block.fused_encode_decode_ref(ep, dp, **kw)
            g = torch.randn(got.shape, generator=kgen, device=dev).to(dtype)
            gb = block.fused_block_bwd(ew, dw, g=g, **kw)
            again = block.fused_block_bwd(ew, dw, g=g, **kw)
            rb = block.fused_block_bwd_ref(ew, dw, g=g, **kw)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(_flat(gb),
                                                         _flat(again))):
                raise AssertionError(f"fused_block_bwd at T={T} {dname}: "
                                     "two launches on the same inputs "
                                     "differ")
            del again
            f_err = float((got.float() - ref.float()).abs().max())
            rel, absd = _bwd_err(gb, rb)
            if dtype == torch.float32:
                tol, what = BWD_TOL_F32, "vs plain"
                rounding[T] = bwd_rounding_report(ew, dw, kw, g, gb, rb)
            else:
                kw32 = dict(kw, enc_in=kw["enc_in"].float(),
                            dec_in=kw["dec_in"].float())
                r32 = block.fused_block_bwd_ref(ew, dw, g=g.float(), **kw32)
                rel, _ = _bwd_err(gb, r32)
                plain_rel, _ = _bwd_err(rb, r32)
                tol = BWD_BF16_FACTOR * plain_rel + BWD_TOL_F32
                what = (f"vs float32 plain (plain bf16 {plain_rel:.3e})")
            log(f"block train B={TRAIN_BATCH} T={T} {dname}: forward max "
                f"|diff| {f_err:.3e} (tol {KERNEL_TOL[dtype]}); backward "
                f"max |diff| {absd:.3e}, norm-wise {rel:.3e} {what} (tol "
                f"{tol:.3e})")
            if not (torch.isfinite(got.float()).all()
                    and f_err <= KERNEL_TOL[dtype]):
                raise AssertionError(f"training forward disagrees: {f_err}")
            if not all(torch.isfinite(t.float()).all() for t in _flat(gb)) \
                    or not rel <= tol:
                raise AssertionError(f"backward disagrees at T={T} {dname}: "
                                     f"{rel}")
            if dtype != torch.float32:
                continue
            fwd_err, bwd_err = max(fwd_err, f_err), max(bwd_err, absd)
            with torch.no_grad():
                f_ms = cuda_ms(lambda: block.fused_encode_decode(
                    ep, dp, **kw), 10)
                f_plain = cuda_ms(lambda: block.fused_encode_decode_ref(
                    ep, dp, **kw), 3, warmup=1)
            b_ms = cuda_ms(lambda: block.fused_block_bwd(ew, dw, g=g, **kw),
                           5, warmup=1)
            b_plain = cuda_ms(lambda: block.fused_block_bwd_ref(
                ew, dw, g=g, **kw), 3, warmup=1)
            per = 2 if T == 50 else 1
            fb = bound(block.block_flops(TRAIN_BATCH, T, 80, 320),
                       block.block_bytes(TRAIN_BATCH, T, 80, 320, 4))
            bb = bound(block.block_bwd_flops(TRAIN_BATCH, T, 80, 320),
                       block.block_bwd_bytes(TRAIN_BATCH, T, 80, 320, 4))
            tc = block.block_tc_bound_ms(
                block.block_bwd_flops(TRAIN_BATCH, T, 80, 320), torch.float32)
            f_tc = block.block_tc_bound_ms(
                block.block_flops(TRAIN_BATCH, T, 80, 320), torch.float32)
            fwd_shapes.append({"B": TRAIN_BATCH, "T": T, "dtype": dname,
                               "dropout": DROPOUT, "per_step": per,
                               "ms": f_ms, "plain_ms": f_plain,
                               "bound_ms": fb[0], "bound_by": fb[1],
                               "tc_bound_ms": f_tc})
            bwd_shapes.append({"B": TRAIN_BATCH, "T": T, "dtype": dname,
                               "dropout": DROPOUT, "per_step": per,
                               "ms": b_ms, "plain_ms": b_plain,
                               "bound_ms": bb[0], "bound_by": bb[1],
                               "tc_bound_ms": tc})
            log(f"block train B={TRAIN_BATCH} T={T} f32: forward {f_ms:.4f} "
                f"ms (PR 5: {FWD_PR5_MS[(TRAIN_BATCH, T)]}; plain "
                f"{f_plain:.4f}, bound {fb[0]:.4f} {fb[1]}, {f_tc:.4f} at "
                "the TF32 tensor-core peak for 3xTF32); backward "
                f"{b_ms:.4f} ms (PR 5: {BWD_PR5_MS[T]}; plain {b_plain:.4f}, "
                "bound "
                f"{bb[0]:.4f} {bb[1]} at the f32 FMA peak, {tc:.4f} at the "
                "TF32 tensor-core peak for 3xTF32)")

    def per_step(key):
        return sum(s[key] * s["per_step"] for s in bwd_shapes)

    ops = sum(block.block_bwd_flops(TRAIN_BATCH, s["T"], 80, 320)
              * s["per_step"] for s in bwd_shapes)
    nbytes = sum(block.block_bwd_bytes(TRAIN_BATCH, s["T"], 80, 320, 4)
                 * s["per_step"] for s in bwd_shapes)
    bwd = _entry(
        "fused_block_bwd", "cikm2020_dmt_torch/csrc/fused_block_bwd.cu",
        "cikm2020_dmt_tpu/ops/block.py:386", counts["fused_block_bwd"],
        bwd_err, per_step("ms"), per_step("plain_ms"), bound(ops, nbytes),
        None,
        library_note="no single PyTorch call computes the block's backward "
                     "(autograd of the plain version is dozens of calls)",
        unit="ms per training step: 2 launches at T=50 + 1 at T=10, "
             "B=2048, f32, dropout 0.1",
        shapes=bwd_shapes, deterministic=True, rounding=rounding,
        tc_bound_ms=per_step("tc_bound_ms"), tc_bound_note=TC_BOUND_NOTE)
    bwd["targets"] = block_bwd_targets(bwd_shapes)
    return fwd_shapes, fwd_err, bwd


# what a block kernel's tc_bound_ms counts
TC_BOUND_NOTE = ("3 x operations over the dense TF32 tensor-core peak (495 "
                 "TFLOP/s), the 3xTF32 split; bound_ms divides the "
                 "operations by the float32 FMA peak (67 TFLOP/s)")

# the block backward's targets at B=2048, float32, dropout 0.1: within 10
# ms at T=50 and 4.8 ms at T=10.  Reported, not enforced: a kernel that
# misses them stays, with its numbers
BLOCK_BWD_MS = {50: 10.0, 10: 4.8}


def block_bwd_targets(shapes) -> dict:
    out = {f"T{s['T']}_within_ms": s["ms"] <= BLOCK_BWD_MS[s["T"]]
           for s in shapes if s["T"] in BLOCK_BWD_MS}
    log(f"fused_block_bwd targets at B={TRAIN_BATCH} f32: {json.dumps(out)} "
        f"(" + ", ".join(f"T={s['T']} {s['ms']:.4f} ms, limit "
                         f"{BLOCK_BWD_MS[s['T']]}" for s in shapes) + ")")
    return out


# PR 5's times of the kernels at the main paths' shapes (PERF.md, NVIDIA
# H100 80GB HBM3 at 700 W, f32), printed beside this run's
FWD_PR5_MS = {(CANDIDATES, 50): 0.6877, (CANDIDATES, 10): 0.1704,
              (TRAIN_BATCH, 50): 3.6805, (TRAIN_BATCH, 10): 0.7221}
BWD_PR5_MS = {50: 5.6249, 10: 1.7759}
ATT_FWD_PR5_MS = {(50, 50): 0.1929, (10, 10): 0.0214, (1, 50): 0.0285,
                  (1, 10): 0.0077}
ATT_BWD_PR5_MS = {(50, 50): 0.4023, (10, 10): 0.0552, (1, 50): 0.0878,
                  (1, 10): 0.0226}

# widths other than the model's, (D, F, heads, T): a head width that is
# not a multiple of 8 with F not a multiple of 8, two wide heads past 50
# keys, the model's widths at a T whose activations spill out of shared
# memory into the kernels' workspace, and a T past the register tilings
# of the encoder attention (a warp a query row)
WIDTH_CASES = ((36, 100, 3, 7), (64, 256, 2, 60), (80, 320, 4, 200),
               (36, 100, 3, 300))
WIDTH_BATCH = 131
# attention past the register tilings, (Tq, Tk, heads, head width)
ATT_WIDTH_CASES = ((65, 65, 4, 20), (1, 200, 2, 72), (200, 200, 2, 72),
                   (10, 10, 1, 72))
# the forward-vs-replay check: T, at B=300, dropout 0.1; 55 and 128 run
# the SPILL instantiation (at 55 only the backward's activations would
# overflow shared memory, and the forward follows it)
REPLAY_TS = (1, 10, 50, 55, 128)


def width_block_case(D, F, H, T, dtype, dev, B=WIDTH_BATCH, seed=0):
    """Packed weights of one encoder and one decoder sub-block at widths
    (D, F, H) with random biases and layer-norm scales (so a misplaced
    padding column shows), inputs with lengths 0..T, dropout 0.1, and a
    cotangent."""
    from cikm2020_dmt_torch.core.config import TransformerConfig
    from cikm2020_dmt_torch.nn.transformer import transformer_init
    from cikm2020_dmt_torch.ops import block

    gen = torch.Generator(device=dev).manual_seed(seed)
    p = transformer_init(gen, TransformerConfig(d_model=D, d_ff=F,
                                                num_heads=H, maxlen_k=T))

    def jitter(ws):
        wqkv, vecs, w1, b1, w2 = ws
        return (wqkv, vecs + 0.1 * torch.randn(vecs.shape, generator=gen,
                                               device=dev),
                w1, b1 + 0.1 * torch.randn(b1.shape, generator=gen,
                                           device=dev), w2)

    ew = jitter(block.pack_weights(p["enc"][0]))
    dw = jitter(block.pack_weights(p["dec"][0]))
    enc = torch.randn(B, T, D, generator=gen, device=dev).to(dtype)
    dec = torch.randn(B, D, generator=gen, device=dev).to(dtype)
    lens = torch.arange(B, device=dev) % (T + 1)
    mask = (torch.arange(T, device=dev)[None] < lens[:, None]).float()
    g = torch.randn(B, D, generator=gen, device=dev).to(dtype)
    kw = dict(enc_in=enc, dec_in=dec, seq_mask=mask, num_heads=H,
              train=True, rate=DROPOUT,
              seed=torch.tensor([seed + 11], dtype=torch.int32, device=dev))
    return ew, dw, g, kw


def check_block_width(D, F, H, T, dtype, dev, B=WIDTH_BATCH) -> dict:
    """Both block kernels at widths (D, F, H) and length T against their
    plain versions on the same inputs and masks: the forward within
    ``KERNEL_TOL``, the backward norm-wise within ``BWD_TOL_F32`` (float32)
    or within ``BWD_BF16_FACTOR`` times the bfloat16 plain version's own
    distance from the float32 one, plus ``BWD_TOL_F32`` (bfloat16).
    Raises on failure; returns the errors."""
    from cikm2020_dmt_torch.ops import block

    ew, dw, g, kw = width_block_case(D, F, H, T, dtype, dev, B)
    args = (kw["enc_in"], kw["dec_in"], kw["seq_mask"], H, True, DROPOUT,
            kw["seed"])
    got = block._fwd_kernel(ew, dw, *args)
    ref = block._fwd_ref(ew, dw, *args)
    gb = block.fused_block_bwd(ew, dw, g=g, **kw)
    rb = block.fused_block_bwd_ref(ew, dw, g=g, **kw)
    torch.cuda.synchronize()
    f_err = float((got.float() - ref.float()).abs().max())
    if dtype == torch.float32:
        b_err, _ = _bwd_err(gb, rb)
        tol = BWD_TOL_F32
    else:
        kw32 = dict(kw, enc_in=kw["enc_in"].float(),
                    dec_in=kw["dec_in"].float())
        r32 = block.fused_block_bwd_ref(ew, dw, g=g.float(), **kw32)
        b_err, _ = _bwd_err(gb, r32)
        tol = BWD_BF16_FACTOR * _bwd_err(rb, r32)[0] + BWD_TOL_F32
    dname = str(dtype).split(".")[-1]
    where = f"D={D} F={F} H={H} T={T} B={B} {dname}"
    log(f"block kernels at {where}: forward max |diff| {f_err:.3e} (tol "
        f"{KERNEL_TOL[dtype]}); backward norm-wise {b_err:.3e} (tol "
        f"{tol:.3e})")
    finite = torch.isfinite(got.float()).all() and all(
        torch.isfinite(t.float()).all() for t in _flat(gb))
    if not (finite and f_err <= KERNEL_TOL[dtype] and b_err <= tol):
        raise AssertionError(f"block kernels disagree at {where}: forward "
                             f"{f_err}, backward {b_err}")
    return {"D": D, "F": F, "H": H, "T": T, "B": B, "dtype": dname,
            "fwd_max_abs_err": f_err, "bwd_rel_err": b_err, "bwd_tol": tol}


def check_attention_width(Tq, Tk, H, dh, dtype, dev, B=WIDTH_BATCH) -> dict:
    """Both attention kernels at (Tq, Tk) and heads of dh columns against
    their plain versions with the main path's tolerances: float32 forward
    within ``KERNEL_TOL``, backward within ``ATT_BWD_TOL`` of each output's
    max; bfloat16 forward by ``bf16_attention_fwd_check``, backward within
    ``BWD_BF16_FACTOR`` times the bfloat16 plain version's distance from
    the float32 one, plus ``ATT_BWD_TOL``.  Raises on failure."""
    from cikm2020_dmt_torch.ops import attention as att

    gen = torch.Generator(device=dev).manual_seed(Tq * 1000 + Tk + dh)
    D = H * dh
    q, k, v, do = (torch.randn(B, T, D, generator=gen, device=dev)
                   .to(dtype) for T in (Tq, Tk, Tk, Tq))
    km = (torch.arange(Tk, device=dev)[None]
          < (torch.arange(B, device=dev) % (Tk + 1))[:, None]).float()
    qm = km if Tq == Tk else torch.ones(B, Tq, device=dev)
    got = att.fused_attention(q, k, v, qm, km, H)
    ref = att.fused_attention_ref(q, k, v, qm, km, H)
    gb = att.fused_attention_bwd(q, k, v, qm, km, do, H)
    rb = att.fused_attention_bwd_ref(q, k, v, qm, km, do, H)
    torch.cuda.synchronize()
    f_err = float((got.float() - ref.float()).abs().max())
    if dtype == torch.float32:
        f_ok = f_err <= KERNEL_TOL[dtype]
        b_err, tol = _max_rel(gb, rb), ATT_BWD_TOL
    else:
        ratio, share = bf16_attention_fwd_check(got, ref, q, k, v, qm, km, H)
        f_ok = ratio <= 1.0 and share <= ATT_BF16_DIFF_SHARE
        r32 = att.fused_attention_bwd_ref(q.float(), k.float(), v.float(),
                                          qm, km, do.float(), H)
        b_err = _max_rel(gb, r32)
        tol = BWD_BF16_FACTOR * _max_rel(rb, r32) + ATT_BWD_TOL
    dname = str(dtype).split(".")[-1]
    where = f"B={B} Tq={Tq} Tk={Tk} H={H} dh={dh} {dname}"
    log(f"attention kernels at {where}: forward max |diff| {f_err:.3e}; "
        f"backward {b_err:.3e} of each output's max (tol {tol:.3e})")
    finite = torch.isfinite(got.float()).all() and all(
        torch.isfinite(t.float()).all() for t in gb)
    if not (finite and f_ok and b_err <= tol):
        raise AssertionError(f"attention kernels disagree at {where}: "
                             f"forward {f_err}, backward {b_err}")
    return {"Tq": Tq, "Tk": Tk, "H": H, "dh": dh, "B": B, "dtype": dname,
            "fwd_max_abs_err": f_err, "bwd_rel_err": b_err, "bwd_tol": tol}


def check_replay(T, dtype, dev, B=CANDIDATES, widths=(80, 320, 4)) -> dict:
    """The FF pre-activations (h1 w1 + b1, encoder and decoder) that the
    forward kernel formed and that the backward kernel's replay formed, on
    the same inputs with dropout 0.1: they must be the same bits, so every
    ReLU takes in the backward the branch it took in the forward.  Raises
    if any element differs."""
    from cikm2020_dmt_torch.ops import block

    D, F, H = widths
    ew, dw, _, kw = width_block_case(D, F, H, T, dtype, dev, B, seed=T)
    fwd, bwd = block.ff_preactivations(ew, dw, **kw)
    torch.cuda.synchronize()
    live = kw["seq_mask"] > 0
    diff = [int((a != b)[live].sum()) if a.dim() == 3 else int((a != b).sum())
            for a, b in zip(fwd, bwd)]
    dname = str(dtype).split(".")[-1]
    n = [int(live.sum()) * F, B * F]
    log(f"forward vs replay FF pre-activations at D={D} T={T} B={B} {dname}"
        f", dropout {DROPOUT}: {diff[0]} of {n[0]} encoder and {diff[1]} of "
        f"{n[1]} decoder elements differ")
    if any(diff) or not all(torch.isfinite(t[live] if t.dim() == 3 else t)
                            .all() for t in fwd):
        raise AssertionError(f"the backward's replay does not reproduce the "
                             f"forward at T={T} {dname}: {diff}")
    return {"T": T, "dtype": dname, "B": B, "differ": diff, "elements": n}


def widths_phase(dev) -> dict:
    """The forward-vs-replay check at the model's widths, then the block
    and attention kernels at the other widths, float32 and bfloat16."""
    out = {"replay": [], "block": [], "attention": []}
    for T in REPLAY_TS:
        for dtype in (torch.float32, torch.bfloat16):
            out["replay"].append(check_replay(T, dtype, dev))
    for D, F, H, T in WIDTH_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            out["block"].append(check_block_width(D, F, H, T, dtype, dev))
    for Tq, Tk, H, dh in ATT_WIDTH_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            out["attention"].append(check_attention_width(Tq, Tk, H, dh,
                                                          dtype, dev))
    return out


# ---------------------------------------------------------------------------
# The save mode (DMT_BLOCK_SAVE=1): the forward kernel also writes the
# encoder's Q, K, V and attention context, and the backward reads them
# instead of forming them again
# ---------------------------------------------------------------------------

# (D, F, heads, T) at B=300 where the save mode is held to the bits of the
# replay: the forward-vs-replay cases at the model's widths and one other
# width
SAVE_CASES = tuple((80, 320, 4, T) for T in REPLAY_TS) + ((36, 100, 3, 7),)


@contextlib.contextmanager
def save_switch(on: bool):
    """``DMT_BLOCK_SAVE`` set to 1 (or 0) inside the block, as it was
    after."""
    old = os.environ.get("DMT_BLOCK_SAVE")
    os.environ["DMT_BLOCK_SAVE"] = "1" if on else "0"
    try:
        yield
    finally:
        if old is None:
            del os.environ["DMT_BLOCK_SAVE"]
        else:
            os.environ["DMT_BLOCK_SAVE"] = old


@contextlib.contextmanager
def deterministic():
    """PyTorch's deterministic implementations inside the block where it
    has them (the scatter-adds of the embeddings' gradients, whose float
    atomics otherwise sum in another order in each run), a warning where
    it has none (the metrics' cumsum, which no parameter reads).  New
    tensors are left unfilled, as they are outside the block."""
    import torch.utils.deterministic as det

    fill = det.fill_uninitialized_memory
    det.fill_uninitialized_memory = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)
        det.fill_uninitialized_memory = fill


def check_save_bits(where, ew, dw, g, kw):
    """Both block kernels in either mode on the same inputs: the forward's
    output and the backward's 12 outputs must be the same bits with the
    saved tensors as without them, and the saved q, k, v and ctx_e within
    ``KERNEL_TOL`` of the plain version's.  Raises on failure; returns
    (the largest |saved - plain|, the saved tensors)."""
    from cikm2020_dmt_torch.ops import block

    args = (kw["enc_in"], kw["dec_in"], kw["seq_mask"], kw["num_heads"],
            kw["train"], kw["rate"], kw["seed"])
    out = block._fwd_kernel(ew, dw, *args)
    out_s, saved = block._fwd_kernel(ew, dw, *args, save=True)
    gb = _flat(block.fused_block_bwd(ew, dw, g=g, **kw))
    gs = _flat(block.fused_block_bwd(ew, dw, g=g, saved=saved, **kw))
    _, ref = block._fwd_ref(ew, dw, *args, save=True)
    torch.cuda.synchronize()
    differ = [int((a != b).sum()) for a, b in zip((out,) + gb, (out_s,) + gs)]
    errs = [float((a.float() - b.float()).abs().max())
            for a, b in zip(saved, ref)]
    tol = KERNEL_TOL[kw["enc_in"].dtype]
    log(f"save mode at {where}: elements that differ from the replay "
        f"{differ[0]} (out) and {sum(differ[1:])} (backward, 12 outputs); "
        f"saved q, k, v, ctx_e vs plain max |diff| "
        + ", ".join(f"{e:.3e}" for e in errs) + f" (tol {tol})")
    finite = all(torch.isfinite(t.float()).all() for t in saved)
    if any(differ) or not finite or max(errs) > tol:
        raise AssertionError(f"save mode at {where}: differ {differ}, saved "
                             f"vs plain {errs}")
    return max(errs), saved


def check_save(D, F, H, T, dtype, dev, B=CANDIDATES) -> dict:
    """``check_save_bits`` at widths (D, F, H) and length T, lengths
    0..T, dropout 0.1 (``width_block_case``)."""
    ew, dw, g, kw = width_block_case(D, F, H, T, dtype, dev, B, seed=T)
    dname = str(dtype).split(".")[-1]
    err, _ = check_save_bits(f"D={D} F={F} H={H} T={T} B={B} {dname}", ew,
                             dw, g, kw)
    return {"D": D, "F": F, "H": H, "T": T, "B": B, "dtype": dname,
            "bit_equal": True, "saved_max_abs_err": err}


def save_block_phase(params, dev) -> tuple[dict, dict]:
    """The save mode at the flagship's training shapes (B=2048, T=50 and
    10, float32 and bfloat16, dropout 0.1, lengths 0..T; the trained
    weights): ``check_save_bits``, then, in float32, both kernels timed in
    either mode in turns (off, on, on, off) beside their save-mode bounds.
    Returns the forward's and the backward's ``save`` records (without
    launches)."""
    from cikm2020_dmt_torch.ops import block

    kgen = torch.Generator(device=dev).manual_seed(SEED + 8)
    seed = torch.tensor([SEED + 9], dtype=torch.int32, device=dev)
    fwd_shapes, bwd_shapes = [], []
    err = 0.0
    for T, p in ((50, params["trans"]["seq0"]), (10, params["trans"]["seq2"])):
        ew, dw = block.pack_weights(p["enc"][0]), block.pack_weights(p["dec"][0])
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            kw = block_inputs(T, dtype, kgen, dev, B=TRAIN_BATCH)
            kw.update(train=True, rate=DROPOUT, seed=seed)
            g = torch.randn(TRAIN_BATCH, 80, generator=kgen, device=dev
                            ).to(dtype)
            e, saved = check_save_bits(f"B={TRAIN_BATCH} T={T} {dname}", ew,
                                       dw, g, kw)
            err = max(err, e)
            if dtype != torch.float32:
                continue
            args = (kw["enc_in"], kw["dec_in"], kw["seq_mask"], 4, True,
                    DROPOUT, seed)
            f = {s: lambda s=s: block._fwd_kernel(ew, dw, *args, save=s)
                 for s in (False, True)}
            b = {False: lambda: block.fused_block_bwd(ew, dw, g=g, **kw),
                 True: lambda: block.fused_block_bwd(ew, dw, g=g,
                                                     saved=saved, **kw)}
            ms = {(k, s): [] for k in "fb" for s in (False, True)}
            for s in (False, True, True, False):
                ms[("f", s)].append(cuda_ms(f[s], 10))
                ms[("b", s)].append(cuda_ms(b[s], 5, warmup=1))
            per = 2 if T == 50 else 1
            for shapes, k, ops, nbytes in (
                    (fwd_shapes, "f", block.block_flops(TRAIN_BATCH, T, 80,
                                                        320),
                     block.block_bytes(TRAIN_BATCH, T, 80, 320, 4,
                                       save=True)),
                    (bwd_shapes, "b",
                     block.block_bwd_flops(TRAIN_BATCH, T, 80, 320,
                                           saved=True),
                     block.block_bwd_bytes(TRAIN_BATCH, T, 80, 320, 4,
                                           saved=True))):
                bd = bound(ops, nbytes)
                shapes.append({
                    "B": TRAIN_BATCH, "T": T, "dtype": dname,
                    "dropout": DROPOUT, "per_step": per,
                    "ms": statistics.mean(ms[(k, True)]),
                    "off_ms": statistics.mean(ms[(k, False)]),
                    "readings": {"on": ms[(k, True)], "off": ms[(k, False)]},
                    "bound_ms": bd[0], "bound_by": bd[1],
                    "tc_bound_ms": block.block_tc_bound_ms(ops, dtype),
                    "flop": ops, "bytes": nbytes})
            fs, bs = fwd_shapes[-1], bwd_shapes[-1]
            log(f"save mode B={TRAIN_BATCH} T={T} f32: forward "
                f"{fs['ms']:.4f} ms (off {fs['off_ms']:.4f}; bound "
                f"{fs['bound_ms']:.4f} {fs['bound_by']}, "
                f"{fs['tc_bound_ms']:.4f} at the TF32 tensor-core peak for "
                f"3xTF32); backward {bs['ms']:.4f} ms (off "
                f"{bs['off_ms']:.4f}; bound {bs['bound_ms']:.4f} "
                f"{bs['bound_by']}, {bs['tc_bound_ms']:.4f} at the TF32 "
                f"tensor-core peak); readings on/off {bs['readings']}")

    def record(shapes, what):
        ops = sum(s["flop"] * s["per_step"] for s in shapes)
        nbytes = sum(s["bytes"] * s["per_step"] for s in shapes)
        bd = bound(ops, nbytes)
        return {"what": what, "max_abs_err": err,
                "ms": sum(s["ms"] * s["per_step"] for s in shapes),
                "off_ms": sum(s["off_ms"] * s["per_step"] for s in shapes),
                "bound_ms": bd[0], "bound_by": bd[1],
                "tc_bound_ms": sum(s["tc_bound_ms"] * s["per_step"]
                                   for s in shapes),
                "tc_bound_note": TC_BOUND_NOTE,
                "unit": "ms per training step: 2 launches at T=50 + 1 at "
                        "T=10, B=2048, f32, dropout 0.1; off_ms the same "
                        "launches without the save mode, timed in turns",
                "shapes": shapes}

    return (record(fwd_shapes, "writes the encoder's q, k, v and ctx_e; "
                               "max_abs_err: saved tensors vs plain"),
            record(bwd_shapes, "reads them instead of replaying the "
                               "encoder's projection and attention"))


def save_train_phase(tr, state, batches, dev, expected: dict) -> dict:
    """The flagship's training path with ``DMT_BLOCK_SAVE=1``: one step
    from one state, batch and dropout seed twice without the save mode and
    once with it, with PyTorch's deterministic implementations on
    (``deterministic``): its loss the same bits, and every parameter leaf
    that the two runs without it produce bit-equal the same bits with it
    (without them, a small table's gradient can sum in another order in
    each run and agree by chance in two of three); then
    10 steps in either mode in turns (off, on, on, off), counted: per step
    exactly ``expected`` launches, of which 3 forward and 3 backward in
    the save mode when it is on and none when it is off.  Returns the
    numbers."""
    from cikm2020_dmt_torch.metrics.streaming import task_metrics_init
    from cikm2020_dmt_torch.nn.layers import tree_map

    def one_step(save):
        s = tree_map(lambda t: t.clone(), state)
        gen = torch.Generator(device=dev).manual_seed(SEED + 7)
        reset_counts()
        with save_switch(save), deterministic():
            s1, _, loss = tr.train_step(s, task_metrics_init(dev),
                                        batches[0], gen)
        torch.cuda.synchronize()
        return loss, dict(_leaves(s1["params"])), read_save_counts()

    loss_a, pa, _ = one_step(False)
    loss_b, pb, _ = one_step(False)
    loss_s, ps, saves = one_step(True)
    same = [k for k in pa if torch.equal(pa[k], pb[k])]
    bad = [k for k in same if not torch.equal(ps[k], pa[k])]
    log(f"save mode, one step at batch {TRAIN_BATCH}: loss {float(loss_s)!r}"
        f" with it, {float(loss_a)!r} and {float(loss_b)!r} without; "
        f"{len(same)} of {len(pa)} parameter leaves bit-equal over two runs "
        f"without it, {len(same) - len(bad)} of those bit-equal with it; "
        f"save-mode launches {json.dumps(saves)}")
    if not torch.equal(loss_s, loss_a) or bad or saves != {
            "fused_block_fwd": 3, "fused_block_bwd": 3}:
        raise AssertionError(f"save mode step: loss {float(loss_s)!r} vs "
                             f"{float(loss_a)!r}, leaves that differ {bad}, "
                             f"save-mode launches {saves}")
    n_leaves = len(pa)
    del pa, pb, ps

    # ---- the path, timed in turns, counted ----
    steps = 10
    metrics = task_metrics_init(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    with save_switch(True):  # warm up the allocator for the saved tensors
        for i in range(2):
            state, metrics, _ = tr.train_step(state, metrics, batches[i], gen)
    readings = {"off": [], "on": []}
    launches = {}
    for save in (False, True, True, False):
        with save_switch(save):
            state, metrics, losses, counts, step_ms, _ = timed_steps(
                tr, state, metrics, batches, gen, steps)
            saves = read_save_counts()
        want = {k: expected.get(k, 0) * steps for k in counts}
        want_s = {k: (3 * steps if save else 0) for k in saves}
        mode = "on" if save else "off"
        log(f"training path, save mode {mode}: {steps} steps, launches "
            f"{json.dumps(counts)}, in the save mode {json.dumps(saves)}; "
            f"step {step_ms:.3f} ms")
        if counts != want or saves != want_s or not np.isfinite(losses).all():
            raise AssertionError(f"save mode {mode}: launches {counts} "
                                 f"(want {want}), in the save mode {saves} "
                                 f"(want {want_s}), losses {losses}")
        readings[mode].append(step_ms)
        for k, n in saves.items():
            launches[k] = launches.get(k, 0) + n
    out = {"step_ms": statistics.mean(readings["on"]),
           "off_step_ms": statistics.mean(readings["off"]),
           "readings": readings, "loss_bit_equal": True,
           "leaves_bit_equal": len(same), "leaves": n_leaves,
           "save_launches": launches}
    out["examples_per_s"] = TRAIN_BATCH / (out["step_ms"] / 1e3)
    out["off_examples_per_s"] = TRAIN_BATCH / (out["off_step_ms"] / 1e3)
    log(f"training step at batch {TRAIN_BATCH}: save mode on "
        f"{out['step_ms']:.3f} ms ({out['examples_per_s']:.1f} examples/s), "
        f"off {out['off_step_ms']:.3f} ms "
        f"({out['off_examples_per_s']:.1f} examples/s), CUDA events, two "
        f"runs of {steps} steps each in turns")
    return out


def build_specs():
    """Every kernel library this script runs: the block kernels at the
    model's widths and at the other widths of ``WIDTH_CASES``."""
    from cikm2020_dmt_torch.ops import block

    widths = sorted({(80, 320, 4)} | {c[:3] for c in WIDTH_CASES})
    return [k for k in KERNELS if not k.startswith("fused_block")] + [
        block.library(k, *w) for w in widths
        for k in (block.KERNEL, block.BWD_KERNEL)]


def segsum_phase(cfg, tr, state, batch, counts, dev):
    """The segment sum against its plain version on the union of a real
    training batch (N = 2048 x 111 ids, D=32), bfloat16 (the main path's
    grid type) and float32, and with the budget overflowed; two launches
    the same bits in each case; timed in bfloat16 and float32."""
    from cikm2020_dmt_torch.ops import scatter_rows as sr
    from cikm2020_dmt_torch.train.lazy import collect

    spec = next(t for t in tr.lazy_plan if t.name == "Sku")
    table = state["params"]["emb"]["Sku"]
    col = collect(spec, batch, table, cfg.dedup_budget_div)
    over = collect(spec, batch, table, 64)
    N, U = col.ids.numel(), col.uids.numel()
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    err = 0.0
    for c, dtype in ((col, torch.bfloat16), (col, torch.float32),
                     (over, torch.bfloat16)):
        num = c.uids.numel() + 1
        g = torch.randn(N, 32, generator=gen, device=dev).to(dtype)
        got = sr.sorted_segment_sum_rows(g, c.order, c.seg_sorted, num)
        again = sr.sorted_segment_sum_rows(g, c.order, c.seg_sorted, num)
        want = sr.sorted_segment_sum_rows_ref(g, c.order, c.seg_sorted, num)
        torch.cuda.synchronize()
        # float32 sums of up to ~10**5 rows (the padding id's run) taken
        # in another order: the error scales with the sum of |g| of a run
        mag = sr.sorted_segment_sum_rows_ref(g.abs(), c.order, c.seg_sorted,
                                             num)
        d = (got - want).abs()
        ok = bool((d <= 1e-6 * mag + 1e-6).all())
        same = torch.equal(got, again)
        log(f"sorted_segsum N={N} D=32 {str(dtype).split('.')[-1]} "
            f"U={num - 1} overflow={int(c.overflow)}: max |diff| "
            f"{float(d.max()):.3e}, {float((d / (mag + 1e-30)).max()):.3e} "
            f"of the run's sum of |g| (tol 1e-6); two launches bit-equal: "
            f"{same}")
        if not ok:
            raise AssertionError("sorted_segsum disagrees with its plain "
                                 "version")
        if not same:
            raise AssertionError("sorted_segsum: two launches on the same "
                                 "inputs differ")
        err = max(err, float(d.max()))
    if int(over.overflow) <= 0:
        raise AssertionError("the overflow case did not overflow")
    num = U + 1
    lens = torch.unique_consecutive(col.seg_sorted, return_counts=True)[1]
    timed = {}
    g32 = torch.randn(N, 32, generator=gen, device=dev)
    for name, g, elem in (("bfloat16", g32.to(torch.bfloat16), 2),
                          ("float32", g32, 4)):
        ms = cuda_ms(lambda: sr.sorted_segment_sum_rows(
            g, col.order, col.seg_sorted, num), 50)
        plain = cuda_ms(lambda: sr.sorted_segment_sum_rows_ref(
            g, col.order, col.seg_sorted, num), 20)
        lib = cuda_ms(lambda: torch.zeros(num, 32, device=dev).index_add_(
            0, col.pos, g32), 20)
        b = bound(0, sr.segsum_bytes(N, 32, elem, num))
        log(f"sorted_segsum N={N} {name} ({lens.numel()} runs, the longest "
            f"{int(lens.max())} rows): kernel {ms:.4f} ms, plain "
            f"{plain:.4f} ms, index_add_ {lib:.4f} ms, bound {b[0]:.4f} ms "
            f"({b[1]}); kernel / bound {ms / b[0]:.2f}")
        timed[name] = (ms, plain, b, lib)
    ms, plain, b, lib = timed["bfloat16"]
    ms32, plain32, b32, lib32 = timed["float32"]
    entry = _entry(
        "sorted_segsum", "cikm2020_dmt_torch/csrc/sorted_segsum.cu",
        "cikm2020_dmt_tpu/ops/scatter_rows.py:169", counts["sorted_segsum"],
        err, ms, plain, b, lib,
        library_note="torch.zeros(U+1, 32).index_add_(0, pos, g) on the "
                     "float32 rows (index_add_ on the bf16 rows would sum in "
                     "bf16)",
        shape={"N": N, "D": 32, "dtype": "bfloat16", "num_out": num,
               "runs": lens.numel(), "longest_run": int(lens.max())},
        bit_equal_repeat=True,
        float32={"ms": ms32, "plain_ms": plain32, "bound_ms": b32[0],
                 "bound_by": b32[1], "library_ms": lib32})
    return entry, col


def update_phase(state, col, counts, dev):
    """The row writes against their plain versions at the main path's
    shapes: the [5M, 32] Sku table (bf16; float32 under ``grid_bf16``)
    with U rows (sentinels and five negative ids among them) and its
    float32 [2, 5M, 32] moments with 2U rows; compared exactly."""
    from cikm2020_dmt_torch.ops import scatter_rows as sr

    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    table = state["params"]["emb"]["Sku"]
    R, U = table.shape[0], col.uids.numel()
    ids = col.uids.clone()
    ids[:5] = -1 - torch.arange(5, device=dev)
    keep = (ids >= 0) & (ids < R)
    rows = torch.randn(U, 32, generator=gen, device=dev).to(table.dtype)
    ids2 = torch.cat([torch.where(keep, ids, 2 * R),
                      torch.where(keep, ids + R, 2 * R)])
    keep2 = ids2 < 2 * R
    rows2 = torch.randn(2 * U, 32, generator=gen, device=dev)
    entries = []
    for name, fn, ref, dst, i, r, k, elem, src, replaces in (
            ("update_rows", sr.update_rows, sr.update_rows_ref, table, ids,
             rows, keep, table.element_size(), "update_rows.cu",
             "cikm2020_dmt_tpu/ops/scatter_rows.py:45"),
            ("update_rows_3d", sr.update_rows_3d, sr.update_rows_3d_ref,
             state["lazy_opt"]["Sku"]["mv"], ids2, rows2, keep2, 4,
             "update_rows.cu", "scripts/probe_mv3d_tpu.py:25")):
        a, b = dst.clone(), dst.clone()
        fn(a, i, r)
        ref(b, i, r)
        torch.cuda.synchronize()
        if not torch.equal(a, b):
            raise AssertionError(f"{name} disagrees with its plain version")
        flat = b.view(-1, 32)
        iv, rv = i[k], r[k]
        ms = cuda_ms(lambda: fn(a, i, r), 50)
        plain = cuda_ms(lambda: ref(b, i, r), 20)
        lib = cuda_ms(lambda: flat.index_put_((iv,), rv), 20)
        n = int(k.sum())
        bd = bound(0, sr.update_rows_bytes(i.numel(), n, 32, elem))
        log(f"{name} {tuple(dst.shape)} {str(dst.dtype).split('.')[-1]}, "
            f"{i.numel()} ids ({n} written): exact; kernel {ms:.4f} ms, "
            f"plain {plain:.4f} ms, index_put_ {lib:.4f} ms, bound "
            f"{bd[0]:.4f} ms ({bd[1]}); kernel <= index_put_: {ms <= lib}")
        entries.append(_entry(
            name, "cikm2020_dmt_torch/csrc/" + src, replaces, counts[name],
            0.0, ms, plain, bd, lib,
            library_note="table[ids_valid] = rows_valid (index_put_), the "
                         "valid ids selected beforehand",
            shape={"table": list(dst.shape), "ids": i.numel(),
                   "written": n},
            targets={"vs_index_put": ms <= lib}))
        del a, b
    return entries


def _kernel_launches(fn) -> int:
    """Kernels the card ran for one call of ``fn`` (``torch.profiler``'s
    device activity)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def adam_exact(tr, state, batch, gen, what: str):
    """The dense Adam kernel (``ops/adam.py``) on ``tr``'s dense tree with
    one real step's gradients (the attention projections' cut from their
    fused products): p', m' and v' the same bits as the plain step leaf by
    leaf.  Returns (leaves, (lr, bc1, bc2), strided gradients)."""
    from cikm2020_dmt_torch.ops import adam
    from cikm2020_dmt_torch.train.optim import adam_scalars, zip_leaves

    b, cols = tr._collect(state["params"], batch)
    dense, diff, rows_d, _, _, loss = tr._forward(state, b, cols, gen)
    g_dense, _ = tr._backward(dense, diff, rows_d, loss)
    opt = state["opt"]
    leaves = zip_leaves(dense, g_dense, opt["m"], opt["v"])
    scalars = adam_scalars(opt["count"], tr.schedule)[1:]
    strided = sum(1 for _, g, _, _ in leaves if not g.is_contiguous())
    got = adam.adam_dense(leaves, *scalars)
    want = adam.adam_dense_ref(leaves, *scalars)
    torch.cuda.synchronize()
    for k, (g3, w3) in enumerate(zip(got, want)):
        for name, x, y in zip("pmv", g3, w3):
            if not torch.equal(x, y):
                raise AssertionError(f"adam_dense ({what}): leaf {k} {name} "
                                     f"{tuple(x.shape)} {x.dtype} differs "
                                     "from the plain step")
    log(f"adam_dense ({what}): {len(leaves)} dense leaves ({strided} "
        "gradients cut from a wider product), the same bits as the plain "
        "step")
    return leaves, scalars, strided


def adam_phase(tr, state, batch, gen, counts, dev) -> dict:
    """The dense Adam kernel on the flagship's dense tree (``adam_exact``),
    timed beside its bound (bytes): the kernel alone (the gradients made
    contiguous before), the whole call (the strided gradients' copies
    too), and the plain path's time, kernels a call and host time;
    ``counts`` are the training phase's launches."""
    from cikm2020_dmt_torch.ops import adam

    leaves, scalars, strided = adam_exact(tr, state, batch, gen, "dmt")
    contiguous = [(p, g.contiguous(), m, v) for p, g, m, v in leaves]

    def fused():
        return adam.adam_dense(leaves, *scalars)

    def plain():
        return adam.adam_dense_ref(leaves, *scalars)

    # ten calls, whose launches fit the card's queue, so the events time
    # the device's work back to back (fifty calls of the kernel alone read
    # 0.116-2.29 ms on one card, the host's pace leaking in); the median
    # of three such means.  The plain path's 2,078 launches a call never
    # fit, so its time is the host's pace
    def device_ms(fn):
        return statistics.median(cuda_ms(fn, 10) for _ in range(3))

    ms = device_ms(lambda: adam.adam_dense(contiguous, *scalars))
    call_ms = device_ms(fused)
    plain_ms = cuda_ms(plain, 10)
    host = {}
    for name, fn in (("kernel", fused), ("plain", plain)):
        runs = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            runs.append((time.perf_counter() - t0) * 1e3)
        host[name] = statistics.median(runs)
    kernels = {"kernel": _kernel_launches(fused),
               "plain": _kernel_launches(plain)}
    nbytes = adam.adam_bytes(leaves)
    bd = bound(0, nbytes)
    by_dtype = {str(dt).split(".")[-1]: sum(
        p.numel() for p, _, _, _ in leaves if p.dtype == dt)
        for dt in adam.TYPES}
    log(f"adam_dense on the flagship's {len(leaves)} dense leaves "
        f"({json.dumps(by_dtype)} elements): kernel {ms:.4f} ms; the "
        f"call {call_ms:.4f} ms in {kernels['kernel']} kernels ({strided} "
        f"copies of strided gradients); plain {plain_ms:.4f} ms in "
        f"{kernels['plain']} kernels (device time, at the host's pace); "
        "host ms a call, "
        f"synchronised before: kernel {host['kernel']:.3f}, plain "
        f"{host['plain']:.3f}; bound {bd[0]:.4f} ms ({bd[1]}, "
        f"{nbytes / 1e6:.1f} MB)")
    return _entry(
        "adam_dense", "cikm2020_dmt_torch/csrc/adam_dense.cu", None,
        counts["adam_dense"], 0.0, ms, plain_ms, bd, None,
        replaces_note="no TPU kernel: the JAX package leaves the dense "
                      "optimizer to XLA",
        shape={"leaves": len(leaves), "elements": by_dtype,
               "strided_grads": strided, "bytes": nbytes},
        call_ms=call_ms, kernels_a_call=kernels, host_ms=host,
        bit_equal={"dmt": len(leaves)},
        launches_by_path={"train": counts["adam_dense"]})


def eval_phase(cfg, params, dev) -> dict:
    """The eval path on ``cfg``: ``run_eval`` on 4 synthetic batches of
    the config's validation batch size, counted (12 attention-forward
    launches per batch, nothing else) and timed; one batch's metric values
    and scores against the same eval on the CPU (within 1e-4)."""
    from cikm2020_dmt_torch.data.pipeline import Batch
    from cikm2020_dmt_torch.models.zoo import build_model
    from cikm2020_dmt_torch.train import evaluate

    def run_eval(cfg, model, params, batches, device):
        """``run_eval`` over given batches of tensors (no header lines):
        (metric values, p_clk, p_ord)."""
        vals, _, clk, ord_ = evaluate.run_eval(
            cfg, model, params, None, n,
            data_iter=[Batch(b, [b""] * n) for b in batches], device=device)
        return vals, clk, ord_

    n = cfg.validation_batch_size
    model = build_model(cfg)
    batches = [synthetic_batch(cfg, n, SEED + 200 + i, dev)
               for i in range(4)]
    run_eval(cfg, model, params, batches[:1], device=dev)  # warm-up

    # ---- the main path: 4 batches, counted ----
    reset_counts()
    t0 = time.perf_counter()
    vals, clk, ord_ = run_eval(cfg, model, params, batches, device=dev)
    seconds = time.perf_counter() - t0
    counts = read_counts()
    eps = len(batches) * n / seconds
    log(f"eval path: {len(batches)} batches of {n}: launches "
        f"{json.dumps(counts)}; {seconds * 1e3 / len(batches):.3f} ms per "
        f"batch (host clock, ends in the scores' copy), {eps:.1f} "
        f"examples/s; metrics {json.dumps(vals)}")
    want = {k: (12 * len(batches) if k == "attention_fwd" else 0)
            for k in counts}
    if counts != want:
        raise AssertionError(f"eval launched {counts}, expected {want}")
    if clk.shape != (len(batches) * n,) or not (
            np.isfinite(clk).all() and np.isfinite(ord_).all()
            and all(np.isfinite(v) for v in vals.values())):
        raise AssertionError("eval: scores or metrics not finite")

    # ---- one batch on the card against the CPU ----
    t0 = time.perf_counter()
    one = run_eval(cfg, model, params, batches[:1], device=dev)
    ref = run_eval(cfg, model, params,
                   [{k: v.cpu() for k, v in batches[0].items()}],
                   device="cpu")
    s_err = max(float(np.abs(a - b).max()) for a, b in zip(one[1:], ref[1:]))
    m_err = max(abs(one[0][k] - ref[0][k]) for k in ref[0])
    log(f"eval card vs CPU, one batch of {n}: scores max |diff| "
        f"{s_err:.3e}, metric values max |diff| {m_err:.3e} (tol 1e-4), "
        f"{time.perf_counter() - t0:.2f}s")
    if not (s_err <= 1e-4 and m_err <= 1e-4):
        raise AssertionError(f"eval card vs CPU: scores {s_err}, metrics "
                             f"{m_err}")
    return {"counts": counts, "ms_per_batch": seconds * 1e3 / len(batches),
            "examples_per_s": eps, "batch": n}


# (name, Tq, Tk, launches per step of the 2+2 stacks): the encoder's
# self-attention and the decoder's single query, over the click and order
# sequences (T=50) and the cart (T=10)
ATTENTION_SHAPES = (("enc", 50, 50, 4), ("enc", 10, 10, 2),
                    ("dec", 1, 50, 4), ("dec", 1, 10, 2))
# the attention backward against its plain version: elementwise, relative
# to each output's largest |value|.  Attention has no ReLU kink: float32
# differs only in the order of sums
ATT_BWD_TOL = 1e-4


def _attention_inputs(B, Tq, Tk, dtype, gen, dev):
    """Standard-normal q [B, Tq, 80], k, v [B, Tk, 80] and a cotangent;
    key lengths cycling through 0..Tk; the encoder's query mask is its key
    mask, the decoder's all ones."""
    q, k, v, do = (torch.randn(B, t, 80, generator=gen, device=dev).to(dtype)
                   for t in (Tq, Tk, Tk, Tq))
    lens = torch.arange(B, device=dev) % (Tk + 1)
    km = (torch.arange(Tk, device=dev)[None] < lens[:, None]).float()
    qm = km if Tq == Tk else torch.ones(B, Tq, device=dev)
    return q, k, v, qm, km, do


def _max_rel(got, want):
    return max(float((a.float() - b.float()).abs().max()
                     / b.float().abs().max().clamp(min=1e-30))
               for a, b in zip(got, want))


def bf16_ulp(x):
    """Spacing of bfloat16 values at |x| (8 significant bits)."""
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp(min=2.0 ** -100)))
                      - 7)


# the bfloat16 attention forward against its plain version: both round the
# same operands at the same points, and only the order of float32 sums
# differs, so it rarely flips a rounding.  Per element, two flips of the
# output's rounding (an ulp of |out|) and two of a probability's before
# P v (an ulp of the row's largest probability times the head's largest
# |v|) bound the difference; a kernel that rounds at other points differs
# in a large share of the elements, so that share is held too
ATT_BF16_DIFF_SHARE = 1e-2


def bf16_attention_fwd_check(got, ref, q, k, v, qm, km, H=4):
    """(largest |got - ref| over its per-element limit, share of elements
    that differ at all) for a bfloat16 attention forward."""
    from cikm2020_dmt_torch.ops.attention import attention_probs, heads, merge
    p = attention_probs(heads(q.float(), H), heads(k.float(), H), km)
    pmax = (p * qm[:, None, :, None]).amax(-1, keepdim=True)
    vmax = heads(v.float().abs(), H).amax(2, keepdim=True)
    limit = 2 * bf16_ulp(ref.float()) + merge(2 * bf16_ulp(pmax) * vmax)
    diff = (got.float() - ref.float()).abs()
    return float((diff / limit).max()), float((diff > 0).float().mean())


def _sdpa_args(q, k, v, km):
    """[B, H, T, dh] views and the additive float mask (0 or -2^32+1 at a
    masked key) for scaled_dot_product_attention."""
    from cikm2020_dmt_torch.ops.attention import NEG_INF, heads
    mask = torch.where(km > 0, 0.0, NEG_INF)[:, None, None, :]
    return [heads(t, 4) for t in (q, k, v)] + [mask]


def attention_phase(counts: dict, dev) -> tuple[dict, dict]:
    """Both attention kernels against their plain versions on the card at
    every shape of the path (B = 300 serving, 2048 training, 4096 eval;
    the four (Tq, Tk) of ``ATTENTION_SHAPES``), float32 and bfloat16;
    the backward's two launches on the same inputs compared bit for bit;
    float32 (the main path's type) timed beside the plain versions, the
    bound and the SDPA yardstick.  ``counts`` holds each kernel's launches
    on the main paths.  Returns the two entries of the kernels line."""
    from cikm2020_dmt_torch.ops import attention as att

    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    fshapes, bshapes = [], []
    ferr = berr = ferr16 = 0.0
    for B in (CANDIDATES, TRAIN_BATCH, 4096):
        for part, Tq, Tk, per_step in ATTENTION_SHAPES:
            for dtype in (torch.float32, torch.bfloat16):
                dname = str(dtype).split(".")[-1]
                q, k, v, qm, km, do = _attention_inputs(B, Tq, Tk, dtype,
                                                        gen, dev)
                got = att.fused_attention(q, k, v, qm, km, 4)
                ref = att.fused_attention_ref(q, k, v, qm, km, 4)
                gb = att.fused_attention_bwd(q, k, v, qm, km, do, 4)
                again = att.fused_attention_bwd(q, k, v, qm, km, do, 4)
                rb = att.fused_attention_bwd_ref(q, k, v, qm, km, do, 4)
                torch.cuda.synchronize()
                where = f"B={B} {part} Tq={Tq} Tk={Tk} {dname}"
                if not all(torch.equal(a, b) for a, b in zip(gb, again)):
                    raise AssertionError(f"attention_bwd at {where}: two "
                                         "launches on the same inputs "
                                         "differ")
                f_err = float((got.float() - ref.float()).abs().max())
                if dtype == torch.float32:
                    b_err, tol, what = _max_rel(gb, rb), ATT_BWD_TOL, "plain"
                    f_ok = f_err <= KERNEL_TOL[dtype]
                    f_what = f"(tol {KERNEL_TOL[dtype]})"
                else:
                    r32 = att.fused_attention_bwd_ref(
                        q.float(), k.float(), v.float(), qm, km, do.float(),
                        4)
                    plain = _max_rel(rb, r32)
                    b_err = _max_rel(gb, r32)
                    tol = BWD_BF16_FACTOR * plain + ATT_BWD_TOL
                    what = f"float32 plain (bf16 plain {plain:.3e})"
                    ratio, share = bf16_attention_fwd_check(got, ref, q, k, v,
                                                            qm, km)
                    f_ok = ratio <= 1.0 and share <= ATT_BF16_DIFF_SHARE
                    f_what = (f"({ratio:.3f} of the per-element limit, "
                              f"{share:.3e} of elements differ, at most "
                              f"{ATT_BF16_DIFF_SHARE})")
                log(f"attention {where}: forward max |diff| {f_err:.3e} "
                    f"{f_what}; backward {b_err:.3e} of "
                    f"each output's max vs {what} (tol {tol:.3e}); "
                    "backward bitwise repeatable")
                if not (torch.isfinite(got.float()).all() and f_ok):
                    raise AssertionError(f"attention_fwd disagrees at "
                                         f"{where}: {f_what}")
                if not (all(torch.isfinite(t.float()).all() for t in gb)
                        and b_err <= tol):
                    raise AssertionError(f"attention_bwd disagrees at "
                                         f"{where}: {b_err}")
                if dtype != torch.float32:
                    ferr16 = max(ferr16, f_err)
                    continue
                ferr = max(ferr, f_err)
                berr = max(berr, max(float((a - b).abs().max())
                                     for a, b in zip(gb, rb)))
                fshapes.append(_time_attention_fwd(att, sdpa, B, Tq, Tk,
                                                   part, per_step, q, k, v,
                                                   qm, km))
                bshapes.append(_time_attention_bwd(att, sdpa, B, Tq, Tk,
                                                   part, per_step, q, k, v,
                                                   qm, km, do))
                del again

    def per_step(shapes, key, B=TRAIN_BATCH):
        """The sum over one request, eval batch or training step (they
        launch the same 12 shapes) at batch size ``B``."""
        return sum(s[key] * s["per_step"] for s in shapes if s["B"] == B)

    def step_bound(flops, nbytes, B=TRAIN_BATCH):
        return bound(sum(flops(B, tq, tk, 80) * n
                         for _, tq, tk, n in ATTENTION_SHAPES),
                     sum(nbytes(B, tq, tk, 80, 4) * n
                         for _, tq, tk, n in ATTENTION_SHAPES))

    def by_unit(shapes, flops, nbytes, units):
        out = {}
        for unit, B in units:
            out[unit] = {"B": B, "bound_ms": step_bound(flops, nbytes, B)[0],
                         **{k: per_step(shapes, k, B) for k in
                            ("ms", "plain_ms", "library_ms")}}
            log(f"{shapes[0]['kernel']} per {unit} (B={B}, 12 launches): "
                + ", ".join(f"{k} {v:.4f}" for k, v in out[unit].items()
                            if k != "B"))
        return out

    unit = ("ms per training step of the 2+2 stacks: 4 launches at (Tq, "
            "Tk) = (50, 50), 2 at (10, 10), 4 at (1, 50), 2 at (1, 10); "
            "B=2048, f32")
    fwd = _entry(
        "attention_fwd", "cikm2020_dmt_torch/csrc/attention_fwd.cu",
        "cikm2020_dmt_tpu/ops/attention.py:52", counts["attention_fwd"],
        ferr, per_step(fshapes, "ms"), per_step(fshapes, "plain_ms"),
        step_bound(att.attention_flops, att.attention_bytes),
        per_step(fshapes, "library_ms"),
        library_note="torch.nn.functional.scaled_dot_product_attention on "
                     "[B, 4, T, 20] views with the additive float mask (0 "
                     "or -2^32+1 at a masked key); the zeroing of absent "
                     "query rows is not part of it",
        unit=unit, max_abs_err_bf16=ferr16, shapes=fshapes,
        by_unit=by_unit(fshapes, att.attention_flops, att.attention_bytes,
                        (("request", CANDIDATES), ("eval_batch", 4096),
                         ("training_step", TRAIN_BATCH))))
    bwd = _entry(
        "attention_bwd", "cikm2020_dmt_torch/csrc/attention_bwd.cu",
        "cikm2020_dmt_tpu/ops/attention.py:89", counts["attention_bwd"],
        berr, per_step(bshapes, "ms"), per_step(bshapes, "plain_ms"),
        step_bound(att.attention_bwd_flops, att.attention_bwd_bytes),
        per_step(bshapes, "library_ms"),
        library_note="torch.autograd.grad through that SDPA call (its "
                     "backward only: the graph is kept between calls)",
        unit=unit, shapes=bshapes, deterministic=True,
        by_unit=by_unit(bshapes, att.attention_bwd_flops,
                        att.attention_bwd_bytes,
                        (("training_step", TRAIN_BATCH),)))
    bwd["targets"] = attention_bwd_targets(bshapes, bwd["ms"])
    fwd["targets"] = attention_fwd_targets(fshapes, fwd["ms"])
    return fwd, bwd


# the attention forward's targets at B=2048, float32: the encoder's (50,
# 50) faster than SDPA and within 0.20 ms, a training step's 12 launches
# within 1.2 ms, and no shape more than 5% slower than its time before the
# redesign (PERF.md, the kernel table).  Reported, not enforced
ATT_FWD_T50_MS = 0.20
ATT_FWD_STEP_MS = 1.2
ATT_FWD_BEFORE_MS = {(50, 50): 0.3660, (10, 10): 0.0447, (1, 50): 0.0634,
                     (1, 10): 0.0127}


def attention_fwd_targets(shapes, step_ms) -> dict:
    mine = {(s["Tq"], s["Tk"]): s for s in shapes if s["B"] == TRAIN_BATCH}
    t50 = mine[(50, 50)]
    out = {"50x50_vs_sdpa": t50["ms"] < t50["library_ms"],
           "50x50_within_ms": t50["ms"] <= ATT_FWD_T50_MS,
           "step_within_ms": step_ms <= ATT_FWD_STEP_MS}
    for key, before in ATT_FWD_BEFORE_MS.items():
        out[f"{key[0]}x{key[1]}_within_5pct_of_before"] = (
            mine[key]["ms"] <= 1.05 * before)
    log(f"attention_fwd targets at B={TRAIN_BATCH} f32: {json.dumps(out)} "
        f"((50, 50) {t50['ms']:.4f} ms, SDPA {t50['library_ms']:.4f}, limit "
        f"{ATT_FWD_T50_MS}; step {step_ms:.4f} ms, limit {ATT_FWD_STEP_MS})")
    return out


# the attention backward's targets at B=2048, float32: no slower than SDPA's
# backward at each shape, the encoder's (50, 50) within 0.30 ms, a training
# step's 12 launches within 1.75 ms.  Reported, not enforced: a kernel that
# misses them stays, with its numbers
ATT_BWD_T50_MS = 0.30
ATT_BWD_STEP_MS = 1.75


def attention_bwd_targets(shapes, step_ms) -> dict:
    out = {f"{s['Tq']}x{s['Tk']}_vs_sdpa": s["ms"] <= s["library_ms"]
           for s in shapes if s["B"] == TRAIN_BATCH}
    t50 = next(s["ms"] for s in shapes
               if s["B"] == TRAIN_BATCH and s["Tq"] == s["Tk"] == 50)
    out["50x50_within_ms"] = t50 <= ATT_BWD_T50_MS
    out["step_within_ms"] = step_ms <= ATT_BWD_STEP_MS
    log(f"attention_bwd targets at B={TRAIN_BATCH} f32: {json.dumps(out)} "
        f"((50, 50) {t50:.4f} ms, limit {ATT_BWD_T50_MS}; step "
        f"{step_ms:.4f} ms, limit {ATT_BWD_STEP_MS})")
    return out


def _time_attention_fwd(att, sdpa, B, Tq, Tk, part, per_step, q, k, v, qm,
                        km) -> dict:
    args = _sdpa_args(q, k, v, km)
    ms = cuda_ms(lambda: att.fused_attention(q, k, v, qm, km, 4), 20)
    plain = cuda_ms(lambda: att.fused_attention_ref(q, k, v, qm, km, 4), 10)
    lib = cuda_ms(lambda: sdpa(*args[:3], attn_mask=args[3]), 10)
    b = bound(att.attention_flops(B, Tq, Tk, 80),
              att.attention_bytes(B, Tq, Tk, 80, 4))
    pr5 = ATT_FWD_PR5_MS[(Tq, Tk)] if B == TRAIN_BATCH else "not timed"
    log(f"attention_fwd B={B} {part} Tq={Tq} Tk={Tk} f32: kernel {ms:.4f} "
        f"ms (PR 5: {pr5}), plain {plain:.4f} ms, SDPA {lib:.4f} ms, bound {b[0]:.4f} ms "
        f"({b[1]})")
    return {"kernel": "attention_fwd", "B": B, "Tq": Tq, "Tk": Tk,
            "part": part, "dtype": "float32", "per_step": per_step,
            "ms": ms, "plain_ms": plain, "library_ms": lib, "bound_ms": b[0],
            "bound_by": b[1]}


def _time_attention_bwd(att, sdpa, B, Tq, Tk, part, per_step, q, k, v, qm,
                        km, do) -> dict:
    ms = cuda_ms(lambda: att.fused_attention_bwd(q, k, v, qm, km, do, 4), 10)
    plain = cuda_ms(lambda: att.fused_attention_bwd_ref(q, k, v, qm, km, do,
                                                        4), 5)
    *qkv, mask = _sdpa_args(*(t.detach().requires_grad_()
                              for t in (q, k, v)), km)
    out = sdpa(*qkv, attn_mask=mask)
    g = att.heads(do, 4)
    lib = cuda_ms(lambda: torch.autograd.grad(out, qkv, g,
                                              retain_graph=True), 5)
    del out
    b = bound(att.attention_bwd_flops(B, Tq, Tk, 80),
              att.attention_bwd_bytes(B, Tq, Tk, 80, 4))
    pr5 = ATT_BWD_PR5_MS[(Tq, Tk)] if B == TRAIN_BATCH else "not timed"
    log(f"attention_bwd B={B} {part} Tq={Tq} Tk={Tk} f32: kernel {ms:.4f} "
        f"ms (PR 5: {pr5}), plain {plain:.4f} ms, SDPA backward {lib:.4f} ms, bound "
        f"{b[0]:.4f} ms ({b[1]})")
    return {"kernel": "attention_bwd", "B": B, "Tq": Tq, "Tk": Tk,
            "part": part, "dtype": "float32", "per_step": per_step,
            "ms": ms, "plain_ms": plain, "library_ms": lib, "bound_ms": b[0],
            "bound_by": b[1]}


# ---------------------------------------------------------------------------
# The rest of the model lattice (mlp ... mmoe_transformer) and the paper
# baselines (lr, wnd, dcn, din, dien): thirteen paths at full width, 1 + 1
# blocks of (80, 320, 4)
# ---------------------------------------------------------------------------

_CONF_DIR = os.path.dirname(CONF)
# (path, conf file, model_type replacing the file's): the four demo
# configurations as written, and four lattice types and the five paper
# baselines, which no conf file configures, on conf/dmt.conf (as the JAX
# package's tests build them)
BASELINES = ("lr", "wnd", "dcn", "din", "dien")
ZOO_PATHS = (
    ("mlp_demo", "mlp_demo.conf", None),
    ("embed_mlp_demo", "embed_mlp_demo.conf", None),
    ("transformer_demo", "transformer_demo.conf", None),
    ("mmoe_transformer_demo", "mmoe_transformer_demo.conf", None),
    ("multi_task", "dmt.conf", "multi_task"),
    ("mmoe", "dmt.conf", "mmoe"),
    ("multi_task_transformer", "dmt.conf", "multi_task_transformer"),
    ("embed_mlp_unbias", "dmt.conf", "embed_mlp_unbias"),
) + tuple((name, "dmt.conf", name) for name in BASELINES)
# launches per training step: the fused block forward and backward once
# per sequence group, the lazy update's three where a table has at least
# dedup_rows_threshold (1,000,000) rows (Sku in every configuration with
# tables), the dense Adam one a 63 dense leaves (every path trains with
# Adam: mmoe_transformer_demo has 130 leaves, multi_task_transformer 108,
# dien 66, the others 8-43); mlp has no table and the baselines run no
# block
EXPECTED_PER_STEP.update({
    "mlp_demo": {"adam_dense": 1},
    "embed_mlp_demo": {**LAZY_PER_STEP, "adam_dense": 1},
    "transformer_demo": {"fused_block_fwd": 1, "fused_block_bwd": 1,
                         **LAZY_PER_STEP, "adam_dense": 1},
    "mmoe_transformer_demo": {"fused_block_fwd": 3, "fused_block_bwd": 3,
                              **LAZY_PER_STEP, "adam_dense": 3},
    "multi_task": {**LAZY_PER_STEP, "adam_dense": 1},
    "mmoe": {**LAZY_PER_STEP, "adam_dense": 1},
    "multi_task_transformer": {"fused_block_fwd": 3, "fused_block_bwd": 3,
                               **LAZY_PER_STEP, "adam_dense": 2},
    "embed_mlp_unbias": {**LAZY_PER_STEP, "adam_dense": 1},
    **{name: {**LAZY_PER_STEP, "adam_dense": 2 if name == "dien" else 1}
       for name in BASELINES},
})
DIN_FILE_STEPS = 2          # cli.train steps of din_files_check, one save
ZOO_STEPS = 5               # timed training steps at TRAIN_BATCH
ZOO_EVAL = (2, 4096)        # eval batches and their size
ZOO_REQUESTS = (5, 25)      # serving warm-ups and timed requests
ZOO_OPTIMIZERS = ("sgd", "adadelta", "adagrad", "rmsprop", "ftrl")


def zoo_config(conf: str, model_type=None):
    from cikm2020_dmt_torch.core.config import DMTConfig
    cfg = DMTConfig.from_ini(os.path.join(_CONF_DIR, conf))
    return cfg if model_type is None else dataclasses.replace(
        cfg, model_type=model_type)


def _norm_constants(cfg):
    from cikm2020_dmt_torch.serve.export import norm_constants
    nrng = np.random.default_rng(SEED)
    mean = nrng.normal(0.5, 1.0, cfg.feature_dimension)
    std = nrng.uniform(0.1, 3.0, cfg.feature_dimension)
    return mean, std, norm_constants(mean, std)


def _expect(counts: dict, per: dict, n: int, what: str) -> None:
    want = {k: per.get(k, 0) * n for k in counts}
    if counts != want:
        raise AssertionError(f"{what} launched {counts}, expected {want}")


def zoo_path(name: str, cfg, dev) -> dict:
    """One lattice path at full width: (a) one step at batch 256 against
    the CPU (``card_vs_cpu_step``), (b) ``ZOO_STEPS`` timed training steps
    at batch 2048 after two warm-ups, exactly ``EXPECTED_PER_STEP[name]``
    launches a step, (c) ``run_eval`` over ``ZOO_EVAL`` batches, one block
    forward per sequence group and batch, (d) ``Scorer`` latency over
    ``ZOO_REQUESTS`` requests of 300, one block forward per group and
    request, and the three requests' Scores within ``SCORES_TOL`` of a
    ``Scorer`` on the CPU over the same state (a paper baseline's in
    [0, 1]: ``check_scores``).  Returns the path's numbers and its
    counts."""
    from cikm2020_dmt_torch.data.pipeline import Batch
    from cikm2020_dmt_torch.metrics.streaming import task_metrics_init
    from cikm2020_dmt_torch.nn.layers import tree_map
    from cikm2020_dmt_torch.serve.export import Scorer
    from cikm2020_dmt_torch.train import evaluate
    from cikm2020_dmt_torch.train.loop import Trainer

    t_path = time.perf_counter()
    expected = EXPECTED_PER_STEP[name]
    groups = expected.get("fused_block_fwd", 0)
    check = card_vs_cpu_step(cfg, dev)
    torch.cuda.empty_cache()

    # ---- (b) training, counted ----
    tr = Trainer(cfg, device=dev)
    state = tr.init_state(torch.Generator(device=dev).manual_seed(SEED))
    batches = [synthetic_batch(cfg, TRAIN_BATCH, SEED + 300 + i, dev)
               for i in range(2)]
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    metrics = task_metrics_init(dev)
    for i in range(2):
        state, metrics, _ = tr.train_step(state, metrics, batches[i], gen)
    torch.cuda.synchronize()
    state, metrics, losses, train_counts, step_ms, wall_ms = timed_steps(
        tr, state, metrics, batches, gen, ZOO_STEPS)
    _expect(train_counts, expected, ZOO_STEPS, f"{name} training")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{name}: non-finite training loss {losses}")
    del batches

    # ---- (c) eval, counted ----
    n_eval, eval_bs = ZOO_EVAL
    ebatches = [synthetic_batch(cfg, eval_bs, SEED + 400 + i, dev)
                for i in range(n_eval)]
    data = [Batch(b, [b""] * eval_bs) for b in ebatches]

    def run_eval(batches):
        return evaluate.run_eval(cfg, tr.model, state["params"], None,
                                 eval_bs, data_iter=batches, device=dev,
                                 model_state=state["model_state"])

    run_eval(data[:1])                      # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    vals, _, clk, ord_ = run_eval(data)
    eval_s = time.perf_counter() - t0
    eval_counts = read_counts()
    _expect(eval_counts, {"fused_block_fwd": groups}, n_eval,
            f"{name} eval")
    if clk.shape != (n_eval * eval_bs,) or not (
            np.isfinite(clk).all() and np.isfinite(ord_).all()
            and all(np.isfinite(v) for v in vals.values())):
        raise AssertionError(f"{name} eval: scores or metrics not finite")
    del ebatches, data

    # ---- (d) serving, counted ----
    _, _, (scale, const_vec) = _norm_constants(cfg)
    scorer = Scorer(cfg, state["params"], scale, const_vec,
                    model_state=state["model_state"])
    requests = make_requests(cfg, CANDIDATES, REQUEST_LENS, SEED)
    closed = cfg.model_type in BASELINES
    warm, timed = ZOO_REQUESTS
    for i in range(warm):
        check_scores(scorer(requests[i % len(requests)]), CANDIDATES,
                     closed)
    torch.cuda.synchronize()
    reset_counts()
    lat = []
    for i in range(timed):
        t0 = time.perf_counter()
        out = scorer(requests[i % len(requests)])
        lat.append((time.perf_counter() - t0) * 1e3)
    serve_counts = read_counts()
    _expect(serve_counts, {"fused_block_fwd": groups}, timed,
            f"{name} serving")
    check_scores(out, CANDIDATES, closed)
    # the requests on the card against the same Scorer on the CPU
    cpu = Scorer(cfg, tree_map(lambda t: t.cpu(), state["params"]), scale,
                 const_vec, device="cpu",
                 model_state=tree_map(lambda t: t.cpu(),
                                      state["model_state"]))
    serve_err = max(float(np.abs(a[k] - b[k]).max())
                    for a, b in ((scorer(q), cpu(q)) for q in requests)
                    for k in b)
    if not serve_err <= SCORES_TOL:
        raise AssertionError(f"{name} serving: card vs CPU Scores "
                             f"{serve_err} (tol {SCORES_TOL})")
    del cpu
    p50 = statistics.median(lat)
    p90 = sorted(lat)[int(0.9 * len(lat)) - 1]
    rec = {"model_type": cfg.model_type, "step_ms": step_ms,
           "step_wall_ms": wall_ms,
           "examples_per_s": TRAIN_BATCH / (step_ms / 1e3),
           "losses": [losses[0], losses[-1]],
           "eval_ms_per_batch": eval_s * 1e3 / n_eval,
           "eval_examples_per_s": n_eval * eval_bs / eval_s,
           "p50_ms": p50, "p90_ms": p90, "serve_card_vs_cpu": serve_err,
           "card_vs_cpu": {k: v for k, v in check.items()
                           if k != "seconds"},
           "counts": {k: train_counts[k] + eval_counts[k] + serve_counts[k]
                      for k in train_counts},
           "seconds": time.perf_counter() - t_path}
    log(f"zoo {name} ({cfg.model_type}): step {step_ms:.3f} ms (CUDA "
        f"events; host clock {wall_ms:.3f} ms), "
        f"{rec['examples_per_s']:.1f} examples/s at batch {TRAIN_BATCH}, "
        f"losses {losses[0]:.4f}..{losses[-1]:.4f}; eval "
        f"{rec['eval_ms_per_batch']:.3f} ms per batch of {eval_bs}, "
        f"{rec['eval_examples_per_s']:.1f} examples/s; request p50 "
        f"{p50:.3f} ms, p90 {p90:.3f} ms over {timed} of {CANDIDATES}, "
        f"card vs CPU Scores {serve_err:.3e}; launches train {json.dumps(train_counts)}, eval "
        f"{eval_counts['fused_block_fwd']}, serve "
        f"{serve_counts['fused_block_fwd']} block forwards; "
        f"{rec['seconds']:.1f}s")
    del tr, state, scorer
    torch.cuda.empty_cache()
    return rec


def zoo_bn_check(dev, d: str) -> dict:
    """``mmoe_transformer_demo`` with batch norm (the per-expert MMoE):
    one step against the CPU, moving statistics included; then one step
    on the card saved as a checkpoint, exported as a float32 bundle,
    loaded, and scored against a ``Scorer`` over the checkpoint's params
    and model state (the same card, so within ``SCORES_TOL``)."""
    from cikm2020_dmt_torch.metrics.streaming import task_metrics_init
    from cikm2020_dmt_torch.serve.export import (Scorer, export_model,
                                                 load_scorer)
    from cikm2020_dmt_torch.train.loop import Trainer

    t0 = time.perf_counter()
    mean, std, (scale, const_vec) = _norm_constants(
        zoo_config("mmoe_transformer_demo.conf"))
    for stat, v in (("mean", mean), ("std", std)):
        with open(os.path.join(d, stat), "w") as f:
            f.write("\t".join(repr(float(x)) for x in v) + "\n")
    cfg = dataclasses.replace(
        zoo_config("mmoe_transformer_demo.conf"), is_bn=True,
        output_path=os.path.join(d, "out"),
        train_data_mean_path=os.path.join(d, "mean"),
        train_data_std_path=os.path.join(d, "std"))
    check = card_vs_cpu_step(cfg, dev)
    torch.cuda.empty_cache()
    tr = Trainer(cfg, device=dev)
    state = tr.init_state(torch.Generator(device=dev).manual_seed(SEED))
    state, _, _ = tr.train_step(
        state, task_metrics_init(dev),
        synthetic_batch(cfg, TRAIN_BATCH, SEED + 500, dev),
        torch.Generator(device=dev).manual_seed(SEED))
    tr.ckpt.save(1, state)
    bundle = load_scorer(cfg, export_model(cfg, 1, os.path.join(d, "bundle")),
                         device=dev)
    direct = Scorer(cfg, state["params"], scale, const_vec,
                    model_state=state["model_state"])
    err = 0.0
    for req in make_requests(cfg, CANDIDATES, REQUEST_LENS, SEED):
        a, b = bundle(req), direct(req)
        # after one step the moving variance is 0.001 of the batch's, so
        # the normalized logits are large and a probability may round to
        # 0 or 1 (the reference's arithmetic): finite and in [0, 1]
        for k, v in a.items():
            if v.shape != (CANDIDATES,) or not (
                    np.isfinite(v).all() and (v >= 0).all()
                    and (v <= 1).all()):
                raise AssertionError(f"zoo batch-norm bundle {k}: {v}")
        err = max(err, max(float(np.abs(a[k] - b[k]).max()) for k in b))
    n_state = len(list(_leaves(bundle.model_state)))
    log(f"zoo batch norm (mmoe_transformer_demo, is_bn): card vs CPU "
        f"moving statistics norm-wise {check['model_state_err']:.2e}; "
        f"float32 bundle ({n_state} moving statistics) vs the "
        f"checkpoint's Scorer: max |diff| {err:.3e} (tol {SCORES_TOL}); "
        f"{time.perf_counter() - t0:.1f}s")
    if not (n_state and err <= SCORES_TOL):
        raise AssertionError(f"zoo batch-norm bundle: {n_state} moving "
                             f"statistics, Scores differ by {err}")
    del tr, state, bundle, direct
    torch.cuda.empty_cache()
    return {"card_vs_cpu": {k: v for k, v in check.items()
                            if k != "seconds"},
            "bundle_scores_err": err, "moving_statistics": n_state}


def din_files_check(dev, d: str) -> dict:
    """``din`` on ``conf/dmt.conf`` as a user runs it, at full width:
    ``DIN_FILE_STEPS`` shards of ``TRAIN_BATCH`` examples written with
    ``write_shards``, ``cli.train`` over them with one save at the last
    step (exactly the lazy update's three launches and one dense Adam a
    step, finite
    losses), then ``cli.export`` of a float32 bundle and of an int8 one
    (``export_int8_rows`` ``INT8_ROWS`` in the config's ``[export_model]``:
    Sku), each read back by ``load_scorer`` and scoring the three
    requests: float32 within ``SCORES_TOL`` of a ``Scorer`` over the
    restored checkpoint, int8 within ``INT8_TOL`` of float32; export and
    serving launch no kernel.  Returns the numbers and the training
    launches."""
    from cikm2020_dmt_torch.cli import export as cli_export
    from cikm2020_dmt_torch.cli import train as cli_train
    from cikm2020_dmt_torch.core.checkpoint import CheckpointManager
    from cikm2020_dmt_torch.core.config import DMTConfig
    from cikm2020_dmt_torch.serve.export import Scorer, load_scorer

    t_all = time.perf_counter()
    steps = DIN_FILE_STEPS
    cfg = dataclasses.replace(zoo_config("dmt.conf", "din"),
                              validate_step=steps, batch_size=TRAIN_BATCH)
    mean, std, (scale, const_vec) = _norm_constants(cfg)
    stats = {}
    for stat, v in (("mean", mean), ("std", std)):
        stats[stat] = os.path.join(d, stat)
        with open(stats[stat], "w") as f:
            f.write("\t".join(repr(float(x)) for x in v) + "\n")
    data = os.path.join(d, "data")
    os.makedirs(data)
    write_shards(cfg, data, steps, TRAIN_BATCH, SEED + 600)
    confs = {}
    for kind, rows in (("f32", 0), ("int8", INT8_ROWS)):
        # two copies of one config file (one model tag), as a user keeps
        confs[kind] = os.path.join(d, kind, "din.conf")
        os.makedirs(os.path.dirname(confs[kind]))
        write_conf(dataclasses.replace(cfg, export_int8_rows=rows),
                   confs[kind], data + "/", os.path.join(d, "out"),
                   train_data_mean_path=stats["mean"],
                   train_data_std_path=stats["std"])
    reset_counts()
    t0 = time.perf_counter()
    tr = cli_train.main(["--conf_file", confs["f32"], "--device", str(dev),
                         "--max_steps", str(steps)])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_counts = read_counts()
    _expect(train_counts, EXPECTED_PER_STEP["din"], steps, "din cli.train")
    ecfg = DMTConfig.from_ini(confs["f32"])
    with open(os.path.join(ecfg.summary_path, "train.jsonl")) as f:
        summary = [json.loads(line) for line in f]
    if tr.last_step != steps or [x["step"] for x in summary] != [steps] \
            or not np.isfinite(summary[0]["loss"]):
        raise AssertionError(f"din cli.train: last step {tr.last_step}, "
                             f"summary {summary}")
    del tr
    torch.cuda.empty_cache()

    reset_counts()
    scorers, export_s = {}, {}
    for kind, conf in confs.items():
        t0 = time.perf_counter()
        bundle = cli_export.main(["--conf_file", conf, "--model_ckpt",
                                  f"model.ckpt-{steps}"])
        export_s[kind] = time.perf_counter() - t0
        with open(os.path.join(bundle, "descriptor.json")) as f:
            int8 = json.load(f)["int8_tables"]
        if int8 != [] if kind == "f32" else "Sku" not in int8:
            raise AssertionError(f"din {kind} bundle: int8 tables {int8}")
        scorers[kind] = load_scorer(DMTConfig.from_ini(conf), bundle,
                                    device=dev)
    restored = CheckpointManager(ecfg.model_path).restore(steps, dev)
    direct = Scorer(ecfg, restored["params"], scale, const_vec,
                    model_state=restored["model_state"])
    del restored
    requests = make_requests(ecfg, CANDIDATES, REQUEST_LENS, SEED)
    want = [direct(q) for q in requests]
    scores = {kind: [s(q) for q in requests] for kind, s in scorers.items()}
    torch.cuda.synchronize()
    _expect(read_counts(), {}, 1, "din export and serving")
    errs = {}
    for kind, outs in scores.items():
        base = want if kind == "f32" else scores["f32"]
        for o in outs:
            check_scores(o, CANDIDATES, closed=True)
        errs[kind] = max(float(np.abs(o[k] - b[k]).max())
                         for o, b in zip(outs, base) for k in b)
    log(f"zoo din from files: cli.train {steps} steps of {TRAIN_BATCH} in "
        f"{train_s:.2f}s (loss {summary[0]['loss']:.4f}, launches "
        f"{json.dumps(train_counts)}); cli.export float32 "
        f"{export_s['f32']:.2f}s, int8 {export_s['int8']:.2f}s; Scores "
        f"float32 bundle vs the checkpoint's Scorer {errs['f32']:.3e} (tol "
        f"{SCORES_TOL}), int8 vs float32 {errs['int8']:.3e} (tol "
        f"{INT8_TOL}); {time.perf_counter() - t_all:.1f}s")
    if not (errs["f32"] <= SCORES_TOL and errs["int8"] <= INT8_TOL):
        raise AssertionError(f"din bundles: float32 vs the checkpoint "
                             f"{errs['f32']}, int8 vs float32 "
                             f"{errs['int8']}")
    del scorers, direct
    torch.cuda.empty_cache()
    return {"train_s": train_s, "export_s": export_s, "scores_err": errs,
            "loss": summary[0]["loss"], "counts": train_counts,
            "seconds": time.perf_counter() - t_all}


def zoo_optimizer_check(opt: str, dev) -> dict:
    """One step of ``embed_mlp_demo`` under ``opt`` (no lazy plan: the
    1,000,000 x 32 Sku table takes the dense update) on the card and on
    a CPU copy of the same state, batch 256: no kernel launched; loss
    within 1e-4; each param leaf within 1e-2 of the CPU step's largest
    move of that leaf, plus one bfloat16 step of its largest |value| for
    bfloat16 leaves (a bfloat16 table's gradient is summed in bfloat16, in
    another order on the card), plus, under rmsprop, twice the most one
    step moves an element whose gradient is rounding noise (lr /
    sqrt(1 - decay): rmsprop divides by the root of 0.1 g^2, as Adam's
    "2 lr" rule in ``card_vs_cpu_step``); and, since that bound is loose,
    the median |card - CPU| over the elements the CPU step moved below
    1e-6 in every float32 leaf."""
    from cikm2020_dmt_torch.metrics.streaming import task_metrics_init
    from cikm2020_dmt_torch.nn.layers import tree_map
    from cikm2020_dmt_torch.train.loop import Trainer

    t0 = time.perf_counter()
    cfg = dataclasses.replace(zoo_config("embed_mlp_demo.conf"),
                              optimizer=opt)
    card, cpu = Trainer(cfg, device=dev), Trainer(cfg, device="cpu")
    if card.lazy_plan:
        raise AssertionError(f"{opt}: a lazy plan under a dense optimizer")
    state = card.init_state(torch.Generator(device=dev).manual_seed(SEED))
    state_cpu = tree_map(lambda t: t.cpu().clone(), state)
    before = dict(_leaves(state_cpu["params"]))
    batch = synthetic_batch(cfg, CHECK_BATCH, SEED + 10, dev)
    reset_counts()
    s1, _, loss = card.train_step(state, task_metrics_init(dev), batch,
                                  torch.Generator(device=dev))
    torch.cuda.synchronize()
    counts = read_counts()
    _expect(counts, {}, 1, f"{opt} step")
    s2, _, loss_cpu = cpu.train_step(
        state_cpu, task_metrics_init(),
        {k: v.cpu() for k, v in batch.items()}, torch.Generator())
    loss_err = abs(float(loss) - float(loss_cpu)) / abs(float(loss_cpu))
    noise_step = (cfg.learning_rate[0] / np.sqrt(1 - 0.9)
                  if opt == "rmsprop" else 0.0)
    worst = med_worst = 0.0
    for (path, a), (_, b) in zip(_leaves(s1["params"]),
                                 _leaves(s2["params"])):
        bf16 = b.dtype == torch.bfloat16
        a, b, b0 = a.cpu().float(), b.float(), before[path].float()
        moved = b != b0
        tol = (1e-2 * float((b - b0).abs().max()) + 2 * noise_step
               + (2.0 ** -7 * float(b.abs().max()) if bf16 else 0.0))
        d = (a - b).abs()
        err = float(d.max())
        worst = max(worst, err / tol if tol > 0 else (0.0 if err == 0
                                                       else np.inf))
        if not err <= tol:
            raise AssertionError(f"{opt} card vs CPU param {path}: "
                                 f"{err:.3e} (tol {tol:.3e})")
        if not bf16 and int(moved.sum()):
            med = float(d[moved].median())
            med_worst = max(med_worst, med)
            if not med <= 1e-6:
                raise AssertionError(f"{opt} card vs CPU param {path}: "
                                     f"median |diff| {med:.3e} over the "
                                     "moved elements (tol 1e-6)")
    log(f"zoo optimizer {opt} (embed_mlp_demo, dense tables): loss "
        f"{float(loss):.6f} vs {float(loss_cpu):.6f} (rel {loss_err:.2e}, "
        f"tol 1e-4); params {worst:.3f} of their tolerance, largest "
        f"median {med_worst:.2e} (tol 1e-6); launches "
        f"{json.dumps(counts)}; {time.perf_counter() - t0:.1f}s")
    if not loss_err <= 1e-4:
        raise AssertionError(f"{opt} card vs CPU loss: {loss_err}")
    del card, cpu, state, state_cpu, s1, s2
    torch.cuda.empty_cache()
    return {"loss_rel_err": loss_err, "param_err_over_tol": worst,
            "param_median_err": med_worst}


def zoo_phase(dev) -> dict:
    """The thirteen paths (``zoo_path``), batch norm once
    (``zoo_bn_check``), ``din`` from files through ``cli.train`` and
    ``cli.export`` (``din_files_check``) and the five dense optimizers
    once each (``zoo_optimizer_check``).  Returns the numbers and the
    launch counts of the paths' counted runs and of ``din``'s
    ``cli.train``, summed."""
    t0 = time.perf_counter()
    paths = {name: zoo_path(name, zoo_config(conf, mt), dev)
             for name, conf, mt in ZOO_PATHS}
    with tempfile.TemporaryDirectory() as d:
        bn = zoo_bn_check(dev, d)
    with tempfile.TemporaryDirectory() as d:
        din_files = din_files_check(dev, d)
    opts = {opt: zoo_optimizer_check(opt, dev) for opt in ZOO_OPTIMIZERS}
    counts = {k: sum(p["counts"][k] for p in paths.values())
              + din_files["counts"][k]
              for k in next(iter(paths.values()))["counts"]}
    wall = time.perf_counter() - t0
    log(f"zoo phase: {len(paths)} paths, batch norm, din from files, "
        f"{len(opts)} optimizers; launches {json.dumps(counts)}; wall "
        f"{wall:.1f}s")
    return {"paths": paths, "batch_norm": bn, "din_files": din_files,
            "optimizers": opts, "counts": counts, "wall_s": wall}


# ---------------------------------------------------------------------------
# The data mesh: ranks joined by torch.distributed (core/mesh.py)
# ---------------------------------------------------------------------------

MESH_RANKS = 2              # ranks sharing the one card over gloo
MESH_BATCH = 2048           # examples a rank takes per step
MESH_STEPS = 3              # compared steps, dropout off
MESH_DROPOUT_STEPS = 2      # timed steps with dropout on
MESH_EVAL = (2, 4096)       # eval batches and their size
MESH_CLI_STEPS = 2          # cli.train --num_processes 2 steps, one save
MESH_TIMEOUT = 600.0        # seconds a spawned group may take
NCCL = "nccl"               # the one-rank check's backend


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def no_dropout(cfg):
    return dataclasses.replace(
        cfg, dropout_rate_bias=(0.0,) * len(cfg.dropout_rate_bias),
        transformer=dataclasses.replace(cfg.transformer, dropout_rate=0.0))


def _rank_rows(batch: dict, rank: int, n: int, dev) -> dict:
    k = batch["valid"].shape[0] // n
    return {key: v[rank * k:(rank + 1) * k].to(dev)
            for key, v in batch.items()}


def _snapshot(tr, state, rows) -> dict:
    """The compared leaves of a train state, on the host: the params and
    dense optimizer state but the Sku table (model-split tables gathered
    over the model group), and Sku's ``rows`` with their moments (fetched
    from their owners, or over the model group, on a mesh; every rank
    calls it)."""
    from cikm2020_dmt_torch.convert import gather_split
    from cikm2020_dmt_torch.nn.layers import tree_map
    from cikm2020_dmt_torch.parallel.embedding_shard import shard_take_rows
    from cikm2020_dmt_torch.parallel.full_shard import lookup_fms
    params, opt = state["params"], dict(state["opt"])
    if tr.mesh is not None:
        params = gather_split(params, tr.cfg, tr.mesh)
        for k in ("m", "v"):
            opt[k] = gather_split(opt[k], tr.cfg, tr.mesh)
    params = dict(params)
    params["emb"] = {k: v for k, v in params["emb"].items() if k != "Sku"}
    table, mv = state["params"]["emb"]["Sku"], state["lazy_opt"]["Sku"]["mv"]
    if "Sku" in tr.full_mesh:
        R, p = tr.full_mesh["Sku"]
        sku, m, v = (lookup_fms(tr.mesh, t, rows, R, p)
                     for t in (table, mv[0], mv[1]))
    elif "Sku" in tr.sharded:
        sku, m, v = (shard_take_rows(tr.mesh, t, rows, *tr.sharded["Sku"])
                     for t in (table, mv[0], mv[1]))
    else:
        sku, m, v = table[rows], mv[0][rows], mv[1][rows]
    out = {"params": params, "opt": opt, "sku": sku, "m": m,
           "v": v, "lazy_overflow": tr.lazy_overflow(state)}
    return tree_map(lambda t: t.detach().cpu().clone()
                    if torch.is_tensor(t) else t, out)


class _Timer:
    """Wraps a module function: synchronises and adds up its ms."""

    def __init__(self, module, name: str, dev):
        self.module, self.name, self.dev = module, name, dev
        self.real = getattr(module, name)
        self.ms = []

    def __enter__(self):
        def timed(*a, **k):
            _sync(self.dev)
            t0 = time.perf_counter()
            out = self.real(*a, **k)
            _sync(self.dev)
            self.ms.append((time.perf_counter() - t0) * 1e3)
            return out
        setattr(self.module, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)
        return False


def mesh_rank(rank: int, cfg, batches: list, eval_batches: list, rows,
              dev) -> dict:
    """One rank of the two sharing the card over gloo: ``run_eval`` on the
    init params, ``MESH_STEPS`` steps with dropout off from the seeded init
    (counted, timed, the compared leaves after the first and the last), then
    ``MESH_DROPOUT_STEPS`` with dropout on, timed by part (row fetch,
    gradient push, the summed gradients' all_reduce) with the fused
    block's seeds recorded.  Rank 0 also takes the last step's global
    batch in one process from the state the ranks gathered before it, and
    holds the ranks' Sku m row by row against that step's
    (``_check_sku_rows``): the exchange of that step alone, without the
    drift of the earlier steps' rounding."""
    from cikm2020_dmt_torch.core.mesh import build_mesh
    from cikm2020_dmt_torch.data.pipeline import Batch
    from cikm2020_dmt_torch.metrics.streaming import (task_metrics_init,
                                                      task_metrics_values)
    from cikm2020_dmt_torch.nn.layers import tree_map
    from cikm2020_dmt_torch.ops import block
    from cikm2020_dmt_torch.parallel import full_shard
    from cikm2020_dmt_torch.train import loop
    from cikm2020_dmt_torch.train.evaluate import run_eval

    dev = torch.device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg0 = no_dropout(cfg)
    mesh = build_mesh(cfg0, device=dev)
    tr = loop.Trainer(cfg0, mesh=mesh)
    state = tr.init_state(torch.Generator(device=dev).manual_seed(SEED))
    n = eval_batches[0]["valid"].shape[0]
    ev = run_eval(cfg0, tr.model, state["params"], None, n, mesh=mesh,
                  data_iter=[Batch(b, [b""] * n) for b in eval_batches])
    local = [_rank_rows(b, rank, mesh.size, dev) for b in batches]
    rows = rows.to(dev)
    metrics = task_metrics_init(dev)
    gen = torch.Generator(device=dev)
    _sync(dev)
    reset_counts()
    losses, ms, snaps = [], [], []
    for i, b in enumerate(local):
        if i == len(local) - 1:
            # the state before the last step, whole (every rank gathers)
            before_last = tree_map(lambda t: t.clone(), tr.whole_state(state))
            if rank != 0:
                del before_last
        t0 = time.perf_counter()
        gen.manual_seed(loop.dropout_seed(cfg.seed, i, mesh.data_index))
        state, metrics, loss = tr.train_step(state, metrics, b, gen)
        _sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(tr.reduce_loss(loss))
        if i in (0, len(local) - 1):
            snaps.append(_snapshot(tr, state, rows))
    counts = read_counts()
    vals = task_metrics_values(tr.reduce_metrics(metrics))
    same_start = None
    if rank == 0:
        one = loop.Trainer(cfg0, device=dev)
        after, _, _ = one.train_step(
            before_last, task_metrics_init(dev),
            {k: v.to(dev) for k, v in batches[-1].items()}, gen)
        want = _snapshot(one, after, rows)
        same_start = _check_sku_rows(snaps[-1]["m"], want["m"], True)
        del one, after, before_last, want

    # ---- dropout on: timed by part, the block's seeds recorded ----
    trd = loop.Trainer(cfg, mesh=mesh)
    seeds = []
    real = block._FusedBlock.apply

    def spy(enc_in, dec_in, seq_mask, seed, *rest):
        seeds.append(int(seed.reshape(-1)[0]))
        return real(enc_in, dec_in, seq_mask, seed, *rest)

    reset_counts()
    d_losses, d_ms = [], []
    block._FusedBlock.apply = spy
    try:
        with _Timer(full_shard, "fetch_rows", dev) as fetch, \
                _Timer(loop, "fms_adam_update", dev) as push, \
                _Timer(loop.Trainer, "_sum_over_ranks", dev) as reduce:
            for i in range(MESH_DROPOUT_STEPS):
                t0 = time.perf_counter()
                gen.manual_seed(loop.dropout_seed(cfg.seed, MESH_STEPS + i,
                                                  mesh.data_index))
                state, metrics, loss = trd.train_step(state, metrics,
                                                      local[i], gen)
                _sync(dev)
                d_ms.append((time.perf_counter() - t0) * 1e3)
                d_losses.append(trd.reduce_loss(loss))
    finally:
        block._FusedBlock.apply = real
    return {"eval": (ev[0], ev[2], ev[3]) if rank == 0 else None,
            "losses": losses, "step_ms": ms, "counts": counts,
            "sku_row_m_err_same_start": same_start,
            "snaps": snaps if rank == 0 else None, "metrics": vals,
            "dropout_losses": d_losses, "dropout_step_ms": d_ms,
            "dropout_counts": read_counts(), "seeds": seeds,
            "fetch_ms": fetch.ms, "push_ms": push.ms,
            "all_reduce_ms": reduce.ms,
            "share_rows": int(state["params"]["emb"]["Sku"].shape[0]),
            "jax": any(m.split(".")[0] in ("jax", "cikm2020_dmt_tpu")
                       for m in sys.modules)}


def nccl_rank(rank: int, cfg, batch: dict, dev) -> dict:
    """One rank over nccl: a mesh step against the step without a mesh from
    the same init, both under ``deterministic``: the same bits."""
    from cikm2020_dmt_torch.core.mesh import build_mesh
    from cikm2020_dmt_torch.metrics.streaming import task_metrics_init
    from cikm2020_dmt_torch.train.loop import Trainer

    dev = torch.device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg0 = no_dropout(cfg)
    mesh = build_mesh(cfg0, device=dev)
    out = {"backend": mesh.backend}
    batch = {k: v.to(dev) for k, v in batch.items()}
    results = []
    for tr in (Trainer(cfg0, mesh=mesh), Trainer(cfg0, device=dev)):
        state = tr.init_state(torch.Generator(device=dev).manual_seed(SEED))
        with deterministic():
            reset_counts()
            s1, _, loss = tr.train_step(state, task_metrics_init(dev), batch,
                                        torch.Generator(device=dev))
            _sync(dev)
        results.append((s1, loss, read_counts()))
        del state
    (a, la, ca), (b, lb, cb) = results
    out["leaves"] = _same_bits(a, b, "nccl mesh step vs no mesh")
    if not torch.equal(la, lb):
        raise AssertionError(f"nccl mesh step loss {float(la)} vs "
                             f"{float(lb)}")
    out.update(loss=float(la), counts=ca, counts_plain=cb)
    return out


def cli_rank(rank: int, argv: list, cfg, data: str, n: int) -> dict:
    """``cli.train.main(argv)`` as rank ``rank``, counted; then rank 0
    evaluates the state the ranks ended with (gathered) in one process
    over ``data``."""
    from cikm2020_dmt_torch.cli import train as cli
    from cikm2020_dmt_torch.models.zoo import build_model
    from cikm2020_dmt_torch.train.evaluate import run_eval

    reset_counts()
    t0 = time.perf_counter()
    tr = cli.main(argv + ["--process_id", str(rank)])
    _sync(tr.device)
    seconds = time.perf_counter() - t0
    counts = read_counts()
    whole = tr.whole_state(tr.state)
    out = {"counts": counts, "seconds": seconds, "last_step": tr.last_step,
           "save_s": dict(tr.save_seconds)}
    if rank == 0:
        # a model of its own: the trainer's looks Sku up on the mesh
        vals, _, clk, ord_ = run_eval(cfg, build_model(cfg), whole["params"],
                                      data, n, device=tr.device,
                                      model_state=whole["model_state"])
        out["eval"] = (vals, clk, ord_)
    return out


def _compare_snaps(got: dict, want: dict, before: dict, lr: float,
                   steps: int, hold: bool = True) -> dict:
    """``card_vs_cpu_step``'s rules on two snapshots: m (0.1 g after one
    step) norm-wise within 1e-2 for float32 params and 2**-7 for bfloat16
    ones (Sku's moments are float32, its table bf16), leaves of
    noise-level gradient skipped; params within 2 lr a step (+ one bf16
    step of the largest |value| for bf16 params) and a median |diff|
    below 1e-6 a step over the elements that moved from ``before`` (the
    init), per leaf with a clear gradient; v within twice m's tolerance.
    Both per-step bounds add up over ``steps``: each step's sum order
    moves the states apart once more.  Sku's m is also held row by row
    (``_check_sku_rows``).  With ``hold`` off nothing raises: the readings
    past a bound are listed under ``"past_bounds"``."""
    past = []

    def fail(msg):
        if hold:
            raise AssertionError(msg)
        past.append(msg)

    def pairs(*trees):
        """(path, leaf of each tree), matched by path (a step moves the
        lazy tables to the end of their dict)."""
        first, *rest = [dict(_leaves(t)) for t in trees]
        return [(p, v, *(r[p] for r in rest)) for p, v in first.items()]

    bf16 = {p for p, t in _leaves(want["params"])
            if t.dtype == torch.bfloat16}
    if want["sku"].dtype == torch.bfloat16:
        bf16 |= {"/Sku", "/Sku/m", "/Sku/v"}
    g_pairs = pairs(want["opt"]["m"], got["opt"]["m"])
    g_pairs.append(("/Sku/m", want["m"], got["m"]))
    top = max(float(b.abs().max()) for _, b, _ in g_pairs)
    g_err = 0.0
    noise = set()
    for path, b, a in g_pairs:
        if float(b.abs().max()) < 1e-6 * top:
            noise.add(path)
            continue
        tol = 2.0 ** -7 if path in bf16 else BWD_TOL_F32
        err = float((a.float() - b.float()).norm() / b.float().norm())
        g_err = max(g_err, err)
        if not err <= tol:
            fail(f"mesh vs one process m {path}: {err:.3e}")
    p_pairs = pairs(want["params"], got["params"], before["params"])
    p_pairs.append(("/Sku", want["sku"], got["sku"], before["sku"]))
    p_err = p_med = 0.0
    for path, b, a, b0 in p_pairs:
        moved = b != b0
        a, b = a.float(), b.float()
        tol = 2 * lr * steps + (2.0 ** -7 * float(b.abs().max())
                                if path in bf16 else 0.0)
        d = (a - b).abs()
        p_err = max(p_err, float(d.max()) / tol)
        if not float(d.max()) <= tol:
            fail(f"mesh vs one process param {path}: "
                 f"{float(d.max()):.3e} (tol {tol:.3e})")
        grad = "/Sku/m" if path == "/Sku" else path
        if grad not in noise and int(moved.sum()):
            med = float(d[moved].median())
            p_med = max(p_med, med)
            if not med <= 1e-6 * steps:
                fail(f"mesh vs one process param {path}: median |diff| "
                     f"{med:.3e} over the moved elements after {steps} "
                     "steps")
    v_pairs = pairs(want["opt"]["v"], got["opt"]["v"])
    v_pairs.append(("/Sku/v", want["v"], got["v"]))
    v_top = max(float(b.abs().max()) for _, b, _ in v_pairs)
    v_err = 0.0
    for path, b, a in v_pairs:
        if float(b.abs().max()) < 1e-6 * v_top:
            continue
        tol = 2 * (2.0 ** -7 if path in bf16 else BWD_TOL_F32)
        err = float((a - b).norm() / b.norm())
        v_err = max(v_err, err)
        if not err <= tol:
            fail(f"mesh vs one process v {path}: {err:.3e}")
    if got["lazy_overflow"] != want["lazy_overflow"]:
        fail(f"lazy_overflow {got['lazy_overflow']} vs "
             f"{want['lazy_overflow']}")
    try:
        rows = _check_sku_rows(got["m"], want["m"], steps == 1)
    except AssertionError as e:
        fail(str(e))
        rows = None
    out = {"grad_err": g_err, "param_err_over_tol": p_err,
           "param_median_err": p_med, "v_err": v_err, "sku_row_m_err": rows}
    if not hold:
        out["past_bounds"] = past
    return out


def _check_sku_rows(got: torch.Tensor, want: torch.Tensor,
                    by_element: bool) -> float:
    """Sku's m on each touched row: a group that a rank's push lost or
    sent to the wrong owner leaves its rows' m zero on one side only, or
    off by a rank's whole share, which the norm-wise bound cannot see
    among ~227k groups.  So a row is zero on both sides or on neither,
    and ``by_element`` (after the first step, where the two runs start
    from the same params and differ only in the order of the bfloat16
    gradient rows' sums) every element is within 2**-7 of its |m| plus
    the row's largest |m| (the floor of an element whose rank shares
    cancel).  Later steps of the two runs start from params that
    bfloat16 rounding has set a unit apart here and there, so their m
    drifts further (past 3 * 2**-7 in a CPU rehearsal) and only the zero
    pattern holds there; ``mesh_rank`` holds the last step by element
    against one process that starts it from the ranks' own state.
    Returns the largest |diff| / (|m| + row max)."""
    a, b = got.float(), want.float()
    zero_a, zero_b = (a == 0).all(-1), (b == 0).all(-1)
    if not torch.equal(zero_a, zero_b):
        raise AssertionError(
            f"mesh vs one process Sku m: {int((zero_a & ~zero_b).sum())} "
            f"touched rows zero on the mesh only, "
            f"{int((zero_b & ~zero_a).sum())} in one process only")
    scale = b.abs() + b.abs().amax(-1, keepdim=True)
    err = float(((a - b).abs() / scale.clamp(min=1e-30)).max())
    if by_element and not err <= 2.0 ** -7:
        raise AssertionError(f"mesh vs one process Sku m row by row: "
                             f"{err:.3e} (tol {2.0 ** -7:.3e})")
    return err


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def mesh_phase(cfg, dev, expected: dict, data: str, d: str) -> dict:
    """The data mesh (``core/mesh.py``, ``parallel/full_shard.py``) at the
    flagship's width, ranks spawned with ``core.mesh.run_ranks``:

    - two ranks sharing the card over gloo, ``MESH_BATCH`` examples each,
      against one process at the global batch from the same seeded init:
      ``run_eval`` on the init over ``MESH_EVAL`` (scores and metric
      values within ``SCORES_TOL``), then ``MESH_STEPS`` steps, dropout off
      (each step's loss within 1e-4, the state after the first and the last
      by ``_compare_snaps``, ``lazy_overflow``, metric values within 1e-4;
      exactly ``expected`` launches per step on each rank), then
      ``MESH_DROPOUT_STEPS`` with dropout on (finite losses, the ranks'
      block masks differ), timed by part;
    - one rank over nccl: the mesh step the same bits as the step without a
      mesh;
    - ``cli.train --num_processes 2`` over the files phase's shards
      ``data``, ``MESH_CLI_STEPS`` steps and a save (``expected`` launches
      per step on each rank): the checkpoint restores into a one-process
      ``Trainer``, and ``run_eval`` from it equals the same from the state
      the ranks ended with."""
    from cikm2020_dmt_torch.core.checkpoint import CheckpointManager
    from cikm2020_dmt_torch.core.mesh import run_ranks
    from cikm2020_dmt_torch.data.pipeline import Batch
    from cikm2020_dmt_torch.metrics.streaming import (task_metrics_init,
                                                      task_metrics_values)
    from cikm2020_dmt_torch.ops.block import dropout_mask
    from cikm2020_dmt_torch.train import loop
    from cikm2020_dmt_torch.train.evaluate import run_eval

    t_all = time.perf_counter()
    n_ranks, B = MESH_RANKS, MESH_BATCH * MESH_RANKS
    cfg0 = no_dropout(cfg)
    batches = [synthetic_batch(cfg, B, SEED + 700 + i, "cpu")
               for i in range(MESH_STEPS)]
    eval_batches = [synthetic_batch(cfg, MESH_EVAL[1], SEED + 720 + i, "cpu")
                    for i in range(MESH_EVAL[0])]
    rows = torch.unique(torch.cat([batch_ids(cfg, b, "Sku")
                                   for b in batches]))

    # ---- one process at the global batch ----
    tr = loop.Trainer(cfg0, device=dev)
    state = tr.init_state(torch.Generator(device=dev).manual_seed(SEED))
    n = MESH_EVAL[1]
    one_eval = run_eval(cfg0, tr.model, state["params"], None, n,
                        device=dev, data_iter=[Batch(b, [b""] * n)
                                               for b in eval_batches])
    _sync(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    metrics = task_metrics_init(dev)
    gen = torch.Generator(device=dev)
    one_losses, one_ms = [], []
    one_snaps = [_snapshot(tr, state, rows.to(dev))]
    for i, b in enumerate(batches):
        b = {k: v.to(dev) for k, v in b.items()}
        t0 = time.perf_counter()
        gen.manual_seed(loop.dropout_seed(cfg.seed, i))
        state, metrics, loss = tr.train_step(state, metrics, b, gen)
        _sync(dev)
        one_ms.append((time.perf_counter() - t0) * 1e3)
        one_losses.append(float(loss))
        if i in (0, MESH_STEPS - 1):
            one_snaps.append(_snapshot(tr, state, rows.to(dev)))
    one_peak = torch.cuda.max_memory_allocated(dev) / 1e9
    one_vals = task_metrics_values(metrics)
    del tr, state, metrics
    torch.cuda.empty_cache()

    # ---- two ranks sharing the card over gloo ----
    t0 = time.perf_counter()
    ranks = run_ranks(mesh_rank, n_ranks, cfg, batches, eval_batches, rows,
                      str(dev), backend="gloo", timeout_s=MESH_TIMEOUT)
    ranks_s = time.perf_counter() - t0
    for r in ranks:
        if r["jax"]:
            raise AssertionError("a mesh rank imported JAX")
        for name, got in r["counts"].items():
            if got != expected.get(name, 0) * MESH_STEPS:
                raise AssertionError(f"mesh rank: {name} launched {got} "
                                     f"times in {MESH_STEPS} steps")
        for name, got in r["dropout_counts"].items():
            if got != expected.get(name, 0) * MESH_DROPOUT_STEPS:
                raise AssertionError(f"mesh rank, dropout on: {name} "
                                     f"launched {got} times")
        l_err = max(abs(a - b) / abs(b)
                    for a, b in zip(r["losses"], one_losses))
        if not l_err <= 1e-4:
            raise AssertionError(f"mesh vs one process loss: {r['losses']} "
                                 f"vs {one_losses}")
        m_err = max(abs(r["metrics"][k] - one_vals[k]) for k in one_vals)
        if not m_err <= 1e-4:
            raise AssertionError(f"mesh vs one process metrics: "
                                 f"{r['metrics']} vs {one_vals}")
        if not all(np.isfinite(r["dropout_losses"])):
            raise AssertionError(f"dropout on: loss {r['dropout_losses']}")
    first = _compare_snaps(ranks[0]["snaps"][0], one_snaps[1], one_snaps[0],
                           cfg.learning_rate[0], 1)
    last = _compare_snaps(ranks[0]["snaps"][1], one_snaps[2], one_snaps[0],
                          cfg.learning_rate[0], MESH_STEPS)
    last["sku_row_m_err_same_start"] = ranks[0]["sku_row_m_err_same_start"]
    vals, clk, ord_ = ranks[0]["eval"]
    e_err = max(float(np.abs(clk - one_eval[2]).max()),
                float(np.abs(ord_ - one_eval[3]).max()),
                max(abs(vals[k] - one_eval[0][k]) for k in vals))
    if not e_err <= SCORES_TOL:
        raise AssertionError(f"mesh eval vs one process: {e_err}")
    s0, s1 = ranks[0]["seeds"], ranks[1]["seeds"]
    T = cfg.transformer
    masks_differ = [
        not torch.equal(dropout_mask(a, 0, 4, T.maxlen_k, T.d_model,
                                     T.dropout_rate, "cpu"),
                        dropout_mask(b, 0, 4, T.maxlen_k, T.d_model,
                                     T.dropout_rate, "cpu"))
        for a, b in zip(s0, s1)]
    if not (s0 and len(s0) == len(s1) and all(masks_differ)):
        raise AssertionError(f"the ranks' fused-block seeds {s0} {s1}")
    shared = f"two ranks sharing one card over gloo; {card_name_and_limit()}"
    out = {"ranks": n_ranks, "batch_per_rank": MESH_BATCH,
           "step_ms_per_rank": [r["step_ms"] for r in ranks],
           "one_process_step_ms": one_ms, "one_process_peak_gb": one_peak,
           "fetch_ms": ranks[0]["fetch_ms"], "push_ms": ranks[0]["push_ms"],
           "all_reduce_ms": ranks[0]["all_reduce_ms"],
           "dropout_step_ms": [r["dropout_step_ms"] for r in ranks],
           "first_step": first, "last_step": last, "eval_err": e_err,
           "sku_share_rows": [r["share_rows"] for r in ranks],
           "ranks_wall_s": ranks_s}
    log(f"mesh ({shared}), batch {MESH_BATCH} a rank: step ms per rank "
        f"{json.dumps(out['step_ms_per_rank'])} (host clock, synchronised; "
        f"the first step pays the ranks' warm-up); dropout on "
        f"{json.dumps(out['dropout_step_ms'])} with the parts timed: row "
        f"fetch {json.dumps(out['fetch_ms'])} ms, gradient push "
        f"{json.dumps(out['push_ms'])} ms, gradient all_reduce "
        f"{json.dumps(out['all_reduce_ms'])} ms (rank 0, each synchronised)")
    log(f"mesh: one process at batch {B}: step ms {json.dumps(one_ms)}, "
        f"peak memory {one_peak:.2f} GB; losses {json.dumps(one_losses)} vs "
        f"the ranks' {json.dumps(ranks[0]['losses'])}; after step 1 "
        f"{json.dumps(first)}, after step {MESH_STEPS} {json.dumps(last)}; "
        f"eval max |diff| {e_err:.3e}; Sku rows per rank "
        f"{out['sku_share_rows']}; launches per rank "
        f"{json.dumps(ranks[0]['counts'])}; wall {ranks_s:.1f}s")
    counts = {k: sum(r["counts"][k] + r["dropout_counts"][k] for r in ranks)
              for k in ranks[0]["counts"]}

    # ---- one rank over nccl: the same bits as no mesh ----
    t0 = time.perf_counter()
    nccl = run_ranks(nccl_rank, 1, cfg, synthetic_batch(
        cfg, MESH_BATCH, SEED + 740, "cpu"), str(dev), backend=NCCL,
        timeout_s=MESH_TIMEOUT)[0]
    if nccl["counts"] != {k: expected.get(k, 0) for k in nccl["counts"]}:
        raise AssertionError(f"nccl mesh step launched {nccl['counts']}")
    log(f"mesh: one rank over {nccl['backend']}: the mesh step the same "
        f"bits as the step without a mesh ({nccl['leaves']} leaves, loss "
        f"{nccl['loss']:.6f}); launches {json.dumps(nccl['counts'])}; wall "
        f"{time.perf_counter() - t0:.1f}s")
    for k, v in nccl["counts"].items():
        counts[k] += v

    # ---- cli.train --num_processes 2 over the files phase's shards ----
    t0 = time.perf_counter()
    ccfg = dataclasses.replace(cfg, validate_step=MESH_CLI_STEPS,
                               validation_batch_size=MESH_EVAL[1])
    conf = os.path.join(d, "mesh.conf")
    out_dir = os.path.join(d, "mesh_out")
    write_conf(ccfg, conf, data, out_dir, validation_data_path=data)
    argv = ["--conf_file", conf, "--max_steps", str(MESH_CLI_STEPS),
            "--num_processes", str(n_ranks), "--coordinator",
            f"127.0.0.1:{_free_port()}", "--dist_backend", "gloo",
            "--device", str(dev), "--log_every", "1"]
    from cikm2020_dmt_torch.core.config import DMTConfig
    read = DMTConfig.from_ini(conf)
    clis = run_ranks(cli_rank, n_ranks, argv, read, data, MESH_EVAL[1],
                     backend=None, timeout_s=MESH_TIMEOUT)
    for r in clis:
        if r["last_step"] != MESH_CLI_STEPS:
            raise AssertionError(f"cli.train ranks stopped at {r}")
        for name, got in r["counts"].items():
            if got != expected.get(name, 0) * MESH_CLI_STEPS:
                raise AssertionError(f"cli.train rank: {name} launched "
                                     f"{got} times")
        for k in counts:
            counts[k] += r["counts"][k]
    one = loop.Trainer(read, device=dev)
    ckpt = CheckpointManager(read.model_path)
    if not ckpt.has_step(MESH_CLI_STEPS):
        raise AssertionError("cli.train: no complete checkpoint")
    restored = ckpt.restore(MESH_CLI_STEPS, dev)
    if (int(restored["step"]) != MESH_CLI_STEPS or tuple(
            restored["params"]["emb"]["Sku"].shape) != (
            max(s.id_size for s in cfg.embeddings if s.table == "Sku"),
            next(s.dim for s in cfg.embeddings if s.table == "Sku"))):
        raise AssertionError("cli.train: the checkpoint is not the whole "
                             "one-process state")
    vals, _, clk, ord_ = run_eval(read, one.model, restored["params"], data,
                                  MESH_EVAL[1], device=dev,
                                  model_state=restored["model_state"])
    w_vals, w_clk, w_ord = clis[0]["eval"]
    c_err = max(float(np.abs(clk - w_clk).max()),
                float(np.abs(ord_ - w_ord).max()),
                max(abs(vals[k] - w_vals[k]) for k in vals))
    if not c_err <= SCORES_TOL:
        raise AssertionError(f"eval from the checkpoint vs the ranks' "
                             f"state: {c_err}")
    del restored, one
    torch.cuda.empty_cache()
    log(f"mesh: cli.train --num_processes {n_ranks} ({shared}), "
        f"{MESH_CLI_STEPS} steps and a save: {clis[0]['seconds']:.1f}s on "
        f"rank 0 (save {json.dumps(clis[0]['save_s'])} s); eval from the "
        f"checkpoint in one process vs from the ranks' state max |diff| "
        f"{c_err:.3e}; wall {time.perf_counter() - t0:.1f}s")
    out.update(counts=counts, cli_eval_err=c_err,
               cli_seconds=clis[0]["seconds"],
               wall_s=time.perf_counter() - t_all)
    log(f"mesh phase: wall {out['wall_s']:.1f}s")
    return out


# ---------------------------------------------------------------------------
# The model axis: tables split over the model group
# ---------------------------------------------------------------------------

AXIS_BATCH = 2048           # examples a data index takes per step
AXIS_STEPS = 3              # compared steps on (1, 2), dropout off
AXIS_DROPOUT_STEPS = 2      # timed steps with dropout on, (1, 2)
AXIS_EVAL = (2, 4096)       # eval batches and their size
AXIS_TOL = 1e-6             # the losses' relative tolerance
MESH_LOSS_TOL = 1e-4        # the mesh phase's loss bound against one process
# (data, model, full_mesh_tables, compared steps)
AXIS_MESHES = ((1, 2, True, AXIS_STEPS), (2, 2, True, 2), (1, 2, False, 2))


def _exchange_counter():
    """Wraps ``ShardedEmbeddingEngine._exchange`` to count the lookups that
    took the exchange (each launches one segment sum in the backward);
    returns (the list of outcomes, a function that restores it)."""
    from cikm2020_dmt_torch.parallel.embedding_shard import \
        ShardedEmbeddingEngine as E
    real, took = E._exchange, []

    def spy(self, *a):
        out = real(self, *a)
        took.append(out is not None)
        return out

    E._exchange = spy
    return took, lambda: setattr(E, "_exchange", real)


def axis_rank(rank: int, cfg, data: int, model: int, batches: list,
              eval_batches: list, rows, dev, save_dir) -> dict:
    """One rank of a (data, model) mesh of ranks sharing the card over
    gloo: the compared steps from the seeded init, dropout off (counted,
    timed, the compared leaves after the first step, the leaves every rank
    holds whole after the last).  With ``eval_batches`` (the first mesh)
    also ``run_eval`` on the init, ``AXIS_DROPOUT_STEPS`` with dropout on
    timed by part (the model-group sums of the lookups, the seq exchange,
    the sliced row fetch and gradient push, the gradient sums) with the
    fused block's seeds recorded, and ``Trainer.train`` of one step that
    saves in ``save_dir`` and evaluates the state it ended with."""
    import dataclasses as dc
    from cikm2020_dmt_torch.core.mesh import build_mesh
    from cikm2020_dmt_torch.data.pipeline import Batch
    from cikm2020_dmt_torch.metrics.streaming import task_metrics_init
    from cikm2020_dmt_torch.ops import block
    from cikm2020_dmt_torch.parallel import embedding_shard, full_shard
    from cikm2020_dmt_torch.train import loop
    from cikm2020_dmt_torch.train.evaluate import run_eval

    dev = torch.device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dc.replace(cfg, mesh_model=model, mesh_data=data)
    cfg0 = no_dropout(cfg)
    mesh = build_mesh(cfg0, device=dev)
    tr = loop.Trainer(cfg0, mesh=mesh)
    state = tr.init_state(torch.Generator(device=dev).manual_seed(SEED))
    out = {"split": sorted(getattr(tr.model.engine, "split", ())),
           "full_mesh": sorted(tr.full_mesh), "sharded": sorted(tr.sharded),
           "jax": any(m.split(".")[0] in ("jax", "cikm2020_dmt_tpu")
                      for m in sys.modules)}
    if eval_batches:
        n = eval_batches[0]["valid"].shape[0]
        ev = run_eval(cfg0, tr.model, state["params"], None, n, mesh=mesh,
                      data_iter=[Batch(b, [b""] * n) for b in eval_batches])
        out["eval"] = (ev[0], ev[2], ev[3]) if rank == 0 else None
    local = [_rank_rows(b, mesh.data_index, mesh.data, dev) for b in batches]
    rows = rows.to(dev)
    metrics = task_metrics_init(dev)
    gen = torch.Generator(device=dev)
    took, restore = _exchange_counter()
    _sync(dev)
    reset_counts()
    losses, ms = [], []
    try:
        for i, b in enumerate(local):
            t0 = time.perf_counter()
            gen.manual_seed(loop.dropout_seed(cfg.seed, i, mesh.data_index))
            state, metrics, loss = tr.train_step(state, metrics, b, gen)
            _sync(dev)
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(tr.reduce_loss(loss))
            if i == 0:
                snap = _snapshot(tr, state, rows)
    finally:
        restore()
    out.update(losses=losses, step_ms=ms, counts=read_counts(),
               exchanges=sum(took), lookups=len(took),
               snap=snap if rank == 0 else None,
               replicated={k: v.cpu() for k, v in
                           replicated_leaves(tr, state).items()},
               share_rows={k: int(v.shape[0])
                           for k, v in state["params"]["emb"].items()})
    if not eval_batches:
        return out

    # ---- dropout on: timed by part, the block's seeds recorded ----
    trd = loop.Trainer(cfg, mesh=mesh)
    seeds = []
    real = block._FusedBlock.apply

    def spy(enc_in, dec_in, seq_mask, seed, *rest):
        seeds.append(int(seed.reshape(-1)[0]))
        return real(enc_in, dec_in, seq_mask, seed, *rest)

    d_losses, d_ms = [], []
    block._FusedBlock.apply = spy
    try:
        with _Timer(embedding_shard, "model_axis_sum", dev) as msum, \
                _Timer(embedding_shard.ShardedEmbeddingEngine, "_exchange",
                       dev) as exch, \
                _Timer(full_shard, "fetch_rows", dev) as fetch, \
                _Timer(loop, "fms_adam_update", dev) as push, \
                _Timer(loop.Trainer, "_sum_over_ranks", dev) as reduce:
            for i in range(AXIS_DROPOUT_STEPS):
                t0 = time.perf_counter()
                gen.manual_seed(loop.dropout_seed(cfg.seed, AXIS_STEPS + i,
                                                  mesh.data_index))
                state, metrics, loss = trd.train_step(state, metrics,
                                                      local[i], gen)
                _sync(dev)
                d_ms.append((time.perf_counter() - t0) * 1e3)
                d_losses.append(trd.reduce_loss(loss))
    finally:
        block._FusedBlock.apply = real
    steps = AXIS_DROPOUT_STEPS
    out.update(dropout_losses=d_losses, dropout_step_ms=d_ms, seeds=seeds,
               parts_ms={"model_sums": sum(msum.ms) / steps,
                         "seq_exchange": sum(exch.ms) / steps,
                         "fetch": sum(fetch.ms) / steps,
                         "push": sum(push.ms) / steps,
                         "grad_sums": sum(reduce.ms) / steps})
    del trd, state, metrics, tr
    torch.cuda.empty_cache()

    # ---- Trainer.train: one step and a save, then eval of its state ----
    cfgs = dc.replace(cfg0, output_path=save_dir)
    trs = loop.Trainer(cfgs, mesh=mesh)
    t0 = time.perf_counter()
    arrays = {k: v.cpu().numpy() for k, v in local[0].items()}
    arrays["label"] = np.zeros(len(arrays["valid"]), np.float32)
    trs.train(max_steps=1, data_iter=iter([Batch(arrays)]), log_every=100)
    out["train_save_s"] = time.perf_counter() - t0
    n = eval_batches[0]["valid"].shape[0]
    ev = run_eval(cfgs, trs.model, trs.state["params"], None, n, mesh=mesh,
                  model_state=trs.state["model_state"],
                  data_iter=[Batch(b, [b""] * n) for b in eval_batches])
    out["saved_eval"] = (ev[0], ev[2], ev[3]) if rank == 0 else None
    return out


def _same_replicated(ranks: list, what: str) -> int:
    """The leaves every rank holds whole: the same bits on each rank."""
    first = ranks[0]["replicated"]
    for r in ranks[1:]:
        other = r["replicated"]
        bad = sorted(k for k in first if k not in other
                     or not torch.equal(first[k], other[k]))
        if bad or set(other) != set(first):
            raise AssertionError(f"{what}: replicated leaves differ across "
                                 f"ranks: {bad[:8]}")
    return len(first)


def axis_phase(cfg, dev, expected: dict, d: str) -> dict:
    """The model axis (``core/mesh.py``'s groups,
    ``parallel/embedding_shard.py``'s sharded engine, the model peers'
    slicing in ``parallel/full_shard.py``, ``train/lazy.py``'s sharded
    lazy Adam) at the flagship's width, ranks spawned with
    ``core.mesh.run_ranks`` sharing the card over gloo, each mesh against
    one process at its global batch from the same seeded init:

    - (1, 2), batch ``AXIS_BATCH``: Sku full-mesh (the peers slicing its
      requests), Brand and Shopid split over the model group; ``run_eval``
      on the init over ``AXIS_EVAL``, ``AXIS_STEPS`` steps, dropout off,
      then ``AXIS_DROPOUT_STEPS`` with it on (timed by part; model peers
      draw the same masks), then ``Trainer.train`` of one step with a save
      that one process restores and scores as the ranks do;
    - (2, 2), global batch 2 x ``AXIS_BATCH``: two steps;
    - (1, 2) with ``full_mesh_tables = false``: Sku a sharded lazy table
      (``shard_take_rows``, ``lazy_adam_rows_sharded``), two steps.

    Each: losses within ``AXIS_TOL`` relative and the state after step 1
    by ``_compare_snaps`` (the mesh phase's bounds; Sku's m row by row)
    against the reference, the replicated leaves the same bits on every
    rank, ``lazy_overflow`` 0, and on each rank exactly ``expected``
    launches a step plus one segment sum for each seq lookup that took
    the exchange.  With one data shard the reference is the one process.
    With two, each rank's bf16 table gradient is rounded before the
    shards' sum, as on the data mesh (``mesh_phase``), which on these
    batches is as far from one process (Cid2's m 8.17e-3 norm-wise
    against the bound's 2^-7 on the H100): the reference is the (2, 1)
    data mesh on the same batches, and against one process the first
    step's loss is held to ``AXIS_TOL`` and each step's to the mesh
    phase's ``MESH_LOSS_TOL``, the state's errors reported."""
    from cikm2020_dmt_torch.core.checkpoint import CheckpointManager
    from cikm2020_dmt_torch.core.mesh import run_ranks
    from cikm2020_dmt_torch.data.pipeline import Batch
    from cikm2020_dmt_torch.metrics.streaming import task_metrics_init
    from cikm2020_dmt_torch.train import loop
    from cikm2020_dmt_torch.train.evaluate import run_eval

    t_all = time.perf_counter()
    cfg0 = no_dropout(cfg)
    by_batch = {B: [synthetic_batch(cfg, B, SEED + 800 + 10 * i + B // 2048,
                                    "cpu") for i in range(AXIS_STEPS)]
                for B in (AXIS_BATCH, 2 * AXIS_BATCH)}
    eval_batches = [synthetic_batch(cfg, AXIS_EVAL[1], SEED + 830 + i, "cpu")
                    for i in range(AXIS_EVAL[0])]
    rows = {B: torch.unique(torch.cat([batch_ids(cfg, b, "Sku")
                                       for b in bs]))
            for B, bs in by_batch.items()}

    # ---- one process at each global batch ----
    one = {}
    for B, batches in by_batch.items():
        tr = loop.Trainer(cfg0, device=dev)
        state = tr.init_state(torch.Generator(device=dev).manual_seed(SEED))
        if B == AXIS_BATCH:
            n = AXIS_EVAL[1]
            one_eval = run_eval(cfg0, tr.model, state["params"], None, n,
                          device=dev, data_iter=[Batch(b, [b""] * n)
                                                 for b in eval_batches])
        snaps = [_snapshot(tr, state, rows[B].to(dev))]
        metrics = task_metrics_init(dev)
        gen = torch.Generator(device=dev)
        losses, ms = [], []
        for i, b in enumerate(batches):
            b = {k: v.to(dev) for k, v in b.items()}
            t0 = time.perf_counter()
            gen.manual_seed(loop.dropout_seed(cfg.seed, i))
            state, metrics, loss = tr.train_step(state, metrics, b, gen)
            _sync(dev)
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(loss))
            if i == 0:
                snaps.append(_snapshot(tr, state, rows[B].to(dev)))
        one[B] = {"losses": losses, "step_ms": ms, "snaps": snaps}
        del tr, state, metrics
        torch.cuda.empty_cache()

    # ---- the meshes ----
    counts = {k: 0 for k in read_counts()}
    out = {"meshes": {}}
    shared = f"ranks sharing one card over gloo; {card_name_and_limit()}"
    for data, model, fms, steps in AXIS_MESHES:
        B = data * AXIS_BATCH
        first = (data, model, fms) == (1, 2, True)
        mcfg = cfg if fms else dataclasses.replace(cfg,
                                                   full_mesh_tables=False)
        t0 = time.perf_counter()
        ranks = run_ranks(axis_rank, data * model, mcfg, data, model,
                          by_batch[B][:steps], eval_batches if first else [],
                          rows[B], str(dev), os.path.join(d, "axis_out"),
                          backend="gloo", timeout_s=MESH_TIMEOUT)
        wall = time.perf_counter() - t0
        name = f"({data}, {model})" + ("" if fms else " no full mesh")
        want = one[B]
        for r in ranks:
            if r["jax"]:
                raise AssertionError(f"{name}: a rank imported JAX")
            if r["split"] != ["Brand", "Shopid"] + ([] if fms else ["Sku"]) \
                    or r["full_mesh"] != (["Sku"] if fms else []) \
                    or r["sharded"] != ([] if fms else ["Sku"]):
                raise AssertionError(f"{name}: tables {r['split']} "
                                     f"{r['full_mesh']} {r['sharded']}")
            per = dict(expected)
            per_seg = per.get("sorted_segsum", 0) * steps + r["exchanges"]
            for k, got in r["counts"].items():
                want_n = (per_seg if k == "sorted_segsum"
                          else per.get(k, 0) * steps)
                if got != want_n:
                    raise AssertionError(f"{name}: {k} launched {got} times "
                                         f"in {steps} steps (want {want_n})")
        leaves = _same_replicated(ranks, name)
        losses = ranks[0]["losses"]
        one_err = [abs(a - b) / abs(b) for a, b in zip(losses,
                                                       want["losses"])]
        if data == 1:
            # one data shard: the one process's arithmetic
            ref, ref_losses = want["snaps"][1], want["losses"]
            versus = "one process"
        else:
            # several data shards sum their bf16 table gradients, as PR
            # 14's data mesh does: the (data, 1) mesh on the same batches
            # is the reference, and one process to the mesh phase's loss
            # bound
            ctls = run_ranks(axis_rank, data, mcfg, data, 1,
                             by_batch[B][:steps], [], rows[B], str(dev), None,
                             backend="gloo", timeout_s=MESH_TIMEOUT)
            for r in ctls:
                for k, got in r["counts"].items():
                    if got != expected.get(k, 0) * steps:
                        raise AssertionError(f"({data}, 1): {k} launched "
                                             f"{got} times in {steps} steps")
                    counts[k] += got
            ref, ref_losses = ctls[0]["snap"], ctls[0]["losses"]
            versus = f"the ({data}, 1) data mesh"
            if not (one_err[0] <= AXIS_TOL
                    and max(one_err) <= MESH_LOSS_TOL):
                raise AssertionError(f"{name} vs one process loss: "
                                     f"{losses} vs {want['losses']}")
        l_err = max(abs(a - b) / abs(b) for r in ranks
                    for a, b in zip(r["losses"], ref_losses))
        if not l_err <= AXIS_TOL:
            raise AssertionError(f"{name} vs {versus} loss: {losses} vs "
                                 f"{ref_losses}")
        state_err = _compare_snaps(ranks[0]["snap"], ref, want["snaps"][0],
                                   cfg.learning_rate[0], 1)
        if ranks[0]["snap"]["lazy_overflow"] != 0:
            raise AssertionError(f"{name}: lazy_overflow "
                                 f"{ranks[0]['snap']['lazy_overflow']}")
        one_state = state_err if data == 1 else _compare_snaps(
            ranks[0]["snap"], want["snaps"][1], want["snaps"][0],
            cfg.learning_rate[0], 1, hold=False)
        rec = {"ranks": data * model, "batch": B,
               "step_ms_per_rank": [r["step_ms"] for r in ranks],
               "one_process_step_ms": want["step_ms"][:steps],
               "losses": losses, "versus": versus,
               "reference_losses": ref_losses[:steps],
               "loss_rel_err": l_err,
               "one_process_losses": want["losses"][:steps],
               "one_process_loss_rel_err": one_err,
               "state_after_step_1": state_err,
               "one_process_state_after_step_1": one_state,
               "replicated_leaves": leaves,
               "launches_per_rank": ranks[0]["counts"],
               "exchanges_per_rank": [r["exchanges"] for r in ranks],
               "seq_lookups_per_rank": ranks[0]["lookups"],
               "share_rows": ranks[0]["share_rows"], "wall_s": wall}
        for k in counts:
            counts[k] += sum(r["counts"][k] for r in ranks)
        if first:
            r0 = ranks[0]
            vals, clk, ord_ = r0["eval"]
            e_err = max(float(np.abs(clk - one_eval[2]).max()),
                        float(np.abs(ord_ - one_eval[3]).max()),
                        max(abs(vals[k] - one_eval[0][k]) for k in vals))
            if not e_err <= SCORES_TOL:
                raise AssertionError(f"{name} eval vs one process: {e_err}")
            s0, s1 = ranks[0]["seeds"], ranks[1]["seeds"]
            if not (s0 and s0 == s1):
                raise AssertionError(f"{name}: model peers' block seeds "
                                     f"{s0} {s1}")
            if not all(np.isfinite(r["dropout_losses"]).all() for r in ranks):
                raise AssertionError(f"{name}: dropout on: "
                                     f"{[r['dropout_losses'] for r in ranks]}")
            # the checkpoint in one process scores as the ranks do
            cfgs = dataclasses.replace(cfg0, output_path=os.path.join(
                d, "axis_out"))
            ckpt = CheckpointManager(cfgs.model_path)
            if not ckpt.has_step(1):
                raise AssertionError(f"{name}: no complete checkpoint")
            whole = ckpt.restore(1, dev)
            sh = tuple(whole["params"]["emb"]["Brand"].shape)
            if sh != next((s.id_size, s.dim) for s in cfg.embeddings
                          if s.table == "Brand"):
                raise AssertionError(f"{name}: checkpoint Brand {sh}: not "
                                     "the whole table")
            tro = loop.Trainer(cfgs, device=dev)
            n = AXIS_EVAL[1]
            vals, _, clk, ord_ = run_eval(
                cfgs, tro.model, whole["params"], None, n, device=dev,
                model_state=whole["model_state"],
                data_iter=[Batch(b, [b""] * n) for b in eval_batches])
            w_vals, w_clk, w_ord = r0["saved_eval"]
            c_err = max(float(np.abs(clk - w_clk).max()),
                        float(np.abs(ord_ - w_ord).max()),
                        max(abs(vals[k] - w_vals[k]) for k in vals))
            if not c_err <= SCORES_TOL:
                raise AssertionError(f"{name}: eval from the checkpoint vs "
                                     f"the ranks' state: {c_err}")
            del whole, tro
            torch.cuda.empty_cache()
            rec.update(eval_err=e_err, checkpoint_eval_err=c_err,
                       dropout_step_ms=[r["dropout_step_ms"] for r in ranks],
                       parts_ms=r0["parts_ms"],
                       train_save_s=r0["train_save_s"])
        out["meshes"][name] = rec
        log(f"model axis {name} ({shared}), batch {B}: step ms per rank "
            f"{json.dumps(rec['step_ms_per_rank'])} (host clock, "
            f"synchronised; the first step pays the ranks' warm-up), one "
            f"process {json.dumps(rec['one_process_step_ms'])}; losses "
            f"{json.dumps(losses)} vs {versus}'s "
            f"{json.dumps(rec['reference_losses'])} (max rel {l_err:.3e})"
            + ("" if data == 1 else f", vs one process's "
               f"{json.dumps(rec['one_process_losses'])} (rel "
               f"{json.dumps(one_err)})")
            + f"; after step 1 vs {versus} {json.dumps(state_err)}"
            + ("" if data == 1 else f", vs one process "
               f"{json.dumps(one_state)}")
            + f"; {leaves} replicated leaves the same "
            f"bits on every rank; launches per rank "
            f"{json.dumps(rec['launches_per_rank'])} in {steps} steps "
            f"({rec['exchanges_per_rank']} of {rec['seq_lookups_per_rank']} "
            f"seq lookups took the exchange); wall {wall:.1f}s")
        if first:
            log(f"model axis {name} ({shared}): dropout on step ms "
                f"{json.dumps(rec['dropout_step_ms'])}; a step's parts "
                f"(rank 0, each synchronised, mean of "
                f"{AXIS_DROPOUT_STEPS}): {json.dumps(rec['parts_ms'])} ms; "
                f"eval max |diff| {e_err:.3e}; Trainer.train 1 step and a "
                f"save {rec['train_save_s']:.1f}s, eval from the checkpoint "
                f"in one process vs the ranks' {c_err:.3e}")
    out.update(counts=counts, wall_s=time.perf_counter() - t_all)
    log(f"model axis phase: wall {out['wall_s']:.1f}s")
    return out


# ---------------------------------------------------------------------------
# The bfloat16 training path as bench.py configures it
# ---------------------------------------------------------------------------

BF16_BATCH = 4096           # bench.py's batch
BF16_STEPS = 10             # timed steps at BF16_BATCH
BF16_EVAL_TOL = 1e-4        # eval and request scores, beside 2 x own
LOSS_REL = 1e-5             # the loss rule's relative term
BF16_STEP = 2.0 ** -7       # one bfloat16 step of a value


def bench_config(grid_bf16: bool = False, sku_rows: int = 5_000_000,
                 rows: int = 2048):
    """``bench.py``'s config, rebuilt with the port's parsers (the card has
    no JAX, so ``__graft_entry__._demo_config`` cannot be imported there):
    the flagship mmoe_transformer_unbias with Sku ``sku_rows`` x 32 and
    Cid3, Brand and Shopid of ``rows`` rows, batch 4096, bfloat16 compute
    and the default ``table_bf16_threshold`` (500: every table of at least
    500 rows stored bfloat16).  ``grid_bf16``: the tables float32
    (threshold 0) and the lazy tables' union grid bfloat16."""
    from cikm2020_dmt_torch.core.config import (DMTConfig,
                                                parse_attention_pairs,
                                                parse_embedding_spec,
                                                parse_ts_features)

    sku, c3 = sku_rows, rows
    emb = (
        f"Sku:{sku}:32:item_fea_sku:i#Cid2:500:8:item_c2:i"
        f"#Cid3:{c3}:8:item_c3:i#Brand:{rows}:16:item_brand:i"
        f"#Shopid:{rows}:16:item_shop:i#Sku:{sku}:32:clk_seq_sku_7d_50:u"
        "#TimeClick:24:8:clk_seq_ts_7d_50:u#Cid2:500:8:clk_seq_c2_7d_50:u"
        f"#Cid3:{c3}:8:clk_seq_c3_7d_50:u"
        f"#Brand:{rows}:16:clk_seq_brand_7d_50:u"
        f"#Shopid:{rows}:16:clk_seq_shop_7d_50:u"
        f"#Sku:{sku}:32:ord_seq_sku_12m_10:u"
        "#TimeOrder:24:8:ord_seq_ts_12m_10:u#Cid2:500:8:ord_seq_c2_12m_10:u"
        f"#Cid3:{c3}:8:ord_seq_c3_12m_10:u"
        f"#Brand:{rows}:16:ord_seq_brand_12m_10:u"
        f"#Shopid:{rows}:16:ord_seq_shop_12m_10:u"
        f"#Sku:{sku}:32:cart_seq_sku_12m_10:u"
        "#TimeCart:24:8:cart_seq_ts_12m_10:u#Cid2:500:8:cart_seq_c2_12m_10:u"
        f"#Cid3:{c3}:8:cart_seq_c3_12m_10:u"
        f"#Brand:{rows}:16:cart_seq_brand_12m_10:u"
        f"#Shopid:{rows}:16:cart_seq_shop_12m_10:u")
    pairs = "|".join(
        f"{s}_sku_{w}:item_fea_sku#{s}_c2_{w}:item_c2#{s}_c3_{w}:item_c3"
        f"#{s}_brand_{w}:item_brand#{s}_shop_{w}:item_shop"
        for s, w in (("clk_seq", "7d_50"), ("ord_seq", "12m_10"),
                     ("cart_seq", "12m_10")))
    emb_bias = (f"Cid2:500:5:item_c2:i#Cid3:{c3}:5:item_c3:i"
                f"#Cid2:500:5:near_expo_seq_c2:u"
                f"#Cid3:{c3}:5:near_expo_seq_c3:u")
    return DMTConfig(
        model_type="mmoe_transformer_unbias",
        embeddings=parse_embedding_spec(emb),
        embeddings_bias=parse_embedding_spec(emb_bias),
        attention_pairs=parse_attention_pairs(pairs),
        attention_ts=parse_ts_features(
            "clk_seq_ts_7d_50|ord_seq_ts_12m_10|cart_seq_ts_12m_10"),
        batch_size=BF16_BATCH, validate_step=10**9,
        compute_dtype="bfloat16",
        table_bf16_threshold=0 if grid_bf16 else 500, grid_bf16=grid_bf16)


def float32_reference(cfg):
    """The float32 step of a bfloat16 config: float32 compute and tables,
    no bfloat16 grid or cotangent."""
    return dataclasses.replace(cfg, compute_dtype="float32",
                               table_bf16_threshold=0, grid_bf16=False,
                               onehot_bwd_bf16=False)


def _widened(tree):
    from cikm2020_dmt_torch.nn.layers import tree_map
    return tree_map(lambda t: (t.float() if t.dtype == torch.bfloat16
                               else t).cpu().clone(), tree)


def bf16_card_vs_cpu_step(cfg, dev, batch_size: int = CHECK_BATCH) -> dict:
    """One step of the bfloat16 config ``cfg`` at ``batch_size`` with
    dropout off, on the card and on a CPU copy of the same state, and the
    port's float32 step on the CPU from that state (``float32_reference``,
    tables widened).  Every gradient of the step comes out of bfloat16
    products, so all are held by the bfloat16 rule of the block kernels:
    each leaf's gradient (Adam's first m is 0.1 g; the lazy tables on the
    batch's rows), norm-wise, within ``BWD_BF16_FACTOR`` times the CPU
    bfloat16 step's distance from the float32 step, plus ``BWD_TOL_F32``;
    leaves whose float32 gradient is below 1e-6 of the largest |value| of
    all leaves (zero in exact arithmetic) are skipped.  The loss within
    twice the CPU bfloat16 loss's distance from the float32 loss, plus
    1e-5 relative; each param within 2 lr plus one bfloat16 step of the
    leaf's largest |value|, in the CPU's type (under ``grid_bf16``
    float32 for the lazy tables)."""
    from cikm2020_dmt_torch.metrics.streaming import task_metrics_init
    from cikm2020_dmt_torch.nn.layers import tree_map
    from cikm2020_dmt_torch.train.loop import Trainer

    t0 = time.perf_counter()
    cfg0 = no_dropout(cfg)
    card = Trainer(cfg0, device=dev)
    state = card.init_state(torch.Generator(device=dev).manual_seed(SEED))
    states = {"card": state,
              "cpu": tree_map(lambda t: t.cpu().clone(), state),
              "f32": _widened(state)}
    trainers = {"card": card, "cpu": Trainer(cfg0, device="cpu"),
                "f32": Trainer(float32_reference(cfg0), device="cpu")}
    batch = synthetic_batch(cfg, batch_size, SEED + 10, dev)
    host = {k: v.cpu() for k, v in batch.items()}
    out = {}
    for name, tr in trainers.items():
        b = batch if name == "card" else host
        d = b["mask"].device
        s, _, loss = tr.train_step(states[name], task_metrics_init(d), b,
                                   torch.Generator(device=d))
        out[name] = (s, float(loss))
    torch.cuda.synchronize()
    rows = {t.name: torch.unique(batch_ids(cfg, host, t.name))
            for t in card.lazy_plan}

    def grads(s):
        g = {p: t.detach().cpu().double() for p, t in _leaves(s["opt"]["m"])}
        for name, sub in s["lazy_opt"].items():
            g["lazy/" + name] = sub["mv"][0].cpu().double()[rows[name]]
        return g

    G = {k: grads(v[0]) for k, v in out.items()}
    top = max(float(t.abs().max()) for t in G["f32"].values())
    g_ratio, checked = 0.0, 0
    for path, r in G["f32"].items():
        if float(r.abs().max()) < 1e-6 * top:
            continue
        b16, got = G["cpu"][path], G["card"][path]
        own = float((b16 - r).norm() / r.norm())
        err = float((got - b16).norm() / b16.norm())
        tol = BWD_BF16_FACTOR * own + BWD_TOL_F32
        g_ratio = max(g_ratio, err / tol)
        checked += 1
        if not err <= tol:
            raise AssertionError(f"bf16 card vs CPU gradient {path}: "
                                 f"norm-wise {err:.3e}, CPU bf16 vs f32 "
                                 f"{own:.3e} (tol {tol:.3e})")
    lr = cfg.learning_rate[0]
    p_ratio = 0.0
    want = dict(_leaves(out["cpu"][0]["params"]))
    for path, a in _leaves(out["card"][0]["params"]):
        b = want[path]
        if a.dtype != b.dtype:
            raise AssertionError(f"bf16 card vs CPU param {path}: dtype "
                                 f"{a.dtype} vs {b.dtype}")
        a, b = a.detach().cpu().float(), b.float()
        p_tol = 2 * lr + BF16_STEP * float(b.abs().max())
        err = float((a - b).abs().max())
        p_ratio = max(p_ratio, err / p_tol)
        if not err <= p_tol:
            raise AssertionError(f"bf16 card vs CPU param {path}: {err:.3e} "
                                 f"(tol {p_tol:.3e})")
    lc, lb, lf = out["card"][1], out["cpu"][1], out["f32"][1]
    l_tol = BWD_BF16_FACTOR * abs(lb - lf) + LOSS_REL * abs(lb)
    res = {"loss": lc, "loss_cpu": lb, "loss_f32": lf,
           "loss_err_over_tol": abs(lc - lb) / l_tol,
           "grad_err_over_tol": g_ratio, "leaves_checked": checked,
           "param_err_over_tol": p_ratio,
           "seconds": time.perf_counter() - t0}
    log(f"bf16 card vs CPU step ({'grid_bf16' if cfg.grid_bf16 else 'bf16 '
        'tables'}), batch {batch_size}, dropout off: loss {lc:.6f}, CPU "
        f"bf16 {lb:.6f}, CPU f32 {lf:.6f} ({res['loss_err_over_tol']:.3f} "
        f"of its tolerance); gradients {g_ratio:.3f} of 2 x CPU bf16 vs f32 "
        f"+ 1e-2 at worst over {checked} leaves; params {p_ratio:.3f} of 2 "
        f"lr + one bf16 step; {res['seconds']:.1f}s")
    if not abs(lc - lb) <= l_tol:
        raise AssertionError(f"bf16 card vs CPU loss: {lc} vs {lb} (f32 "
                             f"{lf}, tol {l_tol})")
    if cfg.grid_bf16 and any(
            out["card"][0]["params"]["emb"][t.name].dtype != torch.float32
            for t in card.lazy_plan):
        raise AssertionError("grid_bf16: a lazy table left float32")
    return res


def bf16_eval_serve_check(cfg, params, dev) -> dict:
    """One eval batch of ``BF16_BATCH`` (``run_eval``) and one request of
    ``CANDIDATES`` (``Scorer``) of the bfloat16 config on ``params``:
    counted (3 block-forward launches each, nothing else), and on the card
    against the port's CPU path on the same weights, within twice the CPU
    bfloat16 path's distance from its float32 path (weights widened) plus
    ``BF16_EVAL_TOL``."""
    from cikm2020_dmt_torch.data.pipeline import Batch
    from cikm2020_dmt_torch.models.zoo import build_model
    from cikm2020_dmt_torch.nn.layers import tree_map
    from cikm2020_dmt_torch.serve.export import Scorer, norm_constants
    from cikm2020_dmt_torch.train import evaluate

    t0 = time.perf_counter()
    f32 = float32_reference(cfg)
    host = tree_map(lambda t: t.detach().cpu().clone(), params)
    wide_p = _widened(params)
    n = BF16_BATCH
    batch = synthetic_batch(cfg, n, SEED + 300, dev)
    hb = {k: v.cpu() for k, v in batch.items()}

    def scores(c, p, b, device):
        _, _, clk, ord_ = evaluate.run_eval(
            c, build_model(c), p, None, n, data_iter=[Batch(b, [b""] * n)],
            device=device)
        return {"p_clk": clk, "p_ord": ord_}

    nrng = np.random.default_rng(SEED)
    scale, const_vec = norm_constants(
        nrng.normal(0.5, 1.0, cfg.feature_dimension),
        nrng.uniform(0.1, 3.0, cfg.feature_dimension))
    req = make_requests(cfg, CANDIDATES, REQUEST_LENS[:1], SEED)[0]
    out, counts = {}, {}
    for what in ("eval", "request"):
        reset_counts()
        if what == "eval":
            card = scores(cfg, params, batch, dev)
        else:
            card = Scorer(cfg, params, scale, const_vec)(req)
        torch.cuda.synchronize()
        counts[what] = read_counts()
        want = {k: (3 if k == "fused_block_fwd" else 0) for k in counts[what]}
        if counts[what] != want:
            raise AssertionError(f"bf16 {what} launched {counts[what]}, "
                                 f"expected {want}")
        if what == "eval":
            cpu, ref = scores(cfg, host, hb, "cpu"), scores(f32, wide_p, hb,
                                                            "cpu")
        else:
            cpu = Scorer(cfg, host, scale, const_vec, device="cpu")(req)
            ref = Scorer(f32, wide_p, scale, const_vec, device="cpu")(req)
        worst = 0.0
        for k in ref:
            a, b, r = (np.asarray(x[k], np.float64) for x in (card, cpu, ref))
            if not np.isfinite(a).all():
                raise AssertionError(f"bf16 {what} {k}: not finite")
            err, own = float(np.abs(a - b).max()), float(np.abs(b - r).max())
            tol = BWD_BF16_FACTOR * own + BF16_EVAL_TOL
            worst = max(worst, err / tol)
            log(f"bf16 {what} card vs CPU {k}: max |diff| {err:.3e}, CPU "
                f"bf16 vs f32 {own:.3e} (tol {tol:.3e})")
            if not err <= tol:
                raise AssertionError(f"bf16 {what} {k}: card vs CPU {err}, "
                                     f"tol {tol}")
        out[what] = worst
    res = {"counts": counts, "err_over_tol": out,
           "seconds": time.perf_counter() - t0}
    log(f"bf16 eval batch of {n} and request of {CANDIDATES}: "
        f"{json.dumps(out)} of their tolerances; {res['seconds']:.1f}s")
    return res


def bf16_block_times(params, dev, B: int = BF16_BATCH) -> dict:
    """The block kernels in bfloat16 at the bfloat16 path's shapes (B,
    T = 50 and 10, dropout 0.1): the forward against its plain version
    (``KERNEL_TOL``), the backward against the float32 plain version by
    the bfloat16 rule, then each timed alone beside its plain version and
    its bounds (bytes of bf16 operands; operations at the float32 FMA peak
    and at the bf16 tensor-core peak) and summed per step (2 launches at
    T=50, 1 at T=10)."""
    from cikm2020_dmt_torch.ops import block

    kgen = torch.Generator(device=dev).manual_seed(SEED + 6)
    seed = torch.tensor([SEED + 7], dtype=torch.int32, device=dev)
    recs = {"fwd": [], "bwd": []}
    errs = {"fwd": 0.0, "bwd": 0.0}
    for T, p in ((50, params["trans"]["seq0"]), (10, params["trans"]["seq2"])):
        ep, dp = p["enc"][0], p["dec"][0]
        ew, dw = block.pack_weights(ep), block.pack_weights(dp)
        kw = block_inputs(T, torch.bfloat16, kgen, dev, B=B)
        kw.update(train=True, rate=DROPOUT, seed=seed)
        with torch.no_grad():
            got = block.fused_encode_decode(ep, dp, **kw)
            ref = block.fused_encode_decode_ref(ep, dp, **kw)
        g = torch.randn(got.shape, generator=kgen, device=dev).to(
            torch.bfloat16)
        gb = block.fused_block_bwd(ew, dw, g=g, **kw)
        rb = block.fused_block_bwd_ref(ew, dw, g=g, **kw)
        kw32 = dict(kw, enc_in=kw["enc_in"].float(),
                    dec_in=kw["dec_in"].float())
        r32 = block.fused_block_bwd_ref(ew, dw, g=g.float(), **kw32)
        torch.cuda.synchronize()
        f_err = float((got.float() - ref.float()).abs().max())
        rel, absd = _bwd_err(gb, r32)
        plain_rel, _ = _bwd_err(rb, r32)
        tol = BWD_BF16_FACTOR * plain_rel + BWD_TOL_F32
        log(f"block bf16 B={B} T={T}: forward max |diff| {f_err:.3e} (tol "
            f"{KERNEL_TOL[torch.bfloat16]}); backward norm-wise {rel:.3e} "
            f"vs float32 plain (plain bf16 {plain_rel:.3e}, tol {tol:.3e})")
        if not (torch.isfinite(got.float()).all()
                and f_err <= KERNEL_TOL[torch.bfloat16]):
            raise AssertionError(f"bf16 block forward disagrees: {f_err}")
        if not rel <= tol:
            raise AssertionError(f"bf16 block backward disagrees: {rel}")
        errs["fwd"] = max(errs["fwd"], f_err)
        errs["bwd"] = max(errs["bwd"], float(_bwd_err(gb, rb)[1]))
        del ref, rb, r32
        with torch.no_grad():
            f_ms = cuda_ms(lambda: block.fused_encode_decode(ep, dp, **kw), 10)
            f_plain = cuda_ms(lambda: block.fused_encode_decode_ref(
                ep, dp, **kw), 3, warmup=1)
        b_ms = cuda_ms(lambda: block.fused_block_bwd(ew, dw, g=g, **kw), 5,
                       warmup=1)
        b_plain = cuda_ms(lambda: block.fused_block_bwd_ref(ew, dw, g=g, **kw),
                          3, warmup=1)
        for key, ms, plain, ops, nbytes in (
                ("fwd", f_ms, f_plain, block.block_flops(B, T, 80, 320),
                 block.block_bytes(B, T, 80, 320, 2)),
                ("bwd", b_ms, b_plain, block.block_bwd_flops(B, T, 80, 320),
                 block.block_bwd_bytes(B, T, 80, 320, 2))):
            tc = max(block.block_tc_bound_ms(ops, torch.bfloat16),
                     nbytes / PEAK_HBM_BYTES * 1e3)
            fma = bound(ops, nbytes)
            recs[key].append({"B": B, "T": T, "dtype": "bfloat16",
                              "dropout": DROPOUT,
                              "per_step": 2 if T == 50 else 1, "ms": ms,
                              "plain_ms": plain, "bound_ms": tc,
                              "bound_by": ("operations" if tc > nbytes
                                           / PEAK_HBM_BYTES * 1e3
                                           else "bytes"),
                              "fma_bound_ms": fma[0], "flops": ops,
                              "bytes": nbytes})
            log(f"block bf16 {key} B={B} T={T}: {ms:.4f} ms (plain "
                f"{plain:.4f}), bound {tc:.4f} ms at the bf16 tensor-core "
                f"peak and HBM rate, {fma[0]:.4f} ms at the f32 FMA peak")
        del gb, g, kw
        torch.cuda.empty_cache()
    out = {}
    for key, shapes in recs.items():
        def per_step(k):
            return sum(r[k] * r["per_step"] for r in shapes)
        out[key] = {"shapes": shapes, "max_abs_err": errs[key],
                    "ms": per_step("ms"), "plain_ms": per_step("plain_ms"),
                    "bound_ms": per_step("bound_ms"),
                    "fma_bound_ms": per_step("fma_bound_ms"),
                    "library_ms": None,
                    "unit": f"ms per training step: 2 launches at T=50 + 1 "
                            f"at T=10, B={B}, bf16, dropout {DROPOUT}",
                    "bound_note": "bound_ms: the larger of the bf16 "
                                  "operands' bytes over the HBM rate and "
                                  "the operations over the bf16 dense "
                                  "tensor-core peak (989 TFLOP/s); "
                                  "fma_bound_ms at the f32 FMA peak"}
    return out


def bf16_phase(dev) -> dict:
    """The bfloat16 training path as ``bench.py`` configures it
    (``bench_config``): (a) bf16 tables of at least 500 rows, (b)
    ``grid_bf16`` (float32 tables, bfloat16 union grid).  Each: the card
    against the CPU for one step (``bf16_card_vs_cpu_step``), then
    ``train_phase`` at ``BF16_BATCH`` (3 warm-up and ``BF16_STEPS`` timed
    steps over 4 batches with dropout 0.1, exactly the flagship's launches
    a step, then 20 steps on one batch whose loss falls).  (a) also
    evaluates one batch and serves one request against the CPU
    (``bf16_eval_serve_check``) and times the block kernels in bfloat16
    (``bf16_block_times``); (b) runs the segment sum on its bfloat16
    cotangent of a float32 table (``segsum_phase``) and the row writes on
    its float32 rows (``update_phase``)."""
    t0 = time.perf_counter()
    out = {"paths": {}, "counts": {}}
    for name, grid in (("bf16", False), ("grid_bf16", True)):
        cfg = bench_config(grid_bf16=grid)
        check = bf16_card_vs_cpu_step(cfg, dev)
        torch.cuda.empty_cache()
        train = train_phase(cfg, dev, EXPECTED_PER_STEP["dmt"],
                            batch=BF16_BATCH, steps=BF16_STEPS)
        out["counts"][name] = train["counts"]
        rec = {k: train[k] for k in ("step_ms", "wall_ms", "examples_per_s",
                                     "peak_gb")}
        rec["card_vs_cpu"] = check
        if grid:
            seg, col = segsum_phase(cfg, train["trainer"], train["state"],
                                    train["batches"][0], train["counts"],
                                    dev)
            out["segsum"] = seg
            out["rows"] = update_phase(train["state"], col, train["counts"],
                                       dev)
            del col
        else:
            params = train["state"]["params"]
            rec["eval_serve"] = bf16_eval_serve_check(cfg, params, dev)
            out["eval_serve_counts"] = rec["eval_serve"]["counts"]
            out["blocks"] = bf16_block_times(params, dev)
            del params
        out["paths"][name] = rec
        del train
        torch.cuda.empty_cache()
        log(f"bf16 phase {name}: step {rec['step_ms']:.3f} ms (CUDA events; "
            f"host clock {rec['wall_ms']:.3f} ms), "
            f"{rec['examples_per_s']:.1f} examples/s at batch {BF16_BATCH}, "
            f"peak memory {rec['peak_gb']:.2f} GB")
    out["wall_s"] = time.perf_counter() - t0
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False); nothing was run", file=sys.stderr)
        return 2
    from cikm2020_dmt_torch.core.config import DMTConfig
    from cikm2020_dmt_torch.ops import _build

    t_main = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # bfloat16 products summed in float32 (the port's entry points set it
    # too: models/base.float32_sums)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda", 0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    # ---- build every kernel library (the block kernels at each width of
    # the run), one nvcc per library, in parallel ----
    t0 = time.perf_counter()
    specs = build_specs()
    seconds = _build.build(specs)
    build_wall = time.perf_counter() - t0
    log(f"build: {json.dumps(seconds)} wall {build_wall:.2f}s")
    for spec in specs:
        if not isinstance(spec, str) and "BLOCK_D=80" not in spec[1]:
            continue  # ptxas lines of the model's widths only
        name = spec if isinstance(spec, str) else spec[0]
        for line in _build.build_log(spec).splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  ptxas {name}: {line.strip()}")

    # ---- the flagship (conf/dmt.conf): 1+1 stacks, the fused block ----
    t_flag = time.perf_counter()
    cfg = DMTConfig.from_ini(CONF)
    fwd, serve = serve_phase(cfg, dev)
    torch.cuda.empty_cache()
    card_vs_cpu_step(cfg, dev)
    torch.cuda.empty_cache()
    train = train_phase(cfg, dev, EXPECTED_PER_STEP["dmt"])
    counts = train["counts"]
    fwd_shapes, fwd_err, bwd = block_train_phase(train["state"]["params"],
                                                 counts, dev)
    serve_launches = fwd["launches"]
    fwd.update(launches=serve_launches + counts["fused_block_fwd"],
               max_abs_err=max(fwd["max_abs_err"], fwd_err),
               launches_by_path={"serve": serve_launches,
                                 "train": counts["fused_block_fwd"]},
               train_shapes=fwd_shapes)
    t_w = time.perf_counter()
    widths = widths_phase(dev)
    log(f"widths phase: wall {time.perf_counter() - t_w:.1f}s")
    fwd["replay_bit_equal"] = widths["replay"]
    fwd["other_widths"] = bwd["other_widths"] = widths["block"]
    seg, col = segsum_phase(cfg, train["trainer"], train["state"],
                            train["batches"][0], counts, dev)
    rows = update_phase(train["state"], col, counts, dev)
    opt = adam_phase(train["trainer"], train["state"], train["batches"][0],
                     train["gen"], counts, dev)
    step_ms, eps = train["step_ms"], train["examples_per_s"]

    # ---- the save mode (DMT_BLOCK_SAVE=1) of the fused block ----
    t_s = time.perf_counter()
    save_cases = [check_save(*c, dtype, dev) for c in SAVE_CASES
                  for dtype in (torch.float32, torch.bfloat16)]
    fwd_save, bwd_save = save_block_phase(train["state"]["params"], dev)
    save_train = save_train_phase(train["trainer"], train["state"],
                                  train["batches"], dev,
                                  EXPECTED_PER_STEP["dmt"])
    for rec, name in ((fwd_save, "fused_block_fwd"),
                      (bwd_save, "fused_block_bwd")):
        rec.update(launches=save_train["save_launches"][name],
                   bit_equal=save_cases)
    fwd["save"], bwd["save"] = fwd_save, bwd_save
    log(f"save phase: training step {save_train['step_ms']:.3f} ms with "
        f"the save mode, {save_train['off_step_ms']:.3f} ms without it in "
        f"the same phase ({step_ms:.3f} ms in the training phase); wall "
        f"{time.perf_counter() - t_s:.1f}s")

    # ---- the Python data path: TFRecord shards -> batch_stream -> card ----
    t_d = time.perf_counter()
    data = data_phase(cfg, train["trainer"], train["state"], train["gen"],
                      dev, EXPECTED_PER_STEP["dmt"])
    for rec in [fwd, bwd, seg] + rows + [opt]:
        by = rec.setdefault("launches_by_path",
                            {"train": counts[rec["name"]]})
        by["data"] = data["counts"][rec["name"]]
    log(f"data phase: wall {time.perf_counter() - t_d:.1f}s")
    p50 = serve["p50"]
    data_eps = (data["host_examples_per_s"], data["step_examples_per_s"])
    unpacked_ms = data["device_batch_ms"]
    del train, col, serve, data
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as fdir:
        # ---- training from files: the C++ assembler, cli.train,
        # checkpoints ----
        t_f = time.perf_counter()
        files = files_phase(cfg, dev, EXPECTED_PER_STEP["dmt"], data_eps[0],
                            unpacked_ms, data_eps[1], fdir)
        for rec in [fwd, bwd, seg] + rows + [opt]:
            rec["launches_by_path"]["files"] = (
                files["counts"][rec["name"]]
                + 2 * files["resume_counts"][rec["name"]])
        log(f"files phase: wall {time.perf_counter() - t_f:.1f}s")

        # ---- evaluating, testing and serving model.ckpt-4 ----
        t_e = time.perf_counter()
        evs = eval_serve_phase(cfg, dev, files, fdir)
        n_evs = sum(evs["launches"].values())
        fwd["launches"] += n_evs
        fwd["launches_by_path"]["eval_serve"] = n_evs
        fwd["eval_serve_launches"] = evs["launches"]
        log(f"eval/serve phase: wall {time.perf_counter() - t_e:.1f}s")

        # ---- the data mesh: spawned ranks joined by torch.distributed ----
        torch.cuda.empty_cache()
        mesh = mesh_phase(cfg, dev, EXPECTED_PER_STEP["dmt"], files["data"],
                          fdir)
        for rec in [fwd, bwd, seg] + rows + [opt]:
            rec["launches_by_path"]["mesh"] = mesh["counts"][rec["name"]]

        # ---- the model axis: tables split over the model group ----
        torch.cuda.empty_cache()
        axis = axis_phase(cfg, dev, EXPECTED_PER_STEP["dmt"], fdir)
        for rec in [fwd, bwd, seg] + rows + [opt]:
            rec["launches_by_path"]["model_axis"] = \
                axis["counts"][rec["name"]]
    t_flag = time.perf_counter() - t_flag

    # ---- conf/dmt_2block.conf: 2+2 stacks, the attention kernels ----
    t_two = time.perf_counter()
    cfg2 = DMTConfig.from_ini(CONF_2BLOCK)
    serve2 = serve_path(cfg2, dev, {"attention_fwd": 12})
    ev = eval_phase(cfg2, serve2["params"], dev)
    del serve2["params"]
    torch.cuda.empty_cache()
    card_vs_cpu_step(cfg2, dev)
    torch.cuda.empty_cache()
    train2 = train_phase(cfg2, dev, EXPECTED_PER_STEP["dmt_2block"])
    leaves2 = adam_exact(train2["trainer"], train2["state"],
                         train2["batches"][0], train2["gen"], "dmt_2block")[0]
    opt["bit_equal"]["dmt_2block"] = len(leaves2)
    opt["launches"] += train2["counts"]["adam_dense"]
    opt["launches_by_path"]["dmt_2block_train"] = \
        train2["counts"]["adam_dense"]
    del train2["trainer"], train2["state"], train2["batches"], leaves2
    torch.cuda.empty_cache()
    att_counts = {k: serve2["counts"][k] + ev["counts"][k]
                  + train2["counts"][k]
                  for k in ("attention_fwd", "attention_bwd")}
    att_fwd, att_bwd = attention_phase(att_counts, dev)
    att_fwd["other_widths"] = att_bwd["other_widths"] = widths["attention"]
    att_fwd["launches_by_path"] = {
        "serve": serve2["counts"]["attention_fwd"],
        "eval": ev["counts"]["attention_fwd"],
        "train": train2["counts"]["attention_fwd"]}
    t_two = time.perf_counter() - t_two

    # ---- the rest of the model lattice ----
    zoo = zoo_phase(dev)
    for rec in [fwd, bwd, seg] + rows + [opt]:
        n = zoo["counts"][rec["name"]]
        rec["launches"] += n
        rec.setdefault("launches_by_path", {})["zoo"] = n

    # ---- the bfloat16 training path as bench.py configures it ----
    torch.cuda.empty_cache()
    bf = bf16_phase(dev)
    for rec in [fwd, bwd, seg] + rows + [opt]:
        by = rec.setdefault("launches_by_path", {})
        for path, c in bf["counts"].items():
            rec["launches"] += c[rec["name"]]
            by[path] = c[rec["name"]]
    n_ev = sum(c["fused_block_fwd"] for c in bf["eval_serve_counts"].values())
    fwd["launches"] += n_ev
    fwd["launches_by_path"]["bf16_eval_serve"] = n_ev
    fwd["bf16"], bwd["bf16"] = bf["blocks"]["fwd"], bf["blocks"]["bwd"]
    keep = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "max_abs_err", "shape")
    seg["grid_bf16"] = {k: bf["segsum"][k] for k in keep + ("float32",)}
    for rec, r in zip(rows, bf["rows"]):
        rec["float32_table"] = {k: r[k] for k in keep}

    smi = card_name_and_limit()
    log("bf16 (bench.py's config, batch "
        f"{BF16_BATCH}): " + "; ".join(
            f"{name} step {p['step_ms']:.3f} ms, {p['examples_per_s']:.1f} "
            f"examples/s, peak {p['peak_gb']:.2f} GB"
            for name, p in bf["paths"].items())
        + f"; block forward {bf['blocks']['fwd']['ms']:.4f} ms and backward "
        f"{bf['blocks']['bwd']['ms']:.4f} ms a step in bf16; wall "
        f"{bf['wall_s']:.1f}s")
    log(f"dmt: request p50 {p50:.3f} ms; training step "
        f"{step_ms:.3f} ms, {eps:.1f} examples/s at batch {TRAIN_BATCH}; "
        f"with DMT_BLOCK_SAVE=1 {save_train['step_ms']:.3f} ms, "
        f"{save_train['examples_per_s']:.1f} examples/s (without it in the "
        f"same phase {save_train['off_step_ms']:.3f} ms); Python data "
        f"path {data_eps[0]:.1f} examples/s on the host against the "
        f"step's {data_eps[1]:.1f}; C++ assembler "
        f"{files['host_examples_per_s']:.1f} examples/s ({os.cpu_count()} "
        f"host cores, {len(os.sched_getaffinity(0))} available), packed device_batch {files['device_batch_ms']:.3f} "
        f"ms (unpacked {unpacked_ms:.3f}); save "
        f"{max(files['save_s'].values()):.2f}s, restore "
        f"{files['restore_s']:.2f}s; eval from files "
        f"{evs['eval_examples_per_s']:.1f} examples/s at batch "
        f"{evs['batch']}; "
        f"request through the preprocessor p50 float32 "
        f"{evs['p50_f32']:.3f} ms, int8 {evs['p50_int8']:.3f} ms; queue "
        f"{evs['queue'][1]['requests_per_s']:.1f} requests/s in groups of "
        f"1, {evs['queue'][8]['requests_per_s']:.1f} in groups up to 8; "
        f"wall {t_flag:.1f}s")
    log(f"dmt_2block: request p50 {serve2['p50']:.3f} ms, p90 "
        f"{serve2['p90']:.3f} ms; eval {ev['ms_per_batch']:.3f} ms per "
        f"batch of {ev['batch']}, {ev['examples_per_s']:.1f} examples/s; "
        f"training step {train2['step_ms']:.3f} ms, "
        f"{train2['examples_per_s']:.1f} examples/s at batch {TRAIN_BATCH}; "
        f"wall {t_two:.1f}s")
    log("zoo: " + "; ".join(
        f"{name} step {p['step_ms']:.3f} ms, eval "
        f"{p['eval_examples_per_s']:.1f} examples/s, request p50 "
        f"{p['p50_ms']:.3f} ms" for name, p in zoo["paths"].items())
        + f"; wall {zoo['wall_s']:.1f}s")
    log("model axis (ranks sharing one card over gloo): " + "; ".join(
        f"{k} step ms {json.dumps(v['step_ms_per_rank'])}, one process "
        f"{json.dumps(v['one_process_step_ms'])}"
        for k, v in axis["meshes"].items())
        + f"; wall {axis['wall_s']:.1f}s")
    log(f"mesh (two ranks sharing one card over gloo, batch "
        f"{MESH_BATCH} a rank): step ms "
        f"{json.dumps(mesh['step_ms_per_rank'])}; one process at batch "
        f"{MESH_BATCH * MESH_RANKS} "
        f"{json.dumps(mesh['one_process_step_ms'])} ms, peak "
        f"{mesh['one_process_peak_gb']:.2f} GB; wall {mesh['wall_s']:.1f}s")
    log(f"build wall {build_wall:.2f}s; script wall "
        f"{time.perf_counter() - t_main:.1f}s")
    print(smi)
    print(json.dumps({"kernels": [fwd, bwd, seg] + rows
                      + [att_fwd, att_bwd, opt]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
