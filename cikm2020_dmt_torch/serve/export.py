"""Serving: the export bundle, request assembly, online dense
normalization, u-side broadcast and the blended Scores
(``cikm2020_dmt_tpu/serve/export.py``).

A request is an assembled index batch (numpy arrays keyed like the
training batch) with ``raw_features`` ``[B, feature_dimension]``, ``valid``
``[B]`` and the id features.  ``ServingPreprocessor`` assembles one from
raw string ids through the training vocabs (the C++ assembler's
``lookup_ids``).  Single-user (u-side) features may come as ``[1, L]``
rows, which the scorer broadcasts to the B candidates.

    normalized = clip(clip(raw, 0, max) * scale - const_vec, -0.99, 0.99)
    Scores     = (w0 * sigmoid(click) + w1 * sigmoid(order)) / (w0 + w1)

with relevance-only logits (the bias head is dropped; a single-task model
gives one probability for both tasks).  ``export_model`` writes a bundle of
a checkpoint (``{export_dir}/params.pt``, one ``torch.save`` file of the
params and the model state written as checkpoints are, beside the JAX
bundle's ``descriptor.json`` and ``norm.npz``); with
``export_int8_rows`` the large tables ship int8 with per-row float32
scales (``quantize_tables``), grouped as the reference's lane-packed
storage groups rows.  ``load_scorer`` reads a bundle back into a
``Scorer``, whose ``score_async`` / ``score_group_async`` return device
tensors without waiting for the card (``serve/queue.py`` groups requests
through them).
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from ..core import tracing
from ..core.checkpoint import CheckpointManager, save_file
from ..core.config import DMTConfig
from ..data.pipeline import IDS, LEN, WTS
from ..data.schema import FeatureSchema
from ..data.vocab import VocabSet
from ..models.base import float32_sums
from ..models.zoo import build_model
from ..nn.embedding import pack_factor
from ..nn.layers import tree_map
from ..train.losses import scores_from_logits

EPS = 1e-7
F32_MAX = float(np.finfo(np.float32).max)
PARAMS_FILE = "params.pt"


def read_stat_vector(path: str, dim: int) -> np.ndarray:
    """Tab-separated float vector (reference util.py:154-159)."""
    if not path:
        raise ValueError(
            "export needs train_data_mean_path / train_data_std_path set in "
            "the [path] config section (online normalization constants)")
    with open(path) as f:
        vals = [float(s.strip()) for s in f.readline().split("\t")]
    if len(vals) != dim:
        raise ValueError(f"stat file {path}: {len(vals)} values, want {dim}")
    return np.asarray(vals, np.float64)


def norm_constants(mean: np.ndarray, std: np.ndarray
                   ) -> tuple[np.ndarray, np.ndarray]:
    """(scale, const_vec) of the online normalizer, computed in float64 and
    returned as float32."""
    mean = np.asarray(mean, np.float64)
    std = np.asarray(std, np.float64)
    std_eps = std + EPS
    scale = std / (3.0 * std_eps * std_eps)
    const_vec = mean * std / (3.0 * std_eps * std_eps) \
        + mean * std / std_eps - mean
    return scale.astype(np.float32), const_vec.astype(np.float32)


def normalize_dense(raw: torch.Tensor, scale: torch.Tensor,
                    const_vec: torch.Tensor) -> torch.Tensor:
    x = raw.clamp(0.0, F32_MAX)
    return (x * scale - const_vec).clamp(-0.99, 0.99)


class ServingPreprocessor:
    """Host-side request assembly: raw strings -> padded index batch.

    i-side features are per-item (length = request batch); u-side features
    are single-user and broadcast to every row (reference
    online_build_sparsetensor tiling).  Ids map through the C++
    assembler's vocab tables (``NativeAssembler.lookup_ids``), one call per
    feature; a failed build of its library raises."""

    def __init__(self, cfg: DMTConfig, schema: Optional[FeatureSchema] = None):
        from ..data.native import NativeAssembler
        self.cfg = cfg
        self.schema = schema or FeatureSchema.from_config(cfg)
        self.vocabs = VocabSet(cfg.embeddings + cfg.embeddings_bias,
                               cfg.vocab_path)
        self.ts_features = set(cfg.attention_ts)
        self._native = NativeAssembler(cfg, schema=self.schema,
                                       vocabs=self.vocabs, num_threads=1)

    def _map_ids(self, f, vals: list) -> np.ndarray:
        """Raw id values -> int32 indices (vocab/OOV/hash or raw-int ts)."""
        if f.name in self.ts_features:
            def ts(v) -> int:
                try:
                    return min(int(float(v)), 2**31 - 1)
                except ValueError:
                    return 0
            return np.fromiter((ts(v) for v in vals), np.int32, len(vals))
        return self._native.lookup_ids(
            f.name, [v if isinstance(v, bytes) else str(v).encode()
                     for v in vals])

    def assemble(self, batch_size: int,
                 id_values: dict[str, list[bytes]],
                 id_wts: Optional[dict[str, list[float]]] = None,
                 raw_features: Optional[np.ndarray] = None,
                 tile_uside: bool = True) -> dict:
        """One request of ``batch_size`` candidates.  ``tile_uside=False``
        ships ``[1, L]`` u-side rows for the scorer to broadcast."""
        id_wts = id_wts or {}
        out: dict[str, np.ndarray] = {
            "valid": np.ones((batch_size,), np.float32),
            "mask": np.zeros((batch_size, self.schema.num_classes), np.float32),
        }
        if raw_features is not None:
            out["raw_features"] = np.asarray(raw_features, np.float32)
        for f in self.schema.id_features:
            vals = id_values.get(f.name, [])
            wts = id_wts.get(f.name)
            if f.side == "u":
                # single-user sequence: map once, tile across the batch
                k = min(len(vals), f.max_len)
                ids_row = np.zeros((f.max_len,), np.int32)
                wts_row = np.zeros((f.max_len,), np.float32)
                ids_row[:k] = self._map_ids(f, vals[:k])
                if wts is None:
                    wts_row[:k] = 1.0
                else:
                    kw = min(k, len(wts))
                    wts_row[:kw] = wts[:kw]
                    wts_row[kw:k] = 1.0
                rows = batch_size if tile_uside else 1
                out[f.name + IDS] = np.tile(ids_row, (rows, 1))
                out[f.name + WTS] = np.tile(wts_row, (rows, 1))
                out[f.name + LEN] = np.full((rows,), k, np.int32)
            else:
                # i-side: one value per request row
                k = min(len(vals), batch_size)
                per = np.zeros((batch_size, f.max_len), np.int32)
                perw = np.zeros((batch_size, f.max_len), np.float32)
                perl = np.zeros((batch_size,), np.int32)
                per[:k, 0] = self._map_ids(f, vals[:k])
                if wts is None:
                    perw[:k, 0] = 1.0
                else:
                    kw = min(k, len(wts))
                    perw[:kw, 0] = wts[:kw]
                    perw[kw:k, 0] = 1.0
                perl[:k] = 1
                out[f.name + IDS] = per
                out[f.name + WTS] = perw
                out[f.name + LEN] = perl
        return out


def uside_keys(schema: FeatureSchema) -> frozenset:
    """Batch keys of single-user (u-side) features."""
    return frozenset(f.name + suffix
                     for f in schema.id_features if f.side == "u"
                     for suffix in (IDS, WTS, LEN))


def broadcast_uside(batch: dict, keys: frozenset, bsz: int) -> dict:
    """``[1, ...]`` u-side features broadcast to the request batch; any
    other key is left as it is, so a ``[1, ...]`` i-side input still fails
    on its shape in the model."""
    return {k: (v.expand((bsz,) + tuple(v.shape[1:]))
                if k in keys and v.dim() >= 1 and v.shape[0] == 1
                and bsz > 1 else v)
            for k, v in batch.items()}


class Scorer:
    """Scores assembled requests on one device.

    ``params`` is the model's param tree (``model.init``,
    ``convert.params_from_jax`` or a bundle's, int8 tables included) and
    ``model_state`` its batch-norm moving statistics (default a fresh
    model's); both are moved to ``device`` once.  The default device is
    the card: on a machine without CUDA the constructor raises instead of
    scoring on the CPU.  Pass ``device="cpu"`` for the plain PyTorch
    path."""

    def __init__(self, cfg: DMTConfig, params, scale: np.ndarray,
                 const_vec: np.ndarray, device="cuda",
                 model_state: Optional[dict] = None):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"Scorer: device {self.device} requested but CUDA is not "
                "available; pass device='cpu' to score on the CPU")
        float32_sums(self.device)
        self.cfg = cfg
        self.model = build_model(cfg)
        self.params = tree_map(lambda t: t.to(self.device), params)
        self.model_state = tree_map(lambda t: t.to(self.device),
                                    model_state or {})
        self.scale = torch.as_tensor(scale, dtype=torch.float32,
                                     device=self.device)
        self.const_vec = torch.as_tensor(const_vec, dtype=torch.float32,
                                         device=self.device)
        self._w = tuple(cfg.export_weight)
        self._wsum = float(sum(self._w))
        self.uside = uside_keys(self.model.schema)

    def _tensor(self, v) -> torch.Tensor:
        """A request array on the scorer's device; a host array goes to
        the card from pinned memory without blocking the host (counted in
        ``scorer.h2d_bytes``)."""
        if isinstance(v, torch.Tensor):
            if self.device.type == "cuda" and v.device.type == "cpu":
                tracing.count("scorer.h2d_bytes", v.nbytes)
            return v.to(self.device)
        t = torch.as_tensor(np.asarray(v))
        if self.device.type == "cuda":
            tracing.count("scorer.h2d_bytes", t.nbytes)
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    @torch.inference_mode()
    def _score(self, b: dict) -> dict:
        b["features"] = normalize_dense(b["raw_features"], self.scale,
                                        self.const_vec)
        logits = self.model.apply(self.params, b, state=self.model_state)
        p_ctr, p_cvr = scores_from_logits(self.cfg, logits, rel_only=True)
        scores = (self._w[0] * p_ctr + self._w[1] * p_cvr) / self._wsum
        return {"Scores": scores, "click_Scores": p_ctr,
                "order_Scores": p_cvr}

    def score_async(self, batch: dict) -> dict:
        """One request -> ``Scores``, ``click_Scores``, ``order_Scores``,
        each a ``[B]`` tensor on the scorer's device, returned without
        waiting for the card: the caller overlaps the next request's host
        work with this one's kernels and reads the values when needed.
        Under ``core.tracing.recording()`` the inputs' way to the device
        is a ``scorer.merge`` span and the forward a ``scorer.forward``
        one."""
        with tracing.span("scorer.merge"):
            b = {k: self._tensor(v) for k, v in batch.items()}
            b = broadcast_uside(b, self.uside, b["valid"].shape[0])
        with tracing.span("scorer.forward"):
            return self._score(b)

    def score_group_async(self, batches: list[dict]) -> dict:
        """Several requests with the same candidate count in one pass,
        returned as ``score_async`` returns them: ``[sum(B_i)]`` tensors
        in request order.

        Each request carries ``[1, ...]`` u-side rows (``assemble`` with
        ``tile_uside=False``).  i-side arrays are concatenated over the
        requests and each request's u-side row is repeated over its
        candidates.  Requests already on the device are concatenated
        there; host requests are merged on the host, so each key crosses
        to the card once.  Spans as in ``score_async``."""
        n_req = len(batches)
        if n_req == 0:
            raise ValueError("score_group: no requests")
        if n_req == 1:
            return self.score_async(batches[0])
        sizes = {int(b["valid"].shape[0]) for b in batches}
        if len(sizes) != 1:
            raise ValueError("score_group needs equal candidate counts per "
                             f"request, got {sorted(sizes)}")
        per = sizes.pop()
        with tracing.span("scorer.merge"):
            b = {}
            for k in batches[0]:
                vals = [r[k] for r in batches]
                if all(isinstance(v, torch.Tensor) for v in vals):
                    b[k] = torch.cat([self._tensor(v) for v in vals])
                else:
                    b[k] = self._tensor(np.concatenate(
                        [np.asarray(v) for v in vals]))
            for k in self.uside:
                v = b.get(k)
                if v is not None and v.shape[0] == n_req and per > 1:
                    b[k] = v.repeat_interleave(per, dim=0)
        with tracing.span("scorer.forward"):
            return self._score(b)

    def __call__(self, batch: dict) -> dict:
        """One request -> numpy ``Scores``, ``click_Scores``,
        ``order_Scores``, each ``[B]``."""
        return {k: v.cpu().numpy() for k, v in
                self.score_async(batch).items()}

    def score_group(self, batches: list[dict]) -> dict:
        """``score_group_async`` as numpy arrays."""
        return {k: v.cpu().numpy() for k, v in
                self.score_group_async(batches).items()}


def quantize_table(table: np.ndarray) -> dict:
    """Symmetric per-row int8 quantization: q = round(row / scale) with
    scale = rowmax(|row|) / 127, so the largest elementwise error is
    scale / 2.  numpy arithmetic, the JAX package's bits."""
    t = np.asarray(table, np.float32)
    scale = np.abs(t).max(axis=1, keepdims=True) / 127.0
    scale = np.where(scale > 0, scale, 1.0).astype(np.float32)
    q = np.clip(np.rint(t / scale), -127, 127).astype(np.int8)
    return {"q": q, "scale": scale}


def _packed(cfg: DMTConfig, rows: int, dim: int) -> int:
    """Logical rows per physical row of the reference's storage of a
    ``[rows, dim]`` main table (1: not lane-packed)."""
    if cfg.packed_tables and rows >= cfg.pack_rows_threshold:
        return pack_factor(dim)
    return 1


def quantize_tables(cfg: DMTConfig, params: dict, rows_threshold: int
                    ) -> tuple[dict, list]:
    """int8-quantize every main embedding table with at least
    ``rows_threshold`` physical rows; returns (new params, the quantized
    names for the descriptor).

    The reference quantizes the rows it stores: a table it lane-packs
    (``cfg.packed_tables``, at least ``pack_rows_threshold`` logical rows,
    ``p = 128 // D`` > 1) has ``ceil(R / p)`` physical rows of p logical
    rows each, and gets one scale per such group.  So here a packed table
    is quantized as ``[ceil(R / p), p * D]`` (zero rows padding the last
    group) and kept as logical int8 rows ``q [R, D]`` with ``scale
    [ceil(R / p), 1]``; the threshold is compared with ``ceil(R / p)``.
    Bias-net tables are tiny and left as they are."""
    quantized: list = []
    out = dict(params)
    if "emb" in out:
        tables = dict(out["emb"])
        for name, t in tables.items():
            rows, dim = t.shape
            p = _packed(cfg, rows, dim)
            phys = -(-rows // p)
            if phys < rows_threshold:
                continue
            arr = t.float().cpu().numpy()
            if p > 1:
                arr = np.pad(arr, ((0, phys * p - rows), (0, 0)))
                arr = arr.reshape(phys, p * dim)
            qt = quantize_table(arr)
            tables[name] = {
                "q": torch.from_numpy(qt["q"].reshape(-1, dim)[:rows].copy()),
                "scale": torch.from_numpy(qt["scale"])}
            quantized.append(name)
        out["emb"] = tables
    return out, quantized


def export_model(cfg: DMTConfig, ckpt_step: int,
                 export_dir: Optional[str] = None) -> str:
    """Bundles ``model.ckpt-{ckpt_step}``'s params and model state, the
    normalization constants and a descriptor, on the host; returns the
    bundle's directory.

    Layout (replaces the TF SavedModel dir, export_model.py:121-137):
        {export_dir}/params.pt         {"params", "model_state"}
                                       (``torch.save``)
        {export_dir}/descriptor.json
        {export_dir}/norm.npz          scale + const_vec

    ``cfg.export_int8_rows`` > 0 ships the large tables int8
    (``quantize_tables``), dequantized after the gather when scored."""
    from ..train.evaluate import _restore_for_eval

    export_dir = os.path.abspath(export_dir or os.path.join(
        cfg.model_path, "frozen", f"ckpt-{ckpt_step}"))
    params, mstate = _restore_for_eval(CheckpointManager(cfg.model_path),
                                       ckpt_step)
    mean = read_stat_vector(cfg.train_data_mean_path, cfg.feature_dimension)
    std = read_stat_vector(cfg.train_data_std_path, cfg.feature_dimension)
    scale, const_vec = norm_constants(mean, std)
    int8_tables: list = []
    if cfg.export_int8_rows > 0:
        params, int8_tables = quantize_tables(cfg, params,
                                              cfg.export_int8_rows)

    os.makedirs(export_dir, exist_ok=True)
    save_file({"params": params, "model_state": mstate},
              os.path.join(export_dir, PARAMS_FILE))
    np.savez(os.path.join(export_dir, "norm.npz"),
             scale=scale, const_vec=const_vec)
    with open(os.path.join(export_dir, "descriptor.json"), "w") as f:
        json.dump({
            "model_type": cfg.model_type,
            "ckpt_step": ckpt_step,
            "export_weight": list(cfg.export_weight),
            "feature_dimension": cfg.feature_dimension,
            "int8_tables": int8_tables,
            "signature": {"inputs": "raw_features + id features",
                          "outputs": ["Scores", "click_Scores", "order_Scores"]},
        }, f, indent=2)
    return export_dir


def load_scorer(cfg: DMTConfig, export_dir: str, device="cuda") -> Scorer:
    """A ``Scorer`` on ``device`` over an ``export_model`` bundle.  The
    default device is the card: without CUDA this raises."""
    from ..train.evaluate import check_device

    device = check_device(device, "load_scorer")
    export_dir = os.path.abspath(export_dir)
    with open(os.path.join(export_dir, "descriptor.json")) as f:
        desc = json.load(f)
    bundle = torch.load(os.path.join(export_dir, PARAMS_FILE),
                        map_location=device, weights_only=True)
    params = bundle["params"]
    for name in desc.get("int8_tables", ()):
        if not isinstance(params["emb"][name], dict):
            raise ValueError(f"bundle {export_dir}: {name} is listed as "
                             "int8 but holds no int8 table")
    norm = np.load(os.path.join(export_dir, "norm.npz"))
    return Scorer(cfg, params, norm["scale"], norm["const_vec"],
                  device=device, model_state=bundle["model_state"])
