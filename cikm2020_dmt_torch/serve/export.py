"""Serving: online dense normalization, u-side broadcast and the blended
Scores (``cikm2020_dmt_tpu/serve/export.py``).

A request is an assembled index batch (numpy arrays keyed like the
training batch) with ``raw_features`` ``[B, feature_dimension]``, ``valid``
``[B]`` and the id features.  Single-user (u-side) features may come as
``[1, L]`` rows, which the scorer broadcasts to the B candidates.

    normalized = clip(clip(raw, 0, max) * scale - const_vec, -0.99, 0.99)
    Scores     = (w0 * sigmoid(click) + w1 * sigmoid(order)) / (w0 + w1)

with relevance-only logits (the bias head is dropped).  The string-id
``ServingPreprocessor`` (vocab files), int8 tables and the request queue
are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.config import DMTConfig
from ..data.pipeline import IDS, LEN, WTS
from ..data.schema import FeatureSchema
from ..models.zoo import build_model
from ..nn.layers import tree_map
from ..train.losses import scores_from_logits

EPS = 1e-7
F32_MAX = float(np.finfo(np.float32).max)


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

    ``params`` is the model's param tree (``model.init`` or
    ``convert.params_from_jax``); it is moved to ``device`` once.  The
    default device is the card: on a machine without CUDA the constructor
    raises instead of scoring on the CPU.  Pass ``device="cpu"`` for the
    plain PyTorch path."""

    def __init__(self, cfg: DMTConfig, params, scale: np.ndarray,
                 const_vec: np.ndarray, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"Scorer: device {self.device} requested but CUDA is not "
                "available; pass device='cpu' to score on the CPU")
        self.cfg = cfg
        self.model = build_model(cfg)
        self.params = tree_map(lambda t: t.to(self.device), params)
        self.scale = torch.as_tensor(scale, dtype=torch.float32,
                                     device=self.device)
        self.const_vec = torch.as_tensor(const_vec, dtype=torch.float32,
                                         device=self.device)
        self._w = tuple(cfg.export_weight)
        self._wsum = float(sum(self._w))
        self.uside = uside_keys(self.model.schema)

    def _tensors(self, batch: dict) -> dict:
        return {k: torch.as_tensor(np.asarray(v)).to(self.device)
                for k, v in batch.items()}

    @torch.inference_mode()
    def _score(self, b: dict) -> dict:
        b["features"] = normalize_dense(b["raw_features"], self.scale,
                                        self.const_vec)
        logits = self.model.apply(self.params, b)
        p_ctr, p_cvr = scores_from_logits(self.cfg, logits, rel_only=True)
        scores = (self._w[0] * p_ctr + self._w[1] * p_cvr) / self._wsum
        out = {"Scores": scores, "click_Scores": p_ctr,
               "order_Scores": p_cvr}
        return {k: v.cpu().numpy() for k, v in out.items()}

    def __call__(self, batch: dict) -> dict:
        """One request -> numpy ``Scores``, ``click_Scores``,
        ``order_Scores``, each ``[B]``."""
        b = self._tensors(batch)
        return self._score(broadcast_uside(b, self.uside,
                                           b["valid"].shape[0]))

    def score_group(self, batches: list[dict]) -> dict:
        """Several requests with the same candidate count in one pass.

        Each request carries ``[1, ...]`` u-side rows.  i-side arrays are
        concatenated over the requests and each request's u-side row is
        repeated over its candidates.  Returns ``[sum(B_i)]`` arrays in
        request order."""
        n_req = len(batches)
        if n_req == 0:
            raise ValueError("score_group: no requests")
        sizes = {int(np.asarray(b["valid"]).shape[0]) for b in batches}
        if len(sizes) != 1:
            raise ValueError("score_group needs equal candidate counts per "
                             f"request, got {sorted(sizes)}")
        per = sizes.pop()
        merged = {k: np.concatenate([np.asarray(b[k]) for b in batches])
                  for k in batches[0]}
        b = self._tensors(merged)
        for k in self.uside:
            v = b.get(k)
            if v is not None and v.shape[0] == n_req and per > 1:
                b[k] = v.repeat_interleave(per, dim=0)
        return self._score(b)
