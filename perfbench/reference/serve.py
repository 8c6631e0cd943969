"""Plain PyTorch reference of serving: online normalization of the raw
dense features, the user's rows repeated over the candidates, the
forward without the bias head, and the blended Scores."""

from __future__ import annotations

import numpy as np
import torch

from . import model

STD_EPS = 1e-7
F32_MAX = float(np.finfo(np.float32).max)


def norm_constants(mean, std):
    """(scale, const) of ``clip(clip(raw, 0, max) * scale - const, -0.99,
    0.99)``, worked out in float64 and kept in float32."""
    mean = np.asarray(mean, np.float64)
    std = np.asarray(std, np.float64)
    se = std + STD_EPS
    scale = std / (3.0 * se * se)
    const = mean * std / (3.0 * se * se) + mean * std / se - mean
    return scale.astype(np.float32), const.astype(np.float32)


def batch_of(conf, requests: list, scale, const, device) -> dict:
    """The requests as one batch of their candidates, u-side rows
    repeated, features normalized."""
    n = [int(r["valid"].shape[0]) for r in requests]
    out = {}
    for key in requests[0]:
        if key in ("raw_features", "valid") or key.startswith("_"):
            continue
        parts = [np.repeat(r[key], k, axis=0) if r[key].shape[0] == 1
                 and k > 1 else r[key] for r, k in zip(requests, n)]
        out[key] = torch.from_numpy(np.concatenate(parts)).to(device)
    raw = torch.from_numpy(np.concatenate(
        [r["raw_features"] for r in requests])).to(device)
    s = torch.as_tensor(scale, device=device)
    c = torch.as_tensor(const, device=device)
    out["features"] = (raw.clamp(0.0, F32_MAX) * s - c).clamp(-0.99, 0.99)
    return out


@torch.no_grad()
def scores(conf, params, requests: list, scale, const, device,
           block: int = 16) -> list:
    """[3, candidates] numpy (Scores, click, order) of each request, in
    blocks of ``block`` requests."""
    out = []
    for i in range(0, len(requests), block):
        part = requests[i:i + block]
        b = batch_of(conf, part, scale, const, device)
        logits, _ = model.forward(conf, params, b, model.Lookups(),
                                  train=False, with_bias=False)
        s = torch.stack(model.scores(conf, logits)).cpu().numpy()
        off = 0
        for r in part:
            k = int(r["valid"].shape[0])
            out.append(s[:, off:off + k])
            off += k
    return out
