"""Training batches from the seed: normal dense features, a one-hot class
mask, each id feature's length uniform in 1..max_len and Zipf ids hashed
over its table (ranking traffic is heavy-tailed), timestamps uniform up
to 10**7.

Parameters (the cell's ``traffic``): ``batch`` examples a batch,
``batches`` distinct batches cycled by the window, ``zipf`` the exponent,
``labels`` the class of each draw of the label pool."""

from __future__ import annotations

import numpy as np
import torch

from .. import seeds
from ..reference.model import IDS, LEN, WTS


def batch(conf, n: int, seed: int, zipf: float, labels) -> dict:
    """One batch as numpy arrays, from a numpy seed."""
    rng = np.random.default_rng(seed)
    classes = [c for c, _ in conf.train_weight]
    label = rng.choice(np.asarray(labels), n)
    mask = np.zeros((n, len(classes)), np.float32)
    mask[np.arange(n), [classes.index(int(c)) for c in label]] = 1.0
    b = {"features": rng.normal(size=(n, conf.feature_dimension)
                                ).astype(np.float32),
         "valid": np.ones((n,), np.float32), "mask": mask}
    ts = set(conf.attention_ts)
    for f in conf.features:
        L = f.max_len
        lens = rng.integers(1, L + 1, n).astype(np.int32)
        if f.feature in ts:
            ids = rng.integers(1, 10 ** 7, (n, L))
        else:
            z = rng.zipf(zipf, (n, L)).astype(np.int64)
            ids = (z * 2654435761) % max(1, f.rows)
        present = np.arange(L)[None, :] < lens[:, None]
        b[f.feature + IDS] = (ids * present).astype(np.int32)
        b[f.feature + WTS] = present.astype(np.float32)
        b[f.feature + LEN] = lens
    return b


def make(conf, params: dict, seed: int, device) -> list:
    """The cell's distinct batches on ``device``."""
    out = []
    for i in range(int(params["batches"])):
        b = batch(conf, int(params["batch"]),
                  seeds.derive(seed, seeds.BATCHES, i),
                  float(params["zipf"]), params["labels"])
        out.append({k: torch.from_numpy(v).to(device) for k, v in b.items()})
    return out
