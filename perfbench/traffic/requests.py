"""Rerank requests from the seed: ``candidates`` items, each with random
raw dense features and one id per item feature, and the user's ``[1, L]``
rows.  The click, order and cart history lengths of the pool are spread
evenly over ``0..lens[g]`` (``lens`` of the cell's ``traffic``) and each
sequence's lengths are shuffled over the requests by the seed, so every
seed serves the same set of sizes in another order; the other u-side
features (the bias net's, which serving does not read) draw their own.

Parameters: ``pool`` distinct requests, ``candidates``, ``lens``."""

from __future__ import annotations

import numpy as np

from .. import seeds
from ..reference.model import IDS, LEN, WTS


def make(conf, params: dict, seed: int) -> list:
    """The pool of requests, numpy arrays keyed like a batch, with
    ``raw_features`` in place of ``features``.  Each request also records
    its drawn history lengths under ``_lens`` (popped by the caller)."""
    rng = np.random.default_rng(seeds.derive(seed, seeds.REQUESTS))
    n = int(params["candidates"])
    top = [int(x) for x in params["lens"]]
    ts = set(conf.attention_ts)
    group_of = {u: gi for gi, grp in enumerate(conf.attention_pairs)
                for u, _ in grp}
    for gi, t in enumerate(conf.attention_ts):
        group_of[t] = gi
    pool = int(params["pool"])
    spread = [rng.permutation([(i * (t + 1)) // pool for i in range(pool)])
              for t in top]
    out = []
    for r in range(pool):
        lens = [int(s[r]) for s in spread]
        req = {"raw_features": rng.uniform(
                   -1.0, 6.0, (n, conf.feature_dimension)).astype(np.float32),
               "valid": np.ones((n,), np.float32), "_lens": lens}
        for f in conf.features:
            L = f.max_len
            if f.side == "u":
                k = (min(lens[group_of[f.feature]], L)
                     if f.feature in group_of
                     else int(rng.integers(0, L + 1)))
                ids = np.zeros((1, L), np.int32)
                hi = 10 ** 7 if f.feature in ts else f.rows
                ids[0, :k] = rng.integers(1, hi, k)
                wts = (np.arange(L) < k).astype(np.float32)[None]
                lens_arr = np.array([k], np.int32)
            else:
                ids = np.zeros((n, L), np.int32)
                ids[:, 0] = rng.integers(1, f.rows, n)
                wts = np.zeros((n, L), np.float32)
                wts[:, 0] = 1.0
                lens_arr = np.ones((n,), np.int32)
            req[f.feature + IDS] = ids
            req[f.feature + WTS] = wts
            req[f.feature + LEN] = lens_arr
        out.append(req)
    return out
