"""Inverse-propensity weights for unbiased learning-to-rank (the port's
own copy of ``cikm2020_dmt_tpu/data/propensity.py``).

Propensity arrays estimated by EM (``propensity_em_position``, 401
entries by clipped display position; ``propensity_em_page``, 101 entries by
clipped page) load from a Python-literal file; each example's IPS weight is
``clip(1/p, 1, 10)``.  Without a file every propensity is 1.0, so every
weight is 1.0 (IPS off).
"""

from __future__ import annotations

import ast
import re

import numpy as np

MAX_POSITION = 400
MAX_PAGE = 100

_ASSIGN_RE = re.compile(rb"(propensity_em\w*)\s*=\s*(\[)", re.S)


def load_propensity_file(path: str) -> dict[str, np.ndarray]:
    """Parse ``name = [ ... ]`` float-list literals from a python file."""
    with open(path, "rb") as f:
        src = f.read()
    out: dict[str, np.ndarray] = {}
    for m in _ASSIGN_RE.finditer(src):
        name = m.group(1).decode()
        start = m.start(2)
        depth = 0
        for i in range(start, len(src)):
            c = src[i:i + 1]
            if c == b"[":
                depth += 1
            elif c == b"]":
                depth -= 1
                if depth == 0:
                    literal = src[start:i + 1].decode()
                    out[name] = np.asarray(ast.literal_eval(literal), dtype=np.float32)
                    break
    return out


class PropensityModel:
    """Position/page -> propensity -> clipped IPS weight."""

    def __init__(self, em_type: str = "page", table: np.ndarray | None = None):
        self.em_type = em_type
        size = (MAX_POSITION if em_type == "position" else MAX_PAGE) + 1
        if table is None:
            table = np.ones((size,), dtype=np.float32)
        self.table = np.asarray(table, dtype=np.float32)

    @classmethod
    def from_file(cls, path: str, em_type: str) -> "PropensityModel":
        tables = load_propensity_file(path)
        key = f"propensity_em_{em_type}"
        return cls(em_type, tables.get(key))

    def weights(self, positions: np.ndarray, pages: np.ndarray, labels: np.ndarray):
        """Returns (propensity, weight, weight_positive, weight_mul), the
        four per-example features the batch carries."""
        idx = positions if self.em_type == "position" else pages
        idx = np.minimum(idx, len(self.table) - 1)
        p = self.table[idx]
        w = np.clip(1.0 / np.maximum(p, 1e-12), 1.0, 10.0).astype(np.float32)
        w_pos = np.where(labels > 0.5, w, np.float32(1.0)).astype(np.float32)
        return p, w, w_pos, w
