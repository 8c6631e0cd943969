"""Warm-starting embedding tables from pretrained arrays (the port's own
copy of the JAX package's ``train/warmstart.py``).

Reference: ``base.embedding_update`` loads pickled numpy tables at start-up
(reference model/net/base.py:178-196), triggered by the
``update_emb`` config DSL ``Table:path#...`` (recsys_conf.py:330-338,
run_dnn.py:298-299).

The port keeps logical ``[R, D]`` tables, so a pretrained array replaces
its table as it is; the table keeps its dtype and device (a bfloat16
table gets a bfloat16 copy of the float32 array).
"""

from __future__ import annotations

import os
import pickle
from typing import Mapping

import numpy as np
import torch


def load_pretrained_table(path: str) -> np.ndarray:
    """One table from ``path``, ``path.pickle``, ``.npy`` or ``.npz`` (the
    reference used ``np.load(path + '.pickle')``), as float32."""
    for candidate in (path, path + ".pickle", path + ".npy", path + ".npz"):
        if os.path.exists(candidate):
            if candidate.endswith((".pickle", ".pkl")):
                with open(candidate, "rb") as f:
                    return np.asarray(pickle.load(f), np.float32)
            arr = np.load(candidate, allow_pickle=True)
            if isinstance(arr, np.lib.npyio.NpzFile):
                arr = arr[arr.files[0]]
            return np.asarray(arr, np.float32)
    raise FileNotFoundError(f"no pretrained table at {path}[.pickle|.npy|.npz]")


def warm_start_embeddings(params: dict,
                          table_paths: Mapping[str, str]) -> dict:
    """``params`` with the named tables of ``params["emb"]`` replaced by
    the arrays at their paths.  An unknown table raises ``KeyError``, an
    array whose shape is not the table's ``ValueError`` (the reference's
    assign would fail likewise)."""
    if not table_paths:
        return params
    emb = dict(params.get("emb", {}))
    for name, path in table_paths.items():
        if name not in emb:
            raise KeyError(f"unknown embedding table {name!r}; "
                           f"have {sorted(emb)}")
        arr = load_pretrained_table(path)
        old = emb[name]
        if tuple(arr.shape) != tuple(old.shape):
            raise ValueError(f"pretrained table {name}: shape {arr.shape} "
                             f"!= {tuple(old.shape)}")
        emb[name] = torch.from_numpy(arr).to(device=old.device,
                                             dtype=old.dtype)
    out = dict(params)
    out["emb"] = emb
    return out


def parse_update_emb(spec: str) -> dict[str, str]:
    """``Table:path#Table2:path2`` -> {table: path}; entries that are not
    one ``table:path`` pair are skipped (reference get_emb_init_info,
    recsys_conf.py:330-338)."""
    out: dict[str, str] = {}
    for item in spec.split("#"):
        fields = item.split(":")
        if len(fields) != 2:
            continue
        out[fields[0]] = fields[1]
    return out
