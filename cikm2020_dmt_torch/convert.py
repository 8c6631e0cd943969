"""JAX param trees -> the port's param trees.

The reference's params are nested dicts and lists of arrays; the port's
have the same keys and the same leaf layouts, so converting is a copy of
each leaf into a tensor of the same dtype.  The one layout that differs is
the reference's 128-lane packed table storage (a TPU tiling layout, rows of
``p = 128 // dim`` logical rows): every table of the main and bias-net
collections is unpacked to its logical ``[R, dim]`` rows.

The input holds numpy arrays (``jax.tree_util.tree_map(np.asarray, ...)``
of a JAX ``model.init`` or checkpoint); bfloat16 arrays may come as
``ml_dtypes.bfloat16`` numpy arrays and keep that dtype here.  Every leaf
is carried, the bias net's included.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.config import DMTConfig, EmbeddingSpec
from .nn.embedding import pack_factor, unpack_table
from .nn.layers import tree_map


def to_tensor(a, device="cpu") -> torch.Tensor:
    """numpy (or ml_dtypes bfloat16) array -> tensor of the same dtype."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a).copy())
    return t.to(device)


def tree_to_tensors(tree, device="cpu"):
    """Every numpy leaf of a param tree -> a tensor on ``device``."""
    return tree_map(lambda a: to_tensor(a, device), tree)


def _tables(tables: dict, specs: tuple[EmbeddingSpec, ...], device) -> dict:
    """Each table to logical ``[rows, dim]``, unpacking packed storage."""
    shape_of = {}
    for spec in specs:
        shape_of.setdefault(spec.table, (spec.id_size, spec.dim))
    out = {}
    for name, arr in tables.items():
        arr = np.asarray(arr)
        rows, dim = shape_of[name]
        p = pack_factor(dim)
        if arr.shape == (rows, dim):
            logical = arr
        elif p > 1 and arr.shape == (-(-rows // p), p * dim):
            logical = unpack_table(arr, rows, dim)
        else:
            raise ValueError(f"table {name!r}: shape {arr.shape} is neither "
                             f"logical ({rows}, {dim}) nor its packed form")
        out[name] = to_tensor(logical, device)
    return out


def params_from_jax(cfg: DMTConfig, params, device="cpu") -> dict:
    """A JAX param tree (numpy leaves) -> the port's tree on ``device``."""
    out = {k: tree_to_tensors(v, device) for k, v in params.items()
           if k not in ("emb", "bias_net")}
    if "emb" in params:
        out["emb"] = _tables(params["emb"], cfg.embeddings, device)
    if "bias_net" in params:
        bias = dict(params["bias_net"])
        out["bias_net"] = {k: tree_to_tensors(v, device)
                           for k, v in bias.items() if k != "emb"}
        out["bias_net"]["emb"] = _tables(bias["emb"], cfg.embeddings_bias,
                                         device)
    return out
