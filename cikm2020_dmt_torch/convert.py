"""JAX param trees and train states -> the port's.

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

``train_state_from_jax`` carries a JAX ``Trainer`` state across: the
params, the model state (``model_state_from_jax``), the dense optimizer's
state in the keys of ``train/optim.py`` (optax Adam's ``mu``/``nu``/
``count`` as ``m``/``v``/``count``; the adagrad, rmsprop and adadelta
states under their optax field names; the schedule's ``count``; the JAX
FTRL's ``n``/``z``/``step``; trees of tables unpacked like the params),
and the lazy-Adam moments, which JAX stores flat as [2 R_phys, w] (m in
rows [0, R_phys)) and the port as [2, R, D].
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


def _shapes(specs: tuple[EmbeddingSpec, ...]) -> dict:
    shape_of = {}
    for spec in specs:
        shape_of.setdefault(spec.table, (spec.id_size, spec.dim))
    return shape_of


def _logical(name: str, arr, rows: int, dim: int):
    """One table's rows as logical ``[rows, dim]``, unpacking packed
    storage."""
    arr = np.asarray(arr)
    p = pack_factor(dim)
    if arr.shape == (rows, dim):
        return arr
    if p > 1 and arr.shape == (-(-rows // p), p * dim):
        return unpack_table(arr, rows, dim)
    raise ValueError(f"table {name!r}: shape {arr.shape} is neither "
                     f"logical ({rows}, {dim}) nor its packed form")


def _tables(tables: dict, specs: tuple[EmbeddingSpec, ...], device) -> dict:
    """Each table to logical ``[rows, dim]``, unpacking packed storage."""
    shape_of = _shapes(specs)
    return {name: to_tensor(_logical(name, arr, *shape_of[name]), device)
            for name, arr in tables.items()}


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


def model_state_from_jax(state, device="cpu") -> dict:
    """A JAX model state (batch norm's moving statistics, numpy leaves)
    -> the port's; the trees are the same."""
    return tree_to_tensors(state, device)


def _scalar(x, device) -> torch.Tensor:
    return torch.tensor(int(np.asarray(x)), dtype=torch.int64,
                        device=device)


def opt_state_from_jax(cfg: DMTConfig, opt_state, device="cpu") -> dict:
    """A JAX dense optimizer state (an optax chain's tuple of states, or
    the FTRL dict) -> the port's dict.  Param-shaped trees are converted
    like the params, counts become int64 scalars."""
    if isinstance(opt_state, dict):           # the JAX package's FTRL
        return {"n": params_from_jax(cfg, opt_state["n"], device),
                "z": params_from_jax(cfg, opt_state["z"], device),
                "step": _scalar(opt_state["step"], device)}
    names = {"mu": "m", "nu": "v"} if cfg.optimizer.lower() == "adam" \
        else {}
    out: dict = {}
    for part in opt_state:
        for field, value in getattr(part, "_asdict", dict)().items():
            key = names.get(field, field)
            if key in out:
                continue      # the schedule's count equals Adam's own
            out[key] = (params_from_jax(cfg, value, device)
                        if isinstance(value, dict)
                        else _scalar(value, device))
    return out


def _lazy_moments(name: str, mv, rows: int, dim: int, device):
    """JAX lazy-Adam moments -> [2, rows, dim] float32: flat [2 R_phys, w]
    (m in the first half of the rows) or already stacked [2, R_phys, w]."""
    mv = np.asarray(mv)
    halves = mv if mv.ndim == 3 else mv.reshape(2, mv.shape[0] // 2, -1)
    return to_tensor(np.stack([_logical(name, h, rows, dim)
                               for h in halves]), device)


def train_state_from_jax(cfg: DMTConfig, state, device="cpu") -> dict:
    """A JAX ``Trainer`` state (numpy leaves, the tree of
    ``Trainer.init_state``) -> the port's ``Trainer`` state on
    ``device``."""
    shape_of = _shapes(cfg.embeddings)
    return {
        "params": params_from_jax(cfg, state["params"], device),
        "model_state": model_state_from_jax(state.get("model_state", {}),
                                            device),
        "opt": opt_state_from_jax(cfg, state["opt_state"], device),
        "lazy_opt": {name: {"mv": _lazy_moments(name, sub["mv"],
                                                *shape_of[name], device)}
                     for name, sub in state.get("lazy_opt", {}).items()},
        "step": _scalar(state["step"], device),
        "lazy_overflow": _scalar(state.get("lazy_overflow", 0), device),
    }


# ---------------------------------------------------------------------------
# A train state on a mesh
# ---------------------------------------------------------------------------


def _split_leaves(cfg: DMTConfig, mesh) -> dict:
    """Path -> (R, p, lo, hi) of each model-split table of a param tree
    (``("emb", name)`` or ``("bias_net", "emb", name)``): its logical rows,
    group size and this rank's share [lo, hi)."""
    from .parallel.embedding_shard import model_split_tables
    from .parallel.full_shard import share_rows
    out = {}
    for name, (R, p) in model_split_tables(cfg, mesh.size,
                                           mesh.model).items():
        path = (("bias_net", "emb", name[5:]) if name.startswith("bias:")
                else ("emb", name))
        out[path] = (R, p) + share_rows(R, p, mesh.model, mesh.model_index)
    return out


def _at(tree: dict, path: tuple, fn, info) -> dict:
    """A copy of ``tree`` with ``fn(leaf, *info)`` at ``path`` where it
    holds one (the dicts on the way copied), else ``tree``."""
    node = tree.get(path[0]) if isinstance(tree, dict) else None
    if node is None:
        return tree
    out = dict(tree)
    out[path[0]] = (fn(node, *info) if len(path) == 1
                    else _at(node, path[1:], fn, info))
    return out


def _map_paths(tree: dict, paths: dict, fn) -> dict:
    """``_at`` for each path -> info of ``paths``."""
    for path, info in paths.items():
        tree = _at(tree, path, fn, info)
    return tree


def _param_trees(state: dict) -> list:
    """The keys of ``state["opt"]`` that hold a param-shaped tree (Adam's
    m and v, FTRL's n and z, ...)."""
    return [k for k, v in state.get("opt", {}).items()
            if isinstance(v, dict) and ("emb" in v or "bias_net" in v)]


def shard_params(cfg: DMTConfig, params: dict, mesh) -> dict:
    """Params on ``mesh.device`` with each full-mesh table cut to this
    rank's rows (``full_shard.share_rows``) and each model-split table to
    its model index's rows; a table already cut stays as it is.  JAX
    params held on a (d, m) mesh convert with ``params_from_jax`` (the
    whole arrays) and then this."""
    from .parallel.full_shard import fms_tables, share_rows
    out = tree_map(lambda t: t.to(mesh.device), params)
    for name, (R, p) in fms_tables(cfg, mesh.size).items():
        if out["emb"][name].shape[0] == R:
            lo, hi = share_rows(R, p, mesh.size, mesh.rank)
            out["emb"][name] = out["emb"][name][lo:hi].clone()
    return _map_paths(out, _split_leaves(cfg, mesh),
                      lambda t, R, p, lo, hi:
                      t[lo:hi].clone() if t.shape[0] == R else t)


def shard_state(cfg: DMTConfig, state: dict, mesh) -> dict:
    """A whole train state (any device) -> this rank's share on
    ``mesh.device``: each full-mesh table's rows ``share_rows`` and the
    same rows of its [2, R, D] moments; each model-split table's rows of
    its model index, with the same rows of its dense optimizer state or of
    its lazy moments; ``lazy_overflow`` with rank 0 only (the ranks'
    counts are summed where they are read); every other leaf whole."""
    from .parallel.full_shard import fms_tables, share_rows
    out = tree_map(lambda t: t.to(mesh.device), state)
    for name, (R, p) in fms_tables(cfg, mesh.size).items():
        lo, hi = share_rows(R, p, mesh.size, mesh.rank)
        out["params"]["emb"][name] = out["params"]["emb"][name][lo:hi].clone()
        if name in out.get("lazy_opt", {}):
            out["lazy_opt"][name]["mv"] = \
                out["lazy_opt"][name]["mv"][:, lo:hi].clone()
    split = _split_leaves(cfg, mesh)

    def cut(t, R, p, lo, hi):
        return t[lo:hi].clone()

    out["params"] = _map_paths(out["params"], split, cut)
    for k in _param_trees(out):
        out["opt"][k] = _map_paths(out["opt"][k], split, cut)
    lazy = {("lazy_opt", path[-1], "mv"): info for path, info in split.items()
            if path[0] == "emb"}
    out = _map_paths(out, lazy, lambda t, R, p, lo, hi: t[:, lo:hi].clone())
    if mesh.rank != 0 and "lazy_overflow" in out:
        out["lazy_overflow"] = torch.zeros_like(out["lazy_overflow"])
    return out


def _whole(mesh, t: torch.Tensor, axis: int, R: int, per: int,
           over) -> torch.Tensor:
    """The shares ``t`` (at most ``per`` rows on dim ``axis``) of the ranks
    of ``over`` (None: every rank) gathered in order, cut to R rows."""
    pad = per - t.shape[axis]
    if pad:
        shape = list(t.shape)
        shape[axis] = pad
        t = torch.cat([t, t.new_zeros(shape)], axis)
    g = mesh.all_gather(t, axis=over)                 # [n, ...]
    g = torch.cat(list(g.unbind(0)), axis)
    return g.narrow(axis, 0, R)


def _model_whole(mesh, axis: int):
    """``_map_paths``'s fn: a model-split share gathered over the model
    group on dim ``axis``."""
    from .parallel.full_shard import share_rows

    def fn(t, R, p, lo, hi):
        lo0, hi0 = share_rows(R, p, mesh.model, 0)
        return _whole(mesh, t, axis, R, hi0 - lo0, "model")
    return fn


def gather_split(tree: dict, cfg: DMTConfig, mesh) -> dict:
    """A param-shaped tree (params, or an optimizer's tree of them) with
    each model-split table's share gathered whole over the model group
    (every rank takes part)."""
    return _map_paths(tree, _split_leaves(cfg, mesh), _model_whole(mesh, 0))


def gather_state(cfg: DMTConfig, state: dict, mesh) -> dict:
    """This rank's share -> the whole train state on every rank (on
    ``mesh.device``), in the one-process layout: the full-mesh tables and
    moments gathered in rank order, the model-split tables with their
    optimizer state over the model group, ``lazy_overflow`` summed.  Every
    rank takes part (collectives)."""
    from .parallel.full_shard import fms_tables, share_rows
    out = dict(state)
    out["params"] = dict(state["params"])
    out["params"]["emb"] = dict(state["params"].get("emb", {}))
    out["lazy_opt"] = dict(state.get("lazy_opt", {}))
    for name, (R, p) in fms_tables(cfg, mesh.size).items():
        lo, hi = share_rows(R, p, mesh.size, 0)
        per = hi - lo
        out["params"]["emb"][name] = _whole(
            mesh, state["params"]["emb"][name], 0, R, per, None)
        if name in out["lazy_opt"]:
            out["lazy_opt"][name] = {"mv": _whole(
                mesh, state["lazy_opt"][name]["mv"], 1, R, per, None)}
    out["params"] = gather_split(out["params"], cfg, mesh)
    for k in _param_trees(state):
        out["opt"] = _at(out["opt"], (k,), gather_split, (cfg, mesh))
    lazy = {("lazy_opt", path[-1], "mv"): info
            for path, info in _split_leaves(cfg, mesh).items()
            if path[0] == "emb"}
    out = _map_paths(out, lazy, _model_whole(mesh, 1))
    if "lazy_overflow" in state:
        out["lazy_overflow"] = mesh.reduce_sum(state["lazy_overflow"])
    return out
