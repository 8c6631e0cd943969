"""Embedding engine: the lookups a model makes, behind one object.

The reference engine
(``cikm2020_dmt_tpu/parallel/embedding_shard.py``) routes large tables
through dedup, one-hot or packed-row gathers; those exist for the TPU's
scatter and tiling costs and change no value, so here a lookup is a clamped
gather of a logical ``[R, D]`` table, differentiated by PyTorch's own
autograd (a scatter-add, accumulated in float32 for bfloat16 tables and
rounded once, as the reference's one-hot backward does).  One route does
change values: with ``onehot_bwd_bf16`` under bfloat16 compute, a lookup
that the reference sends through its one-hot backward (``bf16_cotangent``)
rounds its float32 cotangent to bfloat16 before the float32 sum.

During a training step the trainer sets ``overlay``: table name ->
``train.lazy.LazyOverlay``.  Lookups of an overlaid table then slice the
step's id-union grid at the site of their feature (``overlay_take``),
which keeps that table's gradient row-sparse.  The ``name`` argument names
the table, as in the reference; bias-net tables are namespaced
``bias:<table>``, so no overlay reaches them.

On a mesh (``make_engine(cfg, mesh)``) a full-mesh table holds only the
rank's share of its rows (``parallel/full_shard.py``): outside a training
step's overlay, ``FullMeshEngine`` looks its rows up from their owners
(``full_shard.lookup_fms``, exact), so every rank must make the same
lookups in the same order.

With a model axis (``mesh_model > 1``) a table of at least
``shard_rows_threshold`` physical rows (groups of ``p`` logical rows where
the reference packs the table) that the model axis divides, and that is
not full-mesh, is split by rows over the model group
(``model_split_tables``, the one policy; ``core.mesh.param_placement`` and
the lazy plan read it): model index m holds the logical rows
``full_shard.share_rows(R, p, model, m)``.  ``ShardedEmbeddingEngine``
looks such a table up by a masked local gather and a sum over the model
group, whose backward is the identity (each model peer holds the whole
cotangent), so each rank's gradient is the replicated engine's on its own
rows:

- ``pooled`` pools before the sum (float32), so ``[b, D]`` crosses the
  wire and not ``[b, L, D]``;
- ``seq`` (``shard_seq_exchange``, the default) dedups the ids, buckets
  them by owner (``C`` slots each), gathers the owned rows, and one
  ``all_gather`` of ``[M C p, D]`` over the model group serves the
  inverse map (``take_rows_sparse_sorted``, whose backward is the segment
  sum).  Past the budget or a bucket it takes the exact grid sum; the
  predicate reads the same ids on every model peer, so they agree;
- ``seq`` without the exchange is the grid sum.

Ids outside the table read the zero row there, as in the reference's
sharded engine (the replicated engine clamps them into range).  int8
serving tables stay replicated, and an overlaid table takes its overlay.
``shard_take_rows`` is the rows of explicit ids (the lazy plan's sharded
tables: ``train/lazy.py``).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.mesh import model_axis_gather, model_axis_sum
from ..nn.embedding import (pack_factor, pooled_from_grid, presence_mask,
                            take_clip)


def take_quant(table: dict, ids: torch.Tensor) -> torch.Tensor:
    """Rows of an int8 table, dequantized after the gather:
    ``q[id] * scale[id // group]`` in float32, ids clamped into range."""
    q, scale = table["q"], table["scale"]
    group = pack_factor(q.shape[1]) if scale.shape[0] != q.shape[0] else 1
    flat = ids.reshape(-1).clamp(0, q.shape[0] - 1)
    rows = (q.index_select(0, flat).to(scale.dtype)
            * scale.index_select(0, flat // group))
    return rows.reshape(*ids.shape, q.shape[1])


class _Bf16Cotangent(torch.autograd.Function):
    """The identity, whose backward rounds the cotangent to bfloat16 and
    back to its type."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(g.dtype)


def bf16_cotangent(cfg, table: torch.Tensor) -> bool:
    """Whether a lookup of the replicated float32 ``table`` rounds its
    cotangent to bfloat16: where the reference routes it to
    ``take_onehot(..., bf16_grad=True)`` (``dedup_grads``, fewer logical
    rows than ``dedup_rows_threshold``, at most ``onehot_bwd_rows_max``
    physical rows of its storage) with ``onehot_bwd_bf16`` under bfloat16
    compute.  A bfloat16 table's cotangent is bfloat16 already."""
    if cfg is None or not (cfg.onehot_bwd_bf16 and cfg.dedup_grads
                           and cfg.compute_dtype == "bfloat16"):
        return False
    R, D = table.shape
    return (table.dtype == torch.float32 and R < cfg.dedup_rows_threshold
            and -(-R // table_group(cfg, R, D)) <= cfg.onehot_bwd_rows_max)


class EmbeddingEngine:
    """Replicated-table engine: plain clamped gathers, int8 gathers, or
    the lazy-Adam overlay of the current training step.  ``cfg`` (None:
    plain gathers only) routes the one-hot backward's bfloat16 rounding
    (``bf16_cotangent``)."""

    def __init__(self, cfg=None):
        self.overlay: dict = {}
        self.cfg = cfg

    def _take(self, name: str, table: torch.Tensor, ids,
              feature: Optional[str]) -> torch.Tensor:
        ov = self.overlay.get(name)
        if ov is not None:
            from ..train.lazy import overlay_take
            return overlay_take(ov, feature, ids)
        if isinstance(table, dict):
            return take_quant(table, ids)
        if table.dtype == torch.bfloat16 and table.requires_grad:
            # float32 gradient accumulation, one rounding to the table type
            return take_clip(table.float(), ids).to(table.dtype)
        rows = take_clip(table, ids)
        if table.requires_grad and bf16_cotangent(self.cfg, table):
            rows = _Bf16Cotangent.apply(rows)
        return rows

    def pooled(self, name: str, table: torch.Tensor, ids, wts, lens,
               feature: Optional[str] = None,
               combiner: str = "mean") -> torch.Tensor:
        """Weighted mean (or, with ``combiner="sum"``, sum) of the present
        rows: ``[B, L] -> [B, D]``."""
        return pooled_from_grid(self._take(name, table, ids, feature), wts,
                                lens, combiner)

    def seq(self, name: str, table: torch.Tensor, ids,
            feature: Optional[str] = None) -> torch.Tensor:
        """Per-position rows, not zero-padded: ``[B, L] -> [B, L, D]``."""
        return self._take(name, table, ids, feature)


DENSE_ENGINE = EmbeddingEngine()


class FullMeshEngine(EmbeddingEngine):
    """The engine of a data mesh: a full-mesh table (its rank's share of
    rows) is looked up through the owners' exchange; every other table as
    in ``EmbeddingEngine``."""

    def __init__(self, cfg, mesh, tables: dict):
        super().__init__(cfg)
        self.mesh = mesh
        self.tables = tables       # name -> (logical rows R, group size p)

    def _take(self, name: str, table, ids, feature: Optional[str]):
        if name in self.tables and name not in self.overlay:
            from .full_shard import lookup_fms
            R, p = self.tables[name]
            return lookup_fms(self.mesh, table, ids, R, p)
        return super()._take(name, table, ids, feature)


def table_group(cfg, rows: int, dim: int) -> int:
    """Logical rows per physical row of a table in the reference's storage:
    ``128 // dim`` where it packs the table (``packed_tables``, at least
    ``pack_rows_threshold`` rows), else 1."""
    if cfg.packed_tables and rows >= cfg.pack_rows_threshold:
        return pack_factor(dim)
    return 1


def should_shard_table(cfg, model: int, rows: int) -> bool:
    """Whether a table of ``rows`` physical rows splits over a model axis
    of ``model`` ranks (JAX ``should_shard_table``)."""
    return model > 1 and rows >= cfg.shard_rows_threshold and \
        rows % model == 0


def model_split_tables(cfg, n_dev: int, model: int
                       ) -> dict[str, tuple[int, int]]:
    """Engine name -> (R logical rows, group size p) of each table split
    over the model axis on a mesh of ``n_dev`` ranks: main tables by name,
    bias-net tables as ``bias:<table>``; full-mesh tables excluded."""
    if model <= 1:
        return {}
    from .full_shard import fms_tables
    fms = fms_tables(cfg, n_dev)
    out = {}
    for prefix, specs in (("", cfg.embeddings), ("bias:", cfg.embeddings_bias)):
        by_table: dict[str, list] = {}
        for spec in specs:
            by_table.setdefault(spec.table, []).append(spec)
        for table, same in by_table.items():
            if not prefix and table in fms:
                continue
            R = max(s.id_size for s in same)
            p = table_group(cfg, same[0].id_size, same[0].dim)
            if should_shard_table(cfg, model, -(-R // p)):
                out[prefix + table] = (R, p)
    return out


def shard_lo(mesh, R: int, p: int) -> int:
    """The first logical row of this rank's share of a model-split table."""
    from .full_shard import share_rows
    return share_rows(R, p, mesh.model, mesh.model_index)[0]


def shard_take_rows(mesh, table: torch.Tensor, idx: torch.Tensor, R: int,
                    p: int) -> torch.Tensor:
    """Rows ``idx`` [n] of a model-split table of R logical rows (``table``
    is this rank's share): a masked local gather, then a float32 sum over
    the model group (exact: one peer holds each row).  Ids outside [0, R),
    the lazy plan's sentinels among them, read the zero row.  Every model
    peer passes the same ids; no gradient."""
    rel = idx.long() - shard_lo(mesh, R, p)
    n_here = table.shape[0]
    inb = (idx >= 0) & (idx < R) & (rel >= 0) & (rel < n_here)
    rows = table.index_select(0, rel.clamp(0, n_here - 1)).float()
    rows = torch.where(inb[:, None], rows, torch.zeros((), device=rows.device))
    return mesh.all_reduce(rows, axis="model").to(table.dtype)


class ShardedEmbeddingEngine(FullMeshEngine):
    """The engine of a mesh with a model axis: full-mesh tables through
    their owners, model-split tables (``split``: name -> (R, p)) through
    the model group, every other table replicated."""

    def __init__(self, cfg, mesh, full: dict, split: dict):
        super().__init__(cfg, mesh, full)
        self.split = split
        self.exchange = cfg.shard_seq_exchange
        self.budget_div = cfg.dedup_budget_div

    def _is_split(self, name: str, table) -> bool:
        return (name in self.split and name not in self.overlay
                and not isinstance(table, dict))

    @staticmethod
    def _source(table: torch.Tensor) -> torch.Tensor:
        """The share gathered from: float32 for a bfloat16 share that takes
        a gradient (accumulated in float32 and rounded once, as
        ``EmbeddingEngine``)."""
        if table.dtype == torch.bfloat16 and table.requires_grad:
            return table.float()
        return table

    def _local(self, name: str, table: torch.Tensor, ids) -> torch.Tensor:
        """[..., D]: the rows of the ids this rank holds, zeros for the
        others and for ids outside [0, R)."""
        R, p = self.split[name]
        n_here = table.shape[0]
        rel = ids.long() - shard_lo(self.mesh, R, p)
        inb = (ids >= 0) & (ids < R) & (rel >= 0) & (rel < n_here)
        rows = take_clip(self._source(table), rel)
        return torch.where(inb[..., None], rows,
                           torch.zeros((), dtype=rows.dtype,
                                       device=rows.device))

    def pooled(self, name: str, table, ids, wts, lens,
               feature: Optional[str] = None,
               combiner: str = "mean") -> torch.Tensor:
        if not self._is_split(name, table):
            return super().pooled(name, table, ids, wts, lens, feature,
                                  combiner)
        w = (wts * presence_mask(wts, lens)).float()
        part = torch.einsum("bl,bld->bd", w,
                            self._local(name, table, ids).float())
        pooled = model_axis_sum(part, self.mesh)
        if combiner != "sum":
            denom = w.sum(dim=-1, keepdim=True)
            pooled = torch.where(denom > 0,
                                 pooled / denom.clamp(min=1e-12),
                                 torch.zeros((), device=pooled.device))
        return pooled.to(table.dtype)

    def seq(self, name: str, table, ids,
            feature: Optional[str] = None) -> torch.Tensor:
        if not self._is_split(name, table):
            return super().seq(name, table, ids, feature)
        if self.exchange:
            out = self._exchange(name, table, ids)
            if out is not None:
                return out
        return model_axis_sum(self._local(name, table, ids),
                              self.mesh).to(table.dtype)

    def _exchange(self, name: str, table: torch.Tensor, ids):
        """The deduplicated exchange (JAX ``ShardedEmbeddingEngine.seq``'s
        fast branch), or None where the ids overflow the budget U or a
        bucket its C slots (one host read)."""
        from ..ops.scatter_rows import take_rows_sparse_sorted
        from ..train.lazy import union
        from .full_shard import _owned_rows, _round8, owner_layout
        mesh = self.mesh
        R, p = self.split[name]
        M, mi = mesh.model, mesh.model_index
        flat = ids.reshape(-1).long().clamp(0, R - 1)
        n = flat.numel()
        U = min(n, max(256, -(-n // max(1, self.budget_div))))
        C = min(U, _round8(-(-2 * U // M)))
        G = -(-R // p)
        per = G // M
        u = union(flat, R, p, U)
        bucketed, bslot, _, _, cap_drop = owner_layout(u.groups, C, M, per,
                                                       G)
        if int(torch.maximum(u.overflow, cap_drop)) > 0:
            return None
        rel = bucketed[mi * C:(mi + 1) * C] - mi * per
        rows = _owned_rows(self._source(table), rel, (rel >= 0) & (rel < per),
                           p)                                   # [C, p, D]
        grid = model_axis_gather(rows, mesh).reshape(M * C * p, -1)
        grid = torch.cat([grid, grid.new_zeros((1, grid.shape[1]))])

        def to_bucket(slot):
            # union row slot (u * p + r; U * p: none) -> bucket row
            b = bslot[(slot // p).clamp(max=U - 1)]
            return torch.where((slot < U * p) & (b < M * C),
                               b * p + slot % p, M * C * p)

        out = take_rows_sparse_sorted(grid, to_bucket(u.pos), u.order,
                                      to_bucket(u.seg_sorted))
        out = out.reshape(*ids.shape, -1)
        keep = (ids >= 0) & (ids < R)      # outside the table: zeros
        return torch.where(keep[..., None], out, torch.zeros(
            (), dtype=out.dtype, device=out.device)).to(table.dtype)


def make_engine(cfg, mesh) -> EmbeddingEngine:
    """The engine for ``mesh`` (None: one device): ``FullMeshEngine`` on a
    data mesh, ``ShardedEmbeddingEngine`` with a model axis."""
    if mesh is None:
        return EmbeddingEngine(cfg)
    from .full_shard import fms_tables
    full = fms_tables(cfg, mesh.size)
    if mesh.model > 1:
        return ShardedEmbeddingEngine(
            cfg, mesh, full, model_split_tables(cfg, mesh.size, mesh.model))
    return FullMeshEngine(cfg, mesh, full)
