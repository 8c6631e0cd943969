"""Lazy (row-sparse) Adam for the large embedding tables
(``cikm2020_dmt_tpu/train/lazy.py``), single device.

Per step and per planned table:

1. ``collect``, before the loss: the batch's id union over every feature
   of the table is sorted once (``torch.sort``, stable).  Ids fall into
   groups of ``spec.group`` consecutive rows; the run index of the sorted
   groups is each distinct group's slot, the distinct groups are compacted
   into a budget of U slots (the unused tail filled with distinct
   out-of-range sentinels), ``uids`` lists the U * group rows of those
   slots, ``pos`` carries each element's row slot back to batch order, and
   groups past the budget map to the overflow slot and are counted.
2. The loss differentiates ``rows = table[uids]``: ``make_overlay``
   gathers the whole union in one ``take_rows_sparse_sorted`` whose
   backward is one segment sum (the CUDA kernel on the card), and each
   lookup slices its feature's range out of that grid (``overlay_take``,
   keyed by feature name).  Under overflow the forward stays exact: the
   missed elements read their true table rows (``lazy_overflow_exact``).
3. ``lazy_adam_rows`` runs Adam on the [U * group, D] block and writes the
   rows of the table and of the [2, R, D] moments back in place
   (``update_rows`` and ``update_rows_3d``, CUDA kernels on the card);
   sentinel, padding and overflow slots are dropped.

Semantics are LazyAdam: rows a step does not touch keep stale moments.
Tables are logical [R, D] rows here, but the unit of a lazy update is the
reference's: where the reference stores a table 128-lane packed
(``packed_tables``, at least ``pack_rows_threshold`` rows), one packed row
of 128 // D logical rows is one lazy-Adam row, so a logical row that
shares a packed row with a touched one has its moments decayed and its
value moved with it.  ``spec.group`` is that pack factor (1 otherwise).

Under a data mesh (``core/mesh.py``) each rank holds a slice of the global
batch.  A table the plan marks ``full_mesh`` splits its rows over the ranks
and exchanges rows and gradients with their owners
(``parallel/full_shard.py``).  Every other lazy table takes the JAX
package's global union: ``collect`` gathers the ids of every data shard
(over the data group: model peers hold the same rows), unites them, and
slices this rank's elements back out by its data index, so the gradient
rows summed over the ranks update the same rows on every rank.

With a model axis a lazy table that is not full-mesh but that
``embedding_shard.model_split_tables`` splits is ``sharded``: its rows and
moments split over the model group.  ``collect`` fetches the union's rows
once through ``shard_take_rows`` (a model-group sum), the exact-overflow
fallback reads the missed rows the same way (only on a step that
overflows: one host read), and ``lazy_adam_rows_sharded`` runs the row
math on the whole union on every peer and writes back only the rows the
rank holds, with no collective.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable

import torch

from ..core.config import DMTConfig
from ..data.pipeline import IDS
from ..ops.adam import B1, B2, EPS
from ..ops.scatter_rows import (take_rows_sparse_sorted, update_rows,
                                update_rows_3d)


@dataclass(frozen=True)
class LazyTableSpec:
    """Static plan for one lazily updated table."""
    name: str                             # params["emb"] key
    fields: tuple[tuple[str, int], ...]   # (feature, id_size)
    dim: int
    group: int = 1                        # rows updated together
    full_mesh: bool = False               # rows split over every rank
    sharded: bool = False                 # rows split over the model group

    @property
    def rows(self) -> int:
        """R: the table's logical rows (its largest feature's id_size)."""
        return max(size for _, size in self.fields)


@dataclass
class LazyCollection:
    """Per-step index structures, computed before the loss."""
    uids: torch.Tensor        # [U * group] ascending rows, >= R: dropped
    pos: torch.Tensor         # [N] row slot of each element (overflow: last)
    rows: torch.Tensor        # [U * group, D] gathered rows, before update
    offsets: dict             # feature -> (offset, numel) in the union
    rows_total: int           # R
    overflow: torch.Tensor    # distinct groups past the budget
    order: torch.Tensor       # [N] union index of each sorted position
    seg_sorted: torch.Tensor  # [N] slot of each sorted position
    ids: torch.Tensor         # [N] clamped ids in union order


@dataclass
class LazyOverlay:
    """What the engine consults per lookup: the union grid and its sites."""
    grid: torch.Tensor        # [N, D], differentiable
    offsets: dict             # feature -> (offset, numel)


def build_lazy_plan(cfg: DMTConfig, mesh=None) -> tuple[LazyTableSpec, ...]:
    """Tables under lazy Adam: the flag on, Adam, no dense weight decay,
    at least ``dedup_rows_threshold`` rows, and no timestamp feature (those
    ids are re-bucketed inside the model).  On a mesh, the tables that
    ``full_shard.splits`` over its ranks are ``full_mesh``; of the rest,
    those split over its model axis are ``sharded``, the others
    replicated."""
    if mesh is None:
        return plan_tables(cfg, 1)
    return plan_tables(cfg, mesh.size, mesh.model)


def plan_tables(cfg: DMTConfig, n_dev: int,
                model: int = 1) -> tuple[LazyTableSpec, ...]:
    """``build_lazy_plan`` over ``n_dev`` ranks, ``model`` of them on the
    model axis."""
    if not (cfg.lazy_adam and cfg.optimizer.lower() == "adam"
            and cfg.wnd_wd <= 1e-5):
        return ()
    from ..parallel.embedding_shard import model_split_tables, table_group
    from ..parallel.full_shard import splits
    ts_feats = frozenset(cfg.attention_ts)
    by_table: dict[str, list] = {}
    for spec in cfg.embeddings:
        by_table.setdefault(spec.table, []).append(spec)
    specs = tuple(
        LazyTableSpec(name, tuple((s.feature, s.id_size) for s in specs),
                      specs[0].dim,
                      table_group(cfg, specs[0].id_size, specs[0].dim))
        for name, specs in by_table.items()
        if max(s.id_size for s in specs) >= cfg.dedup_rows_threshold
        and not any(s.feature in ts_feats for s in specs))
    split = model_split_tables(cfg, n_dev, model)
    return tuple(replace(s, full_mesh=splits(cfg, s, n_dev),
                         sharded=s.name in split) for s in specs)


def budget(n: int, budget_div: int) -> int:
    """U = round8(max(256, n // budget_div))."""
    return ((max(256, n // max(1, budget_div)) + 7) // 8) * 8


def site_ids(spec: LazyTableSpec, batch: dict) -> tuple[list, dict]:
    """The flat int64 ids of each feature of the table, and each feature's
    (offset, numel) in their concatenation."""
    parts, offsets, off = [], {}, 0
    for feature, _ in spec.fields:
        flat = batch[feature + IDS].reshape(-1).long()
        offsets[feature] = (off, flat.numel())
        off += flat.numel()
        parts.append(flat)
    return parts, offsets


@dataclass
class Union:
    """The sorted, budgeted id union of one table (``union``)."""
    groups: torch.Tensor      # [U] ascending distinct groups, sentinels >= G
    uids: torch.Tensor        # [U * group] their rows
    pos: torch.Tensor         # [N] row slot of each element (overflow: last)
    order: torch.Tensor       # [N] element of each sorted position
    seg_sorted: torch.Tensor  # [N] slot of each sorted position
    overflow: torch.Tensor    # distinct groups past the budget


def union(ids: torch.Tensor, R: int, p: int, U: int) -> Union:
    """The union of ``ids`` (clamped into [0, R)) in groups of ``p`` rows,
    compacted into ``U`` group slots; the unused tail holds the distinct
    out-of-range sentinels G, G + 1, ... (G = ceil(R / p))."""
    n = ids.numel()
    s, order = torch.sort(ids, stable=True)
    grp = s // p
    first = torch.ones_like(s, dtype=torch.bool)
    first[1:] = grp[1:] != grp[:-1]
    seg = torch.cumsum(first, 0) - 1
    # distinct groups ascend: sorting first-of-run groups among sentinels
    # puts exactly the distinct groups first
    G = -(-R // p)
    compact = torch.sort(torch.where(first, grp, torch.full_like(grp, G)))[0]
    ug = torch.full((U,), G, dtype=torch.int64, device=ids.device)
    ug[:min(U, n)] = compact[:U]
    ug = torch.where(ug >= G, G + torch.arange(U, device=ids.device), ug)
    uids = (ug[:, None] * p + torch.arange(p, device=ids.device)).reshape(-1)
    seg_sorted = torch.where(seg < U, seg * p + s % p,
                             torch.full_like(seg, U * p))
    pos = torch.empty_like(seg_sorted).scatter_(0, order, seg_sorted)
    overflow = (first.sum() - U).clamp(min=0)
    return Union(ug, uids, pos, order, seg_sorted, overflow)


def collect(spec: LazyTableSpec, batch: dict, table: torch.Tensor,
            budget_div: int, mesh=None) -> LazyCollection:
    """The table's union over the batch, its rows gathered.  With ``mesh``
    (a replicated or sharded table on a mesh) the union is the global
    batch's: every data shard's ids are gathered and united (the budget is
    the global one, as in the JAX package), and the collection keeps this
    rank's elements, sorted by slot.  A sharded table (``table`` this
    rank's share) fetches the union's rows over the model group."""
    R = spec.rows if spec.sharded else table.shape[0]
    p = spec.group
    parts, offsets = site_ids(spec, batch)
    local = torch.cat(parts).clamp(0, R - 1)
    if mesh is None:
        u = union(local, R, p, budget(local.numel(), budget_div))
        pos, order, seg_sorted = u.pos, u.order, u.seg_sorted
    else:
        # the union (and its budget) does not depend on the ids' order
        n = local.numel()
        ids = mesh.all_gather(local, axis="data").reshape(-1)
        u = union(ids, R, p, budget(ids.numel(), budget_div))
        d = mesh.data_index
        pos = u.pos[d * n:(d + 1) * n]
        order = torch.sort(pos, stable=True)[1]
        seg_sorted = pos[order]
    if spec.sharded:
        from ..parallel.embedding_shard import shard_take_rows
        rows = shard_take_rows(mesh, table, u.uids, R, p)
    else:
        rows = table.index_select(0, u.uids.clamp(max=R - 1))
    return LazyCollection(u.uids, pos, rows, offsets, R, u.overflow, order,
                          seg_sorted, local)


def make_overlay(col: LazyCollection, rows_diff: torch.Tensor,
                 table: torch.Tensor = None, shard=None) -> LazyOverlay:
    """The union grid, inside the differentiated function: ``rows_diff``
    is the diff leaf (bfloat16 rows of a float32 table under
    ``grid_bf16``; the grid keeps its type).  With ``table``
    (cfg.lazy_overflow_exact) elements past the budget read their true
    rows, rounded to the grid's type (no gradient), instead of the zero
    row; the gather runs every step, which costs one [N, D] pass and keeps
    the step free of host synchronisation.  For a sharded table (``shard``
    = (mesh, R, p), ``table`` this rank's share) the rows come through
    ``shard_take_rows``, on a step whose union overflows only (the same
    count on every rank: one host read)."""
    rows_ext = torch.cat([rows_diff, rows_diff.new_zeros(
        (1, rows_diff.shape[1]))])
    grid = take_rows_sparse_sorted(rows_ext, col.pos, col.order,
                                   col.seg_sorted)
    if table is not None and (shard is None or int(col.overflow) > 0):
        miss = (col.pos >= rows_diff.shape[0])[:, None]
        if shard is None:
            fallback = table.detach().index_select(0, col.ids)
        else:
            from ..parallel.embedding_shard import shard_take_rows
            fallback = shard_take_rows(shard[0], table.detach(), col.ids,
                                       *shard[1:])
        grid = torch.where(miss, fallback.to(grid.dtype), grid)
    return LazyOverlay(grid, col.offsets)


def overlay_take(ov: LazyOverlay, feature: str, ids) -> torch.Tensor:
    """A lookup through the overlay: this feature's slice of the grid."""
    site = ov.offsets.get(feature)
    if site is None or site[1] != ids.numel():
        raise RuntimeError(
            f"lazy-Adam overlay: feature {feature!r} is not a site this "
            "step collected; exclude its table from lazy Adam or look it up "
            "by its feature name")
    off, numel = site
    return ov.grid[off:off + numel].reshape(*ids.shape, ov.grid.shape[-1])


def _adam_rows_math(rows, g_rows, mvu, count, lr, dtype):
    """LazyAdam's row math on a [U, D] block: (p_new in ``dtype``, m_new,
    v_new) from the rows, their gradient and their [2, U, D] moments."""
    g32 = g_rows.float()
    m_new = B1 * mvu[0] + (1.0 - B1) * g32
    v_new = B2 * mvu[1] + (1.0 - B2) * (g32 * g32)
    c = count.float()
    mhat = m_new / (1.0 - torch.pow(torch.tensor(B1, device=c.device), c))
    vhat = v_new / (1.0 - torch.pow(torch.tensor(B2, device=c.device), c))
    p_new = (rows.float() - lr * mhat / (torch.sqrt(vhat) + EPS)).to(dtype)
    return p_new, m_new, v_new


def _write_back(table, mv, tgt, keep, p_new, m_new, v_new):
    """Rows ``tgt`` where ``keep`` of the table and of both moment slices,
    in place; the others dropped (a moment id outside [0, 2R))."""
    R, U = table.shape[0], tgt.shape[0]
    update_rows(table, torch.where(keep, tgt, R), p_new)
    ids2 = torch.cat([torch.where(keep, tgt, 2 * R),
                      torch.where(keep, tgt + R, 2 * R)])
    update_rows_3d(mv, ids2, torch.cat([m_new, v_new]).reshape(2 * U, -1))


def lazy_adam_rows(table: torch.Tensor, mv: torch.Tensor,
                   uids: torch.Tensor, rows: torch.Tensor,
                   g_rows: torch.Tensor, count: torch.Tensor,
                   schedule: Callable):
    """One LazyAdam step on the touched rows, written in place into
    ``table`` [R, D] and ``mv`` [2, R, D] (float32 m and v).  ``count`` is
    the post-increment update number: lr = schedule(count - 1), bias
    correction by ``count``, one rounding to the table's type.  Returns
    (table, mv)."""
    R = table.shape[0]
    mvu = mv.index_select(1, uids.clamp(max=R - 1))
    p_new, m_new, v_new = _adam_rows_math(rows, g_rows, mvu, count,
                                          schedule(count - 1), table.dtype)
    _write_back(table, mv, uids, uids < R, p_new, m_new, v_new)
    return table, mv


def lazy_adam_rows_sharded(mesh, table: torch.Tensor, mv: torch.Tensor,
                           uids: torch.Tensor, rows: torch.Tensor,
                           g_rows: torch.Tensor, count: torch.Tensor,
                           schedule: Callable, R: int, p: int):
    """``lazy_adam_rows`` for a table split over the model group (``table``
    and ``mv`` this rank's share of R logical rows in groups of ``p``): the
    row math on the whole union, the same on every peer, then only the
    rows this rank holds written back; no collective.  Returns (table,
    mv)."""
    from ..parallel.embedding_shard import shard_lo
    n_here = table.shape[0]
    rel = uids - shard_lo(mesh, R, p)
    keep = (uids < R) & (rel >= 0) & (rel < n_here)
    safe = torch.where(keep, rel, 0)
    p_new, m_new, v_new = _adam_rows_math(
        rows, g_rows, mv.index_select(1, safe), count, schedule(count - 1),
        table.dtype)
    _write_back(table, mv, safe, keep, p_new, m_new, v_new)
    return table, mv
