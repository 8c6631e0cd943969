"""Full-mesh tables: rows split over every rank, rows and gradients
exchanged with their owners by ``all_to_all``
(``cikm2020_dmt_tpu/parallel/full_shard.py``, its data-axis path).

A table of ``R`` logical rows updates in groups of ``p`` rows (the lazy
unit, ``train/lazy.py``): there are ``G = ceil(R / p)`` groups, and with
``N`` ranks rank ``k`` owns the groups ``[k * G / N, (k + 1) * G / N)``,
that is the logical rows ``[k * G / N * p, min(R, (k + 1) * G / N * p))``
(``share_rows``), with their [2, rows, D] Adam moments.  Per step:

1. ``collect_fms``: each rank unites its own batch's ids (budget U of the
   local element count), buckets the distinct groups by owner into ``C``
   slots per owner (``owner_layout``, ``capacity``), and one ``all_to_all``
   sends the requests, a second one returns the rows.  When any rank's
   union overflows its budget or a bucket its capacity (one scalar
   ``all_reduce`` and a host read per step: the JAX package's ``lax.cond``
   on the same flag), the rows come by the exact path instead: the unique
   lists are all-gathered, each owner fills its rows in and one
   ``all_reduce`` sums them.
2. The step's grid is the rank's own union grid (``train/lazy.make_overlay``
   without the exact-overflow fallback); its backward is the segment-sum
   kernel on each rank.
3. ``fms_adam_update``: the gradient rows go to their owners by the same
   buckets (two ``all_to_all``), the owner sorts what it received, sums it
   per group in float32 (also for ``fms_grad_bf16``, which sends bfloat16)
   and runs LazyAdam on its groups (``lazy_adam_rows``: the ``update_rows``
   and ``update_rows_3d`` kernels on the card).

With a model axis (m > 1) the model peers of a data row hold the same
batch rows, so the same union: when m divides U, peer j requests and
pushes only the strided slice ``groups[j::m]`` with ``capacity(U / m,
N)`` buckets, and one model-group sum reassembles the ``[U p, D]`` grid;
otherwise every peer fetches the whole union and only peer 0 pushes.

Overflow is the JAX package's: elements past the budget read zeros (no
``lazy_overflow_exact`` fallback), gradients of capacity-dropped groups
are skipped for the step, and both are counted in ``lazy_overflow`` (on
model index 0, whose slice's capacity drop JAX's counter reports).

``lookup_fms`` is the forward half on its own, exact (a budget that holds
every id): the eval engine's lookup of a full-mesh table.
"""

from __future__ import annotations

import os

import torch

from ..core.config import DMTConfig


def splits(cfg: DMTConfig, spec, n_dev: int) -> bool:
    """Whether the lazy table ``spec`` (``train/lazy.LazyTableSpec``)
    splits over ``n_dev`` ranks: ``full_mesh_tables`` on, more than one
    rank, and its G = ceil(R / p) groups at least ``shard_rows_threshold``
    and a multiple of ``n_dev``."""
    G = -(-spec.rows // spec.group)
    return (cfg.full_mesh_tables and n_dev > 1
            and G >= cfg.shard_rows_threshold and G % n_dev == 0)


def fms_tables(cfg: DMTConfig, n_dev: int) -> dict[str, tuple[int, int]]:
    """Table name -> (R logical rows, group size p) of the lazy plan's
    full-mesh tables over ``n_dev`` ranks (``train/lazy.plan_tables``)."""
    from ..train.lazy import plan_tables
    return {s.name: (s.rows, s.group) for s in plan_tables(cfg, n_dev)
            if s.full_mesh}


def fms_table_rows(cfg: DMTConfig, n_dev: int) -> dict[str, int]:
    """Table name -> group count G of each table of ``fms_tables`` (JAX
    ``fms_table_rows``: its physical rows)."""
    return {name: -(-R // p)
            for name, (R, p) in fms_tables(cfg, n_dev).items()}


def share_rows(R: int, p: int, n_dev: int, k: int) -> tuple[int, int]:
    """Logical rows [lo, hi) of rank ``k``'s share of an R-row table."""
    per = -(-R // p) // n_dev * p
    return min(R, k * per), min(R, (k + 1) * per)


def _round8(n: int) -> int:
    return ((n + 7) // 8) * 8


def capacity(U: int, n_dev: int) -> int:
    """Slots of one (requester, owner) bucket: twice the even share plus
    128 for skew, at most U.  ``$DMT_FMS_CAP_MULT`` (default 2.0) sets the
    multiple, as in the JAX package."""
    mult = float(os.environ.get("DMT_FMS_CAP_MULT", "2.0"))
    return min(U, _round8(int(mult * U / n_dev) + 128))


def owner_layout(groups: torch.Tensor, C: int, n_dev: int, per_dev: int,
                 G: int):
    """The ascending distinct ``groups`` [U] bucketed by owner (``per_dev``
    groups each).  Returns (bucketed [n_dev * C] groups, G where a slot
    asks nothing; bslot [U] bucket slot of each group, n_dev * C where it
    has none; src [n_dev * C] the group index each slot holds; valid
    [n_dev * C]; capacity_drop, the groups past their bucket)."""
    dev = groups.device
    U = groups.shape[0]
    bounds = torch.searchsorted(
        groups, torch.arange(n_dev + 1, device=dev) * per_dev)
    counts = bounds[1:] - bounds[:-1]
    j = torch.arange(n_dev * C, device=dev)
    o, r = j // C, j % C
    src = (bounds[o] + r).clamp(max=U - 1)
    valid = r < counts[o].clamp(max=C)
    bucketed = torch.where(valid, groups[src], G)
    o_u = (groups // per_dev).clamp(max=n_dev)
    rank = torch.arange(U, device=dev) - bounds[o_u.clamp(max=n_dev - 1)]
    in_bucket = (o_u < n_dev) & (rank < C)
    bslot = torch.where(in_bucket, o_u.clamp(max=n_dev - 1) * C + rank,
                        n_dev * C)
    capacity_drop = (counts - C).clamp(min=0).sum()
    return bucketed, bslot, src, valid, capacity_drop


def _owned_rows(table: torch.Tensor, rel: torch.Tensor, inb: torch.Tensor,
                p: int) -> torch.Tensor:
    """[n, p, D] rows of the owned groups ``rel`` (local group index),
    zeros where not ``inb`` or past the share's last row."""
    rows_here = table.shape[0]
    lrow = rel.clamp(min=0)[:, None] * p + torch.arange(p,
                                                        device=rel.device)
    keep = inb[:, None] & (lrow < rows_here)
    rows = table.index_select(0, lrow.clamp(max=rows_here - 1).reshape(-1))
    rows = rows.reshape(*lrow.shape, table.shape[1])
    return torch.where(keep[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                          device=rows.device))


def _peer_slice(mesh, U: int):
    """Whether the model peers slice a union of U groups (m > 1 divides
    U)."""
    return mesh.model > 1 and U % mesh.model == 0


def fetch_rows(mesh, table: torch.Tensor, groups: torch.Tensor, bad,
               R: int, p: int):
    """[U * p, D] rows of the distinct ``groups`` [U] from their owners,
    and the step's capacity drop (of this rank's slice, where the model
    peers slice the union).  ``bad`` (this rank's overflow, a 0-d tensor)
    joins the flag that picks the exact path."""
    n_dev, D = mesh.size, table.shape[1]
    U = groups.shape[0]
    G = -(-R // p)
    per = G // n_dev
    M, mi = mesh.model, mesh.model_index
    sliced = _peer_slice(mesh, U)
    mine = groups.view(U // M, M)[:, mi].contiguous() if sliced else groups
    C = capacity(mine.shape[0], n_dev)
    bucketed, bslot, _, _, cap_drop = owner_layout(mine, C, n_dev, per, G)
    my_lo = mesh.rank * per
    flag = (torch.maximum(bad, cap_drop) > 0).to(torch.int32).reshape(1)
    if int(mesh.all_reduce(flag, "max")[0]) == 0:
        req = mesh.all_to_all(bucketed)
        rel = req - my_lo
        inb = (rel >= 0) & (rel < per)
        resp = mesh.all_to_all(_owned_rows(table, rel, inb, p))
        resp = torch.cat([resp, resp.new_zeros((1, p, D))])
        rows = resp.index_select(0, bslot)
        if sliced:
            # the peers' slices into one grid: a model-group sum of rows
            # that one peer each fills (exact in float32)
            grid = torch.zeros((U // M, M, p, D), dtype=torch.float32,
                               device=rows.device)
            grid[:, mi] = rows.float()
            rows = mesh.all_reduce(grid, axis="model").to(table.dtype)
    else:
        # exact: every rank's list served by every owner, summed (one
        # owner per group, the rest zero) in float32
        asked = mesh.all_gather(groups).reshape(-1)
        rel = asked - my_lo
        inb = (rel >= 0) & (rel < per)
        rows = _owned_rows(table, rel, inb, p).float()
        rows = mesh.all_reduce(rows.contiguous())
        rows = rows.reshape(n_dev, U, p, D)[mesh.rank].to(table.dtype)
    return rows.reshape(U * p, D), cap_drop


def collect_fms(spec, batch: dict, table: torch.Tensor, mesh, budget_div: int,
                R: int):
    """The rank's union of its own batch's ids of a full-mesh table
    (``table`` is its share of the R logical rows) with the union's rows
    fetched from their owners; ``overflow`` counts the rank's groups past
    the budget and past their bucket."""
    from ..train.lazy import LazyCollection, budget, site_ids, union
    parts, offsets = site_ids(spec, batch)
    ids = torch.cat(parts).clamp(0, R - 1)
    u = union(ids, R, spec.group, budget(ids.numel(), budget_div))
    rows, cap_drop = fetch_rows(mesh, table, u.groups, u.overflow, R,
                                spec.group)
    return LazyCollection(u.uids, u.pos, rows, offsets, R,
                          u.overflow + cap_drop, u.order, u.seg_sorted, ids)


def lookup_fms(mesh, table: torch.Tensor, ids: torch.Tensor, R: int,
               p: int) -> torch.Tensor:
    """``table[ids]`` (clamped) of a full-mesh table, exact: the rank's
    distinct groups fetched from their owners with a budget that holds
    them all.  [...] -> [..., D]."""
    from ..train.lazy import budget, union
    flat = ids.reshape(-1).long().clamp(0, R - 1)
    u = union(flat, R, p, budget(flat.numel(), 1))
    rows, _ = fetch_rows(mesh, table, u.groups, u.overflow, R, p)
    return rows.index_select(0, u.pos).reshape(*ids.shape, table.shape[1])


def fms_adam_update(mesh, table: torch.Tensor, mv: torch.Tensor, col,
                    g_rows: torch.Tensor, count: torch.Tensor, schedule,
                    p: int, grad_bf16: bool = False):
    """LazyAdam for a full-mesh table: the union's gradient rows [U * p,
    D] go to their owners, and each owner runs one Adam step per group it
    received on the float32 sum of the ranks' gradients, in place in its
    share ``table`` and moments ``mv``.  Model peers hold the same
    gradient rows, so each data row's are sent once: peer j its slice
    ``[j::m]``, or peer 0 all of them where m does not divide U.  Returns
    (table, mv)."""
    from ..train.lazy import lazy_adam_rows
    n_dev, D = mesh.size, table.shape[1]
    U = col.uids.shape[0] // p
    G = -(-col.rows_total // p)
    per = G // n_dev
    M, mi = mesh.model, mesh.model_index
    groups = col.uids.view(U, p)[:, 0] // p
    g3 = g_rows.reshape(U, p, D)
    if _peer_slice(mesh, U):
        groups = groups.view(U // M, M)[:, mi].contiguous()
        g3 = g3.view(U // M, M, p, D)[:, mi]
    C = capacity(groups.shape[0], n_dev)
    bucketed, _, src, valid, _ = owner_layout(groups, C, n_dev, per, G)
    if M > 1 and not _peer_slice(mesh, U) and mi > 0:
        # a copy of peer 0's rows: no requests
        bucketed = torch.full_like(bucketed, G)
        valid = torch.zeros_like(valid)
    g_send = torch.where(valid[:, None, None], g3.index_select(0, src),
                         torch.zeros((), dtype=g3.dtype, device=g3.device))
    if grad_bf16:
        g_send = g_send.to(torch.bfloat16)
    req = mesh.all_to_all(bucketed)
    req_g = mesh.all_to_all(g_send)
    rel = req - mesh.rank * per
    key = torch.where((rel >= 0) & (rel < per), rel, per)
    skey, sidx = torch.sort(key, stable=True)
    first = torch.ones_like(skey, dtype=torch.bool)
    first[1:] = skey[1:] != skey[:-1]
    seg = torch.cumsum(first, 0) - 1
    NC = n_dev * C
    gsum = torch.zeros((NC, p, D), dtype=torch.float32, device=g3.device)
    gsum.index_add_(0, seg, req_g.index_select(0, sidx).float())
    owned = torch.sort(torch.where(first, skey, per))[0]     # [NC] ascending
    rows_here = table.shape[0]
    lrow = owned[:, None] * p + torch.arange(p, device=owned.device)
    real = (owned < per)[:, None] & (lrow < rows_here)
    ids = torch.where(real, lrow, rows_here).reshape(-1)
    rows = table.index_select(0, ids.clamp(max=rows_here - 1))
    return lazy_adam_rows(table, mv, ids, rows, gsum.reshape(NC * p, D),
                          count, schedule)
