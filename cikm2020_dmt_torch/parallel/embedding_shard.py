"""Embedding engine: the lookups a model makes, behind one object.

The reference engine
(``cikm2020_dmt_tpu/parallel/embedding_shard.py``) routes large tables
through dedup, one-hot or packed-row gathers; those exist for the TPU's
scatter and tiling costs and change no value, so here a lookup is a clamped
gather of a logical ``[R, D]`` table, differentiated by PyTorch's own
autograd (a scatter-add, accumulated in float32 for bfloat16 tables and
rounded once, as the reference's one-hot backward does).

During a training step the trainer sets ``overlay``: table name ->
``train.lazy.LazyOverlay``.  Lookups of an overlaid table then slice the
step's id-union grid at the site of their feature (``overlay_take``),
which keeps that table's gradient row-sparse.  The ``name`` argument names
the table, as in the reference; bias-net tables are namespaced
``bias:<table>``, so no overlay reaches them.

On a data mesh (``make_engine(cfg, mesh)``) a full-mesh table holds only
the rank's share of its rows (``parallel/full_shard.py``): outside a
training step's overlay, ``FullMeshEngine`` looks its rows up from their
owners (``full_shard.lookup_fms``, exact), so every rank must make the
same lookups in the same order.  The model axis (``ShardedEmbeddingEngine``
of the reference) is not ported.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..nn.embedding import pack_factor, pooled_from_grid, take_clip


def take_quant(table: dict, ids: torch.Tensor) -> torch.Tensor:
    """Rows of an int8 table, dequantized after the gather:
    ``q[id] * scale[id // group]`` in float32, ids clamped into range."""
    q, scale = table["q"], table["scale"]
    group = pack_factor(q.shape[1]) if scale.shape[0] != q.shape[0] else 1
    flat = ids.reshape(-1).clamp(0, q.shape[0] - 1)
    rows = (q.index_select(0, flat).to(scale.dtype)
            * scale.index_select(0, flat // group))
    return rows.reshape(*ids.shape, q.shape[1])


class EmbeddingEngine:
    """Replicated-table engine: plain clamped gathers, int8 gathers, or
    the lazy-Adam overlay of the current training step."""

    def __init__(self):
        self.overlay: dict = {}

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
        return take_clip(table, ids)

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

    def __init__(self, mesh, tables: dict):
        super().__init__()
        self.mesh = mesh
        self.tables = tables       # name -> (logical rows R, group size p)

    def _take(self, name: str, table, ids, feature: Optional[str]):
        if name in self.tables and name not in self.overlay:
            from .full_shard import lookup_fms
            R, p = self.tables[name]
            return lookup_fms(self.mesh, table, ids, R, p)
        return super()._take(name, table, ids, feature)


def make_engine(cfg, mesh) -> EmbeddingEngine:
    """The engine for ``mesh`` (None: one device)."""
    if mesh is None:
        return EmbeddingEngine()
    from ..core.mesh import MODEL_AXIS_SLICE
    if mesh.model > 1:
        raise NotImplementedError(f"mesh_model {mesh.model}: "
                                  f"{MODEL_AXIS_SLICE}")
    from .full_shard import fms_tables
    return FullMeshEngine(mesh, fms_tables(cfg, mesh.size))
