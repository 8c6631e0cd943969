"""Embedding engine: the lookups a model makes, behind one object.

Single device, forward only.  The reference engine
(``cikm2020_dmt_tpu/parallel/embedding_shard.py``) routes large tables
through dedup, one-hot or packed-row gathers; those exist for the TPU's
scatter and tiling costs and change no forward value, so here every lookup
is a clamped gather of a logical ``[R, D]`` table.  The ``name`` argument
names the table, as in the reference, for engines that treat tables apart
(row sharding, lazy-Adam overlays).
"""

from __future__ import annotations

import torch

from ..nn.embedding import pooled_from_grid, take_clip


class EmbeddingEngine:
    """Replicated-table engine: plain clamped gathers."""

    def pooled(self, name: str, table: torch.Tensor, ids, wts, lens
               ) -> torch.Tensor:
        """Mean of the present rows: ``[B, L] -> [B, D]``."""
        return pooled_from_grid(take_clip(table, ids), wts, lens)

    def seq(self, name: str, table: torch.Tensor, ids) -> torch.Tensor:
        """Per-position rows, not zero-padded: ``[B, L] -> [B, L, D]``."""
        return take_clip(table, ids)


DENSE_ENGINE = EmbeddingEngine()
