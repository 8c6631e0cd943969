"""Embedding tables, pooled lookups and timestamp bucketing.

Tables are logical ``[R, D]`` tensors, one per distinct table name of a
collection (the main and bias-net collections are separate dicts).  The
reference's 128-lane packed storage is a TPU layout: ``unpack_table`` turns
it back into logical rows when a JAX checkpoint is converted.

Semantics follow ``cikm2020_dmt_tpu/nn/embedding.py``:

- lookups clamp out-of-range ids into ``[0, R-1]`` (``mode="clip"``);
- mean pooling divides by the sum of the *present* weights, and a row with
  no present ids pools to zeros; sum pooling (DIN's) does not divide;
- timestamps bucket as ``clip(floor(log2(ts)) + 1, 0, rows - 1)`` with the
  log taken in float32, bucket 0 for ts <= 0.
"""

from __future__ import annotations

import torch

from ..core.config import EmbeddingSpec
from .layers import Params, glorot_uniform


def table_init(gen: torch.Generator, rows: int, dim: int,
               dtype=torch.float32) -> torch.Tensor:
    return glorot_uniform()(gen, (rows, dim), dtype)


def pack_factor(dim: int) -> int:
    """Logical rows per 128-lane physical row in the reference's packed
    table layout."""
    if 0 < dim < 128 and 128 % dim == 0:
        return 128 // dim
    return 1


def unpack_table(packed, rows: int, dim: int):
    """``[ceil(R/p), p*dim]`` packed rows -> logical ``[R, dim]`` (a reshape
    and a slice; works on numpy arrays and tensors alike)."""
    if pack_factor(dim) == 1:
        return packed
    return packed.reshape(-1, dim)[:rows]


def table_dtype(rows: int, bf16_rows_threshold: int, dtype=torch.float32):
    """bf16 storage for tables with at least ``bf16_rows_threshold`` rows
    (``cfg.table_bf16_threshold``; 0 disables)."""
    if 0 < bf16_rows_threshold <= rows:
        return torch.bfloat16
    return dtype


def collection_init(gen: torch.Generator, specs: tuple[EmbeddingSpec, ...],
                    dtype=torch.float32, bf16_rows_threshold: int = 0
                    ) -> Params:
    """One logical table per distinct table name (shared across features)."""
    out: Params = {}
    for spec in specs:
        if spec.table not in out:
            out[spec.table] = table_init(
                gen, spec.id_size, spec.dim,
                table_dtype(spec.id_size, bf16_rows_threshold, dtype))
    return out


def take_clip(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` with ids clamped into range: ``[...] -> [..., D]``."""
    flat = ids.reshape(-1).clamp(0, table.shape[0] - 1)
    return table.index_select(0, flat).reshape(*ids.shape, table.shape[1])


def presence_mask(wts: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """``[B, L]`` float mask of present positions from the length vector."""
    pos = torch.arange(wts.shape[-1], device=wts.device)
    return (pos < lens[..., None]).to(wts.dtype)


def pooled_from_grid(grid: torch.Tensor, wts: torch.Tensor,
                     lens: torch.Tensor, combiner: str = "mean"
                     ) -> torch.Tensor:
    """Weighted pool of an already-gathered grid ``[B, L, D] -> [B, D]``
    over the present ids, computed in the grid's dtype like the reference:
    ``"sum"`` is ``sum_j w_j * E[id_j]``, ``"mean"`` divides that by
    ``sum_j w_j`` and gives zeros where no id is present."""
    w = wts * presence_mask(wts, lens)
    weighted = torch.einsum("bl,bld->bd", w.to(grid.dtype), grid)
    if combiner == "sum":
        return weighted
    denom = w.sum(dim=-1, keepdim=True).to(grid.dtype)
    return torch.where(denom > 0, weighted / denom.clamp(min=1e-12),
                       torch.zeros((), dtype=grid.dtype, device=grid.device))


def ts_bucketize(raw_ts: torch.Tensor, num_buckets: int) -> torch.Tensor:
    """Raw time delta -> log2 bucket in ``[0, num_buckets - 1]``; bucket 0
    is reserved for ts <= 0 and padding."""
    safe = raw_ts.clamp(min=1).to(torch.float32)
    bucket = torch.floor(torch.log2(safe)).to(torch.int32) + 1
    bucket = torch.where(raw_ts <= 0, torch.zeros_like(bucket), bucket)
    return bucket.clamp(0, num_buckets - 1)
