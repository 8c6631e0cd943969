"""Row kernels of the lazy-Adam embedding path: the segment sum that is the
backward of the id-union gather, and the in-place row writes of the table
and of its Adam moments.

- ``sorted_segment_sum_rows`` launches ``csrc/sorted_segsum.cu``, which
  replaces ``cikm2020_dmt_tpu/ops/scatter_rows.py`` ``_sorted_segsum_kernel``;
- ``update_rows`` and ``update_rows_3d`` launch ``csrc/update_rows.cu``,
  which replaces ``_update_rows_kernel`` of the same module and
  ``scripts/probe_mv3d_tpu.py`` ``_kernel``;
- ``take_rows_sparse_sorted`` is the union gather whose backward is the
  segment sum, rounded once to the grid's dtype.

Each wrapper takes its plain PyTorch version (``*_ref``) for tensors on the
CPU and launches its kernel for tensors on the card; anything else raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

SEGSUM_KERNEL = "sorted_segsum"
UPDATE_KERNEL = "update_rows"
# sorted rows of a block of csrc/sorted_segsum.cu's first launch (its kTile;
# the launcher refuses any other)
SEGSUM_TILE = 256

_PTR, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64


# g is_bf16 order seg N D num_out out tile scratch scratch_words stream
_SEGSUM_ARGS = (_PTR, _I32, _PTR, _PTR, _I64, _I32, _I64, _PTR, _I32, _PTR,
                _I64, _PTR)
# table R D elem_bytes ids rows n stream
_UPDATE_ARGS = (_PTR, _I64, _I32, _I32, _PTR, _PTR, _I64, _PTR)


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _device(name: str, t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")
    return t.device.type


# ---------------------------------------------------------------------------
# Segment sum of id-sorted rows
# ---------------------------------------------------------------------------


def sorted_segment_sum_rows_ref(g, order, seg_sorted, num_out: int):
    """Plain version: the float32 sum of ``g[order[r]]`` into slot
    ``seg_sorted[r]``, in sorted order; slots no run names are zero."""
    out = torch.zeros((num_out, g.shape[1]), dtype=torch.float32,
                      device=g.device)
    return out.index_add_(0, seg_sorted, g.float().index_select(0, order))


def sorted_segment_sum_rows(g, order, seg_sorted,
                            num_out: int) -> torch.Tensor:
    """``segment_sum(g[order], seg_sorted, num_out)`` in float32.

    g [N, D] float32 or bfloat16 (unsorted), ``order`` [N] the permutation
    that sorts the union by id, ``seg_sorted`` [N] the nondecreasing slot
    of each sorted position, every value below ``num_out`` (the caller's
    guarantee, as for the TPU kernel); slots no position names are zero.
    Returns [num_out, D] float32."""
    if _device("sorted_segment_sum_rows", g) == "cpu":
        return sorted_segment_sum_rows_ref(g, order, seg_sorted, num_out)
    if g.dim() != 2 or g.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"sorted_segment_sum_rows: g {tuple(g.shape)} "
                        f"{g.dtype} (2-D float32 or bfloat16 only)")
    N, D = g.shape
    for name, t in (("order", order), ("seg_sorted", seg_sorted)):
        if t.shape != (N,) or t.dtype != torch.int64 or t.device != g.device:
            raise ValueError(f"sorted_segment_sum_rows: {name} "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}, "
                             f"want ({N},) int64 on {g.device}")
    if num_out < 1:
        raise ValueError(f"sorted_segment_sum_rows: num_out {num_out}")
    dev = g.device
    if N == 0:
        return torch.zeros((num_out, D), dtype=torch.float32, device=dev)
    g = g.contiguous()
    order, seg_sorted = order.contiguous(), seg_sorted.contiguous()
    # the kernel writes every slot, zero or sum
    out = torch.empty((num_out, D), dtype=torch.float32, device=dev)
    words = segsum_scratch_words(N, D, num_out)
    scratch = torch.empty((words,), dtype=torch.int64, device=dev)
    launch = _build.bind(SEGSUM_KERNEL, _SEGSUM_ARGS)
    with torch.cuda.device(dev):
        err = launch(g.data_ptr(), int(g.dtype == torch.bfloat16),
                     order.data_ptr(), seg_sorted.data_ptr(), N, D, num_out,
                     out.data_ptr(), SEGSUM_TILE, scratch.data_ptr(), words,
                     _stream(dev))
    _build.check(SEGSUM_KERNEL, err, f"N={N} D={D} num_out={num_out}")
    sorted_segment_sum_rows.launches += 1
    return out


sorted_segment_sum_rows.launches = 0


def segsum_scratch_words(N: int, D: int, num_out: int) -> int:
    """int64 words of ``csrc/sorted_segsum.cu``'s scratch: the float32
    pieces of the runs cut by tile edges, [2, ceil(N / SEGSUM_TILE), D]
    (two to a word), then the first sorted row of each slot's run,
    [num_out]."""
    return -(-N // SEGSUM_TILE) * D + num_out


# ---------------------------------------------------------------------------
# In-place row writes
# ---------------------------------------------------------------------------


def update_rows_ref(table, ids, rows):
    """Plain version: ``table[ids] = rows`` in place for unique ids, ids
    below 0 or at least len(table) dropped.  Returns ``table``."""
    keep = (ids >= 0) & (ids < table.shape[0])
    table[ids[keep]] = rows[keep].to(table.dtype)
    return table


def _update_kernel(table, ids, rows, name):
    if table.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: dtype {table.dtype} (float32 or bfloat16 "
                        "only)")
    n = ids.shape[0]
    D = table.shape[1]
    if rows.shape != (n, D) or rows.dtype != table.dtype:
        raise ValueError(f"{name}: rows {tuple(rows.shape)} {rows.dtype}, "
                         f"want ({n}, {D}) {table.dtype}")
    if ids.dim() != 1 or ids.dtype != torch.int64:
        raise ValueError(f"{name}: ids {tuple(ids.shape)} {ids.dtype}, want "
                         "1-D int64")
    if not table.is_contiguous():
        raise ValueError(f"{name}: the table must be contiguous (it is "
                         "written in place)")
    for t in (ids, rows):
        if t.device != table.device:
            raise ValueError(f"{name}: operand on {t.device}, table on "
                             f"{table.device}")
    dev = table.device
    ids, rows = ids.contiguous(), rows.contiguous()
    launch = _build.bind(UPDATE_KERNEL, _UPDATE_ARGS)
    with torch.cuda.device(dev):
        err = launch(table.data_ptr(), table.shape[0], D,
                              table.element_size(), ids.data_ptr(),
                              rows.data_ptr(), n, _stream(dev))
    _build.check(UPDATE_KERNEL, err, f"R={table.shape[0]} D={D} n={n}")


def update_rows(table, ids, rows) -> torch.Tensor:
    """``table[ids] = rows`` in place for unique ids (a table [R, D] of
    float32 or bfloat16); ids below 0 or at least R are dropped.  Returns
    ``table``."""
    if _device("update_rows", table) == "cpu":
        return update_rows_ref(table, ids, rows)
    if table.dim() != 2:
        raise ValueError(f"update_rows: table {tuple(table.shape)}, want "
                         "[R, D]")
    _update_kernel(table, ids, rows, "update_rows")
    update_rows.launches += 1
    return table


update_rows.launches = 0


def update_rows_3d_ref(mv, ids, rows):
    """Plain version of ``update_rows_3d``."""
    update_rows_ref(mv.view(-1, mv.shape[-1]), ids, rows)
    return mv


def update_rows_3d(mv, ids, rows) -> torch.Tensor:
    """Row write into a stacked [2, R, D] moment tensor, in place: flat ids
    in [0, 2R) name row ``id % R`` of slice ``id // R``; ids below 0 or at
    least 2R are dropped.  The same kernel as ``update_rows``, launched on
    the free [2R, D] view.  Returns ``mv``."""
    if _device("update_rows_3d", mv) == "cpu":
        return update_rows_3d_ref(mv, ids, rows)
    if mv.dim() != 3 or mv.shape[0] != 2 or not mv.is_contiguous():
        raise ValueError(f"update_rows_3d: mv {tuple(mv.shape)}, want a "
                         "contiguous [2, R, D]")
    _update_kernel(mv.view(-1, mv.shape[-1]), ids, rows, "update_rows_3d")
    update_rows_3d.launches += 1
    return mv


update_rows_3d.launches = 0


# ---------------------------------------------------------------------------
# Union gather with the segment-sum backward
# ---------------------------------------------------------------------------


class _TakeRowsSparseSorted(torch.autograd.Function):

    @staticmethod
    def forward(ctx, rows_ext, pos, order, seg_sorted):
        ctx.save_for_backward(order, seg_sorted)
        ctx.num_slots = rows_ext.shape[0]
        return rows_ext.index_select(0, pos.clamp(0, rows_ext.shape[0] - 1))

    @staticmethod
    def backward(ctx, g):
        order, seg_sorted = ctx.saved_tensors
        gf = g.reshape(-1, g.shape[-1])
        g_rows = sorted_segment_sum_rows(gf, order, seg_sorted,
                                         ctx.num_slots)
        return g_rows.to(g.dtype), None, None, None


def take_rows_sparse_sorted(rows_ext, pos, order, seg_sorted):
    """``rows_ext[pos]`` (clamped) whose backward is one segment sum into
    the [len(rows_ext), D] cotangent, accumulated in float32 and rounded
    once to the grid's dtype (``cikm2020_dmt_tpu/ops/scatter_rows.py``
    ``take_rows_sparse_sorted``).  ``order`` sorts the N elements by id and
    ``seg_sorted`` is the nondecreasing slot of each sorted element, with
    ``pos[order[r]] == seg_sorted[r]``."""
    return _TakeRowsSparseSorted.apply(rows_ext, pos, order, seg_sorted)


# ---------------------------------------------------------------------------
# Work of one launch, for the bound
# ---------------------------------------------------------------------------


def segsum_bytes(N: int, D: int, elem: int, num_out: int) -> int:
    """The rows (``elem`` bytes each), int64 order and run index read once,
    the float32 output written once."""
    return N * D * elem + 2 * 8 * N + 4 * num_out * D


def update_rows_bytes(n_ids: int, n_written: int, D: int, elem: int) -> int:
    """Every int64 id handed in read once (the kernel reads each to drop
    the out-of-range ones), the ``n_written`` rows in range read once and
    written once."""
    return 8 * n_ids + 2 * n_written * D * elem
