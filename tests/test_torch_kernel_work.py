"""The work counts behind the kernels' bounds, the head widths the
attention kernels take, and the attention backward's plain version at the
head widths its kernel instantiates (CPU; no JAX needed)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from cikm2020_dmt_torch.ops import attention as att  # noqa: E402
from cikm2020_dmt_torch.ops import scatter_rows as sr  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # one H100 SXM (NVIDIA data sheet)


# (ids handed in, rows in range, D, element bytes, bytes): the flagship
# step's two row writes, as chip_smoke.update_phase makes them on the
# 5,000,000-row Sku table (4U = 113,664 grouped rows, 43,127 of them in
# range) and its [2, R, 32] float32 moments (twice as many)
ROW_WRITES = {
    "update_rows": (113_664, 43_127, 32, 2, 6_429_568),
    "update_rows_3d": (227_328, 86_254, 32, 4, 23_899_648),
}


@pytest.mark.parametrize("name", list(ROW_WRITES))
def test_update_rows_bytes_count_every_id(name):
    n_ids, n_written, D, elem, want = ROW_WRITES[name]
    got = sr.update_rows_bytes(n_ids, n_written, D, elem)
    assert got == want
    # the ids are read whether or not their row is written
    assert got - sr.update_rows_bytes(0, n_written, D, elem) == 8 * n_ids
    assert sr.update_rows_bytes(n_ids, 0, D, elem) == 8 * n_ids


@pytest.mark.parametrize("name,bound_us", [("update_rows", 1.919),
                                           ("update_rows_3d", 7.134)])
def test_update_rows_bound(name, bound_us):
    n_ids, n_written, D, elem, _ = ROW_WRITES[name]
    b = sr.update_rows_bytes(n_ids, n_written, D, elem) / HBM_BYTES_PER_S
    assert round(b * 1e6, 3) == bound_us


def _inputs(B, Tq, Tk, D, dtype=torch.float32, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.normal(size=(B, t, D))).to(dtype)
                   for t in (Tq, Tk, Tk, Tq))
    lens = np.arange(B) % (Tk + 1)
    km = torch.from_numpy((np.arange(Tk)[None] < lens[:, None])
                          .astype(np.float32))
    qm = km if Tq == Tk else torch.ones(B, Tq)
    return q, k, v, qm, km, do


# the ids keep the test's names: the last field once said whether the
# wrappers took the head width, and now they take every one
@pytest.mark.parametrize("D,H", [
    pytest.param(64, 1, id="64-1-True"), pytest.param(128, 2, id="128-2-True"),
    pytest.param(80, 1, id="80-1-False"),
    pytest.param(160, 2, id="160-2-False")])
def test_wrapper_takes_heads_up_to_max_dh(D, H):
    """The wrappers take heads of 64 columns (the register tilings) and
    wider (the one-warp-a-row kernels, ``csrc/attention_rows.cuh``), and
    the plain versions they are held to compute softmax attention there:
    per head, against ``scaled_dot_product_attention`` with the masked
    keys' score added, on rows with at least one key."""
    q, k, v, qm, km, do = _inputs(12, 10, 10, D)
    assert att._check("x", q, k, v, qm, km, H, do) == (12, 10, 10, D)
    q, k, v, qm, km = (t.double() for t in (q, k, v, qm, km))
    got = att.fused_attention_ref(q, k, v, qm, km, H)
    split = [t.view(12, 10, H, D // H).transpose(1, 2) for t in (q, k, v)]
    bias = ((1 - km) * att.NEG_INF)[:, None, None, :]
    want = torch.nn.functional.scaled_dot_product_attention(
        *split, attn_mask=bias).transpose(1, 2).reshape(12, 10, D)
    live = km.sum(1) > 0
    torch.testing.assert_close(got[live] * qm[live][..., None],
                               want[live] * qm[live][..., None],
                               rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("Tq,Tk", [(50, 50), (1, 50), (10, 10), (1, 10)])
@pytest.mark.parametrize("H", [10, 4, 2])
def test_backward_plain_version_is_the_gradient(Tq, Tk, H):
    """The backward's plain version (written out, not autograd) against
    autograd through the forward's plain version, in float64, at D=80 in
    10, 4 and 2 heads (dh 8, 20, 40) and key lengths 0..Tk: the function
    each head width of the kernel is held to on the card."""
    q, k, v, qm, km, do = _inputs(11, Tq, Tk, 80, torch.float64, seed=H)
    got = att.fused_attention_bwd_ref(q, k, v, qm, km, do, H)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = att.fused_attention_ref(*leaves, qm, km, H)
    want = torch.autograd.grad(out, leaves, do)
    for a, b in zip(got, want):
        assert a.dtype == torch.float64
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("T,fma_ms,tf32_ms,bf16_ms", [
    (50, 0.8483, 0.3445, 0.0575),
    (10, 0.1664, 0.0676, 0.0113),
])
def test_block_bwd_tensor_core_bound(T, fma_ms, tf32_ms, bf16_ms):
    """The block backward's bounds at B=2048: its operations over the
    float32 FMA peak (67 TFLOP/s), three times its operations over the TF32
    tensor-core peak (the 3xTF32 split, 495 TFLOP/s), and its operations
    over the bfloat16 peak (989 TFLOP/s)."""
    from cikm2020_dmt_torch.ops import block
    ops = block.block_bwd_flops(2048, T, 80, 320)
    assert round(ops / 67e12 * 1e3, 4) == fma_ms
    got = block.block_tc_bound_ms(ops, torch.float32)
    assert round(got, 4) == tf32_ms
    assert got == pytest.approx(3 * ops / 495e12 * 1e3)
    assert round(block.block_tc_bound_ms(ops, torch.bfloat16), 4) == bf16_ms


@pytest.mark.parametrize("B,T,fma_ms,tf32_ms,bf16_ms", [
    (300, 50, 0.0414, 0.0168, 0.0028),
    (300, 10, 0.0081, 0.0033, 0.0006),
    (2048, 50, 0.2828, 0.1148, 0.0192),
    (2048, 10, 0.0555, 0.0225, 0.0038),
])
def test_block_fwd_tensor_core_bound(B, T, fma_ms, tf32_ms, bf16_ms):
    """The block forward's bounds at the serving (B=300) and training
    (B=2048) shapes, as the backward's: over the float32 FMA peak, the
    3xTF32 split over the TF32 tensor-core peak, and the bfloat16 peak."""
    from cikm2020_dmt_torch.ops import block
    ops = block.block_flops(B, T, 80, 320)
    assert round(ops / 67e12 * 1e3, 4) == fma_ms
    assert round(block.block_tc_bound_ms(ops, torch.float32), 4) == tf32_ms
    assert round(block.block_tc_bound_ms(ops, torch.bfloat16), 4) == bf16_ms


# (N, D, num_out, int64 words of the segment sum's scratch): the flagship
# step's Sku union (N = 2048 x 111 sorted rows, 113,665 slots: 888 tiles of
# 256 rows), N not a multiple of the tile, N below one tile, one row
SEGSUM_SCRATCH = [(227_328, 32, 113_665, 888 * 32 + 113_665),
                  (5_001, 40, 801, 20 * 40 + 801),
                  (200, 12, 103, 12 + 103),
                  (1, 32, 7, 32 + 7)]


@pytest.mark.parametrize("N,D,num_out,words", SEGSUM_SCRATCH)
def test_segsum_scratch_holds_the_pieces_and_first_rows(N, D, num_out,
                                                        words):
    """The scratch holds two float32 pieces (head, tail) of D columns for
    every tile of ``SEGSUM_TILE`` sorted rows, two to an int64 word, then
    one int64 first row for every slot."""
    assert sr.SEGSUM_TILE == 256
    assert sr.segsum_scratch_words(N, D, num_out) == words
    tiles = -(-N // sr.SEGSUM_TILE)
    assert 8 * words == 2 * 4 * tiles * D + 8 * num_out


@pytest.mark.parametrize("elem,nbytes,bound_us", [(2, 32_735_360, 9.772),
                                                  (4, 47_284_352, 14.115)])
def test_segsum_bound_counts_each_byte_once(elem, nbytes, bound_us):
    """At the flagship's union: the rows and the int64 order and run
    index read once, the float32 output (every slot, named or not)
    written once; the kernel's scratch is not the function's work."""
    got = sr.segsum_bytes(227_328, 32, elem, 113_665)
    assert got == 227_328 * 32 * elem + 16 * 227_328 + 4 * 113_665 * 32
    assert got == nbytes
    assert round(got / HBM_BYTES_PER_S * 1e6, 3) == bound_us
