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


@pytest.mark.parametrize("D,H,ok", [(64, 1, True), (128, 2, True),
                                    (80, 1, False), (160, 2, False)])
def test_wrapper_takes_heads_up_to_max_dh(D, H, ok):
    """The kernels take heads of at most MAX_DH = 64 columns: wider heads
    raise in the wrappers' check."""
    q, k, v, qm, km, do = _inputs(2, 10, 10, D)
    if ok:
        assert att._check("x", q, k, v, qm, km, H, do) == (2, 10, 10, D)
    else:
        with pytest.raises(ValueError, match="head width"):
            att._check("x", q, k, v, qm, km, H, do)


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
    got = block.block_bwd_tc_bound_ms(2048, T, 80, 320, torch.float32)
    assert round(got, 4) == tf32_ms
    assert round(block.block_bwd_tc_bound_ms(2048, T, 80, 320,
                                             torch.bfloat16), 4) == bf16_ms
    assert got == pytest.approx(3 * ops / 495e12 * 1e3)
