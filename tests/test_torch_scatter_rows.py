"""The port's row kernels' plain versions (``ops/scatter_rows.py``) and the
lazy-Adam index structures (``train/lazy.py``) against the JAX package:
the Pallas kernels in interpret mode, the reference's gather with its
segment-sum backward, and ``collect``.  The CUDA kernels are held against
the same plain versions on the card by ``chip_smoke.py`` and
``tests/test_torch_cuda.py``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import __graft_entry__ as g  # noqa: E402
from cikm2020_dmt_tpu.ops import scatter_rows as jsr  # noqa: E402
from cikm2020_dmt_tpu.train import lazy as jlazy  # noqa: E402
from cikm2020_dmt_torch.ops import scatter_rows as sr  # noqa: E402
from cikm2020_dmt_torch.train import lazy  # noqa: E402


def _runs(rng, lengths):
    """A dense nondecreasing run index with runs of the given lengths."""
    return np.repeat(np.arange(len(lengths)), lengths).astype(np.int64)


def test_segsum_matches_pallas_kernel():
    """D=128 float32, runs that straddle the TPU kernel's 256-row chunks,
    slots that no run names (num_out past the last run)."""
    rng = np.random.default_rng(0)
    seg = _runs(rng, [1, 300, 5, 700, 2, 1, 40, 255, 257, 3])
    N = seg.size
    num_out = int(seg[-1]) + 6
    g_sorted = rng.normal(size=(N, 128)).astype(np.float32)
    want = jsr.sorted_segment_sum_rows(jnp.asarray(g_sorted),
                                       jnp.asarray(seg.astype(np.int32)),
                                       num_out, interpret=True)
    order = rng.permutation(N)
    g_unsorted = np.empty_like(g_sorted)
    g_unsorted[order] = g_sorted
    got = sr.sorted_segment_sum_rows(torch.from_numpy(g_unsorted),
                                     torch.from_numpy(order),
                                     torch.from_numpy(seg), num_out)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)
    assert (got[int(seg[-1]) + 1:] == 0).all()


def test_segsum_bf16_matches_index_add():
    """D=32 bfloat16 rows: float32 accumulation, as a direct index_add_ of
    the float32 rows by each element's slot."""
    rng = np.random.default_rng(1)
    ids = np.minimum(rng.zipf(1.3, 5000), 700).astype(np.int64)
    s = np.sort(ids, kind="stable")
    order = np.argsort(ids, kind="stable")
    seg = np.cumsum(np.r_[True, s[1:] != s[:-1]]) - 1
    pos = np.empty_like(seg)
    pos[order] = seg
    gb = torch.from_numpy(rng.normal(size=(5000, 32)).astype(np.float32)
                          ).to(torch.bfloat16)
    got = sr.sorted_segment_sum_rows(gb, torch.from_numpy(order),
                                     torch.from_numpy(seg), int(seg[-1]) + 3)
    want = torch.zeros(int(seg[-1]) + 3, 32).index_add_(
        0, torch.from_numpy(pos), gb.float())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


def test_update_rows_matches_pallas_kernel():
    """D=128 float32 against the TPU kernel (interpret mode), in place;
    the sentinel tail (ids >= R) is dropped."""
    rng = np.random.default_rng(2)
    R, n = 1000, 300
    table = rng.normal(size=(R, 128)).astype(np.float32)
    ids = rng.permutation(R)[:n].astype(np.int64)
    ids[-20:] = R + np.arange(20)
    rows = rng.normal(size=(n, 128)).astype(np.float32)
    want = jsr.update_rows(jnp.asarray(table), jnp.asarray(ids, jnp.int32),
                           jnp.asarray(rows), interpret=True)
    t = torch.from_numpy(table.copy())
    out = sr.update_rows(t, torch.from_numpy(ids), torch.from_numpy(rows))
    assert out.data_ptr() == t.data_ptr()
    np.testing.assert_array_equal(t.numpy(), np.asarray(want))


@pytest.mark.parametrize("stacked", [False, True])
def test_update_rows_bf16_sentinels_and_negative_ids(stacked):
    """D=32 bfloat16 (``update_rows``) and the stacked [2, R, D] float32
    moments (``update_rows_3d``) against jnp ``.at[ids].set(mode="drop")``
    on the flat view: ids at least the row count are dropped, and so are
    negative ids, as the TPU kernel drops them (jnp would wrap them)."""
    rng = np.random.default_rng(3)
    R, D, n = 500, 32, 120
    R_all = 2 * R if stacked else R
    ids = rng.permutation(R_all)[:n].astype(np.int64)
    ids[:10] = R_all + np.arange(10)
    ids[10:15] = -1 - np.arange(5)
    flat = rng.normal(size=(R_all, D)).astype(np.float32)
    rows = rng.normal(size=(n, D)).astype(np.float32)
    jids = np.where(ids < 0, R_all, ids)
    if stacked:
        want = jnp.asarray(flat).at[jids].set(rows, mode="drop")
        mv = torch.from_numpy(flat.copy()).view(2, R, D)
        sr.update_rows_3d(mv, torch.from_numpy(ids), torch.from_numpy(rows))
        np.testing.assert_array_equal(mv.reshape(-1, D).numpy(),
                                      np.asarray(want))
    else:
        tb = torch.from_numpy(flat).to(torch.bfloat16)
        rb = torch.from_numpy(rows).to(torch.bfloat16)
        want = jnp.asarray(tb.float().numpy(), jnp.bfloat16).at[jids].set(
            jnp.asarray(rb.float().numpy(), jnp.bfloat16), mode="drop")
        sr.update_rows(tb, torch.from_numpy(ids), rb)
        np.testing.assert_array_equal(tb.float().numpy(),
                                      np.asarray(want, np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_take_rows_sparse_sorted_gradient_matches_jax(dtype):
    """Forward gather and segment-sum backward, rounded once to the grid
    type, against the reference's custom VJP."""
    rng = np.random.default_rng(4)
    N, U, D = 900, 60, 32
    ids = np.minimum(rng.zipf(1.2, N), 200).astype(np.int64)
    s = np.sort(ids, kind="stable")
    order = np.argsort(ids, kind="stable")
    seg = np.minimum(np.cumsum(np.r_[True, s[1:] != s[:-1]]) - 1, U)
    pos = np.empty_like(seg)
    pos[order] = seg
    rows = rng.normal(size=(U + 1, D)).astype(np.float32)
    cot = rng.normal(size=(N, D)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    i32 = [jnp.asarray(a.astype(np.int32)) for a in (pos, order, seg)]
    out, vjp = jax.vjp(lambda r: jsr.take_rows_sparse_sorted(r, *i32),
                       jnp.asarray(rows, jdt))
    (want,) = vjp(jnp.asarray(cot, jdt))
    r = torch.from_numpy(rows).to(tdt).requires_grad_()
    got = sr.take_rows_sparse_sorted(r, torch.from_numpy(pos),
                                     torch.from_numpy(order),
                                     torch.from_numpy(seg))
    np.testing.assert_array_equal(got.detach().float().numpy(),
                                  np.asarray(out, np.float32))
    got.backward(torch.from_numpy(cot).to(tdt))
    assert r.grad.dtype == tdt
    tol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(r.grad.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("budget_div", [8, 64])
def test_collect_matches_jax(budget_div):
    """The id union of the Sku table over a synthetic batch: unique ids
    with the sentinel tail, each element's slot, the overflow count, the
    sorted run index and the gathered rows, against the reference's
    ``collect`` on a logical (unpacked) table."""
    cfg = g._demo_config(sku_rows=4096)
    batch = g.synthetic_batch(cfg, 64, seed=5)
    fields = tuple((s.feature, s.id_size) for s in cfg.embeddings
                   if s.table == "Sku")
    table = np.random.default_rng(6).normal(size=(4096, 32)
                                            ).astype(np.float32)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want = jlazy.collect(jlazy.LazyTableSpec("Sku", fields, 1, 32), jb,
                         jnp.asarray(table), budget_div)
    got = lazy.collect(lazy.LazyTableSpec("Sku", fields, 32),
                       {k: torch.from_numpy(v) for k, v in batch.items()},
                       torch.from_numpy(table), budget_div)
    np.testing.assert_array_equal(got.uids.numpy(), np.asarray(want.uids))
    np.testing.assert_array_equal(got.pos.numpy(), np.asarray(want.pos))
    np.testing.assert_array_equal(got.seg_sorted.numpy(),
                                  np.asarray(want.seg_sorted))
    np.testing.assert_array_equal(got.rows.numpy(), np.asarray(want.rows))
    assert int(got.overflow) == int(want.overflow)
    assert (int(got.overflow) > 0) == (budget_div == 64)
    for feature, _ in fields:
        assert got.offsets[feature] == want.offsets[id(jb[feature + "__ids"])]


@pytest.mark.parametrize("budget_div", [8, 64])
def test_grouped_collect_matches_jax(budget_div):
    """A table the reference stores packed (4 rows of 32 per 128 lanes):
    the reference's union is one of packed rows; the port's lists the same
    groups as logical rows (group g -> rows 4g..4g+3), and each element's
    slot is its group's slot times 4 plus its row within the group."""
    cfg = g._demo_config(sku_rows=4096)
    batch = g.synthetic_batch(cfg, 64, seed=5)
    fields = tuple((s.feature, s.id_size) for s in cfg.embeddings
                   if s.table == "Sku")
    table = np.random.default_rng(6).normal(size=(4096, 32)
                                            ).astype(np.float32)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want = jlazy.collect(jlazy.LazyTableSpec("Sku", fields, 4, 32), jb,
                         jnp.asarray(table.reshape(-1, 128)), budget_div)
    got = lazy.collect(lazy.LazyTableSpec("Sku", fields, 32, group=4),
                       {k: torch.from_numpy(v) for k, v in batch.items()},
                       torch.from_numpy(table), budget_div)
    wu = np.asarray(want.uids).astype(np.int64)
    U = wu.shape[0]
    np.testing.assert_array_equal(
        got.uids.numpy(), (wu[:, None] * 4 + np.arange(4)).ravel())
    ids = np.clip(np.concatenate([batch[f + "__ids"].reshape(-1)
                                  for f, _ in fields]), 0, 4095)
    wpos = np.asarray(want.pos)
    np.testing.assert_array_equal(
        got.pos.numpy(), np.where(wpos < U, wpos * 4 + ids % 4, U * 4))
    real = wu < 1024
    np.testing.assert_array_equal(
        got.rows.numpy().reshape(U, 128)[real], np.asarray(want.rows)[real])
    assert int(got.overflow) == int(want.overflow)
    assert (int(got.overflow) > 0) == (budget_div == 64)
    seg = got.seg_sorted.numpy()
    assert (np.diff(seg) >= 0).all()
    np.testing.assert_array_equal(seg, got.pos.numpy()[got.order.numpy()])
