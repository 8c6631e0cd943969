"""The CUDA kernels against their plain PyTorch versions on the card.

These tests need a CUDA card and skip without one; run them on the H100
with ``python -m pytest -m cuda tests/test_torch_cuda.py``.  They import
only PyTorch and the port, so they run where JAX is not installed."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from cikm2020_dmt_torch.core.config import TransformerConfig  # noqa: E402
from cikm2020_dmt_torch.nn.transformer import transformer_init  # noqa: E402
from cikm2020_dmt_torch.ops import block  # noqa: E402


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run `python -m pytest -m cuda "
                    "tests/test_torch_cuda.py` on the H100")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("T_", [10, 50])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_version_on_card(T_, dtype, cuda_device):
    """The CUDA kernel against the plain version on the card, lens 0..T."""
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    p = transformer_init(gen, TransformerConfig(maxlen_k=T_))
    B = 301
    enc = torch.randn(B, T_, 80, generator=gen, device=cuda_device).to(dt)
    dec = torch.randn(B, 80, generator=gen, device=cuda_device).to(dt)
    lens = torch.arange(B, device=cuda_device) % (T_ + 1)
    mask = (torch.arange(T_, device=cuda_device)[None] < lens[:, None]
            ).float()
    kw = dict(enc_in=enc, dec_in=dec, seq_mask=mask, num_heads=4)
    got = block.fused_encode_decode(p["enc"][0], p["dec"][0], **kw)
    want = block.fused_encode_decode_ref(p["enc"][0], p["dec"][0], **kw)
    torch.cuda.synchronize()
    tol = 1e-4 if dt == torch.float32 else 3e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def _block_case(T_, dt, dev, B=301, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    p = transformer_init(gen, TransformerConfig(maxlen_k=T_))
    enc = torch.randn(B, T_, 80, generator=gen, device=dev).to(dt)
    dec = torch.randn(B, 80, generator=gen, device=dev).to(dt)
    lens = torch.arange(B, device=dev) % (T_ + 1)
    mask = (torch.arange(T_, device=dev)[None] < lens[:, None]).float()
    seed_t = torch.tensor([12345], dtype=torch.int32, device=dev)
    kw = dict(enc_in=enc, dec_in=dec, seq_mask=mask, num_heads=4,
              train=True, rate=0.1, seed=seed_t)
    return p, kw


def _rel_err(got, want):
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp(min=1e-30))


def _norm_err(got, want):
    return float((got.float() - want.float()).norm()
                 / want.float().norm().clamp(min=1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("T_", [10, 50])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_forward_and_backward_match_plain_on_card(T_, dtype,
                                                        cuda_device):
    """Dropout on (rate 0.1): the forward kernel and the backward kernel
    against their plain versions on the same masks.  The forward's error is
    relative to its largest |value|: float32 differs only in the order of
    sums; bfloat16 may flip the rounding of an operand.  The backward's is
    norm-wise per output: besides the sum order, a ReLU whose
    pre-activation lies within rounding of 0 can take the other branch in
    the kernel's replay, which moves a few weight-grad elements by a whole
    term."""
    dt = getattr(torch, dtype)
    p, kw = _block_case(T_, dt, cuda_device)
    got = block.fused_encode_decode(p["enc"][0], p["dec"][0], **kw)
    want = block.fused_encode_decode_ref(p["enc"][0], p["dec"][0], **kw)
    tol = 1e-4 if dt == torch.float32 else 3e-2
    assert _rel_err(got, want) <= tol
    g = torch.randn(want.shape, device=cuda_device).to(dt)
    ew, dw = block.pack_weights(p["enc"][0]), block.pack_weights(p["dec"][0])
    bkw = {k: v for k, v in kw.items()}
    got = block.fused_block_bwd(ew, dw, g=g, **bkw)
    want = block.fused_block_bwd_ref(ew, dw, g=g, **bkw)
    flat_got = (got[0], got[1]) + tuple(got[2])
    flat_want = (want[0], want[1]) + tuple(want[2])
    if dt == torch.float32:
        # ReLU flips: up to 5.0e-4 norm-wise measured (chip_smoke.py, whose
        # bwd_rounding_report holds both versions against float64)
        tols = [1e-2] * len(flat_want)
    else:
        # bfloat16 rounds every product operand, and a sum in another
        # order flips roundings: hold both against the float32 plain
        # version, the kernel within twice the plain version's error (plus
        # the float32 tolerance)
        kw32 = dict(bkw, enc_in=bkw["enc_in"].float(),
                    dec_in=bkw["dec_in"].float())
        r32 = block.fused_block_bwd_ref(ew, dw, g=g.float(), **kw32)
        flat_32 = (r32[0], r32[1]) + tuple(r32[2])
        tols = [2 * _norm_err(b, c) + 1e-2
                for b, c in zip(flat_want, flat_32)]
        flat_want = flat_32
    torch.cuda.synchronize()
    for i, (a, b, tol) in enumerate(zip(flat_got, flat_want, tols)):
        assert a.shape == b.shape and torch.isfinite(a.float()).all(), i
        assert _norm_err(a, b) <= tol, (i, _norm_err(a, b), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [32, 40])
def test_segsum_matches_plain_on_card(dtype, D, cuda_device):
    """Zipf-like ids with one run far longer than a chunk, unnamed tail
    slots, and an overflow slot collecting every id past the budget."""
    from cikm2020_dmt_torch.ops import scatter_rows as sr
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    N = 5000
    ids = torch.randint(0, 900, (N,), generator=gen, device=cuda_device)
    ids[:2000] = 0
    s, order = torch.sort(ids, stable=True)
    first = torch.ones_like(s, dtype=torch.bool)
    first[1:] = s[1:] != s[:-1]
    seg = torch.cumsum(first.long(), 0) - 1
    U = 300
    seg = seg.clamp(max=U)
    g = torch.randn(N, D, generator=gen, device=cuda_device).to(dt)
    got = sr.sorted_segment_sum_rows(g, order, seg, U + 5)
    want = sr.sorted_segment_sum_rows_ref(g, order, seg, U + 5)
    # float32 sums taken in another order: the error scales with a run's
    # sum of |g|
    mag = sr.sorted_segment_sum_rows_ref(g.abs(), order, seg, U + 5)
    torch.cuda.synchronize()
    assert ((got - want).abs() <= 1e-6 * mag + 1e-6).all()
    assert (got[U + 1:] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_update_rows_match_plain_on_card(dtype, cuda_device):
    from cikm2020_dmt_torch.ops import scatter_rows as sr
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    R, D, n = 1000, 32, 200
    table = torch.randn(R, D, generator=gen, device=cuda_device).to(dt)
    ids = torch.randperm(R, generator=gen, device=cuda_device)[:n]
    ids[:10] = R + torch.arange(10, device=cuda_device)   # sentinels
    ids[10:15] = -1 - torch.arange(5, device=cuda_device)  # dropped
    rows = torch.randn(n, D, generator=gen, device=cuda_device).to(dt)
    got = sr.update_rows(table.clone(), ids, rows)
    want = sr.update_rows_ref(table.clone(), ids, rows)
    mv = torch.randn(2, R, D, generator=gen, device=cuda_device)
    real = (ids >= 0) & (ids < R)
    ids2 = torch.cat([torch.where(real, ids, 2 * R),
                      torch.where(real, ids + R, -1)])
    rows2 = torch.randn(2 * n, D, generator=gen, device=cuda_device)
    got3 = sr.update_rows_3d(mv.clone(), ids2, rows2)
    want3 = sr.update_rows_3d_ref(mv.clone(), ids2, rows2)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got3, want3)


@pytest.mark.cuda
@pytest.mark.parametrize("T_", [10, 50])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_is_deterministic_on_card(T_, dtype, cuda_device):
    """Two launches of the backward kernel on the same inputs give the same
    bits: each partial element has one owner and the partials are summed
    in a fixed order."""
    dt = getattr(torch, dtype)
    p, kw = _block_case(T_, dt, cuda_device, B=517)
    g = torch.randn(517, 80, device=cuda_device).to(dt)
    ew, dw = block.pack_weights(p["enc"][0]), block.pack_weights(p["dec"][0])
    first = block.fused_block_bwd(ew, dw, g=g, **kw)
    second = block.fused_block_bwd(ew, dw, g=g, **kw)
    torch.cuda.synchronize()
    for a, b in zip((first[0], first[1]) + tuple(first[2]),
                    (second[0], second[1]) + tuple(second[2])):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_segsum_with_skipped_slots_matches_plain_on_card(dtype, cuda_device):
    """The lazy-Adam union of a grouped table: slot = group run index * 4
    + the row within the group, so slots no id names are skipped (and
    stay zero), and every group past the budget goes to the last slot."""
    from cikm2020_dmt_torch.ops import scatter_rows as sr
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    N, U, p = 5000, 200, 4
    ids = torch.randint(0, 4000, (N,), generator=gen, device=cuda_device)
    ids[:1500] = 7
    s, order = torch.sort(ids, stable=True)
    grp = s // p
    first = torch.ones_like(s, dtype=torch.bool)
    first[1:] = grp[1:] != grp[:-1]
    seg = torch.cumsum(first.long(), 0) - 1
    seg = torch.where(seg < U, seg * p + s % p, torch.full_like(seg, U * p))
    g = torch.randn(N, 32, generator=gen, device=cuda_device).to(dt)
    got = sr.sorted_segment_sum_rows(g, order, seg, U * p + 1)
    want = sr.sorted_segment_sum_rows_ref(g, order, seg, U * p + 1)
    mag = sr.sorted_segment_sum_rows_ref(g.abs(), order, seg, U * p + 1)
    torch.cuda.synchronize()
    assert ((got - want).abs() <= 1e-6 * mag + 1e-6).all()
    named = torch.zeros(U * p + 1, dtype=torch.bool, device=cuda_device)
    named[seg] = True
    assert (~named).any() and (got[~named] == 0).all()


# ---------------------------------------------------------------------------
# The attention kernels (ops/attention.py)
# ---------------------------------------------------------------------------

# (Tq, Tk): the encoder's self-attention and the decoder's single query,
# at the click/order sequence's T=50 and the cart's T=10
ATTENTION_SHAPES = [(50, 50), (10, 10), (1, 50), (1, 10)]


def _attention_case(Tq, Tk, dt, dev, B=301, seed=0):
    """q, k, v, masks and a cotangent; key lengths cycle through 0..Tk and
    the encoder's query mask is its key mask."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, do = (torch.randn(B, t, 80, generator=gen, device=dev).to(dt)
                   for t in (Tq, Tk, Tk, Tq))
    lens = torch.arange(B, device=dev) % (Tk + 1)
    km = (torch.arange(Tk, device=dev)[None] < lens[:, None]).float()
    qm = km if Tq == Tk else torch.ones(B, Tq, device=dev)
    return q, k, v, qm, km, do


def _max_rel(got, want):
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp(min=1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("Tq,Tk", ATTENTION_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_matches_plain_on_card(Tq, Tk, dtype, cuda_device):
    """The forward within 1e-4 in float32 (sums in another order); in
    bfloat16 within ``chip_smoke.bf16_attention_fwd_check``'s per-element
    limit of flipped roundings, with at most ``ATT_BF16_DIFF_SHARE`` of the
    elements differing at all.  The backward within 1e-4 of each output's
    largest |value| in float32, and in bfloat16 held against the float32
    plain version within twice the bfloat16 plain version's own error."""
    from chip_smoke import ATT_BF16_DIFF_SHARE, bf16_attention_fwd_check
    from cikm2020_dmt_torch.ops import attention as att
    dt = getattr(torch, dtype)
    q, k, v, qm, km, do = _attention_case(Tq, Tk, dt, cuda_device)
    got = att.fused_attention(q, k, v, qm, km, 4)
    want = att.fused_attention_ref(q, k, v, qm, km, 4)
    torch.cuda.synchronize()
    assert got.dtype == dt and torch.isfinite(got.float()).all()
    if dt == torch.float32:
        assert float((got - want).abs().max()) <= 1e-4
    else:
        ratio, share = bf16_attention_fwd_check(got, want, q, k, v, qm, km)
        assert ratio <= 1.0 and share <= ATT_BF16_DIFF_SHARE, (ratio, share)
    gb = att.fused_attention_bwd(q, k, v, qm, km, do, 4)
    rb = att.fused_attention_bwd_ref(q, k, v, qm, km, do, 4)
    if dt == torch.float32:
        tols = [1e-4] * 3
    else:
        r32 = att.fused_attention_bwd_ref(q.float(), k.float(), v.float(), qm,
                                          km, do.float(), 4)
        tols = [2 * _max_rel(b, c) + 1e-4 for b, c in zip(rb, r32)]
        rb = r32
    torch.cuda.synchronize()
    for name, a, b, t in zip("qkv", gb, rb, tols):
        assert a.dtype == dt and torch.isfinite(a.float()).all(), name
        assert _max_rel(a, b) <= t, (name, _max_rel(a, b), t)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_backward_is_deterministic_on_card(dtype, cuda_device):
    """Each output element has one owner thread summing in a fixed order:
    two launches give the same bits."""
    from cikm2020_dmt_torch.ops import attention as att
    q, k, v, qm, km, do = _attention_case(50, 50, getattr(torch, dtype),
                                          cuda_device, B=517)
    first = att.fused_attention_bwd(q, k, v, qm, km, do, 4)
    second = att.fused_attention_bwd(q, k, v, qm, km, do, 4)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["T", "dtype", "heads", "dh"])
def test_attention_kernels_raise_on_what_they_do_not_take(bad, cuda_device):
    """No keys, float16, heads that do not divide D, and no heads: the
    kernels take any Tq, Tk >= 1 and any head width, but not these."""
    from cikm2020_dmt_torch.ops import attention as att
    dt = torch.float16 if bad == "dtype" else torch.float32
    H = {"heads": 3, "dh": 0}.get(bad, 4)
    q, k, v, qm, km, do = _attention_case(10, 10, dt, cuda_device, B=4)
    if bad == "T":
        k, v, km = k[:, :0], v[:, :0], km[:, :0]
    with pytest.raises((ValueError, TypeError)):
        att.fused_attention(q, k, v, qm, km, H)
    with pytest.raises((ValueError, TypeError)):
        att.fused_attention_bwd(q, k, v, qm, km, do, H)


# ---------------------------------------------------------------------------
# Every access width of the row write, every head width of the backward
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [1, 7, 32, 33, 80, "32-offset"])
def test_update_rows_every_access_width_on_card(D, dtype, cuda_device):
    """The kernel copies a row 16 bytes at a time when the row's bytes and
    both base pointers allow, else 4 bytes, else one element: D in {1, 7,
    32, 33, 80} runs each width for float32 and bfloat16, and "32-offset"
    hands in rows that start 2 elements into their buffer (not 16-byte
    aligned).  Exact against the plain versions, with ids past the end and
    negative ids dropped."""
    from cikm2020_dmt_torch.ops import scatter_rows as sr
    dt = getattr(torch, dtype)
    offset = D == "32-offset"
    D = 32 if offset else D
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    R, n = 1000, 300
    ids = torch.randperm(R, generator=gen, device=cuda_device)[:n]
    ids[:20] = R + torch.arange(20, device=cuda_device)
    ids[20:27] = -1 - torch.arange(7, device=cuda_device)

    def rows_of(m):
        buf = torch.randn(m * D + 2, generator=gen, device=cuda_device)
        return (buf[2:] if offset else buf[:m * D]).to(dt).view(m, D)

    table = torch.randn(R, D, generator=gen, device=cuda_device).to(dt)
    rows = rows_of(n)
    got = sr.update_rows(table.clone(), ids, rows)
    want = sr.update_rows_ref(table.clone(), ids, rows)
    mv = torch.randn(2, R, D, generator=gen, device=cuda_device).to(dt)
    real = (ids >= 0) & (ids < R)
    ids2 = torch.cat([torch.where(real, ids, 2 * R),
                      torch.where(real, ids + R, -1)])
    rows2 = rows_of(2 * n)
    got3 = sr.update_rows_3d(mv.clone(), ids2, rows2)
    want3 = sr.update_rows_3d_ref(mv.clone(), ids2, rows2)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got3, want3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H", [10, 4, 2])
@pytest.mark.parametrize("B", [1, 300, 517])
def test_attention_backward_every_head_width_on_card(B, H, dtype,
                                                     cuda_device):
    """D=80 in 10, 4 or 2 heads (dh 8, 20, 40: three compile-time widths),
    at the four (Tq, Tk) of the path and batch sizes that fill blocks
    unevenly, key lengths cycling through 0..Tk (B=1 is a single row with
    no present key).  Float32 within 1e-4 of each output's largest |value|;
    bfloat16 against the float32 plain version within twice the bfloat16
    plain version's own error; two launches give the same bits."""
    from cikm2020_dmt_torch.ops import attention as att
    dt = getattr(torch, dtype)
    for Tq, Tk in ATTENTION_SHAPES:
        q, k, v, qm, km, do = _attention_case(Tq, Tk, dt, cuda_device, B=B,
                                              seed=B + H)
        gb = att.fused_attention_bwd(q, k, v, qm, km, do, H)
        again = att.fused_attention_bwd(q, k, v, qm, km, do, H)
        rb = att.fused_attention_bwd_ref(q, k, v, qm, km, do, H)
        if dt == torch.float32:
            tols = [1e-4] * 3
        else:
            r32 = att.fused_attention_bwd_ref(q.float(), k.float(), v.float(),
                                              qm, km, do.float(), H)
            tols = [2 * _max_rel(b, c) + 1e-4 for b, c in zip(rb, r32)]
            rb = r32
        torch.cuda.synchronize()
        for name, a, a2, b, t in zip("qkv", gb, again, rb, tols):
            where = (Tq, Tk, name)
            assert a.dtype == dt and torch.isfinite(a.float()).all(), where
            assert torch.equal(a, a2), where
            assert _max_rel(a, b) <= t, (where, _max_rel(a, b), t)


# ---------------------------------------------------------------------------
# Edges of the redesigned attention forward and block backward tilings
# ---------------------------------------------------------------------------

# the four shapes of the path, a ragged one, and the largest the kernels take
FWD_EDGE_SHAPES = ATTENTION_SHAPES + [(7, 33), (64, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H", [2, 4, 10])
@pytest.mark.parametrize("B", [1, 300, 517, 2048])
def test_attention_forward_tilings_on_card(B, H, dtype, cuda_device):
    """D=80 in 2, 4 or 10 heads at every shape of the path plus (7, 33) and
    (64, 64), key lengths cycling through 0..Tk (B=1 is a single row with
    no present key), batch sizes that fill the blocks unevenly: float32
    within 1e-4, bfloat16 within ``bf16_attention_fwd_check``'s limits."""
    from chip_smoke import ATT_BF16_DIFF_SHARE, bf16_attention_fwd_check
    from cikm2020_dmt_torch.ops import attention as att
    dt = getattr(torch, dtype)
    for Tq, Tk in FWD_EDGE_SHAPES:
        q, k, v, qm, km, _ = _attention_case(Tq, Tk, dt, cuda_device, B=B,
                                             seed=B + H)
        got = att.fused_attention(q, k, v, qm, km, H)
        want = att.fused_attention_ref(q, k, v, qm, km, H)
        torch.cuda.synchronize()
        where = (Tq, Tk)
        assert got.dtype == dt and torch.isfinite(got.float()).all(), where
        if dt == torch.float32:
            assert float((got - want).abs().max()) <= 1e-4, where
        else:
            ratio, share = bf16_attention_fwd_check(got, want, q, k, v, qm,
                                                    km, H)
            assert ratio <= 1.0 and share <= ATT_BF16_DIFF_SHARE, (where,
                                                                  ratio,
                                                                  share)


def _block_bwd_case(B, T_, dt, dev, rate, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    p = transformer_init(gen, TransformerConfig(maxlen_k=T_))
    enc = torch.randn(B, T_, 80, generator=gen, device=dev).to(dt)
    dec = torch.randn(B, 80, generator=gen, device=dev).to(dt)
    lens = torch.arange(B, device=dev) % (T_ + 1)
    mask = (torch.arange(T_, device=dev)[None] < lens[:, None]).float()
    g = torch.randn(B, 80, generator=gen, device=dev).to(dt)
    kw = dict(enc_in=enc, dec_in=dec, seq_mask=mask, num_heads=4,
              train=rate > 0, rate=rate,
              seed=torch.tensor([seed + 7], dtype=torch.int32, device=dev))
    ew, dw = block.pack_weights(p["enc"][0]), block.pack_weights(p["dec"][0])
    return ew, dw, g, kw


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.1, 0.0])
@pytest.mark.parametrize("T_", [1, 10, 50])
@pytest.mark.parametrize("B", [1, 131, 133, 517])
def test_block_backward_tilings_on_card(B, T_, rate, cuda_device):
    """Batch sizes below and above the SM count that fill no tile evenly,
    one to 50 keys (one, one and four 16-row tiles; lengths cycling through
    0..T), dropout on and off: float32 within 1e-2 norm-wise of the plain
    version per output, bfloat16 against the float32 plain version within
    twice the bfloat16 plain version's own error (plus 1e-2), as
    ``chip_smoke.block_train_phase`` holds them."""
    for dt in (torch.float32, torch.bfloat16):
        ew, dw, g, kw = _block_bwd_case(B, T_, dt, cuda_device, rate,
                                        seed=B + T_)
        got = block.fused_block_bwd(ew, dw, g=g, **kw)
        flat_got = (got[0], got[1]) + tuple(got[2])
        kw32 = dict(kw, enc_in=kw["enc_in"].float(),
                    dec_in=kw["dec_in"].float())
        r32 = block.fused_block_bwd_ref(ew, dw, g=g.float(), **kw32)
        flat_32 = (r32[0], r32[1]) + tuple(r32[2])
        if dt == torch.float32:
            tols = [1e-2] * len(flat_32)
        else:
            rb = block.fused_block_bwd_ref(ew, dw, g=g, **kw)
            tols = [2 * _norm_err(b, c) + 1e-2
                    for b, c in zip((rb[0], rb[1]) + tuple(rb[2]), flat_32)]
        torch.cuda.synchronize()
        for i, (a, b, tol) in enumerate(zip(flat_got, flat_32, tols)):
            where = (str(dt), i)
            assert a.shape == b.shape and torch.isfinite(a.float()).all(), \
                where
            assert _norm_err(a, b) <= tol, (where, _norm_err(a, b), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T_", [1, 10, 50])
def test_block_backward_repeats_bit_for_bit_on_card(T_, dtype, cuda_device):
    """At the training batch: the weight grads are summed over fixed row
    chunks in a fixed order (no sum depends on which block finishes
    first), so two launches give the same bits in every output."""
    ew, dw, g, kw = _block_bwd_case(2048, T_, getattr(torch, dtype),
                                    cuda_device, 0.1, seed=T_)
    first = block.fused_block_bwd(ew, dw, g=g, **kw)
    second = block.fused_block_bwd(ew, dw, g=g, **kw)
    torch.cuda.synchronize()
    for a, b in zip((first[0], first[1]) + tuple(first[2]),
                    (second[0], second[1]) + tuple(second[2])):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["T", "heads"])
def test_block_backward_raises_beyond_its_widths(bad, cuda_device,
                                                 monkeypatch):
    """The kernels take every width whose D is a multiple of the heads and
    every T whose activations the 32-bit indexing reaches: T=40,000 (3.2e9
    floats an example), or heads that do not divide D, raise before any
    build (``_build.build`` is not called)."""
    from cikm2020_dmt_torch.ops import _build

    def no_build(specs):
        raise AssertionError(f"build called for {specs}")

    ew, dw, g, kw = _block_bwd_case(4, 40000 if bad == "T" else 10,
                                    torch.float32, cuda_device, 0.0)
    if bad == "heads":
        kw["num_heads"] = 3
    monkeypatch.setattr(_build, "build", no_build)
    with pytest.raises(ValueError, match="fused_block_bwd"):
        block.fused_block_bwd(ew, dw, g=g, **kw)


# ---------------------------------------------------------------------------
# Other widths, and the forward against the backward's replay
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D,F,H,T_", [(36, 100, 3, 7), (64, 256, 2, 60),
                                      (80, 320, 4, 200), (36, 100, 3, 300)])
def test_block_kernels_at_other_widths_on_card(D, F, H, T_, dtype,
                                               cuda_device):
    """Both block kernels at widths other than the model's (a head of 12
    columns, F not a multiple of 8; two heads of 32 past 50 keys), at
    T=200, whose activations spill into the workspace, and at T=300, past
    the encoder attention's register tilings, against their plain versions
    with chip_smoke's tolerances, dropout 0.1."""
    from chip_smoke import check_block_width
    check_block_width(D, F, H, T_, getattr(torch, dtype), cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Tq,Tk,H,dh", [(65, 65, 4, 20), (1, 200, 2, 72),
                                        (200, 200, 2, 72), (10, 10, 1, 72)])
def test_attention_kernels_past_the_tilings_on_card(Tq, Tk, H, dh, dtype,
                                                    cuda_device):
    """Both attention kernels past 64 keys and with heads of 72 columns
    (the one-warp-a-row kernels) against their plain versions with the
    main path's tolerances."""
    from chip_smoke import check_attention_width
    check_attention_width(Tq, Tk, H, dh, getattr(torch, dtype), cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("widths,T_", [((80, 320, 4), 1), ((80, 320, 4), 10),
                                       ((80, 320, 4), 50), ((80, 320, 4), 55),
                                       ((80, 320, 4), 128),
                                       ((36, 100, 3), 7),
                                       ((64, 256, 2), 60),
                                       ((36, 100, 3), 300)])
def test_forward_and_replay_preactivations_equal_on_card(widths, T_, dtype,
                                                         cuda_device):
    """The FF pre-activations the forward kernel formed and those the
    backward's replay formed are the same bits (dropout 0.1), so each ReLU
    takes in the backward the branch it took in the forward; also where
    both kernels spill into their workspaces although the forward's own
    activations would fit (T=55), where neither's fit (T=128) and past the
    encoder attention's register tilings (T=300)."""
    from chip_smoke import check_replay
    check_replay(T_, getattr(torch, dtype), cuda_device, widths=widths)


# ---------------------------------------------------------------------------
# The save mode (DMT_BLOCK_SAVE): the forward also writes the encoder's Q,
# K, V and attention context, and the backward reads them
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D,F,H,T_", [(80, 320, 4, 1), (80, 320, 4, 10),
                                      (80, 320, 4, 50), (80, 320, 4, 55),
                                      (80, 320, 4, 128), (36, 100, 3, 7)])
def test_save_mode_bit_equal_on_card(D, F, H, T_, dtype, cuda_device):
    """With dropout 0.1, the forward's output and the backward's 12
    outputs are the same bits with the save mode's q, k, v and ctx_e as
    without them (also where both kernels spill, T=55 and 128, and at
    another width), and the saved tensors lie within chip_smoke's
    ``KERNEL_TOL`` of the plain version's."""
    from chip_smoke import check_save
    check_save(D, F, H, T_, getattr(torch, dtype), cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["count", "shape", "dtype", "device"])
def test_bad_saved_raises_before_any_build_on_card(bad, cuda_device,
                                                   monkeypatch):
    """A ``saved`` of the wrong count, shape, dtype (ctx_e must be
    float32) or device raises before any build or launch."""
    from cikm2020_dmt_torch.ops import _build

    def no_build(specs):
        raise AssertionError(f"build called for {specs}")

    ew, dw, g, kw = _block_bwd_case(4, 10, torch.float32, cuda_device, 0.0)
    B, T_, D = kw["enc_in"].shape
    saved = [torch.zeros(B, T_, D, device=cuda_device) for _ in range(4)]
    if bad == "count":
        saved = saved[:3]
    elif bad == "shape":
        saved[0] = torch.zeros(B, T_ + 1, D, device=cuda_device)
    elif bad == "dtype":
        saved[3] = torch.zeros(B, T_, D, dtype=torch.bfloat16,
                               device=cuda_device)
    else:
        saved[1] = torch.zeros(B, T_, D)
    monkeypatch.setattr(_build, "build", no_build)
    monkeypatch.setattr(_build, "bind", no_build)
    with pytest.raises(ValueError, match="fused_block_bwd: saved"):
        block.fused_block_bwd(ew, dw, g=g, saved=tuple(saved), **kw)


# ---------------------------------------------------------------------------
# The segment sum's tiles (csrc/sorted_segsum.cu: 256 sorted rows a tile)
# ---------------------------------------------------------------------------


def _segsum_case(N, pad, D, dt, dev, seed=0, p=4):
    """A lazy-Adam union of ``N`` ids in groups of ``p``: ``pad`` of them
    the padding id 0 (one run over ``pad`` sorted rows), the rest
    heavy-tailed; slot = group run index * p + the row in the group, so
    slots no id names are skipped, and every group past the budget (a
    fifth fewer than the distinct groups) goes to the overflow slot, with
    two slots no id names past it.  Returns (g, order, seg, num_out)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    ids = torch.from_numpy((rng.zipf(1.3, N) * 2654435761) % 500_000)
    ids[:pad] = 0
    ids = ids.to(dev)
    s, order = torch.sort(ids, stable=True)
    grp = s // p
    first = torch.ones_like(s, dtype=torch.bool)
    first[1:] = grp[1:] != grp[:-1]
    seg = torch.cumsum(first.long(), 0) - 1
    U = max(1, int(int(first.sum()) * 0.8))
    seg = torch.where(seg < U, seg * p + s % p, torch.full_like(seg, U * p))
    g = torch.from_numpy(rng.normal(size=(N, D)).astype(np.float32))
    return g.to(dev).to(dt), order, seg, U * p + 3


# (N, padding rows): a padding run over more than 1,000 tiles; N not a
# multiple of the tile; N below one tile; one row
SEGSUM_TILE_CASES = [(300_000, 280_000), (5_001, 2_000), (200, 150), (1, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [32, 40, 12])
@pytest.mark.parametrize("N,pad", SEGSUM_TILE_CASES)
def test_segsum_tiles_match_plain_on_card(N, pad, D, dtype, cuda_device):
    """The segment sum against its plain version where runs cross tiles,
    with skipped slots, an overflow slot and unnamed slots past it, at
    D = 32 and 40 (16-byte row copies) and 12 (bf16 rows of 24 bytes:
    element copies); the unnamed slots are exactly 0 (the kernel writes
    every slot of an uninitialised output)."""
    from cikm2020_dmt_torch.ops import scatter_rows as sr
    g, order, seg, num = _segsum_case(N, pad, D, getattr(torch, dtype),
                                      cuda_device)
    got = sr.sorted_segment_sum_rows(g, order, seg, num)
    want = sr.sorted_segment_sum_rows_ref(g, order, seg, num)
    # float32 sums taken in another order: the error scales with a run's
    # sum of |g|
    mag = sr.sorted_segment_sum_rows_ref(g.abs(), order, seg, num)
    torch.cuda.synchronize()
    assert ((got - want).abs() <= 1e-6 * mag + 1e-6).all()
    named = torch.zeros(num, dtype=torch.bool, device=cuda_device)
    named[seg] = True
    assert (~named).any() and (got[~named] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [32, 12])
def test_segsum_repeats_bit_for_bit_on_card(D, dtype, cuda_device):
    """Two launches on the same inputs give the same bits (a fixed order
    of sums, no atomics), the padding run over more than 1,000 tiles; the
    output is taken from a pool that held other values in between."""
    from cikm2020_dmt_torch.ops import scatter_rows as sr
    g, order, seg, num = _segsum_case(300_000, 280_000, D,
                                      getattr(torch, dtype), cuda_device,
                                      seed=1)
    first = sr.sorted_segment_sum_rows(g, order, seg, num)
    junk = torch.full((num * D * 2,), float("nan"), device=cuda_device)
    del junk
    second = sr.sorted_segment_sum_rows(g, order, seg, num)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_packed_transfer_and_prefetch_on_card(cuda_device):
    """``Trainer.device_prefetch`` at the flagship's batch: each batch on
    the card equals ``Trainer.unpack_device_batch`` of the CPU pack.

    - A pinned staging is written again only after its last copy has
      completed: with the copy stream held back by a sleep, six batches
      through two stagings still arrive intact (a staging overwritten
      early would send a later batch's bytes).
    - The copies run on their own stream: the next batch's copy completes
      while the step's stream is still busy."""
    from pathlib import Path

    import chip_smoke as cs
    from cikm2020_dmt_torch.core.config import DMTConfig
    from cikm2020_dmt_torch.data.pipeline import Batch
    from cikm2020_dmt_torch.train.loop import Trainer

    cfg = DMTConfig.from_ini(str(Path(__file__).resolve().parent.parent
                                 / "conf" / "dmt.conf"))
    batches = [Batch({k: v.numpy() for k, v in
                      cs.synthetic_batch(cfg, 2048, s, "cpu").items()})
               for s in range(6)]
    cpu = Trainer(cfg, device="cpu")
    want = [Trainer.unpack_device_batch(cpu.device_batch(b), cpu._pack_layout)
            for b in batches]
    cycles_per_ms = cs._sleep_cycles_per_ms()

    def check(tr, got):
        assert [b for b, _ in got] == batches
        for (_, dev), w in zip(got, want):
            assert set(dev) == {"__packed_f32", "__packed_i32"}
            out = Trainer.unpack_device_batch(dev, tr._pack_layout)
            assert set(out) == set(w)
            for k, v in w.items():
                assert out[k].device.type == "cuda" and \
                    out[k].dtype == v.dtype
                assert torch.equal(out[k].cpu(), v), k

    # the copy stream held back: every staging waits for its last copy
    tr = Trainer(cfg, device=cuda_device)
    tr._copy_stream = torch.cuda.Stream(cuda_device)
    with torch.cuda.stream(tr._copy_stream):
        torch.cuda._sleep(int(cycles_per_ms * 100))
    got = list(tr.device_prefetch(iter(batches)))
    torch.cuda.synchronize()
    check(tr, got)

    # the step's stream held back: the copies do not wait for it
    tr = Trainer(cfg, device=cuda_device)
    feed = tr.device_prefetch(iter(batches))
    got = [next(feed)]                     # batches 0 and 1 copied
    busy_ms = 200.0
    torch.cuda._sleep(int(cycles_per_ms * busy_ms))
    t0 = cs.time.perf_counter()
    got.append(next(feed))                 # batch 2 packed and copied
    tr._copy_stream.synchronize()
    copy_ms = (cs.time.perf_counter() - t0) * 1e3
    step_busy = not torch.cuda.current_stream().query()
    got += list(feed)
    torch.cuda.synchronize()
    assert step_busy and copy_ms < busy_ms / 2, copy_ms
    check(tr, got)


def _eval_serve_cfg(tmp_path):
    """``conf/dmt.conf`` at its widths with tables of at most 5,000 rows
    (Sku lane-packed in the reference's storage: 1,250 physical rows),
    batches of 256, its data written as four shards of 100 examples under
    ``tmp_path``, a random mean / std pair; the int8 threshold (1,000
    physical rows) quantizes Sku alone."""
    import dataclasses
    from pathlib import Path

    import numpy as np

    import chip_smoke as cs
    from cikm2020_dmt_torch.core.config import DMTConfig

    cfg = DMTConfig.from_ini(str(Path(__file__).resolve().parent.parent
                                 / "conf" / "dmt.conf"))
    data = tmp_path / "data"
    data.mkdir()
    rng = np.random.default_rng(0)
    stats = {}
    for name, vals in (("mean", rng.normal(0.5, 1.0, 615)),
                       ("std", rng.uniform(0.1, 3.0, 615))):
        stats[name] = tmp_path / name
        stats[name].write_text("\t".join(repr(float(v)) for v in vals))
    cfg = dataclasses.replace(
        cfg, embeddings=tuple(dataclasses.replace(e, id_size=min(
            e.id_size, 5000)) for e in cfg.embeddings),
        pack_rows_threshold=1000, export_int8_rows=1000,
        validation_batch_size=256, test_batch_size=256,
        output_path=str(tmp_path / "out"),
        train_data_mean_path=str(stats["mean"]),
        train_data_std_path=str(stats["std"]))
    cs.write_shards(cfg, str(data), 4, 100, seed=9)
    return cfg, str(data) + "/"


@pytest.mark.cuda
def test_run_eval_from_files_on_card(cuda_device, tmp_path):
    """``run_eval`` over TFRecord shards with the gates, on the card and
    on the CPU: scores, metric values and gate means within 1e-4, the
    same header lines, 3 block-forward launches a batch and no other."""
    import numpy as np

    from cikm2020_dmt_torch.models.zoo import build_model
    from cikm2020_dmt_torch.ops import attention, scatter_rows
    from cikm2020_dmt_torch.train.evaluate import run_eval

    cfg, data = _eval_serve_cfg(tmp_path)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    counted = (block.fused_encode_decode, block.fused_block_bwd,
               attention.fused_attention, scatter_rows.update_rows)
    for fn in counted:
        fn.launches = 0
    card = run_eval(cfg, model, params, data, 256, collect_gates=True,
                    device=cuda_device)
    assert [fn.launches for fn in counted] == [3 * 2, 0, 0, 0]
    cpu = run_eval(cfg, model, params, data, 256, collect_gates=True,
                   device="cpu")
    assert card[1] == cpu[1] and len(card[1]) == 400
    for a, b in zip(card[2:], cpu[2:]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)
    for k in cpu[0]:
        assert abs(card[0][k] - cpu[0][k]) <= 1e-4, k


@pytest.mark.cuda
def test_int8_load_scorer_on_card(cuda_device, tmp_path):
    """An int8 bundle (Sku quantized in groups of 4 logical rows) read
    onto the card scores as on the CPU within 1e-4, and within 0.05 of the
    float32 bundle; ``score_async`` leaves its tensors on the card."""
    import dataclasses

    import numpy as np

    import chip_smoke as cs
    from cikm2020_dmt_torch.core.checkpoint import CheckpointManager
    from cikm2020_dmt_torch.models.zoo import build_model
    from cikm2020_dmt_torch.serve.export import export_model, load_scorer

    cfg, _ = _eval_serve_cfg(tmp_path)
    params = build_model(cfg).init(torch.Generator().manual_seed(1))
    CheckpointManager(cfg.model_path).save(3, {"params": params})
    d8 = export_model(cfg, 3, str(tmp_path / "int8"))
    d32 = export_model(dataclasses.replace(cfg, export_int8_rows=0), 3,
                       str(tmp_path / "f32"))
    card = load_scorer(cfg, d8, device=cuda_device)
    sku = card.params["emb"]["Sku"]
    assert sku["q"].dtype == torch.int8 and sku["q"].is_cuda
    assert tuple(sku["q"].shape) == (5000, 32)
    assert tuple(sku["scale"].shape) == (1250, 1)
    cpu = load_scorer(cfg, d8, device="cpu")
    f32 = load_scorer(cfg, d32, device=cuda_device)
    for req in cs.make_requests(cfg, 300, cs.REQUEST_LENS, 0):
        a = card.score_async(req)
        assert all(v.is_cuda for v in a.values())
        b = cpu(req)
        for k in b:
            np.testing.assert_allclose(a[k].cpu().numpy(), b[k], rtol=0,
                                       atol=1e-4, err_msg=k)
        np.testing.assert_allclose(b["Scores"], f32(req)["Scores"],
                                   atol=0.05)


@pytest.mark.cuda
def test_queue_on_card(cuda_device):
    """``ScorerQueue`` over a card ``Scorer``: 16 requests from 4 threads,
    each within 1e-4 of the request scored alone, in forwards of groups of
    at most 8, each forward 3 block-forward launches."""
    import dataclasses
    import threading
    from pathlib import Path

    import numpy as np

    import chip_smoke as cs
    from cikm2020_dmt_torch.core.config import DMTConfig
    from cikm2020_dmt_torch.models.zoo import build_model
    from cikm2020_dmt_torch.serve.export import Scorer
    from cikm2020_dmt_torch.serve.queue import ScorerQueue

    cfg = DMTConfig.from_ini(str(Path(__file__).resolve().parent.parent
                                 / "conf" / "dmt.conf"))
    cfg = dataclasses.replace(cfg, embeddings=tuple(
        dataclasses.replace(e, id_size=min(e.id_size, 5000))
        for e in cfg.embeddings))
    params = build_model(cfg).init(torch.Generator().manual_seed(2))
    scorer = cs.CountingScorer(Scorer(cfg, params, np.ones(615, np.float32),
                                 np.zeros(615, np.float32),
                                 device=cuda_device))
    reqs = cs.make_requests(cfg, 300, cs.REQUEST_LENS, 3)
    alone = [scorer.scorer(r)["Scores"] for r in reqs]
    block.fused_encode_decode.launches = 0
    q = ScorerQueue(scorer)
    q.warmup(reqs[0])
    got = []

    def client(t):
        futs = [((t + i) % 3, q.submit(reqs[(t + i) % 3]))
                for i in range(4)]
        got.extend((k, f.result(timeout=60)["Scores"]) for k, f in futs)

    threads = [threading.Thread(target=client, args=(t,)) for t in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    q.close()
    assert len(got) == 16
    for k, s in got:
        assert s.is_cuda and s.shape == (300,)
        np.testing.assert_allclose(s.cpu().numpy(), alone[k], rtol=0,
                                   atol=1e-4)
    torch.cuda.synchronize()
    assert block.fused_encode_decode.launches == 3 * scorer.n


LATTICE = ("mlp", "embed_mlp", "embed_mlp_unbias", "multi_task", "mmoe",
           "transformer", "multi_task_transformer", "mmoe_transformer",
           "mmoe_transformer_unbias")


def _adam_launches(cfg) -> int:
    """The dense Adam's launches in one training step of ``cfg``:
    ``ops/adam.py``'s plan of the dense leaves (one launch a
    ``MAX_LEAVES`` leaves)."""
    from cikm2020_dmt_torch.ops import adam
    from cikm2020_dmt_torch.train.loop import Trainer, _flatten

    tr = Trainer(cfg, device="cpu")
    params = tr.model.init(torch.Generator().manual_seed(0))
    return len(adam.plan([t.numel()
                          for t in _flatten(tr._dense(params), [])]))


def _lattice_cfg(model_type, is_bn=False):
    """``conf/dmt.conf`` with ``model_type``, tables cut to 5,000 rows and
    the tables of 5,000 rows under lazy Adam; dropout off; batch norm's
    decay 0, so one step leaves the batch's own statistics (a fresh batch
    norm evaluates with zero variance, rsqrt(1e-4) = 100 a layer, which
    magnifies any rounding difference)."""
    import dataclasses
    from pathlib import Path

    from cikm2020_dmt_torch.core.config import DMTConfig

    cfg = DMTConfig.from_ini(str(Path(__file__).resolve().parent.parent
                                 / "conf" / "dmt.conf"))
    return dataclasses.replace(
        cfg, model_type=model_type, is_bn=is_bn, bn_decay=0.0,
        dedup_rows_threshold=5000,
        dropout_rate_bias=(0.0,) * len(cfg.dropout_rate_bias),
        transformer=dataclasses.replace(cfg.transformer, dropout_rate=0.0),
        embeddings=tuple(dataclasses.replace(e, id_size=min(e.id_size, 5000))
                         for e in cfg.embeddings))


@pytest.mark.cuda
@pytest.mark.parametrize("model_type,is_bn", [(m, False) for m in LATTICE]
                         + [("mmoe_transformer", True), ("mlp", True)])
def test_lattice_model_on_card(model_type, is_bn, cuda_device):
    """Each lattice model on the card: one training step with one block
    forward and backward per sequence group and the lazy update's three
    launches per table of 5,000 rows (Sku, Cid3, Brand, Shopid after the
    cut) or none (mlp), the dense Adam's planned launches, a finite loss and, where ``is_bn``, the moving
    statistics moved; then its eval forward (the bias head too) on that
    state within 1e-4 of the CPU forward, one block-forward launch per
    group."""
    import chip_smoke as cs
    from cikm2020_dmt_torch.metrics.streaming import task_metrics_init
    from cikm2020_dmt_torch.nn.layers import tree_map
    from cikm2020_dmt_torch.train.loop import Trainer

    cfg = _lattice_cfg(model_type, is_bn)
    tr = Trainer(cfg, device=cuda_device)
    state = tr.init_state(torch.Generator(device=cuda_device).manual_seed(0))
    groups = len(cfg.attention_pairs) if "transformer" in model_type else 0
    lazy = len(tr.lazy_plan)
    assert lazy == (0 if model_type == "mlp" else 4)
    batch = cs.synthetic_batch(cfg, 256, 1, cuda_device)
    cs.reset_counts()
    state, _, loss = tr.train_step(state, task_metrics_init(cuda_device),
                                   batch, torch.Generator(device=cuda_device))
    torch.cuda.synchronize()
    assert cs.read_counts() == {
        "fused_block_fwd": groups, "fused_block_bwd": groups,
        "attention_fwd": 0, "attention_bwd": 0, "sorted_segsum": lazy,
        "update_rows": lazy, "update_rows_3d": lazy,
        "adam_dense": _adam_launches(cfg)}
    assert torch.isfinite(loss)
    flat = torch.utils._pytree.tree_leaves
    moving = flat(state["model_state"])
    assert bool(moving) == is_bn
    assert all(float(t.abs().max()) > 0 for t in moving[::2])

    batch = cs.synthetic_batch(cfg, 256, 2, cuda_device)
    cs.reset_counts()
    out = tr.model.apply(state["params"], batch, is_predict=False,
                         state=state["model_state"])
    torch.cuda.synchronize()
    assert cs.read_counts()["fused_block_fwd"] == groups
    cpu = tr.model.apply(tree_map(lambda t: t.cpu(), state["params"]),
                         {k: v.cpu() for k, v in batch.items()},
                         is_predict=False,
                         state=tree_map(lambda t: t.cpu(),
                                        state["model_state"]))
    for a, b in zip(flat(out), flat(cpu)):
        assert a.device.type == cuda_device.type and a.shape == b.shape
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("model_type", ["din", "dien"])
def test_baseline_step_matches_cpu_on_card(model_type, cuda_device):
    """One step of a paper baseline at batch 256 (``conf/dmt.conf``'s
    widths, tables cut to 5,000 rows, four of them under lazy Adam) on the
    card against the same step on the CPU, with the tolerances of
    ``chip_smoke.card_vs_cpu_step`` (which raises past them); the card's
    step launches one segment sum and two row writes per lazy table and
    no block."""
    import chip_smoke as cs

    cfg = _lattice_cfg(model_type)
    cs.reset_counts()
    check = cs.card_vs_cpu_step(cfg, cuda_device)
    assert cs.read_counts() == {
        "fused_block_fwd": 0, "fused_block_bwd": 0, "attention_fwd": 0,
        "attention_bwd": 0, "sorted_segsum": 4, "update_rows": 4,
        "update_rows_3d": 4, "adam_dense": _adam_launches(cfg)}
    assert check["loss_rel_err"] <= 1e-4 and check["grad_err"] <= 1e-2


@pytest.mark.cuda
def test_dien_request_with_an_empty_group_on_card(cuda_device):
    """DIEN serving requests whose order or click and cart histories are
    empty: the card's Scores within 1e-4 of the CPU's, no kernel
    launched; DIEN's attention weighs a length-0 row's L steps
    uniformly on the card."""
    import numpy as np

    import chip_smoke as cs
    from cikm2020_dmt_torch.models import baselines
    from cikm2020_dmt_torch.models.components import seq_input_dim
    from cikm2020_dmt_torch.models.zoo import build_model
    from cikm2020_dmt_torch.nn.layers import tree_map
    from cikm2020_dmt_torch.serve.export import Scorer

    cfg = _lattice_cfg("dien")
    params = build_model(cfg).init(
        torch.Generator(device=cuda_device).manual_seed(0))
    _, _, (scale, const) = cs._norm_constants(cfg)
    card = Scorer(cfg, params, scale, const, device=cuda_device)
    cpu = Scorer(cfg, tree_map(lambda t: t.cpu(), params), scale, const,
                 device="cpu")
    requests = cs.make_requests(cfg, 300, ((17, 0, 3), (0, 33, 0)), 0)
    cs.reset_counts()
    got = [card(q) for q in requests]
    torch.cuda.synchronize()
    assert not any(cs.read_counts().values())
    for q, out in zip(requests, got):
        cs.check_scores(out, 300)
        want = cpu(q)
        for k in want:
            np.testing.assert_allclose(out[k], want[k], rtol=0, atol=1e-4)

    attn = params["attn0"]
    mask = torch.ones((3, 50), device=cuda_device)
    mask[0] = 0.0
    w = baselines.dien_attention_apply(
        attn, torch.randn((3, seq_input_dim(cfg, 0)), device=cuda_device),
        torch.randn((3, 50, 16), device=cuda_device), mask)
    torch.testing.assert_close(w[0], torch.full((50,), 1.0 / 50,
                                                device=cuda_device))


@pytest.mark.cuda
def test_mesh_collectives_on_card(cuda_device):
    """Two gloo ranks sharing the card: ``core.mesh``'s collectives take
    card tensors and hand back card tensors; bfloat16 moves as its
    bytes; ``from_chief`` hands rank 0's flags to both."""
    import torch_mesh_workers as workers
    from cikm2020_dmt_torch.core.mesh import run_ranks

    out = run_ranks(workers.card_collectives, 2, timeout_s=300)
    x = [torch.arange(8, dtype=torch.float32) + 10 * r for r in range(2)]
    for r, o in enumerate(out):
        assert o["backend"] == "gloo" and o["device"].startswith("cuda")
        want_a2a = torch.cat([x[0].reshape(4, 2)[2 * r:2 * r + 2],
                              x[1].reshape(4, 2)[2 * r:2 * r + 2]])
        assert torch.equal(o["a2a"], want_a2a)
        assert torch.equal(o["gathered"], torch.stack(x))
        assert torch.equal(o["sum"], x[0] + x[1])
        assert o["agree"] == (True, False)
        assert o["from_chief"] == (True, False)


@pytest.mark.cuda
def test_mesh_step_on_card(cuda_device):
    """Two gloo ranks sharing the card, one step of ``conf/dmt.conf``'s
    model (Sku cut to 20,000 rows and split over the ranks, the other
    three lazy tables cut to 5,000 and replicated) at 128 rows a rank: the
    loss of the one-process step at 256 within 1e-4, and on each rank the
    block's 3 + 3 launches and one segment sum and two row writes a lazy
    table."""
    import dataclasses

    import chip_smoke as cs
    import torch_mesh_workers as workers
    from cikm2020_dmt_torch.core.mesh import run_ranks
    from cikm2020_dmt_torch.metrics.streaming import task_metrics_init
    from cikm2020_dmt_torch.train.loop import Trainer

    cfg = _lattice_cfg("mmoe_transformer_unbias")
    cfg = dataclasses.replace(
        cfg, shard_rows_threshold=10000, embeddings=tuple(
            dataclasses.replace(e, id_size=20000) if e.table == "Sku" else e
            for e in cfg.embeddings))
    batch = cs.synthetic_batch(cfg, 256, 3, "cpu")
    out = run_ranks(workers.card_mesh_step, 2, cfg, batch, timeout_s=300)
    tr = Trainer(cfg, device=cuda_device)
    st = tr.init_state(torch.Generator(device=cuda_device).manual_seed(0))
    _, _, loss = tr.train_step(st, task_metrics_init(cuda_device),
                               {k: v.to(cuda_device)
                                for k, v in batch.items()},
                               torch.Generator(device=cuda_device))
    for o in out:
        assert o["full_mesh"] == ["Sku"]
        assert abs(o["loss"] - float(loss)) <= 1e-4 * abs(float(loss))
        assert o["counts"] == {
            "fused_block_fwd": 3, "fused_block_bwd": 3, "attention_fwd": 0,
            "attention_bwd": 0, "sorted_segsum": 4, "update_rows": 4,
            "update_rows_3d": 4, "adam_dense": _adam_launches(cfg)}


@pytest.mark.cuda
def test_sharded_write_back_sentinel_on_card(cuda_device):
    """``lazy_adam_rows_sharded``'s write-back on the card, model index 1
    of 2 holding rows [64, 128) of a 128-row table: ids of the other
    share, sentinels past R and the id one past the share (which in the
    [2, R, D] moments would name row 0 of v) are all dropped; the owned
    rows are the plain version's."""
    from cikm2020_dmt_torch.core.mesh import Mesh
    from cikm2020_dmt_torch.train.lazy import lazy_adam_rows_sharded

    gen = torch.Generator().manual_seed(5)
    R, D = 128, 32
    table = torch.randn(R // 2, D, generator=gen)
    mv = torch.rand(2, R // 2, D, generator=gen)
    # ascending: 3 rows of the other share, 4 owned, the one past the
    # share (logical 128 = R: the lazy sentinel) and sentinels beyond
    uids = torch.tensor([0, 31, 63, 64, 65, 100, 127, 128, 129, 130])
    rows = torch.randn(len(uids), D, generator=gen)
    g = torch.randn(len(uids), D, generator=gen)
    count = torch.tensor(3)

    def run(dev):
        mesh = Mesh(1, 2, 1, torch.device(dev), "gloo")
        t, m = table.clone().to(dev), mv.clone().to(dev)
        lazy_adam_rows_sharded(mesh, t, m, uids.to(dev), rows.to(dev),
                               g.to(dev), count.to(dev),
                               lambda c: torch.tensor(1e-3, device=dev), R,
                               1)
        return t.cpu(), m.cpu()

    t_card, mv_card = run(cuda_device)
    t_cpu, mv_cpu = run("cpu")
    owned = torch.tensor([0, 1, 36, 63])          # 64, 65, 100, 127
    others = torch.ones(R // 2, dtype=torch.bool)
    others[owned] = False
    assert torch.equal(t_card[others], table[others])
    assert torch.equal(mv_card[:, others], mv[:, others])
    torch.testing.assert_close(t_card, t_cpu, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(mv_card, mv_cpu, rtol=1e-6, atol=1e-9)
    assert not torch.equal(t_card[owned], table[owned])


@pytest.mark.cuda
def test_model_axis_step_on_card(cuda_device):
    """A ``(1, 2)`` mesh of two gloo ranks sharing the card, one step of
    ``conf/dmt.conf``'s model (Sku cut to 20,000 rows, lazy and full-mesh;
    Cid3, Brand and Shopid cut to 5,000 rows, dense and split over the
    model group) at the one-process step's 256 rows: the loss within
    1e-4, the replicated leaves the same bits on both ranks, and on each
    rank the block's 3 + 3 launches, Sku's two row writes and 16 segment
    sums: Sku's overlay and the 15 seq lookups of the split tables that
    take the exchange (the three of length 10 overflow their budget of
    320 ids and take the grid sum; a CPU rehearsal of this batch counts
    the same)."""
    import dataclasses

    import chip_smoke as cs
    import torch_mesh_workers as workers
    from cikm2020_dmt_torch.core.mesh import run_ranks
    from cikm2020_dmt_torch.metrics.streaming import task_metrics_init
    from cikm2020_dmt_torch.train.loop import Trainer

    cfg = _lattice_cfg("mmoe_transformer_unbias")
    cfg = dataclasses.replace(
        cfg, shard_rows_threshold=1000, dedup_rows_threshold=10000,
        mesh_model=2, embeddings=tuple(
            dataclasses.replace(e, id_size=20000) if e.table == "Sku" else e
            for e in cfg.embeddings))
    batch = cs.synthetic_batch(cfg, 256, 3, "cpu")
    out = run_ranks(workers.card_mesh_step, 2, cfg, batch, timeout_s=300)
    tr = Trainer(cfg, device=cuda_device)
    st = tr.init_state(torch.Generator(device=cuda_device).manual_seed(0))
    _, _, loss = tr.train_step(st, task_metrics_init(cuda_device),
                               {k: v.to(cuda_device)
                                for k, v in batch.items()},
                               torch.Generator(device=cuda_device))
    for o in out:
        assert o["full_mesh"] == ["Sku"]
        assert o["split"] == ["Brand", "Cid3", "Shopid", "bias:Cid3"]
        assert abs(o["loss"] - float(loss)) <= 1e-4 * abs(float(loss))
        assert o["counts"] == {
            "fused_block_fwd": 3, "fused_block_bwd": 3, "attention_fwd": 0,
            "attention_bwd": 0, "sorted_segsum": 16, "update_rows": 1,
            "update_rows_3d": 1, "adam_dense": _adam_launches(cfg)}
    mine, other = out[0]["replicated"], out[1]["replicated"]
    assert set(mine) == set(other)
    assert [k for k in mine if not torch.equal(mine[k], other[k])] == []


def _bench_cfg(grid_bf16):
    """``chip_smoke.bench_config`` with Sku cut to 40,000 rows (lazy Adam
    from 10,000 rows, so Sku alone)."""
    import dataclasses

    import chip_smoke as cs
    return dataclasses.replace(
        cs.bench_config(grid_bf16, sku_rows=40_000),
        dedup_rows_threshold=10_000)


@pytest.mark.cuda
@pytest.mark.parametrize("grid_bf16", [False, True],
                         ids=["bf16_tables", "grid_bf16"])
def test_bf16_step_matches_cpu_on_card(grid_bf16, cuda_device):
    """One bfloat16 step of ``bench.py``'s config (Sku cut) on the card
    against the CPU by ``chip_smoke.bf16_card_vs_cpu_step``'s rule (which
    raises past it): the card's step launches 3 block forwards and
    backwards and the lazy update's three kernels, nothing else; under
    ``grid_bf16`` the tables stay float32.  The Trainer has turned off
    cuBLAS's bfloat16 reductions (``models/base.float32_sums``): with them
    on, 3 of 6 such checks at batch 256 failed on an H100."""
    import chip_smoke as cs

    cfg = _bench_cfg(grid_bf16)
    cs.reset_counts()
    check = cs.bf16_card_vs_cpu_step(cfg, cuda_device)
    assert cs.read_counts() == {
        "fused_block_fwd": 3, "fused_block_bwd": 3, "attention_fwd": 0,
        "attention_bwd": 0, "sorted_segsum": 1, "update_rows": 1,
        "update_rows_3d": 1, "adam_dense": _adam_launches(cfg)}
    assert check["grad_err_over_tol"] <= 1.0
    assert check["leaves_checked"] > 100
    # the Trainer on the card sums bfloat16 products in float32
    matmul = torch.backends.cuda.matmul
    assert not matmul.allow_bf16_reduced_precision_reduction


@pytest.mark.cuda
def test_onehot_bf16_lookup_on_card(cuda_device):
    """``onehot_bwd_bf16`` on the card: a small float32 table's gradient
    under bfloat16 compute is the float32 sum of the bfloat16-rounded
    cotangents, as on the CPU (within float32 sum order), not the sum of
    the unrounded ones."""
    import dataclasses

    from cikm2020_dmt_torch.parallel.embedding_shard import EmbeddingEngine

    cfg = dataclasses.replace(_bench_cfg(False), onehot_bwd_bf16=True)
    gen = torch.Generator().manual_seed(0)
    table = torch.randn(500, 8, generator=gen)
    ids = torch.randint(0, 500, (256, 50), generator=gen)
    g = torch.randn(256, 50, 8, generator=gen)
    grads = []
    for dev in ("cpu", cuda_device):
        t = table.to(dev, copy=True).requires_grad_()
        EmbeddingEngine(cfg)._take("Cid2", t, ids.to(dev), "item_c2").backward(
            g.to(dev))
        grads.append(t.grad.cpu())
    plain = torch.zeros_like(table).index_add_(0, ids.reshape(-1),
                                               g.reshape(-1, 8))
    scale = float(grads[0].abs().max())
    assert float((grads[1] - grads[0]).abs().max()) <= 1e-6 * scale
    assert float((plain - grads[0]).abs().max()) > 1e-4 * scale
