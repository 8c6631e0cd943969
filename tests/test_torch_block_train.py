"""The fused block in training: the port's plain backward
(``fused_block_bwd_ref``) against the JAX Pallas kernel's gradients in
interpret mode and against the reference's jnp path, and the dropout masks
that the kernels share with the plain versions.  The CUDA kernels are held
against these plain versions on the card by ``chip_smoke.py`` and
``tests/test_torch_cuda.py``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cikm2020_dmt_tpu.core.config import TransformerConfig as JTC  # noqa: E402
from cikm2020_dmt_tpu.nn import transformer as jtrans  # noqa: E402
from cikm2020_dmt_tpu.ops.block import fused_encode_decode as j_fused  # noqa: E402
from cikm2020_dmt_torch.convert import tree_to_tensors  # noqa: E402
from cikm2020_dmt_torch.core.config import TransformerConfig as TTC  # noqa: E402
from cikm2020_dmt_torch.nn import transformer as ttrans  # noqa: E402
from cikm2020_dmt_torch.ops import block  # noqa: E402

D, H, F, T = 16, 2, 32, 10
# lens 1..T and an odd batch (11 rows)
LENS = list(range(1, T + 1)) + [3]


def _params(seed):
    tc = JTC(d_model=D, num_heads=H, d_ff=F, maxlen_k=T, maxlen_q=1,
             num_blocks_encode=1, num_blocks_decode=1, dropout_rate=0.0,
             position_encoding_method="position_learn")
    p = jtrans.transformer_init(jax.random.PRNGKey(seed), tc)
    return tc, jax.tree_util.tree_map(np.asarray, p)


def _inputs(lens, seed):
    rng = np.random.default_rng(seed)
    B = len(lens)
    enc = rng.normal(size=(B, T, D)).astype(np.float32)
    dec = rng.normal(size=(B, D)).astype(np.float32)
    g = rng.normal(size=(B, D)).astype(np.float32)
    mask = (np.arange(T)[None] < np.asarray(lens)[:, None]).astype(np.float32)
    return enc, dec, g, mask


def _packed(tree):
    return block.pack_weights(tree_to_tensors(tree))


def _assert_grads(got, want, rtol, atol):
    names = ("d_enc", "d_dec", "wqkv", "vecs", "w1", "b1", "w2") + tuple(
        "dec_" + n for n in ("wqkv", "vecs", "w1", "b1", "w2"))
    for name, a, b in zip(names, got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                                   atol=atol, err_msg=name)


def test_plain_backward_matches_pallas_kernel():
    """Float32, no dropout: the plain backward against jax.vjp through the
    TPU kernel (Pallas interpret mode) on the same inputs and weights."""
    _, p = _params(0)
    enc, dec, g, mask = _inputs(LENS, 1)

    def f(ep, dp, e, d):
        return j_fused(ep, dp, enc_in=e, dec_in=d, seq_mask=jnp.asarray(mask),
                       num_heads=H, dropout=0.0, train=False, interpret=True)

    _, vjp = jax.vjp(f, p["enc"][0], p["dec"][0], jnp.asarray(enc),
                     jnp.asarray(dec))
    gep, gdp, ge, gd = vjp(jnp.asarray(g))
    want = [ge, gd] + [t.numpy() for t in _packed(gep) + _packed(gdp)]
    d_enc, d_dec, gw = block.fused_block_bwd_ref(
        _packed(p["enc"][0]), _packed(p["dec"][0]),
        enc_in=torch.from_numpy(enc), dec_in=torch.from_numpy(dec),
        seq_mask=torch.from_numpy(mask), g=torch.from_numpy(g), num_heads=H)
    assert all(t.dtype == torch.float32 for t in gw)
    _assert_grads([d_enc, d_dec] + [t.numpy() for t in gw], want,
                  rtol=2e-4, atol=1e-4)


def test_plain_backward_matches_autograd_with_dropout():
    """Dropout on: the explicit backward against torch.autograd through the
    plain forward, which draws the same masks from the same seed."""
    _, p = _params(1)
    enc, dec, g, mask = _inputs([0] + LENS, 2)
    tp = tree_to_tensors(p)
    for leaf in jax.tree_util.tree_leaves(
            tp, is_leaf=lambda x: isinstance(x, torch.Tensor)):
        leaf.requires_grad_()
    e = torch.from_numpy(enc).requires_grad_()
    d = torch.from_numpy(dec).requires_grad_()
    kw = dict(seq_mask=torch.from_numpy(mask), num_heads=H, train=True,
              rate=0.3, seed=torch.tensor([77], dtype=torch.int32))
    out = block.fused_encode_decode_ref(tp["enc"][0], tp["dec"][0],
                                        enc_in=e, dec_in=d, **kw)
    out.backward(torch.from_numpy(g))
    want = [e.grad, d.grad] + list(
        block.pack_weights(jax.tree_util.tree_map(
            lambda t: t.grad, tp["enc"][0],
            is_leaf=lambda x: isinstance(x, torch.Tensor)))) + list(
        block.pack_weights(jax.tree_util.tree_map(
            lambda t: t.grad, tp["dec"][0],
            is_leaf=lambda x: isinstance(x, torch.Tensor))))
    d_enc, d_dec, gw = block.fused_block_bwd_ref(
        _packed(p["enc"][0]), _packed(p["dec"][0]), enc_in=e.detach(),
        dec_in=d.detach(), g=torch.from_numpy(g), **kw)
    _assert_grads([d_enc, d_dec] + list(gw),
                  [t.detach() for t in want], rtol=1e-5, atol=1e-5)
    # the dropout really dropped: the eval-mode gradient differs
    d_eval = block.fused_block_bwd_ref(
        _packed(p["enc"][0]), _packed(p["dec"][0]), enc_in=e.detach(),
        dec_in=d.detach(), g=torch.from_numpy(g), seq_mask=kw["seq_mask"],
        num_heads=H)[0]
    assert (d_eval - d_enc).abs().max() > 1e-2
    assert (d_enc == 0).float().mean() > 0.2


def test_len0_row_gradients_match_jnp_path(monkeypatch):
    """Through ``encode_decode`` (position encoding included), with rows of
    length 0: the port's gradients against jax.vjp of the reference's jnp
    path.  A masked key's score is a constant there, so no gradient reaches
    it; the Pallas kernel lets it through on len-0 rows and is not the
    oracle here."""
    monkeypatch.setenv("DMT_FUSED_BLOCK", "0")
    tc, p = _params(2)
    enc, dec, g, mask = _inputs([0, 4, 0, T, 1], 3)

    def f(params, s, t):
        return jtrans.encode_decode(params, tc, seq_emb=s,
                                    seq_mask=jnp.asarray(mask), tar_emb=t,
                                    train=False)

    _, vjp = jax.vjp(f, p, jnp.asarray(enc), jnp.asarray(dec))
    gp, gs, gt = vjp(jnp.asarray(g))
    tp = tree_to_tensors(p)
    leaves = jax.tree_util.tree_leaves(
        tp, is_leaf=lambda x: isinstance(x, torch.Tensor))
    for leaf in leaves:
        leaf.requires_grad_()
    s = torch.from_numpy(enc).requires_grad_()
    t = torch.from_numpy(dec).requires_grad_()
    out = ttrans.encode_decode(
        tp, TTC(**{k: getattr(tc, k) for k in tc.__dataclass_fields__}),
        seq_emb=s, seq_mask=torch.from_numpy(mask), tar_emb=t)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(s.grad.numpy(), np.asarray(gs), rtol=2e-4,
                               atol=1e-4)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(gt), rtol=2e-4,
                               atol=1e-4)
    for a, b in zip(leaves, jax.tree_util.tree_leaves(gp)):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), rtol=2e-4,
                                   atol=1e-4)


def _lowbias32_int(x: int) -> int:
    """lowbias32 on Python integers, with explicit 32-bit wrapping."""
    m = 0xFFFFFFFF
    x ^= x >> 16
    x = (x * 0x7FEB352D) & m
    x ^= x >> 15
    x = (x * 0x846CA68B) & m
    return x ^ (x >> 16)


def test_mask_hash_is_uint32_arithmetic():
    """The int64 tensor hash equals the 32-bit hash the kernels compute."""
    xs = [0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1, 123456789, 0xDEADBEEF]
    got = block.lowbias32(torch.tensor(xs, dtype=torch.int64)).tolist()
    assert got == [_lowbias32_int(x) for x in xs]
    seed, site, rate = 1234, 1 * 16 + 1, 0.25
    mask = block.dropout_mask(seed, site, 3, 4, 5, rate, "cpu")
    key = _lowbias32_int((seed + site * 0x9E3779B9) & 0xFFFFFFFF)
    thr = block.keep_threshold(rate)
    for b in range(3):
        ex = _lowbias32_int(key ^ b)
        for r in range(4):
            for c in range(5):
                kept = (_lowbias32_int(ex ^ (r << 16 | c)) >> 8) < thr
                assert float(mask[b, r, c]) == (
                    np.float32(1 / (1 - rate)) if kept else 0.0)


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_keep_rate_and_scale(rate):
    """The kept fraction within 5 binomial standard deviations of
    1 - rate, kept values scaled by 1 / (1 - rate) in float32, sites and
    seeds independent, and the same mask for the same arguments."""
    m = block.dropout_mask(7, block.SITE_ENC_IN, 64, 50, 80, rate, "cpu")
    n = m.numel()
    kept = float((m > 0).float().sum())
    p = 1 - rate
    assert abs(kept - n * p) < 5 * np.sqrt(n * p * (1 - p))
    scale = torch.tensor(1 / (1 - rate), dtype=torch.float32)
    assert set(m.unique().tolist()) == {0.0, float(scale)}
    again = block.dropout_mask(7, block.SITE_ENC_IN, 64, 50, 80, rate, "cpu")
    assert torch.equal(m, again)
    other_site = block.dropout_mask(7, block.SITE_DEC_IN, 64, 50, 80, rate,
                                    "cpu")
    other_seed = block.dropout_mask(8, block.SITE_ENC_IN, 64, 50, 80, rate,
                                    "cpu")
    for o in (other_site, other_seed):
        agree = float(((o > 0) == (m > 0)).float().mean())
        assert abs(agree - (p * p + (1 - p) * (1 - p))) < 0.01


def test_backward_work_counts():
    """The backward's bound: 3x the forward's operations, ~28 MFLOP per
    example at T=50, D=80, F=320."""
    assert block.block_bwd_flops(1, 50, 80, 320) == 3 * block.block_flops(
        1, 50, 80, 320)
    assert 2.7e7 < block.block_bwd_flops(1, 50, 80, 320) < 2.9e7
    assert block.block_bwd_bytes(2048, 50, 80, 320, 4) > 2 * 2048 * 50 * 80 * 4
