"""The port's attention core (``ops/attention.py``, plain PyTorch on the
CPU) against the JAX package: the Pallas kernel ``fused_attention`` run in
interpret mode, as ``tests/test_pallas_ops.py`` runs it, and the per-op
``attention_core``, on the same numpy inputs.  The CUDA kernels are held
against the same plain versions on the card by ``chip_smoke.py`` and
``tests/test_torch_cuda.py``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cikm2020_dmt_tpu.nn.transformer import attention_core as j_core  # noqa: E402
from cikm2020_dmt_tpu.ops.attention import fused_attention as j_fused  # noqa: E402
from cikm2020_dmt_torch.nn.transformer import attention_core  # noqa: E402
from cikm2020_dmt_torch.ops import attention as tatt  # noqa: E402

D, H = 80, 4
# (Tq, Tk, query lens, key lens): the encoder (self-attention, query mask
# = key mask), the decoder (one query over the keys) and the cart's T=10
SHAPES = {
    "encoder_T50": (50, 50, None, [50, 17, 1, 33]),
    "decoder_T50": (1, 50, [1, 1, 1, 1], [50, 8, 2, 25]),
    "encoder_T10": (10, 10, None, [10, 4, 7, 1]),
}


def _case(Tq, Tk, qlens, klens, seed):
    rng = np.random.default_rng(seed)
    B = len(klens)
    qlens = klens if qlens is None else qlens
    q, k, v = (rng.normal(size=(B, t, D)).astype(np.float32)
               for t in (Tq, Tk, Tk))
    qm = (np.arange(Tq)[None] < np.asarray(qlens)[:, None]).astype(np.float32)
    km = (np.arange(Tk)[None] < np.asarray(klens)[:, None]).astype(np.float32)
    tgt = rng.normal(size=(B, Tq, D)).astype(np.float32)
    return q, k, v, qm, km, tgt


def _port(q, k, v, qm, km, requires_grad=False):
    ts = [torch.from_numpy(x).requires_grad_(requires_grad)
          for x in (q, k, v)]
    return ts, tatt.fused_attention(*ts, torch.from_numpy(qm),
                                    torch.from_numpy(km), H)


def _jax_kernel(q, k, v, qm, km):
    return j_fused(q, k, v, jnp.asarray(qm), jnp.asarray(km), H,
                   interpret=True)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_forward_matches_jax_kernel(shape):
    Tq, Tk, ql, kl = SHAPES[shape]
    q, k, v, qm, km, _ = _case(Tq, Tk, ql, kl, seed=list(SHAPES).index(shape))
    want = np.asarray(_jax_kernel(q, k, v, qm, km))
    _, got = _port(q, k, v, qm, km)
    assert got.shape == want.shape and got.dtype == torch.float32
    # every row here has a present key: the kernel and the port agree
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def _loss_grads_port(q, k, v, qm, km, tgt):
    ts, out = _port(q, k, v, qm, km, requires_grad=True)
    loss = (((out - torch.from_numpy(tgt)) ** 2)
            * torch.from_numpy(qm)[..., None]).sum()
    return [g.numpy() for g in torch.autograd.grad(loss, ts)]


def _loss_grads_jax(fn, q, k, v, qm, km, tgt):
    def loss(q, k, v):
        return jnp.sum((fn(q, k, v, qm, km) - tgt) ** 2 * qm[..., None])
    return [np.asarray(g) for g in
            jax.grad(loss, argnums=(0, 1, 2))(q, k, v)]


@pytest.mark.parametrize("shape", list(SHAPES))
def test_gradients_match_jax_kernel(shape):
    """The hand-written backward against ``jax.grad`` through the Pallas
    kernel's custom VJP, with ``test_pallas_ops.py``'s tolerances."""
    Tq, Tk, ql, kl = SHAPES[shape]
    q, k, v, qm, km, tgt = _case(Tq, Tk, ql, kl, seed=10)
    want = _loss_grads_jax(_jax_kernel, q, k, v, qm, km, tgt)
    got = _loss_grads_port(q, k, v, qm, km, tgt)
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5,
                                   err_msg=f"d{name}")


def _j_core(q, k, v, qm, km):
    return j_core(q, k, v, jnp.asarray(qm), jnp.asarray(km), H)


@pytest.mark.parametrize("Tq", [50, 1])
def test_len0_rows_match_jnp_path(Tq):
    """Rows with no present key (users with no history): the port follows
    ``attention_core`` in value and gradient (uniform softmax over the Tk
    real keys, no gradient through masked keys).  The Pallas kernel pads
    Tk=50 to 56, so its uniform softmax spans 56 positions and disagrees on
    such rows; it agrees on the others."""
    klens = [0, 13, 0, 50]
    q, k, v, qm, km, tgt = _case(Tq, 50, [1] * 4 if Tq == 1 else None,
                                 klens, seed=20)
    if Tq == 50:
        qm = np.ones_like(qm)  # keep the len-0 rows' queries present
    want = np.asarray(_j_core(q, k, v, qm, km))
    _, got = _port(q, k, v, qm, km)
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    gw = _loss_grads_jax(_j_core, q, k, v, qm, km, tgt)
    gp = _loss_grads_port(q, k, v, qm, km, tgt)
    for name, a, b in zip("qkv", gp, gw):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5,
                                   err_msg=f"d{name}")
    # a masked key's score gets no gradient; its value gets one only on a
    # len-0 row, whose uniform probabilities reach it
    dk, dv = gp[1], gp[2]
    assert (dk[0] == 0).all() and (dk[1][13:] == 0).all()
    assert (dv[1][13:] == 0).all() and (dv[0] != 0).any()
    kernel = np.asarray(_jax_kernel(q, k, v, qm, km))
    np.testing.assert_allclose(kernel[[1, 3]], want[[1, 3]], rtol=2e-5,
                               atol=2e-5)
    assert np.abs(kernel[[0, 2]] - want[[0, 2]]).max() > 1e-2


BF16_ULP = 2.0 ** -7  # spacing of bfloat16 values in [1, 2)


def _ulp(x):
    """bfloat16 spacing at |x| (the spacing at 2**-20 below that)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -20)))
    return BF16_ULP * 2.0 ** e


@pytest.mark.parametrize("shape", list(SHAPES))
def test_bf16_matches_jax_kernel(shape):
    """bfloat16 inputs: both round the probabilities to bfloat16 before
    P v and round the output; sums in float32 taken in another order can
    flip a rounding, so they agree to two bfloat16 ulps of the larger."""
    Tq, Tk, ql, kl = SHAPES[shape]
    q, k, v, qm, km, _ = _case(Tq, Tk, ql, kl, seed=30)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = np.asarray(_jax_kernel(jq, jk, jv, qm, km).astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(np.array(x.astype(jnp.float32))
                                   ).to(torch.bfloat16) for x in (jq, jk, jv))
    got = tatt.fused_attention(tq, tk, tv, torch.from_numpy(qm),
                               torch.from_numpy(km), H)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    diff = np.abs(got - want)
    assert (diff <= 2 * _ulp(np.maximum(np.abs(got), np.abs(want)))).all(), \
        float(diff.max())


def test_bf16_backward_rounds_like_jax_kernel():
    """The bfloat16 backward (dS and the probabilities rounded to bfloat16
    before their products, as the TPU kernel does) against ``jax.grad``
    through the Pallas kernel in bfloat16, to two bfloat16 ulps of each
    gradient's largest value."""
    Tq, Tk, ql, kl = SHAPES["encoder_T10"]
    q, k, v, qm, km, tgt = _case(Tq, Tk, ql, kl, seed=40)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    do = jnp.asarray(tgt, jnp.bfloat16)
    _, vjp = jax.vjp(lambda a, b, c: _jax_kernel(a, b, c, qm, km), jq, jk, jv)
    want = [np.asarray(g.astype(jnp.float32)) for g in vjp(do)]
    to_t = (lambda x: torch.from_numpy(np.array(x.astype(jnp.float32)))
            .to(torch.bfloat16))
    got = tatt.fused_attention_bwd(to_t(jq), to_t(jk), to_t(jv),
                                   torch.from_numpy(qm), torch.from_numpy(km),
                                   to_t(do), H)
    for name, a, b in zip("qkv", got, want):
        assert a.dtype == torch.bfloat16
        tol = 2 * _ulp(np.abs(b).max())
        np.testing.assert_allclose(a.float().numpy(), b, rtol=0, atol=tol,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("shape", list(SHAPES))
def test_bf16_forward_check_tells_sum_order_from_rounding_points(shape):
    """The card's bfloat16 forward check (``chip_smoke``) passes the plain
    version with its keys permuted (the same math, float32 sums in another
    order, as in the kernel) and fails a version that skips rounding the
    probabilities to bfloat16 before P v, by the share of elements that
    differ."""
    from chip_smoke import ATT_BF16_DIFF_SHARE, bf16_attention_fwd_check
    Tq, Tk, _, _ = SHAPES[shape]
    B = 128
    klens = np.arange(B) % (Tk + 1)
    q, k, v, qm, km, _ = _case(Tq, Tk, None if Tq == Tk else [1] * B, klens,
                               seed=60)
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    qm, km = torch.from_numpy(qm), torch.from_numpy(km)
    ref = tatt.fused_attention_ref(q, k, v, qm, km, H)
    perm = torch.randperm(Tk, generator=torch.Generator().manual_seed(0))
    reordered = tatt.fused_attention_ref(q, k[:, perm], v[:, perm], qm,
                                         km[:, perm], H)
    ratio, share = bf16_attention_fwd_check(reordered, ref, q, k, v, qm, km)
    assert ratio <= 1.0 and share <= ATT_BF16_DIFF_SHARE, (ratio, share)
    unrounded = tatt.attend(q.float(), k.float(), v.float(), km, qm, None, H,
                            lambda t: t).to(torch.bfloat16)
    _, share = bf16_attention_fwd_check(unrounded, ref, q, k, v, qm, km)
    assert share > 10 * ATT_BF16_DIFF_SHARE, share


def test_attention_core_without_dropout_is_the_plain_version():
    """One copy of the math: the dropout core of training, ``attention_core``,
    with its draw at rate 0 returns what the kernel's plain version returns,
    so the two paths differ only by the dropout mask."""
    q, k, v, qm, km, _ = _case(10, 10, None, [10, 4, 0, 2], seed=50)
    args = [torch.from_numpy(x) for x in (q, k, v, qm, km)]
    got = attention_core(*args, H, dropout=0.0,
                         gen=torch.Generator().manual_seed(0))
    torch.testing.assert_close(got, tatt.fused_attention_ref(*args, H),
                               rtol=0, atol=0)


def test_work_counts():
    """The bounds' counts at B=2048, d_model 80: the encoder at T=50 does
    1.64 GFLOP over 131 MB, the decoder (Tq=1, Tk=50) moves 67 MB, the
    encoder's backward does 4.1 GFLOP over 229 MB (float32)."""
    assert tatt.attention_flops(2048, 50, 50, 80) == 4 * 2048 * 2500 * 80
    assert round(tatt.attention_bytes(2048, 50, 50, 80, 4) / 1e6) == 132
    assert round(tatt.attention_bytes(2048, 1, 50, 80, 4) / 1e6) == 67
    assert tatt.attention_bwd_flops(2048, 50, 50, 80) == 10 * 2048 * 2500 * 80
    assert round(tatt.attention_bwd_bytes(2048, 50, 50, 80, 4) / 1e6) == 230
    assert tatt.attention_bytes(8, 10, 10, 80, 2) == \
        tatt.attention_bytes(8, 10, 10, 80, 4) - 2 * (4 * 8 * 10 * 80)


@pytest.mark.parametrize("which", ["forward", "backward"])
def test_wrappers_raise_off_cpu_and_cuda(which):
    """Only CPU tensors take the plain versions: any other device raises
    instead of falling back."""
    meta = torch.empty((2, 3, 8), device="meta")
    mask = torch.empty((2, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        if which == "forward":
            tatt.fused_attention(meta, meta, meta, mask, mask, 2)
        else:
            tatt.fused_attention_bwd(meta, meta, meta, mask, mask, meta, 2)
