"""The port's Deep-Interest-Transformer block (plain PyTorch, CPU) against
the JAX reference: the per-op jnp ``encode_decode`` path and the Pallas
fused-block kernel run in interpret mode, on the same numpy inputs and the
same weights.  The CUDA kernel itself is held against the same plain
version on the card by ``chip_smoke.py`` and ``tests/test_torch_cuda.py``."""

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
from cikm2020_dmt_torch.ops import block as tblock  # noqa: E402

D, H, F, T, TS = 16, 2, 32, 10, 8
MODES = ("position_sin_cos", "position_learn", "time_add", "time_concat")


def _cfgs(**kw):
    base = dict(d_model=D, num_heads=H, d_ff=F, maxlen_k=T, maxlen_q=1,
                num_blocks_encode=1, num_blocks_decode=1, dropout_rate=0.0)
    base.update(kw)
    return JTC(**base), TTC(**base)


def _inputs(lens, seed=0):
    rng = np.random.default_rng(seed)
    B = len(lens)
    seq = rng.normal(size=(B, T, D)).astype(np.float32)
    tar = rng.normal(size=(B, D)).astype(np.float32)
    ts = rng.normal(size=(B, T, TS)).astype(np.float32)
    mask = (np.arange(T)[None] < np.asarray(lens)[:, None]).astype(np.float32)
    return seq, tar, ts, mask


def _jax(params, tc, seq, tar, ts, mask, monkeypatch, fused: bool):
    monkeypatch.setenv("DMT_FUSED_BLOCK", "1" if fused else "0")

    def fn(params, seq, mask, tar, ts):
        return jtrans.encode_decode(params, tc, seq_emb=seq, seq_mask=mask,
                                    tar_emb=tar, ts_emb=ts, train=False)

    # one compile instead of one per op; the flag is read while tracing
    return np.asarray(jax.jit(fn)(params, seq, mask, tar, ts))


def _port(params, tc, seq, tar, ts, mask):
    out = ttrans.encode_decode(tree_to_tensors(params), tc,
                               seq_emb=torch.from_numpy(seq),
                               seq_mask=torch.from_numpy(mask),
                               tar_emb=torch.from_numpy(tar),
                               ts_emb=torch.from_numpy(ts))
    return out.numpy()


def _np_params(tc, seed):
    p = jtrans.transformer_init(jax.random.PRNGKey(seed), tc, ts_dim=TS)
    return jax.tree_util.tree_map(np.asarray, p)


# lens 1..T and an odd batch (11 rows)
LENS = list(range(1, T + 1)) + [3]


@pytest.mark.parametrize("fused_oracle", [False, True],
                         ids=["jnp", "pallas_interpret"])
@pytest.mark.parametrize("mode", MODES)
def test_block_matches_jax(mode, fused_oracle, monkeypatch):
    jtc, ttc = _cfgs(position_encoding_method=mode,
                     is_decoder_add_pos_emb=(mode == "position_sin_cos"))
    params = _np_params(jtc, seed=MODES.index(mode))
    seq, tar, ts, mask = _inputs(LENS, seed=1)
    want = _jax(params, jtc, seq, tar, ts, mask, monkeypatch, fused_oracle)
    got = _port(params, ttc, seq, tar, ts, mask)
    assert got.shape == (len(LENS), D)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_len0_row_matches_jnp_path(monkeypatch):
    """A sequence with no present key (a user with no history) gets a
    uniform softmax over its T real positions, as in the jnp path.  The
    Pallas wrapper pads T to a multiple of 8 first, so its uniform softmax
    runs over the padded length and disagrees on such rows: it is not the
    oracle here."""
    jtc, ttc = _cfgs(position_encoding_method="position_learn")
    params = _np_params(jtc, seed=7)
    seq, tar, ts, mask = _inputs([0, 4, 0, T], seed=2)
    want = _jax(params, jtc, seq, tar, ts, mask, monkeypatch, fused=False)
    got = _port(params, ttc, seq, tar, ts, mask)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    # the padded Pallas path agrees on rows with keys, not on len-0 rows
    padded = _jax(params, jtc, seq, tar, ts, mask, monkeypatch, fused=True)
    np.testing.assert_allclose(padded[[1, 3]], want[[1, 3]], rtol=2e-5,
                               atol=2e-5)
    assert np.abs(padded[[0, 2]] - want[[0, 2]]).max() > 1e-2


def test_multi_block_per_op_path(monkeypatch):
    """Two encoder blocks take the per-op path (mha_apply / ff_apply),
    which the reference's jnp path defines."""
    jtc, ttc = _cfgs(position_encoding_method="position_sin_cos",
                     num_blocks_encode=2)
    params = _np_params(jtc, seed=3)
    seq, tar, ts, mask = _inputs([1, 5, 10, 0, 7], seed=3)
    want = _jax(params, jtc, seq, tar, ts, mask, monkeypatch, fused=False)
    got = _port(params, ttc, seq, tar, ts, mask)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_bf16_plain_version_matches_pallas_rounding():
    """With bfloat16 inputs the plain version rounds every product operand
    to bfloat16 where the TPU kernel does (f32 sums, softmax and LN).
    Both round the bf16 output, so they agree to one or two bf16 ulps."""
    jtc, _ = _cfgs()
    params = _np_params(jtc, seed=4)
    seq, tar, _, mask = _inputs(LENS, seed=4)
    enc = jnp.asarray(seq, jnp.bfloat16)
    dec = jnp.asarray(tar, jnp.bfloat16)
    want = j_fused(params["enc"][0], params["dec"][0], enc_in=enc,
                   dec_in=dec, seq_mask=jnp.asarray(mask), num_heads=H,
                   dropout=0.0, train=False, interpret=True)
    tp = tree_to_tensors(params)
    got = tblock.fused_encode_decode(
        tp["enc"][0], tp["dec"][0],
        enc_in=torch.from_numpy(np.array(enc.astype(jnp.float32))
                                ).to(torch.bfloat16),
        dec_in=torch.from_numpy(np.array(dec.astype(jnp.float32))
                                ).to(torch.bfloat16),
        seq_mask=torch.from_numpy(mask), num_heads=H)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=2e-2, atol=2e-2)


def test_block_work_counts():
    """The bound's operation count at the serving shape (T=50, D=80,
    F=320): about 9.2 MFLOP per example."""
    per_example = tblock.block_flops(1, 50, 80, 320)
    assert 9.0e6 < per_example < 9.6e6
    assert tblock.block_bytes(300, 50, 80, 320, 4) > 300 * 50 * 80 * 4
