"""Widths other than the model's, and the options the port refuses.

- ``grid_bf16`` and ``DMT_GRID_BF16=1`` (the JAX ``_lazy_step`` rounds
  the union grid of a float32 lazy table to bfloat16; the port read it as
  unported and refused it until it ported it): one CPU step with either
  gives the same bits, the table stays float32, and the step differs from
  one without them.  ``tests/test_torch_grid_bf16*.py`` hold it to JAX.
- The port's plain block and attention versions (the functions the CUDA
  kernels are held to on the card) against the JAX Pallas kernels in
  interpret mode at (D, F, heads, T) = (36, 100, 3, 7) and (64, 256, 2,
  60), forward and backward, and attention at Tk = 70 with heads of 72
  columns: float32, dropout 0, every sequence with a present key.
- The kernel libraries are keyed by their widths, and a shape the block
  kernels cannot take raises before any build.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import __graft_entry__ as g  # noqa: E402
from cikm2020_dmt_tpu.core.config import TransformerConfig as JTC  # noqa: E402
from cikm2020_dmt_tpu.nn import transformer as jtrans  # noqa: E402
from cikm2020_dmt_tpu.ops.attention import fused_attention as j_att  # noqa: E402
from cikm2020_dmt_tpu.ops.block import fused_encode_decode as j_block  # noqa: E402
from cikm2020_dmt_torch.convert import tree_to_tensors  # noqa: E402
from cikm2020_dmt_torch.ops import _build, block  # noqa: E402
from cikm2020_dmt_torch.ops import attention as tatt  # noqa: E402
from cikm2020_dmt_torch.train.loop import Trainer  # noqa: E402
from test_torch_serve import SMALL, port_cfg  # noqa: E402

# float32, dropout 0: the plain versions and the JAX kernels differ only
# in the order of float32 sums
TOL = 1e-5
WIDTHS = {"D36_F100_H3_T7": (36, 100, 3, 7),
          "D64_F256_H2_T60": (64, 256, 2, 60)}


def _port_config(**kw):
    return port_cfg(g._demo_config(**{**SMALL, **kw}))


GRID_KW = dict(table_bf16_threshold=0, dedup_rows_threshold=1000,
               batch_size=32)


def _grid_step(cfg):
    """One CPU step from a seeded init: (trainer, state)."""
    from cikm2020_dmt_torch.metrics.streaming import task_metrics_init
    tr = Trainer(cfg, device="cpu")
    state = tr.init_state(torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(v) for k, v in g.synthetic_batch(
        g._demo_config(**{**SMALL, **GRID_KW}), 32, seed=1).items()}
    state, _, _ = tr.train_step(state, task_metrics_init(), batch,
                                torch.Generator().manual_seed(0))
    return tr, state


def _flat(state):
    from cikm2020_dmt_torch.nn.layers import tree_map
    out = []
    tree_map(out.append, {k: v for k, v in state.items()
                          if k != "model_state"})
    return out


@pytest.mark.parametrize("how", ["config", "environment"])
def test_trainer_refuses_grid_bf16(how, monkeypatch):
    """(The name is the refusal it held until the knob was ported.)  The
    config knob and ``DMT_GRID_BF16=1``, read once when the Trainer is
    built, give the same bits after one step; the lazy Sku table stays
    float32, and the step differs from one without the knob."""
    monkeypatch.setenv("DMT_GRID_BF16", "0")
    _, off = _grid_step(_port_config(**GRID_KW))
    tr, state = _grid_step(_port_config(grid_bf16=True, **GRID_KW))
    if how == "environment":
        ref = state
        monkeypatch.setenv("DMT_GRID_BF16", "1")
        tr, state = _grid_step(_port_config(**GRID_KW))
        monkeypatch.setenv("DMT_GRID_BF16", "0")
        assert all(torch.equal(a, b)
                   for a, b in zip(_flat(state), _flat(ref)))
    assert tr.grid_bf16 and [t.name for t in tr.lazy_plan] == [
        "Sku", "Cid3", "Brand", "Shopid"]
    assert state["params"]["emb"]["Sku"].dtype == torch.float32
    assert state["lazy_opt"]["Sku"]["mv"].dtype == torch.float32
    assert not torch.equal(state["params"]["emb"]["Sku"],
                           off["params"]["emb"]["Sku"])


def test_trainer_takes_grid_bf16_off(monkeypatch):
    monkeypatch.setenv("DMT_GRID_BF16", "0")
    Trainer(_port_config(), device="cpu")


def _block_case(D, F, H, T, seed):
    tc = JTC(d_model=D, num_heads=H, d_ff=F, maxlen_k=T, maxlen_q=1,
             num_blocks_encode=1, num_blocks_decode=1, dropout_rate=0.0,
             position_encoding_method="position_learn")
    p = jax.tree_util.tree_map(
        np.array, jtrans.transformer_init(jax.random.PRNGKey(seed), tc))
    rng = np.random.default_rng(seed)
    # biases and layer-norm scales away from their init, so that a column
    # of the wrong width or head shows
    for side in ("enc", "dec"):
        for leaf in ("q", "k", "v"):
            b = p[side][0]["mha"][leaf]["b"]
            b[...] = rng.normal(scale=0.1, size=b.shape)
        for ln in (p[side][0]["mha"]["ln"], p[side][0]["ff"]["ln"]):
            ln["gamma"][...] += rng.normal(scale=0.1, size=ln["gamma"].shape)
            ln["beta"][...] = rng.normal(scale=0.1, size=ln["beta"].shape)
        p[side][0]["ff"]["fc1"]["b"][...] = rng.normal(
            scale=0.1, size=p[side][0]["ff"]["fc1"]["b"].shape)
    lens = np.array([T, 1, max(1, T // 2), max(1, T - 3)])
    B = len(lens)
    enc = rng.normal(size=(B, T, D)).astype(np.float32)
    dec = rng.normal(size=(B, D)).astype(np.float32)
    cot = rng.normal(size=(B, D)).astype(np.float32)
    mask = (np.arange(T)[None] < lens[:, None]).astype(np.float32)
    return p, enc, dec, cot, mask


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max() / max(1.0, np.abs(want).max())
    assert err <= TOL, f"{what}: {err:.3e} of max(1, |reference|)"


@pytest.mark.parametrize("shape", list(WIDTHS))
def test_plain_block_matches_pallas_kernel_at_width(shape):
    """The plain forward and backward of the fused block against the JAX
    kernel (Pallas interpret mode) and jax.vjp through it, float32, dropout
    0; errors relative to max(1, the output's largest |value|)."""
    D, F, H, T = WIDTHS[shape]
    p, enc, dec, cot, mask = _block_case(D, F, H, T, seed=D + T)

    def f(ep, dp, e, d):
        return j_block(ep, dp, enc_in=e, dec_in=d, seq_mask=jnp.asarray(mask),
                       num_heads=H, dropout=0.0, train=False, interpret=True)

    want, vjp = jax.vjp(f, p["enc"][0], p["dec"][0], jnp.asarray(enc),
                        jnp.asarray(dec))
    gep, gdp, ge, gd = vjp(jnp.asarray(cot))
    ew = block.pack_weights(tree_to_tensors(p["enc"][0]))
    dw = block.pack_weights(tree_to_tensors(p["dec"][0]))
    kw = dict(enc_in=torch.from_numpy(enc), dec_in=torch.from_numpy(dec),
              seq_mask=torch.from_numpy(mask), num_heads=H)
    got = block._fwd_ref(ew, dw, kw["enc_in"], kw["dec_in"], kw["seq_mask"],
                         H, False, 0.0, None)
    _close(got.numpy(), want, "forward")
    d_enc, d_dec, gw = block.fused_block_bwd_ref(ew, dw,
                                                 g=torch.from_numpy(cot), **kw)
    wants = [ge, gd] + [t.numpy() for t in
                        block.pack_weights(tree_to_tensors(gep))
                        + block.pack_weights(tree_to_tensors(gdp))]
    names = ("d_enc", "d_dec") + tuple(
        f"{s}.{n}" for s in ("enc", "dec")
        for n in ("wqkv", "vecs", "w1", "b1", "w2"))
    for name, a, b in zip(names, [d_enc, d_dec] + list(gw), wants):
        _close(a.numpy(), b, name)


@pytest.mark.parametrize("Tq,Tk,H,dh", [(70, 70, 2, 20), (1, 70, 1, 72),
                                        (12, 70, 2, 72)])
def test_plain_attention_matches_pallas_kernel_past_the_tilings(Tq, Tk, H,
                                                                 dh):
    """Past 64 keys and with heads of 72 columns (where the CUDA kernels
    take their one-warp-a-row path): the plain forward and backward
    against the JAX kernel in interpret mode and jax.grad through it."""
    rng = np.random.default_rng(Tq + Tk + dh)
    B, D = 3, H * dh
    q, k, v = (rng.normal(size=(B, t, D)).astype(np.float32)
               for t in (Tq, Tk, Tk))
    klens = np.array([Tk, 1, 65])
    km = (np.arange(Tk)[None] < klens[:, None]).astype(np.float32)
    qm = km if Tq == Tk else np.ones((B, Tq), np.float32)
    do = rng.normal(size=(B, Tq, D)).astype(np.float32)

    def f(q, k, v):
        return j_att(q, k, v, jnp.asarray(qm), jnp.asarray(km), H,
                     interpret=True)

    want, vjp = jax.vjp(f, q, k, v)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    tqm, tkm = torch.from_numpy(qm), torch.from_numpy(km)
    _close(tatt.fused_attention_ref(tq, tk, tv, tqm, tkm, H).numpy(), want,
           "forward")
    got = tatt.fused_attention_bwd_ref(tq, tk, tv, tqm, tkm,
                                       torch.from_numpy(do), H)
    for name, a, b in zip(("dq", "dk", "dv"), got, vjp(jnp.asarray(do))):
        _close(a.numpy(), b, name)


def test_libraries_are_keyed_by_width():
    """Each width of a block kernel is its own library; the attention and
    row kernels keep one."""
    paths = {_build.library_path(block.library(block.BWD_KERNEL, *w))
             for w in ((80, 320, 4), (36, 100, 3), (64, 256, 2))}
    assert len(paths) == 3
    assert "BLOCK_D36-BLOCK_F100-BLOCK_H3" in str(
        _build.library_path(block.library(block.KERNEL, 36, 100, 3)))
    assert _build.library_path("attention_fwd") == \
        _build.library_path(("attention_fwd", ()))


@pytest.mark.parametrize("what", ["T", "heads", "activations"])
def test_width_check_raises_before_any_build(what, monkeypatch):
    """A shape the block kernels cannot take raises in the wrapper's check,
    before the library is built (``_build.build`` must not be called)."""
    def no_build(specs):
        raise AssertionError(f"build called for {specs}")

    monkeypatch.setattr(_build, "build", no_build)
    D, F, H, T = {"T": (80, 320, 4, 40000),
                  "heads": (80, 320, 3, 10),
                  "activations": (80, 4 * 10 ** 8, 4, 10)}[what]
    with pytest.raises(ValueError, match="fused_block"):
        block.check_widths("fused_block_bwd", D, F, H, T)
    if what != "activations":
        B = 2
        ew = (torch.zeros(D, 3 * D), torch.zeros(8, D), torch.zeros(D, F),
              torch.zeros(F), torch.zeros(F, D))
        with pytest.raises(ValueError, match="fused_block_fwd"):
            block._fwd_kernel(ew, ew, torch.zeros(B, T, D),
                              torch.zeros(B, D), torch.ones(B, T), H, False,
                              0.0, None)


@pytest.mark.parametrize("D,F,H,T", [(80, 320, 4, 50), (80, 320, 4, 200),
                                     (64, 256, 2, 60), (36, 100, 3, 300)])
def test_width_check_takes_the_card_widths(D, F, H, T, monkeypatch):
    """The widths the card tests run pass the check without a build, and
    its bound of one example's floats is above what the backward's layout
    takes at the model's widths and T=50 (227,104 bytes of shared memory,
    the size the kernel's build reports)."""
    def no_build(specs):
        raise AssertionError(f"build called for {specs}")

    monkeypatch.setattr(_build, "build", no_build)
    block.check_widths("fused_block_bwd", D, F, H, T)
    n = block.max_act_floats(D, F, H, T)
    assert n < 2 ** 31
    if (D, T) == (80, 50):
        assert 4 * n >= 227104
