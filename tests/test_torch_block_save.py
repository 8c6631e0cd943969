"""The fused block's save mode (``DMT_BLOCK_SAVE=1``) in the port's plain
versions: the saved encoder Q, K, V and attention context against the JAX
Pallas forward's ``save=True`` outputs (interpret mode), the saved-input
backward against the JAX ``saved=`` backward, and the two modes bit-equal
through the plain backward, through autograd and over two ``Trainer``
steps; then the checks of ``saved`` and the work counts of a save-mode
launch.  The CUDA kernels are held to the same on the card by
``chip_smoke.py`` (``check_save``, ``save_phase``) and
``tests/test_torch_cuda.py``."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import __graft_entry__ as g  # noqa: E402
from cikm2020_dmt_tpu.ops import block as jblock  # noqa: E402
from cikm2020_dmt_torch.convert import tree_to_tensors  # noqa: E402
from cikm2020_dmt_torch.metrics.streaming import \
    task_metrics_init  # noqa: E402
from cikm2020_dmt_torch.ops import block  # noqa: E402
from cikm2020_dmt_torch.train.loop import Trainer  # noqa: E402
from test_torch_block_train import (D, H, LENS, T, _assert_grads,  # noqa: E402
                                    _inputs, _packed, _params)
from test_torch_serve import SMALL, port_cfg  # noqa: E402

RATE = 0.1


def _is_tensor(x):
    return isinstance(x, torch.Tensor)


def _flat(bwd):
    return (bwd[0], bwd[1]) + tuple(bwd[2])


@pytest.fixture(scope="module")
def jax_save():
    """The JAX forward with ``save=True`` and the backward with ``saved=``
    (Pallas interpret mode, float32, no dropout) on inputs padded as the
    JAX ``fused_encode_decode`` pads them: T to a multiple of 8 and the
    batch to a multiple of 32, with key mask and cotangent 0 there."""
    _, p = _params(0)
    enc, dec, gout, mask = _inputs(LENS, 1)
    B = enc.shape[0]
    Tp, Bp = -(-T // 8) * 8, -(-B // 32) * 32
    enc_p = np.zeros((Bp, Tp, D), np.float32)
    enc_p[:B, :T] = enc
    dec_p = np.zeros((Bp, D), np.float32)
    dec_p[:B] = dec
    g_p = np.zeros((Bp, D), np.float32)
    g_p[:B] = gout
    km = np.zeros((Bp, Tp), np.float32)
    km[:B, :T] = mask
    kw = dict(num_heads=H, scale=1.0 / math.sqrt(D // H), rate=0.0,
              train=False, interpret=True)
    args = (jnp.zeros((1,), jnp.int32), jnp.asarray(enc_p),
            jnp.asarray(dec_p), jnp.asarray(km.reshape(Bp, 1, Tp)),
            jnp.asarray(km.reshape(Bp, Tp, 1)),
            jblock._pack_weights(p["enc"][0]),
            jblock._pack_weights(p["dec"][0]))
    out, *saved = jblock._fwd_call(*args, save=True, **kw)
    denc, ddec, gew, gdw = jblock._bwd_call(*args, jnp.asarray(g_p),
                                            saved=tuple(saved), **kw)
    return {"p": p, "enc": enc, "dec": dec, "g": gout, "mask": mask,
            "out": np.asarray(out)[:B],
            "saved": [np.ascontiguousarray(np.asarray(t)[:B, :T])
                      for t in saved],
            "bwd": [np.asarray(denc)[:B, :T], np.asarray(ddec)[:B]]
            + [np.asarray(t) for t in gew + gdw]}


def _port_kw(js):
    return dict(enc_in=torch.from_numpy(js["enc"]),
                dec_in=torch.from_numpy(js["dec"]),
                seq_mask=torch.from_numpy(js["mask"]))


def test_saved_tensors_match_jax(jax_save):
    """(a) The plain forward's save outputs (q, k, v, ctx_e) and output
    against the JAX kernel's, within 1e-5 of max(1, |reference|)."""
    p, kw = jax_save["p"], _port_kw(jax_save)
    out, saved = block._fwd_ref(_packed(p["enc"][0]), _packed(p["dec"][0]),
                                kw["enc_in"], kw["dec_in"], kw["seq_mask"],
                                H, False, 0.0, None, save=True)
    assert [t.dtype for t in saved] == [torch.float32] * 4
    for name, got, want in zip(("out", "q", "k", "v", "ctx_e"),
                               (out,) + saved,
                               [jax_save["out"]] + jax_save["saved"]):
        assert got.shape == want.shape, name
        err = np.abs(got.numpy() - want) / np.maximum(1.0, np.abs(want))
        assert err.max() <= 1e-5, (name, err.max())


def test_saved_backward_matches_jax(jax_save):
    """(b) JAX's saved tensors fed to the plain backward, against JAX's
    saved-input backward, at ``test_plain_backward_matches_pallas_kernel``'s
    rtol 2e-4 / atol 1e-4."""
    p, kw = jax_save["p"], _port_kw(jax_save)
    got = block.fused_block_bwd_ref(
        _packed(p["enc"][0]), _packed(p["dec"][0]),
        g=torch.from_numpy(jax_save["g"]), num_heads=H,
        saved=tuple(torch.from_numpy(t) for t in jax_save["saved"]), **kw)
    got = [t.numpy() for t in _flat(got)]
    want = [w.reshape(a.shape) for a, w in zip(got, jax_save["bwd"])]
    _assert_grads(got, want, rtol=2e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_modes_bit_equal(dtype):
    """(c) With dropout 0.1, the plain backward from the plain forward's
    saved tensors gives every one of its 12 outputs with the same bits as
    the backward that forms them again; the forward's output is the same
    in both modes."""
    dt = getattr(torch, dtype)
    _, p = _params(3)
    enc, dec, gout, mask = _inputs(LENS, 4)
    ew, dw = _packed(p["enc"][0]), _packed(p["dec"][0])
    kw = dict(enc_in=torch.from_numpy(enc).to(dt),
              dec_in=torch.from_numpy(dec).to(dt),
              seq_mask=torch.from_numpy(mask), num_heads=H, train=True,
              rate=RATE, seed=torch.tensor([9], dtype=torch.int32))
    args = (kw["enc_in"], kw["dec_in"], kw["seq_mask"], H, True, RATE,
            kw["seed"])
    out, saved = block._fwd_ref(ew, dw, *args, save=True)
    assert torch.equal(out, block._fwd_ref(ew, dw, *args))
    assert [t.dtype for t in saved] == [dt] * 3 + [torch.float32]
    g_t = torch.from_numpy(gout).to(dt)
    off = _flat(block.fused_block_bwd_ref(ew, dw, g=g_t, **kw))
    on = _flat(block.fused_block_bwd(ew, dw, g=g_t, saved=saved, **kw))
    assert len(on) == 12
    for a, b in zip(on, off):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_switch_bit_equal_and_read_per_call(monkeypatch):
    """(d) ``fused_encode_decode`` with ``DMT_BLOCK_SAVE=1`` and with the
    switch unset: the output and every gradient through autograd have the
    same bits.  The switch is read at each call, and only where a backward
    can follow (not under ``torch.no_grad``)."""
    _, p = _params(5)
    enc, dec, gout, mask = _inputs(LENS, 6)
    calls = []
    real = block._fwd_ref

    def spy(*a, **k):
        calls.append(k["save"])
        return real(*a, **k)

    monkeypatch.setattr(block, "_fwd_ref", spy)
    kw = dict(seq_mask=torch.from_numpy(mask), num_heads=H, train=True,
              rate=RATE, seed=torch.tensor([13], dtype=torch.int32))

    def run():
        tp = tree_to_tensors(p)
        leaves = jax.tree_util.tree_leaves((tp["enc"][0], tp["dec"][0]),
                                           is_leaf=_is_tensor)
        for leaf in leaves:
            leaf.requires_grad_()
        e = torch.from_numpy(enc).requires_grad_()
        d = torch.from_numpy(dec).requires_grad_()
        out = block.fused_encode_decode(tp["enc"][0], tp["dec"][0],
                                        enc_in=e, dec_in=d, **kw)
        kept = len(out.grad_fn.saved_tensors)
        grads = torch.autograd.grad(out, [e, d] + leaves,
                                    torch.from_numpy(gout))
        return out.detach(), grads, kept

    monkeypatch.setenv("DMT_BLOCK_SAVE", "1")
    on = run()
    monkeypatch.delenv("DMT_BLOCK_SAVE")
    off = run()
    monkeypatch.setenv("DMT_BLOCK_SAVE", "1")
    with torch.no_grad():
        tp = tree_to_tensors(p)
        block.fused_encode_decode(tp["enc"][0], tp["dec"][0],
                                  enc_in=torch.from_numpy(enc),
                                  dec_in=torch.from_numpy(dec), **kw)
    assert calls == [True, False, False]
    assert on[2] == off[2] + 4  # q, k, v, ctx_e kept for the backward
    assert torch.equal(on[0], off[0])
    assert len(on[1]) == len(off[1]) > 2
    for a, b in zip(on[1], off[1]):
        assert torch.equal(a, b)


def test_trainer_steps_bit_equal(monkeypatch):
    """(e) Two ``Trainer`` steps on ``_demo_config`` (the 1 + 1 fused
    block, transformer dropout 0.1) from the same state, batches and
    dropout generator: with the switch on and off, the losses, params and
    optimizer state have the same bits, and the on run took the save
    mode."""
    jcfg = g._demo_config(**SMALL, batch_size=32)
    cfg = port_cfg(jcfg)
    assert cfg.transformer.dropout_rate > 0.0
    batches = [{k: torch.from_numpy(v)
                for k, v in g.synthetic_batch(jcfg, 32, seed=s).items()}
               for s in range(2)]
    calls = []
    real = block._fwd_ref

    def spy(*a, **k):
        calls.append(k["save"])
        return real(*a, **k)

    monkeypatch.setattr(block, "_fwd_ref", spy)

    def run():
        tr = Trainer(cfg, device="cpu")
        state = tr.init_state(torch.Generator().manual_seed(0))
        metrics, gen = task_metrics_init(), torch.Generator().manual_seed(1)
        losses = []
        for b in batches:
            state, metrics, loss = tr.train_step(state, metrics, b, gen)
            losses.append(loss)
        return losses, state

    monkeypatch.setenv("DMT_BLOCK_SAVE", "1")
    on = run()
    assert calls == [True] * 6  # three sequences a step
    monkeypatch.delenv("DMT_BLOCK_SAVE")
    off = run()
    assert calls[6:] == [False] * 6
    for a, b in zip(on[0], off[0]):
        assert torch.equal(a, b)
    la = jax.tree_util.tree_leaves(on[1], is_leaf=_is_tensor)
    lb = jax.tree_util.tree_leaves(off[1], is_leaf=_is_tensor)
    assert len(la) == len(lb) > 10
    for a, b in zip(la, lb):
        assert torch.equal(a, b)


def _case(dtype=torch.float32):
    _, p = _params(0)
    enc, dec, gout, mask = _inputs(LENS, 1)
    kw = dict(enc_in=torch.from_numpy(enc).to(dtype),
              dec_in=torch.from_numpy(dec).to(dtype),
              seq_mask=torch.from_numpy(mask), num_heads=H)
    return (_packed(p["enc"][0]), _packed(p["dec"][0]),
            torch.from_numpy(gout).to(dtype), kw)


def _bad_saved(case):
    B = len(LENS)
    good = [torch.zeros(B, T, D) for _ in range(4)]
    if case == "count":
        return tuple(good[:3])
    if case == "shape":
        good[1] = torch.zeros(B, T + 1, D)
    elif case == "q_dtype":
        good[0] = torch.zeros(B, T, D, dtype=torch.bfloat16)
    elif case == "ctx_dtype":
        good[3] = torch.zeros(B, T, D, dtype=torch.float64)
    elif case == "device":
        good[2] = torch.zeros(B, T, D, device="meta")
    elif case == "contiguity":
        good[3] = torch.zeros(B, D, T).transpose(1, 2)
    return tuple(good)


@pytest.mark.parametrize("case", ["count", "shape", "q_dtype", "ctx_dtype",
                                  "device", "contiguity"])
def test_bad_saved_raises(case):
    """(f) A ``saved`` of the wrong count, shape, dtype (q, k, v in the
    input's dtype, ctx_e float32), device or layout raises, naming it."""
    ew, dw, gout, kw = _case()
    with pytest.raises(ValueError, match="fused_block_bwd: saved"):
        block.fused_block_bwd(ew, dw, g=gout, saved=_bad_saved(case), **kw)


def test_bf16_saved_dtypes():
    """(f) In bfloat16 the saved q, k, v are bfloat16 and ctx_e float32;
    float32 q is refused."""
    ew, dw, gout, kw = _case(torch.bfloat16)
    _, saved = block._fwd_ref(ew, dw, kw["enc_in"], kw["dec_in"],
                              kw["seq_mask"], H, False, 0.0, None, save=True)
    block.fused_block_bwd(ew, dw, g=gout, saved=saved, **kw)
    with pytest.raises(ValueError, match="saved q"):
        block.fused_block_bwd(ew, dw, g=gout,
                              saved=(saved[0].float(),) + saved[1:], **kw)


def test_save_work_counts():
    """(f) The work of a save-mode launch at the model's widths, worked
    out by hand.  Per example at T=50, D=80: the encoder's QKV projection
    2 x 50 x 80 x 240 = 1,920,000 and its scores and P.V 2 x 2 x 50 x 50 x
    80 = 800,000 operations, which the saved backward does not replay
    (of the backward's 3 x 9,251,200); the saved q, k, v and ctx_e are 4 x
    50 x 80 floats, 64,000 bytes in float32 and 40,000 with bfloat16 q, k,
    v, written by the forward and read by the backward."""
    assert block.block_flops(1, 50, 80, 320) == 9_251_200
    assert block.block_bwd_flops(1, 50, 80, 320) == 27_753_600
    assert block.block_bwd_flops(1, 50, 80, 320, saved=True) == 25_033_600
    assert block.block_bwd_flops(2048, 10, 80, 320, saved=True) == 2048 * (
        3 * block.block_flops(1, 10, 80, 320) - 2 * 10 * 80 * 240
        - 2 * 2 * 10 * 10 * 80)
    for elem, per in ((4, 64_000), (2, 40_000)):
        assert block.block_bytes(1, 50, 80, 320, elem, save=True) \
            - block.block_bytes(1, 50, 80, 320, elem) == per
        assert block.block_bwd_bytes(1, 50, 80, 320, elem, saved=True) \
            - block.block_bwd_bytes(1, 50, 80, 320, elem) == per
    # 131 MB each way at the flagship's T=50 block, B=2048, float32
    assert block.block_bytes(2048, 50, 80, 320, 4, save=True) \
        - block.block_bytes(2048, 50, 80, 320, 4) == 131_072_000
    ops = block.block_bwd_flops(2048, 50, 80, 320, saved=True)
    assert round(block.block_tc_bound_ms(ops, torch.float32), 4) == round(
        3 * 2048 * 25_033_600 / 495e12 * 1e3, 4)
