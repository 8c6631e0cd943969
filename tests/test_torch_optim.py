"""The dense optimizers of ``train/optim.py`` against the JAX package's
``make_optimizer`` (optax's sgd, adagrad, rmsprop and adadelta, and the
JAX package's FTRL), on the CPU.

- three updates of a small param tree (float32 and bfloat16 leaves, a
  nested list included) from the same gradients: the new params and the
  state, leaf by leaf and dtype for dtype;
- one ``Trainer`` step of a small ``embed_mlp`` (its tables take the dense
  update: a non-Adam optimizer has no lazy plan) against the JAX
  ``Trainer``'s, from the same converted state."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

import __graft_entry__ as g  # noqa: E402
from cikm2020_dmt_tpu.train.optim import \
    make_optimizer as j_make_optimizer  # noqa: E402
from cikm2020_dmt_torch.convert import (opt_state_from_jax,  # noqa: E402
                                        to_tensor)
from cikm2020_dmt_torch.train.optim import make_optimizer  # noqa: E402
from test_torch_serve import SMALL, port_cfg  # noqa: E402
from test_torch_zoo_train import config, run_pair, view  # noqa: E402

OPTIMIZERS = ("sgd", "adagrad", "rmsprop", "adadelta", "ftrl")
LR = 1e-2


def tree(rng, dtype):
    def a(*shape):
        return (rng.normal(size=shape) * 0.3).astype(np.float32).astype(
            dtype)
    return {"mlp": {"w": a(6, 4), "b": a(4)},
            "experts": [{"w": a(3, 2)}, {"w": a(3, 2)}],
            "emb": {}}


def leaves(tree, prefix=""):
    """(path, float64 array) of every leaf: tensors (bfloat16 too), numpy
    and JAX arrays."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves(v, f"{prefix}/{i}")
    elif isinstance(tree, torch.Tensor):
        yield prefix, tree.double().numpy()
    else:
        yield prefix, np.asarray(tree).astype(np.float64)


def to_torch(t):
    return jax.tree_util.tree_map(to_tensor, t)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", OPTIMIZERS)
def test_update_matches_jax(name, dtype):
    """Three updates from the same params and gradients: float32 within
    1e-6 of each leaf's largest |value| a step; bfloat16 within one
    bfloat16 step (2**-7) of each leaf's largest |value| a step (the port
    rounds each constant to bfloat16 before it multiplies, as JAX does, and
    rounds after each operation; an XLA fusion may keep a float32
    intermediate), the state likewise, and every leaf keeps JAX's
    dtype."""
    import ml_dtypes
    np_dtype = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    cfg = g._demo_config(**SMALL, optimizer=name, learning_rate=(LR, LR / 2),
                         step_boundary=(2,))
    rng = np.random.default_rng(7)
    params = tree(rng, np_dtype)
    jopt = j_make_optimizer(cfg)
    opt = make_optimizer(port_cfg(cfg))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = jopt.init(jp)
    tp = to_torch(params)
    ts = opt.init(tp)
    rel = 1e-6 if dtype == "float32" else 2.0 ** -7
    for step in range(1, 4):
        grads = tree(rng, np_dtype)
        updates, js = jopt.update(jax.tree_util.tree_map(jnp.asarray, grads),
                                  js, jp)
        jp = optax.apply_updates(jp, updates)
        tp, ts = opt.update(tp, to_torch(grads), ts)
        want_state = opt_state_from_jax(port_cfg(cfg), jax.tree_util.tree_map(
            np.asarray, js))
        assert sorted(ts) == sorted(want_state), name
        for what, got, want in (("params", tp, jp), ("state", ts,
                                                     want_state)):
            gl = dict(leaves(got))
            for path, w in leaves(want):
                a = gl[path]
                assert a.shape == w.shape, (what, path)
                np.testing.assert_allclose(
                    a, w, rtol=0,
                    atol=rel * step * max(np.abs(w).max(), 1e-30),
                    err_msg=f"{name} {dtype} step {step} {what}{path}")
        # dtype for dtype (FTRL's z turns float32, as JAX promotes it)
        jd = [str(np.asarray(x).dtype) for x in
              jax.tree_util.tree_leaves(jp)]
        td = [str(t.dtype).split(".")[-1] for t in
              jax.tree_util.tree_leaves(tp)]
        assert jd == td, name
        for key, sub in ts.items():
            if isinstance(sub, dict):
                want_d = [str(t.dtype) for t in
                          jax.tree_util.tree_leaves(want_state[key])]
                got_d = [str(t.dtype) for t in
                         jax.tree_util.tree_leaves(sub)]
                assert got_d == want_d, (name, key)


def test_unknown_optimizer_raises():
    cfg = port_cfg(g._demo_config(**SMALL, optimizer="lamb"))
    with pytest.raises(ValueError, match="unknown optimizer"):
        make_optimizer(cfg)


RUNS: dict = {}


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_trainer_step_matches_jax(name):
    """One step of ``embed_mlp``: no lazy plan, every table updated by
    the dense optimizer from autograd's index backward (JAX: XLA's
    segment sum; the float32 sums of a table row's many contributions run
    in another order).  Loss within 1e-5; params within 1e-3 of each
    leaf's largest move and the state within 1e-4 of each leaf's largest
    |value| (1e-7 of the moves of all leaves for a leaf whose gradient is
    rounding noise)."""
    cfg = config(model_type="embed_mlp", optimizer=name,
                 learning_rate=(LR,))
    r = run_pair(cfg, n_steps=1)
    assert r["lazy"] == 0
    np.testing.assert_allclose(r["plosses"], r["jlosses"], rtol=1e-5)
    before = view(r["pcfg"], r["jstates"][0])
    want = view(r["pcfg"], r["jstates"][1])
    got = jax.tree_util.tree_map(lambda t: t.numpy(), r["pstates"][0])
    assert int(got["step"]) == int(want["step"]) == 1
    moves = {p: np.abs(w - dict(leaves(before["params"]))[p])
             for p, w in leaves(want["params"])}
    top = max(m.max() for m in moves.values())
    gp = dict(leaves(got["params"]))
    for path, w in leaves(want["params"]):
        atol = max(1e-3 * moves[path].max(), 1e-7 * top)
        np.testing.assert_allclose(gp[path], w, rtol=0, atol=atol,
                                   err_msg=f"{name} params{path}")
    assert sorted(got["opt"]) == sorted(want["opt"])
    for key, sub in want["opt"].items():
        gs = dict(leaves(got["opt"][key]))
        for path, w in leaves(sub):
            np.testing.assert_allclose(
                gs[path], w, rtol=0,
                atol=max(1e-4 * np.abs(w).max(), 1e-12),
                err_msg=f"{name} opt/{key}{path}")
