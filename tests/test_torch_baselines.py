"""The pieces of the port's paper baselines (``models/baselines.py``) and
of the combiner that DIN uses, against the JAX package's, in float32 on
the CPU from numpy seeds and JAX inits carried across by ``convert``:

- ``pooled_from_grid`` with ``combiner="sum"`` and "mean", a row with no
  present id included; ``EmbeddingEngine.pooled`` passing the combiner on
  through plain, int8 and lazy-overlay lookups;
- ``embedding_combiner`` with ``combiner="sum"`` and a ``wts_override``,
  with and without cached grids;
- DIN's ``din_attention_scores``, with batch norm (train and eval, and
  the moving statistics) and without;
- DIEN's ``_gru_cell`` with and without the attention score,
  ``gru_scan`` over padded steps (states and gradients) and
  ``dien_attention_apply`` with a length-0 row, whose weights are
  uniform.

The five models' logits, losses and gradients are held against JAX in
``tests/test_torch_zoo.py`` and ``tests/test_torch_zoo_bn.py``, which
take every model of the registry."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import __graft_entry__ as g  # noqa: E402
from cikm2020_dmt_tpu.models import baselines as jb  # noqa: E402
from cikm2020_dmt_tpu.models import components as jcomp  # noqa: E402
from cikm2020_dmt_tpu.models.zoo import build_model as j_build  # noqa: E402
from cikm2020_dmt_tpu.nn import embedding as jemb  # noqa: E402
from cikm2020_dmt_torch.convert import (params_from_jax,  # noqa: E402
                                        tree_to_tensors)
from cikm2020_dmt_torch.models import baselines as tb  # noqa: E402
from cikm2020_dmt_torch.models import components as tcomp  # noqa: E402
from cikm2020_dmt_torch.nn import embedding as temb  # noqa: E402
from cikm2020_dmt_torch.parallel.embedding_shard import \
    EmbeddingEngine  # noqa: E402
from cikm2020_dmt_torch.train.lazy import LazyOverlay  # noqa: E402
from test_torch_serve import SMALL, port_cfg  # noqa: E402
from test_torch_zoo import assert_trees_close, leaves  # noqa: E402

B, L, D = 16, 7, 12
TOL = 1e-5


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def close(got, want, what, tol=TOL):
    np.testing.assert_allclose(
        np.asarray(got.detach() if hasattr(got, "detach") else got),
        np.asarray(want), rtol=tol, atol=tol, err_msg=what)


def grid_case(seed=0):
    """A grid [B, L, D], weights that are not a presence mask (raw
    scores, some negative), lengths with a length-0 row and a full one."""
    rng = np.random.default_rng(seed)
    grid = rng.normal(size=(B, L, D)).astype(np.float32)
    wts = rng.normal(size=(B, L)).astype(np.float32)
    lens = rng.integers(0, L + 1, B).astype(np.int32)
    lens[0], lens[1] = 0, L
    return grid, wts, lens


# ---------------------------------------------------------------------------
# the combiner
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_pooled_from_grid_matches_jax(combiner):
    grid, wts, lens = grid_case()
    want = jemb.pooled_from_grid(jnp.asarray(grid), jnp.asarray(wts),
                                 jnp.asarray(lens), combiner)
    got = temb.pooled_from_grid(torch.from_numpy(grid),
                                torch.from_numpy(wts),
                                torch.from_numpy(lens), combiner)
    close(got, want, combiner)
    assert float(got[0].abs().max()) == 0.0      # no present id


def test_mean_stays_the_default_and_keeps_its_bits():
    grid, wts, lens = (torch.from_numpy(a) for a in grid_case(1))
    w = wts * temb.presence_mask(wts, lens)
    s = torch.einsum("bl,bld->bd", w, grid)
    den = w.sum(-1, keepdim=True)
    want = torch.where(den > 0, s / den.clamp(min=1e-12), 0.0)
    got = temb.pooled_from_grid(grid, wts, lens)
    assert torch.equal(got, want)
    assert torch.equal(temb.pooled_from_grid(grid, wts, lens, "sum"), s)


@pytest.mark.parametrize("route", ["plain", "int8", "overlay"])
def test_engine_pooled_passes_the_combiner_on(route):
    """``EmbeddingEngine.pooled(..., combiner="sum")`` is the sum of the
    rows its route gathers: a clamped gather of a table, the dequantized
    rows of an int8 table, or the feature's slice of a lazy overlay."""
    rng = np.random.default_rng(2)
    R = 50
    ids = torch.from_numpy(rng.integers(0, R + 5, (B, L)))
    _, wts, lens = (torch.from_numpy(a) for a in grid_case(3))
    engine = EmbeddingEngine()
    table = torch.from_numpy(rng.normal(size=(R, D)).astype(np.float32))
    if route == "plain":
        rows = table[ids.clamp(max=R - 1)]
    elif route == "int8":
        q = torch.from_numpy(rng.integers(-127, 128, (R, D)).astype(np.int8))
        scale = torch.from_numpy(rng.uniform(0.01, 0.1, (R, 1))
                                 .astype(np.float32))
        table = {"q": q, "scale": scale}
        flat = ids.clamp(max=R - 1)
        rows = q[flat].float() * scale[flat]
    else:
        rows = torch.from_numpy(rng.normal(size=(B, L, D))
                                .astype(np.float32))
        engine.overlay = {"T": LazyOverlay(grid=rows.reshape(B * L, D),
                                           offsets={"f": (0, B * L)})}
    for combiner in ("sum", "mean"):
        got = engine.pooled("T", table, ids, wts, lens, feature="f",
                            combiner=combiner)
        want = temb.pooled_from_grid(rows, wts, lens, combiner)
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def din_config():
    cfg = g._demo_config(**SMALL, sku_rows=4096, table_bf16_threshold=0,
                         model_type="din")
    return dataclasses.replace(cfg, attention_pairs=cfg.attention_pairs[:2],
                               attention_ts=cfg.attention_ts[:2])


@pytest.mark.parametrize("cached", [False, True])
def test_embedding_combiner_sum_with_override_matches_jax(cached):
    """Every pooled feature sums; the groups' user features take [B, L]
    raw scores as their weights (the rest keep their own); with
    ``cached`` the groups' features pool from their gathered grids."""
    cfg = din_config()
    pcfg = port_cfg(cfg)
    emb = j_build(cfg).init(jax.random.PRNGKey(1))[0]["emb"]
    pemb = params_from_jax(pcfg, {"emb": np_tree(emb)})["emb"]
    b = g.synthetic_batch(cfg, B, seed=4)
    rng = np.random.default_rng(5)
    override = {u: rng.normal(size=b[u + "__ids"].shape).astype(np.float32)
                for group in cfg.attention_pairs for u, _ in group}
    jcache, pcache = {}, {}
    if cached:
        spec_of = {s.feature: s for s in cfg.embeddings}
        for group in cfg.attention_pairs:
            for feat in (f for pair in group for f in pair):
                table = np.asarray(emb[spec_of[feat].table])
                ids = np.clip(b[feat + "__ids"], 0, table.shape[0] - 1)
                jcache[feat] = jnp.asarray(table[ids])
                pcache[feat] = torch.from_numpy(table[ids])
    want = jcomp.embedding_combiner(
        emb, {k: jnp.asarray(v) for k, v in b.items()}, cfg,
        combiner="sum", seq_cache=jcache if cached else None,
        wts_override={k: jnp.asarray(v) for k, v in override.items()})
    got = tcomp.embedding_combiner(
        pemb, {k: torch.from_numpy(v) for k, v in b.items()}, pcfg,
        combiner="sum", seq_cache=pcache if cached else None,
        wts_override={k: torch.from_numpy(v) for k, v in override.items()})
    assert got.shape == want.shape == (B, tcomp.combiner_dim(pcfg))
    close(got, want, "combiner")
    mean = tcomp.embedding_combiner(
        pemb, {k: torch.from_numpy(v) for k, v in b.items()}, pcfg)
    assert not torch.allclose(got, mean)


# ---------------------------------------------------------------------------
# DIN
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("is_bn", [False, True])
def test_din_attention_scores_match_jax(is_bn):
    """Scores [B, L] of a train-mode and an eval-mode call; under
    ``is_bn`` the moving statistics the train-mode call left (decay 0.9)
    and the eval-mode call on them."""
    params, state = jb.din_attention_init(jax.random.PRNGKey(2), D,
                                          is_bn=is_bn)
    rng = np.random.default_rng(6)
    seq = rng.normal(size=(B, L, D)).astype(np.float32)
    tar = rng.normal(size=(B, D)).astype(np.float32)
    kw = dict(is_bn=is_bn, bn_decay=0.9)
    jy, jst = jb.din_attention_scores(params, state, jnp.asarray(seq),
                                      jnp.asarray(tar), train=True, **kw)
    pp, ps = tree_to_tensors(np_tree(params)), tree_to_tensors(
        np_tree(state))
    py, pst = tb.din_attention_scores(pp, ps, torch.from_numpy(seq),
                                      torch.from_numpy(tar), train=True,
                                      **kw)
    assert py.shape == (B, L)
    close(py, jy, "train scores")
    assert bool(pst) == is_bn
    if is_bn:
        assert_trees_close(pst, np_tree(jst), "moving statistics")
    jy, _ = jb.din_attention_scores(params, jst, jnp.asarray(seq),
                                    jnp.asarray(tar), train=False, **kw)
    py, _ = tb.din_attention_scores(pp, tree_to_tensors(np_tree(jst)),
                                    torch.from_numpy(seq),
                                    torch.from_numpy(tar), train=False,
                                    **kw)
    close(py, jy, "eval scores")


def test_din_init_has_the_jax_tree():
    jp, js = jb.din_attention_init(jax.random.PRNGKey(0), D, is_bn=True)
    pp = tb.din_attention_init(torch.Generator().manual_seed(0), D,
                               is_bn=True)
    want = {k: v.shape for k, v in leaves(np_tree(jp))}
    assert {k: v.shape for k, v in leaves(pp)} == want
    assert all(float(v.min()) == float(v.max()) == float(np.float32(0.1))
               for k, v in leaves(pp) if k.endswith("dense/b"))


# ---------------------------------------------------------------------------
# DIEN
# ---------------------------------------------------------------------------

H = 16


def gru_params(seed, in_dim):
    params = jb.gru_init(jax.random.PRNGKey(seed), in_dim, H)
    # biases away from their 1 / 0 init so a wrong gate order shows
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda a: a + rng.normal(scale=0.3, size=a.shape).astype(np.float32),
        np_tree(params))
    return params, tree_to_tensors(params)


@pytest.mark.parametrize("attention", [False, True])
def test_gru_cell_matches_jax(attention):
    jp, pp = gru_params(3, D)
    rng = np.random.default_rng(7)
    h = rng.normal(size=(B, H)).astype(np.float32)
    x = rng.normal(size=(B, D)).astype(np.float32)
    a = rng.uniform(size=(B,)).astype(np.float32) if attention else None
    want = jb._gru_cell(jp, jnp.asarray(h), jnp.asarray(x),
                        None if a is None else jnp.asarray(a))
    got = tb._gru_cell(pp, torch.from_numpy(h), torch.from_numpy(x),
                       None if a is None else torch.from_numpy(a))
    close(got, want, "cell")


@pytest.mark.parametrize("attention", [False, True])
def test_gru_scan_with_padded_steps_matches_jax(attention):
    """Final and per-step states, and the gradients of a weighted sum of
    the states with respect to the params, the inputs and the attention
    scores; a padded step keeps the state before it (a length-0 row stays
    at zero)."""
    jp, pp = gru_params(4, D)
    seq, _, lens = grid_case(8)
    mask = (np.arange(L)[None] < lens[:, None]).astype(np.float32)
    mask[2, 1] = 0.0           # a gap inside a sequence
    rng = np.random.default_rng(9)
    a = rng.uniform(size=(B, L)).astype(np.float32) if attention else None
    probe = rng.normal(size=(B, L, H)).astype(np.float32)

    def jfn(p, s, sc):
        h, states = jb.gru_scan(p, s, jnp.asarray(mask), sc)
        return jnp.sum(states * probe) + jnp.sum(h), (h, states)

    args = (jp, jnp.asarray(seq), None if a is None else jnp.asarray(a))
    argnums = (0, 1, 2) if attention else (0, 1)
    (_, (jh, jstates)), jgrads = jax.value_and_grad(
        jfn, argnums=argnums, has_aux=True)(*args)
    leaf_list = [t.requires_grad_() for t in jax.tree_util.tree_leaves(pp)]
    ts = torch.from_numpy(seq).requires_grad_()
    ta = None if a is None else torch.from_numpy(a).requires_grad_()
    h, states = tb.gru_scan(pp, ts, torch.from_numpy(mask), ta)
    close(h, jh, "final state")
    close(states, jstates, "states")
    out = (states * torch.from_numpy(probe)).sum() + h.sum()
    wrt = leaf_list + [ts] + ([ta] if attention else [])
    grads = torch.autograd.grad(out, wrt)
    want = jax.tree_util.tree_leaves(np_tree(jgrads[0])) + [
        np.asarray(x) for x in jgrads[1:]]
    for i, (got, w) in enumerate(zip(grads, want)):
        close(got, w, f"gradient {i}", tol=TOL * max(1.0, np.abs(w).max()))
    assert float(states[0].detach().abs().max()) == 0.0
    torch.testing.assert_close(states[2, 1], states[2, 0], rtol=0, atol=0)


def test_dien_attention_matches_jax_and_a_len0_row_is_uniform():
    q_dim = 2 * D
    jp = np_tree(jb.dien_attention_init(jax.random.PRNGKey(5), q_dim, H))
    pp = tree_to_tensors(jp)
    rng = np.random.default_rng(10)
    query = rng.normal(size=(B, q_dim)).astype(np.float32)
    facts = rng.normal(size=(B, L, H)).astype(np.float32)
    _, _, lens = grid_case(11)
    mask = (np.arange(L)[None] < lens[:, None]).astype(np.float32)
    want = jb.dien_attention_apply(jp, jnp.asarray(query),
                                   jnp.asarray(facts), jnp.asarray(mask))
    got = tb.dien_attention_apply(pp, torch.from_numpy(query),
                                  torch.from_numpy(facts),
                                  torch.from_numpy(mask))
    close(got, want, "weights")
    empty = torch.from_numpy(lens == 0)
    assert bool(empty[0])
    torch.testing.assert_close(got[empty],
                               torch.full((int(empty.sum()), L), 1.0 / L))
    present = (got * torch.from_numpy(mask)).sum(-1)[~empty]
    torch.testing.assert_close(present, torch.ones_like(present))


def test_prelu_splits_the_gradient_at_zero_as_jax():
    """At x = 0 (a zero-padded target through the zero-bias projection)
    the gradient is (1 + alpha) / 2, as JAX's max/min give it."""
    alpha = np.full((4,), 0.1, np.float32)
    x = np.array([-2.0, 0.0, 0.0, 3.0], np.float32)
    want = jax.grad(lambda v: jnp.sum(jb.prelu_apply(
        {"alpha": jnp.asarray(alpha)}, v)))(jnp.asarray(x))
    t = torch.from_numpy(x).requires_grad_()
    tb.prelu_apply({"alpha": torch.from_numpy(alpha)}, t).sum().backward()
    close(t.grad, want, "prelu gradient")
