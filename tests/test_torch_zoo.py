"""The port's model lattice against the JAX package's: every model type of
the registry at small widths (two sequence groups, click and order), from
a JAX init converted by ``convert.params_from_jax``, dropout off on both
sides (with batch norm: ``tests/test_torch_zoo_bn.py``, which shares
``case``).

- the eval forward (batch norm on moving statistics that one train-mode
  batch moved away from zero) against JAX ``model.apply``;
- the train-mode loss and every gradient leaf against
  ``jax.value_and_grad`` of JAX ``make_loss_fn``, and the moving
  statistics after that batch;
- the combiner widths, the losses on their own (the propensity weight,
  the raw label, eval weights, the L2 terms) and ``build_model``'s
  errors."""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import __graft_entry__ as g  # noqa: E402
from cikm2020_dmt_tpu.core.config import DMTConfig as JConfig  # noqa: E402
from cikm2020_dmt_tpu.models import components as jcomp  # noqa: E402
from cikm2020_dmt_tpu.models.zoo import build_model as j_build  # noqa: E402
from cikm2020_dmt_tpu.train import losses as jloss  # noqa: E402
from cikm2020_dmt_tpu.train.loop import make_loss_fn  # noqa: E402
from cikm2020_dmt_torch.convert import (model_state_from_jax,  # noqa: E402
                                        params_from_jax, tree_to_tensors)
from cikm2020_dmt_torch.core.config import DMTConfig  # noqa: E402
from cikm2020_dmt_torch.models import components as tcomp  # noqa: E402
from cikm2020_dmt_torch.models.zoo import (MODEL_REGISTRY,  # noqa: E402
                                           UNRECONSTRUCTIBLE_MODEL_TYPES,
                                           build_model)
from cikm2020_dmt_torch.train import losses as tloss  # noqa: E402
from test_torch_serve import SMALL, port_cfg  # noqa: E402

B = 64
MODELS = sorted(MODEL_REGISTRY)
KW = dict(sku_rows=4096, batch_size=B, table_bf16_threshold=0,
          hidden_units=(32, 16), dropout_rate_bias=(0.0, 0.0),
          bn_decay=0.9)
TOL = 1e-5


def config(model_type, is_bn=False, **kw):
    cfg = g._demo_config(**{**SMALL, **KW, **kw}, model_type=model_type,
                         is_bn=is_bn)
    return dataclasses.replace(
        cfg, attention_pairs=cfg.attention_pairs[:2],
        attention_ts=cfg.attention_ts[:2],
        transformer=dataclasses.replace(cfg.transformer, dropout_rate=0.0))


def batch_pair(cfg, seed):
    b = g.synthetic_batch(cfg, B, seed=seed)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, np.asarray(tree.detach() if hasattr(tree, "detach")
                                 else tree, np.float64)


def assert_trees_close(got, want, what, rel=TOL):
    """Leaf by leaf, the paths equal, each within ``rel`` of the leaf's
    largest |value|, and at least ``rel`` of the largest |value| of all
    leaves: a leaf whose value is zero in exact arithmetic is rounding
    noise on both sides (the dense bias before a batch norm, which
    subtracts the batch mean, has no gradient)."""
    g_, w_ = dict(leaves(got)), dict(leaves(want))
    assert sorted(g_) == sorted(w_), what
    top = max(float(np.abs(b).max(initial=0.0)) for b in w_.values())
    for path, b in w_.items():
        a = g_[path]
        assert a.shape == b.shape, (what, path)
        atol = rel * max(float(np.abs(b).max(initial=0.0)), top)
        np.testing.assert_allclose(a, b, rtol=0, atol=atol,
                                   err_msg=f"{what} {path}")


def case(model_type, is_bn, knobs=()):
    """One model's JAX and port results on the same init and batches.
    Without batch norm the init is JAX's (converted to the port's); with
    it the port's, handed to JAX as numpy (the same tree: a JAX init of a
    transformer model costs seconds of small compiles on the CPU).
    ``knobs``: (field, value) pairs set on the config.  Computed once a
    case: ``lru_cache`` keys ``(m, bn)`` and ``(m, bn, ())`` apart, so
    every call reaches the cache with all three arguments."""
    return _case(model_type, is_bn, tuple(knobs))


@functools.lru_cache(maxsize=None)
def _case(model_type, is_bn, knobs):
    cfg = config(model_type, is_bn, **dict(knobs))
    pcfg = port_cfg(cfg)
    jm, pm = j_build(cfg), build_model(pcfg)
    if is_bn:
        init = pm.init(torch.Generator().manual_seed(3))
        params, state = (jax.tree_util.tree_map(
            lambda t: jnp.asarray(t.numpy()), tree)
            for tree in (init, pm.init_state(init)))
    else:
        params, state = jm.init(jax.random.PRNGKey(3))
    (jb, pb), (jb2, pb2) = batch_pair(cfg, 0), batch_pair(cfg, 1)
    loss_fn = make_loss_fn(cfg, jm)

    def jax_side(p, s, b, b2):   # one compile
        (loss, (_, new)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(p, s, b, None)
        # eval on the moving statistics the train-mode batch left
        return loss, new, grads, jm.apply(p, new, b2, train=False)[0]

    jl, jstate, jgrads, jeval = jax.jit(jax_side)(params, state, jb, jb2)

    pp = params_from_jax(pcfg, jax.tree_util.tree_map(np.asarray, params))
    pstate = model_state_from_jax(jax.tree_util.tree_map(np.asarray, state))
    leaf_list = []

    def track(t):
        t = t.detach().requires_grad_()
        leaf_list.append(t)
        return t

    from cikm2020_dmt_torch.nn.layers import tree_map
    pp_d = tree_map(track, pp)
    out, pnew = pm.apply(pp_d, pb, train=True, state=pstate,
                         return_state=True)
    pl = tloss.model_loss(pcfg, pm.num_tasks, out, pp_d, pb, train=True)
    grads = torch.autograd.grad(pl, leaf_list, allow_unused=True)
    it = iter(grads)
    pgrads = tree_map(lambda t: next(it), pp_d)
    with torch.no_grad():
        peval = pm.apply(pp, pb2, train=False, is_predict=False,
                         state=tree_map(lambda t: t.detach(), pnew))
    return dict(pcfg=pcfg, jl=float(jl), pl=float(pl.detach()),
                jgrads=params_from_jax(pcfg, jax.tree_util.tree_map(
                    np.asarray, jgrads)),
                pgrads=pgrads, jstate=jax.tree_util.tree_map(np.asarray,
                                                             jstate),
                pstate=pnew, jeval=jax.tree_util.tree_map(np.asarray, jeval),
                peval=peval)


@pytest.mark.parametrize("model_type", MODELS)
def test_eval_forward_matches_jax(model_type):
    check_eval_forward(model_type, False)


@pytest.mark.parametrize("model_type", MODELS)
def test_train_loss_and_grads_match_jax(model_type):
    check_loss_and_grads(model_type, False)
    assert case(model_type, False)["pstate"] == {}


# config values no other case sets, each on the lattice's two-task models
KNOBS = {"uncertainty": (("loss_weight_method", "uncertainty"),)}


@pytest.mark.parametrize("model_type", ["multi_task",
                                        "mmoe_transformer_unbias"])
@pytest.mark.parametrize("knob", sorted(KNOBS))
def test_knob_loss_and_grads_match_jax(knob, model_type):
    """The loss and every gradient leaf within 1e-5; with ``uncertainty``
    the two Kendall loss weights are leaves of both trees."""
    check_loss_and_grads(model_type, False, KNOBS[knob])
    c = case(model_type, False, KNOBS[knob])
    if knob == "uncertainty":
        assert sorted(c["pgrads"]["uncertainty"]) == [
            "click_weight", "order_weight"]
        assert float(c["pgrads"]["uncertainty"]["click_weight"].abs()) > 0


def check_eval_forward(model_type, is_bn):
    c = case(model_type, is_bn)
    # the same logit structure (tuples of [B, 1]), values within 1e-5
    assert jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda t: 0, c["jeval"])) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(
            lambda t: 0, c["peval"]))
    assert_trees_close(c["peval"], c["jeval"], "eval logits")


def check_loss_and_grads(model_type, is_bn, knobs=()):
    c = case(model_type, is_bn, knobs)
    np.testing.assert_allclose(c["pl"], c["jl"], rtol=TOL)
    assert_trees_close(c["pgrads"], c["jgrads"], "grad")


def test_case_is_computed_once():
    """``case`` with and without its default ``knobs`` is one result."""
    assert case("lr", False) is case("lr", False, ())


def test_combiner_dims_match_jax():
    jcfg = config("transformer")
    pcfg = port_cfg(jcfg)
    for skip in (False, True):
        assert tcomp.combiner_dim(pcfg, skip_seq=skip) == \
            jcomp.combiner_dim(jcfg, skip_seq=skip)
    assert tcomp.interest_dim(pcfg) == jcomp.interest_dim(jcfg)
    assert tcomp.bias_combiner_dim(pcfg) == jcomp.bias_combiner_dim(jcfg)
    # the widths the JAX package states for the demo config
    for conf in ("conf/dmt_demo.conf", "conf/transformer_demo.conf"):
        j, t = JConfig.from_ini(conf), DMTConfig.from_ini(conf)
        for skip in (False, True):
            assert tcomp.combiner_dim(t, skip) == jcomp.combiner_dim(j, skip)
    t = DMTConfig.from_ini("conf/dmt_demo.conf")
    assert tcomp.combiner_dim(t) == 615 + 80 + 3 * 88
    assert tcomp.combiner_dim(t, skip_seq=True) == 615 + 80 + 3 * 8
    assert tcomp.interest_dim(t) == 3 * 80
    assert tcomp.bias_combiner_dim(t) == 20


@pytest.mark.parametrize("name", ["lr", "wnd", "dcn", "din", "dien"])
def test_build_model_rejects_baselines(name):
    """The paper baselines were refused until the port carried them; now
    ``build_model`` builds each, with the JAX class's task count."""
    from cikm2020_dmt_tpu.models.zoo import MODEL_REGISTRY as J
    from cikm2020_dmt_tpu.models.zoo import _register_baselines
    _register_baselines()
    model = build_model(port_cfg(config(name)))
    assert model.name == name
    assert model.num_tasks == J[name].num_tasks == 1


@pytest.mark.parametrize("name", ["nope"] + list(
    UNRECONSTRUCTIBLE_MODEL_TYPES))
def test_build_model_rejects_unknown(name):
    with pytest.raises(ValueError, match="unknown model_type"):
        build_model(port_cfg(config(name)))


def test_registry_matches_jax_lattice():
    """The lattice and the paper baselines: the JAX registry once its
    baselines are registered."""
    from cikm2020_dmt_tpu.models.zoo import MODEL_REGISTRY as J
    from cikm2020_dmt_tpu.models.zoo import _register_baselines
    _register_baselines()
    assert set(MODEL_REGISTRY) == set(J)
    for name, cls in MODEL_REGISTRY.items():
        assert cls.num_tasks == J[name].num_tasks, name


# ---------------------------------------------------------------------------
# the losses on their own
# ---------------------------------------------------------------------------


def _logits(rng, *shapes):
    return [rng.normal(size=s).astype(np.float32) * 3 for s in shapes]


@pytest.mark.parametrize("weighted", [False, True])
def test_multi_task_loss_matches_jax(weighted):
    cfg = config("mmoe")
    rng = np.random.default_rng(1)
    a, b = _logits(rng, (B, 1), (B, 1))
    jb, pb = batch_pair(cfg, 2)
    sw = rng.uniform(0.2, 3.0, B).astype(np.float32) if weighted else None
    want = jloss.multi_task_loss(
        cfg, (jnp.asarray(a), jnp.asarray(b)), jb["mask"],
        sample_weight=None if sw is None else jnp.asarray(sw))
    got = tloss.multi_task_loss(
        port_cfg(cfg), (torch.from_numpy(a), torch.from_numpy(b)),
        pb["mask"], sample_weight=None if sw is None
        else torch.from_numpy(sw))
    np.testing.assert_allclose(float(got), float(want), rtol=TOL)


@pytest.mark.parametrize("raw", [False, True])
@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("kind", ["single", "single_unbias_add",
                                  "single_unbias_multiply"])
def test_single_task_losses_match_jax(kind, train, raw):
    model = "mlp" if kind == "single" else "embed_mlp_unbias"
    method = "two_head_multiply" if kind.endswith("multiply") \
        else "two_head_add"
    cfg = config(model, single_task_raw_label=raw,
                 loss_unbias_method=method, loss_ctr_rel_method="ctr_rel")
    rng = np.random.default_rng(4)
    a, c = _logits(rng, (B, 1), (B, 1))
    jb, pb = batch_pair(cfg, 3)
    if kind == "single":
        want = jloss.single_task_loss(cfg, jnp.asarray(a), jb["mask"],
                                      jb["label"], train=train)
        got = tloss.single_task_loss(port_cfg(cfg), torch.from_numpy(a),
                                     pb["mask"], pb["label"], train=train)
    else:
        want = jloss.single_task_unbias_loss(
            cfg, (jnp.asarray(a), jnp.asarray(c)), jb["mask"], jb["label"],
            train=train)
        got = tloss.single_task_unbias_loss(
            port_cfg(cfg), (torch.from_numpy(a), torch.from_numpy(c)),
            pb["mask"], pb["label"], train=train)
    np.testing.assert_allclose(float(got), float(want), rtol=TOL)


def test_sigmoid_xent_matches_jax():
    rng = np.random.default_rng(5)
    x = np.concatenate([rng.normal(size=200) * 30, [0.0, -100.0, 100.0]]
                       ).astype(np.float32)
    z = rng.uniform(0, 5, x.shape).astype(np.float32)
    np.testing.assert_allclose(
        tloss.sigmoid_xent(torch.from_numpy(x), torch.from_numpy(z)).numpy(),
        np.asarray(jloss.sigmoid_xent(jnp.asarray(x), jnp.asarray(z))),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("emb_lambda", [0.0, 0.01])
def test_l2_regularization_matches_jax(emb_lambda):
    """The dense-kernel term and the batch-unique row term (each touched
    row once, ids past a table's rows dropped), on an embed_mlp init."""
    cfg = config("embed_mlp", wnd_wd=1e-3, l2_emb_lambda=emb_lambda)
    pcfg = port_cfg(cfg)
    params, _ = j_build(cfg).init(jax.random.PRNGKey(5))
    jb, pb = batch_pair(cfg, 6)
    want = jloss.l2_regularization(cfg, params, jb)
    got = tloss.l2_regularization(
        pcfg, params_from_jax(pcfg, jax.tree_util.tree_map(np.asarray,
                                                           params)), pb)
    np.testing.assert_allclose(float(got), float(want), rtol=TOL)


def test_model_state_converts_as_is():
    _, state = j_build(config("mmoe", True)).init(jax.random.PRNGKey(0))
    np_state = jax.tree_util.tree_map(np.asarray, state)
    got = model_state_from_jax(np_state)
    assert_trees_close(got, tree_to_tensors(np_state), "state", rel=0)
    assert len(got["mmoe"]["experts"]) == SMALL["num_experts"]
