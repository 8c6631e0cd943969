"""The port's serving path (``Scorer`` on the CPU) against the JAX
``Scorer`` on the same requests and the same weights: a JAX ``model.init``
converted by ``cikm2020_dmt_torch.convert``, the flagship model
(mmoe_transformer_unbias) with shrunken tables."""

from dataclasses import asdict, astuple, fields

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from __graft_entry__ import _demo_config, synthetic_batch  # noqa: E402
from cikm2020_dmt_tpu.data.pipeline import IDS, LEN, WTS  # noqa: E402
from cikm2020_dmt_tpu.data.schema import FeatureSchema  # noqa: E402
from cikm2020_dmt_tpu.models.zoo import build_model as j_build  # noqa: E402
from cikm2020_dmt_tpu.nn.embedding import unpack_table as j_unpack  # noqa: E402
from cikm2020_dmt_tpu.serve.export import Scorer as JScorer  # noqa: E402
from cikm2020_dmt_tpu.serve.export import norm_constants as j_norm  # noqa: E402
from cikm2020_dmt_torch.convert import params_from_jax  # noqa: E402
from cikm2020_dmt_torch.core import config as tconfig  # noqa: E402
from cikm2020_dmt_torch.models.zoo import build_model as t_build  # noqa: E402
from cikm2020_dmt_torch.serve.export import Scorer, norm_constants  # noqa: E402

B = 12
SMALL = dict(feature_dimension=24, hidden_units_bottom=(32, 16),
             hidden_units_task=(8,), num_experts=3)


def port_cfg(jcfg):
    """The port's DMTConfig with the same field values as a JAX one."""
    kw = {}
    for f in fields(jcfg):
        v = getattr(jcfg, f.name)
        if f.name in ("embeddings", "embeddings_bias"):
            v = tuple(tconfig.EmbeddingSpec(*astuple(s)) for s in v)
        elif f.name == "transformer":
            v = tconfig.TransformerConfig(**asdict(v))
        kw[f.name] = v
    return tconfig.DMTConfig(**kw)


def _uside_row(f, length, rng, ts_feats):
    ids = np.zeros((1, f.max_len), np.int32)
    if f.name in ts_feats:
        ids[0, :length] = rng.integers(1, 10**7, length)
    else:
        ids[0, :length] = rng.integers(1, f.id_size, length)
    wts = (np.arange(f.max_len) < length).astype(np.float32)[None]
    return ids, wts, np.array([length], np.int32)


def make_request(jcfg, n, seed):
    """One request of ``n`` candidates with ``[1, L]`` u-side rows: the
    click history full, the cart history empty (length 0), the rest as
    ``synthetic_batch`` draws them."""
    rng = np.random.default_rng(seed)
    b = synthetic_batch(jcfg, n, seed)
    req = {"raw_features": rng.uniform(-1.0, 6.0, (n, jcfg.feature_dimension)
                                       ).astype(np.float32),
           "valid": np.ones((n,), np.float32)}
    ts_feats = set(jcfg.attention_ts)
    for f in FeatureSchema.from_config(jcfg).id_features:
        keys = (f.name + IDS, f.name + WTS, f.name + LEN)
        if f.side != "u":
            for k in keys:
                req[k] = b[k]
            continue
        if f.name.startswith("clk_seq_"):
            row = _uside_row(f, f.max_len, rng, ts_feats)
        elif f.name.startswith("cart_seq_"):
            row = _uside_row(f, 0, rng, ts_feats)
        else:
            row = tuple(b[k][:1] for k in keys)
        req.update(zip(keys, row))
    return req


def _norm(jcfg, seed=5):
    rng = np.random.default_rng(seed)
    mean = rng.normal(size=jcfg.feature_dimension)
    std = rng.uniform(0.1, 2.0, jcfg.feature_dimension)
    return mean, std


def _pair(seed=0, **overrides):
    """(JAX scorer, port CPU scorer, JAX config, JAX numpy params)."""
    jcfg = _demo_config(**{**SMALL, **overrides})
    model = j_build(jcfg)
    params, state = model.init(jax.random.PRNGKey(seed))
    np_params = jax.tree_util.tree_map(np.asarray, params)
    scale, const = j_norm(*_norm(jcfg))
    js = JScorer(jcfg, params, state, scale, const)
    ts = Scorer(port_cfg(jcfg), params_from_jax(port_cfg(jcfg), np_params),
                scale, const, device="cpu")
    return js, ts, jcfg, np_params


def _close(got, want, tol):
    assert set(got) == {"Scores", "click_Scores", "order_Scores"}
    for k in want:
        assert got[k].shape == np.asarray(want[k]).shape, k
        assert np.isfinite(got[k]).all(), k
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=tol,
                                   atol=tol, err_msg=k)


def test_f32_scores_match_jax():
    js, ts, jcfg, _ = _pair(table_bf16_threshold=0)
    req = make_request(jcfg, B, seed=1)
    _close(ts(req), js(req), 1e-5)


# bf16 tables: both sides gather the same bf16 rows and round the pooled
# bf16 mean at the same points (measured max |diff| 6e-8 over three seeds);
# the tolerance leaves room for a summation order that differs by one bf16
# ulp of a pooled value somewhere, which the f32 trunk damps
BF16_TOL = 1e-4


def test_bf16_tables_scores_match_jax():
    js, ts, jcfg, _ = _pair(seed=1)
    assert ts.params["emb"]["Sku"].dtype == torch.bfloat16
    assert ts.params["emb"]["TimeClick"].dtype == torch.float32
    req = make_request(jcfg, B, seed=2)
    _close(ts(req), js(req), BF16_TOL)


def test_grouped_requests_match_jax_and_single():
    js, ts, jcfg, _ = _pair(seed=2, table_bf16_threshold=0)
    reqs = [make_request(jcfg, B, seed=10 + i) for i in range(3)]
    got = ts.score_group(reqs)
    want = {k: np.asarray(v) for k, v in js.score_group_async(reqs).items()}
    _close(got, want, 1e-5)
    singles = [ts(r)["Scores"] for r in reqs]
    np.testing.assert_allclose(got["Scores"], np.concatenate(singles),
                               rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="equal candidate counts"):
        ts.score_group([reqs[0], make_request(jcfg, B + 1, seed=3)])


def test_packed_tables_unpack_in_convert():
    """Tables the reference stores 128-lane packed come out logical."""
    js, ts, jcfg, np_params = _pair(seed=3, table_bf16_threshold=0,
                                    pack_rows_threshold=1000)
    packed = np_params["emb"]["Sku"]
    assert packed.shape == (4096 // 4, 128)
    sku = ts.params["emb"]["Sku"]
    assert tuple(sku.shape) == (4096, 32)
    np.testing.assert_array_equal(sku.numpy(),
                                  np.asarray(j_unpack(packed, 4096, 32)))
    assert tuple(ts.params["emb"]["Cid3"].shape) == (2048, 8)
    req = make_request(jcfg, B, seed=4)
    _close(ts(req), js(req), 1e-5)


def test_convert_rejects_wrong_table_shape():
    jcfg = _demo_config(**SMALL)
    tcfg = port_cfg(jcfg)
    bad = {"emb": {"Sku": np.zeros((100, 32), np.float32)}}
    with pytest.raises(ValueError, match="Sku"):
        params_from_jax(tcfg, bad)


def test_port_init_tree_matches_jax():
    """``init(generator)`` gives the reference's tree: same keys, shapes
    and dtypes, the bias net included (tables logical, bf16 from 500
    rows)."""
    jcfg = _demo_config(**SMALL, packed_tables=False)
    jp, _ = j_build(jcfg).init(jax.random.PRNGKey(0))
    tp = t_build(port_cfg(jcfg)).init(torch.Generator().manual_seed(0))
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    tflat = jax.tree_util.tree_flatten_with_path(
        tp, is_leaf=lambda x: isinstance(x, torch.Tensor))[0]
    assert [p for p, _ in jflat] == [p for p, _ in tflat]
    for (path, a), (_, t) in zip(jflat, tflat):
        assert tuple(t.shape) == a.shape, path
        assert str(t.dtype).split(".")[-1] == str(a.dtype), path


def test_norm_constants_match_jax():
    mean, std = _norm(_demo_config(**SMALL))
    for got, want in zip(norm_constants(mean, std), j_norm(mean, std)):
        np.testing.assert_array_equal(got, want)


def test_build_model_rejects_unported_types():
    """A reference dispatch name that neither package builds."""
    cfg = port_cfg(_demo_config(**SMALL, model_type="dien_v2"))
    with pytest.raises(ValueError, match="unknown model_type"):
        t_build(cfg)


@pytest.mark.parametrize("method", ["two_head_add", "two_head_multiply"])
@pytest.mark.parametrize("form", ["unbias", "unbias_rel", "single_unbias",
                                  "multi_task", "single"])
def test_scores_from_logits_matches_jax(form, method):
    from cikm2020_dmt_tpu.train.losses import scores_from_logits as j_scores
    from cikm2020_dmt_torch.train.losses import scores_from_logits
    rng = np.random.default_rng(6)
    a, b, c = (rng.normal(size=(7, 1)).astype(np.float32) for _ in range(3))
    model = {"single_unbias": "embed_mlp_unbias", "single": "mlp"}.get(
        form, "mmoe_transformer_unbias")
    jcfg = _demo_config(**SMALL, model_type=model,
                        loss_unbias_method=method)
    logits = {"unbias": ((a, b), c), "unbias_rel": ((a, b), c),
              "single_unbias": (a, c), "multi_task": (a, b),
              "single": a}[form]
    rel = form == "unbias_rel"
    want = j_scores(jcfg, jax.tree_util.tree_map(jax.numpy.asarray, logits),
                    rel_only=rel)
    got = scores_from_logits(port_cfg(jcfg), jax.tree_util.tree_map(
        torch.from_numpy, logits), rel_only=rel)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)
