"""The multi-block transformer path (two encoder and two decoder blocks per
behaviour sequence, transformer dropout 0) of the port on the CPU against
the JAX package on the same numpy batches and JAX weights carried across
by ``convert``: the ``Scorer``, the eval step and ``run_eval``, and two
``Trainer`` steps.  Such a stack takes the per-op transformer path, whose
``mha_apply`` runs ``ops.attention.fused_attention`` without dropout (the
plain version here, the CUDA kernels on the card).  On the CPU the JAX
package runs ``attention_core`` there (its kernel gate needs a TPU); the
kernel itself is compared in ``tests/test_torch_attention.py``."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

import __graft_entry__ as g  # noqa: E402
from cikm2020_dmt_tpu.metrics.streaming import \
    task_metrics_init as j_metrics_init  # noqa: E402
from cikm2020_dmt_tpu.metrics.streaming import \
    task_metrics_values as j_metrics_values  # noqa: E402
from cikm2020_dmt_tpu.models.zoo import build_model as j_build  # noqa: E402
from cikm2020_dmt_tpu.serve.export import Scorer as JScorer  # noqa: E402
from cikm2020_dmt_tpu.serve.export import norm_constants as j_norm  # noqa: E402
from cikm2020_dmt_tpu.train.evaluate import \
    make_eval_step as j_eval_step  # noqa: E402
from cikm2020_dmt_tpu.train.evaluate import run_eval as j_run_eval  # noqa: E402
from cikm2020_dmt_torch.convert import params_from_jax  # noqa: E402
from cikm2020_dmt_torch.core.config import TransformerConfig  # noqa: E402
from cikm2020_dmt_torch.data.pipeline import Batch  # noqa: E402
from cikm2020_dmt_torch.metrics.streaming import (  # noqa: E402
    task_metrics_init, task_metrics_values)
from cikm2020_dmt_torch.models.zoo import build_model  # noqa: E402
from cikm2020_dmt_torch.nn import transformer as ttrans  # noqa: E402
from cikm2020_dmt_torch.serve.export import Scorer  # noqa: E402
from cikm2020_dmt_torch.train.evaluate import (make_eval_step,  # noqa: E402
                                               run_eval)
from test_torch_serve import SMALL, make_request, port_cfg  # noqa: E402
from test_torch_train import (LAZY, PARAM_TOL, leaves,  # noqa: E402
                              no_dropout_config, port_view, run_both)

B = 24


def two_block(cfg):
    """``cfg`` with two encoder and two decoder blocks per sequence."""
    return dataclasses.replace(cfg, transformer=dataclasses.replace(
        cfg.transformer, num_blocks_encode=2, num_blocks_decode=2))


def eval_config():
    """Bias-net dropout left on (0.5): eval must not apply it."""
    return two_block(no_dropout_config(table_bf16_threshold=0,
                                       dropout_rate_bias=(0.5, 0.5)))


@pytest.fixture(scope="module")
def models():
    """(JAX config, JAX model, JAX params, JAX model state, port config,
    port model, port params)."""
    jcfg = eval_config()
    jm = j_build(jcfg)
    params, state = jm.init(jax.random.PRNGKey(3))
    pcfg = port_cfg(jcfg)
    pp = params_from_jax(pcfg, jax.tree_util.tree_map(np.asarray, params))
    assert len(pp["trans"]["seq0"]["enc"]) == 2
    assert len(pp["trans"]["seq0"]["dec"]) == 2
    return jcfg, jm, params, state, pcfg, build_model(pcfg), pp


def test_scorer_matches_jax(models):
    jcfg, _, params, state, pcfg, _, pp = models
    rng = np.random.default_rng(5)
    scale, const = j_norm(rng.normal(size=jcfg.feature_dimension),
                          rng.uniform(0.1, 2.0, jcfg.feature_dimension))
    js = JScorer(jcfg, params, state, scale, const)
    ts = Scorer(pcfg, pp, scale, const, device="cpu")
    req = make_request(jcfg, B, seed=6)  # includes a len-0 cart history
    got, want = ts(req), js(req)
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=1e-5,
                                   atol=1e-5, err_msg=k)


def _batches(cfg, n):
    """Two eval batches; the second has its last 5 rows padded
    (``valid`` 0)."""
    out = [g.synthetic_batch(cfg, n, seed=40 + i) for i in range(2)]
    out[1]["valid"][-5:] = 0.0
    return out


def test_eval_step_matches_jax(models):
    """One eval step: the metric values and both scores."""
    jcfg, jm, params, state, pcfg, pm, pp = models
    batch = _batches(jcfg, B)[0]
    jmet, jctr, jcvr, _ = j_eval_step(jcfg, jm)(
        params, state, j_metrics_init(),
        {k: jax.numpy.asarray(v) for k, v in batch.items()})
    met, ctr, cvr = make_eval_step(pcfg, pm)(
        pp, task_metrics_init(),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(ctr.numpy(), np.asarray(jctr), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(cvr.numpy(), np.asarray(jcvr), rtol=1e-5,
                               atol=1e-5)
    want = j_metrics_values(jax.tree_util.tree_map(np.asarray, jmet))
    got = task_metrics_values(met)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)


def test_run_eval_matches_jax(models):
    """``run_eval`` over two batches, one with padded rows: the metric
    values and the scores of the valid rows."""
    jcfg, jm, params, state, pcfg, pm, pp = models
    batches = _batches(jcfg, B)
    jvals, _, jclk, jord = j_run_eval(
        jcfg, jm, params, state, None, B,
        data_iter=[g._as_batch(b) for b in batches])
    vals, _, clk, ord_ = run_eval(
        pcfg, pm, pp, None, B,
        data_iter=[Batch(b, [b""] * B) for b in batches], device="cpu")
    assert clk.shape == ord_.shape == (2 * B - 5,)
    np.testing.assert_allclose(clk, jclk, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ord_, jord, rtol=1e-5, atol=1e-5)
    for k in jvals:
        np.testing.assert_allclose(vals[k], jvals[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)


def test_eval_rejects_unported_models():
    """A reference dispatch name that neither package builds."""
    cfg = port_cfg(g._demo_config(**SMALL, model_type="din_v2"))
    with pytest.raises(ValueError, match="unknown model_type"):
        make_eval_step(cfg, None)


def test_run_eval_default_device_needs_cuda(models):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    _, _, _, _, pcfg, pm, pp = models
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_eval(pcfg, pm, pp, None, B, data_iter=[])


@pytest.fixture(scope="module")
def train_run():
    return run_both(two_block(no_dropout_config()))


def test_train_loss_matches_jax(train_run):
    np.testing.assert_allclose(train_run["plosses"], train_run["jlosses"],
                               rtol=1e-5)


@pytest.mark.parametrize("step", [1, 2])
def test_train_params_match_jax(train_run, step):
    """``test_torch_train.py``'s tolerance: 2 lr per element (a gradient
    near zero may flip its sign under another summation order), and the
    median far below it."""
    want = port_view(train_run["pcfg"], train_run["jstates"][step])["params"]
    got = jax.tree_util.tree_map(lambda t: t.numpy(),
                                 train_run["pstates"][step - 1]["params"])
    diffs = []
    for (path, a), (_, b) in zip(leaves(got), leaves(want)):
        assert a.shape == b.shape, path
        np.testing.assert_allclose(a, b, rtol=0, atol=PARAM_TOL,
                                   err_msg=path)
        diffs.append(np.abs(a - b).ravel())
    assert np.median(np.concatenate(diffs)) < 1e-6
    assert len(got["trans"]["seq2"]["enc"]) == 2


@pytest.mark.parametrize("step", [1, 2])
def test_train_optimizer_state_matches_jax(train_run, step):
    """Dense m and v and the lazy moments, with ``test_torch_train.py``'s
    tolerances (1e-4 of each leaf's largest |value|, floors 1e-8 and
    1e-12)."""
    want = port_view(train_run["pcfg"], train_run["jstates"][step])
    got = jax.tree_util.tree_map(lambda t: t.numpy(),
                                 train_run["pstates"][step - 1])
    pairs = [(a, b, 1e-8) for a, b in zip(leaves(got["opt"]["m"]),
                                          leaves(want["opt"]["m"]))]
    pairs += [(a, b, 1e-12) for a, b in zip(leaves(got["opt"]["v"]),
                                            leaves(want["opt"]["v"]))]
    for t in LAZY:
        a, b = got["lazy_opt"][t]["mv"], want["lazy_opt"][t]["mv"]
        pairs += [((f"{t}/m", a[0]), (t, b[0]), 1e-8),
                  ((f"{t}/v", a[1]), (t, b[1]), 1e-12)]
    for (path, a), (_, b), floor in pairs:
        atol = max(1e-4 * np.abs(b).max(), floor)
        np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=path)


def test_train_metrics_match_jax(train_run):
    want = dict(leaves(train_run["jmetrics"]))
    got = dict(leaves(jax.tree_util.tree_map(lambda t: t.numpy(),
                                             train_run["pmetrics"])))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("train,rate,path", [
    (False, 0.1, "kernel"), (True, 0.0, "kernel"), (True, 0.1, "jnp")])
def test_mha_reaches_the_kernel_without_dropout(train, rate, path,
                                                monkeypatch):
    """``mha_apply`` calls ``ops.attention.fused_attention`` unless dropout
    is active (training with a rate > 0), where it keeps ``attention_core``:
    4 attention calls (2 encoder + 2 decoder blocks) per sequence."""
    calls = {"kernel": 0, "jnp": 0}

    def spy(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(ttrans, "fused_attention",
                        spy("kernel", ttrans.fused_attention))
    monkeypatch.setattr(ttrans, "attention_core",
                        spy("jnp", ttrans.attention_core))
    tc = TransformerConfig(d_model=16, num_heads=2, d_ff=32, maxlen_k=10,
                           num_blocks_encode=2, num_blocks_decode=2,
                           dropout_rate=rate)
    gen = torch.Generator().manual_seed(0)
    params = ttrans.transformer_init(gen, tc)
    mask = (torch.arange(10)[None] < torch.tensor([[3], [10], [0]])).float()
    out = ttrans.encode_decode(params, tc, seq_emb=torch.randn(3, 10, 16),
                               seq_mask=mask, tar_emb=torch.randn(3, 16),
                               train=train, gen=gen)
    assert out.shape == (3, 16) and torch.isfinite(out).all()
    assert calls == {"kernel": 4 * (path == "kernel"),
                     "jnp": 4 * (path == "jnp")}
