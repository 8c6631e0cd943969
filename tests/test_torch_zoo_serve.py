"""Eval, checkpoints, export and serving of the lattice's models other than
the flagship, on the CPU, against the JAX package where it has the same
function:

- ``run_eval`` of a single-task model (``embed_mlp``) and of a multi-task
  one (``mmoe``, its gate means too), both with batch norm on moving
  statistics a train-mode batch moved, against JAX ``run_eval``;
- a ``Trainer`` checkpoint with a model state saved and restored;
- ``export_model`` -> ``load_scorer`` scoring as a ``Scorer`` over the
  checkpoint (float32 and int8 bundles), and as the JAX ``Scorer`` on the
  same weights, for ``mlp`` (no table), ``embed_mlp`` and ``mmoe``, each
  with batch norm; ``ServingPreprocessor`` for a model without tables;
- ``ScorerQueue`` over a single-task model, which scores one probability
  for both tasks;
- the CLI chain (train, resume, valid, test, export) of ``mlp`` from
  TFRecord shards."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

import __graft_entry__ as g  # noqa: E402
from cikm2020_dmt_tpu.models.zoo import build_model as j_build  # noqa: E402
from cikm2020_dmt_tpu.serve.export import Scorer as JScorer  # noqa: E402
from cikm2020_dmt_tpu.train.evaluate import \
    run_eval as j_run_eval  # noqa: E402
from cikm2020_dmt_torch.convert import (model_state_from_jax,  # noqa: E402
                                        params_from_jax)
from cikm2020_dmt_torch.core.checkpoint import \
    CheckpointManager  # noqa: E402
from cikm2020_dmt_torch.data.pipeline import Batch  # noqa: E402
from cikm2020_dmt_torch.metrics.streaming import \
    task_metrics_init  # noqa: E402
from cikm2020_dmt_torch.models.zoo import build_model  # noqa: E402
from cikm2020_dmt_torch.serve import export  # noqa: E402
from cikm2020_dmt_torch.serve.queue import ScorerQueue  # noqa: E402
from cikm2020_dmt_torch.train.evaluate import (_restore_for_eval,  # noqa: E402
                                               run_eval)
from cikm2020_dmt_torch.train.loop import Trainer  # noqa: E402
from test_torch_serve import SMALL, _norm, make_request, port_cfg  # noqa: E402
from test_torch_zoo_train import BASE, NO_TABLES  # noqa: E402

B = 64
N = 12           # candidates of a request
STEP = 3
INT8_ROWS = 1000
TOL = 1e-5
MODELS = {"mlp": dict(model_type="mlp", is_bn=True, **NO_TABLES),
          "embed_mlp_bn": dict(model_type="embed_mlp", is_bn=True),
          "mmoe_bn": dict(model_type="mmoe", is_bn=True)}


def config(name, **kw):
    cfg = g._demo_config(**{**SMALL, **BASE, **MODELS[name], **kw})
    return dataclasses.replace(cfg, transformer=dataclasses.replace(
        cfg.transformer, dropout_rate=0.0))


def jax_model(cfg, seed=3):
    """(JAX model, params, model state after one train-mode batch)."""
    jm = j_build(cfg)
    params, state = jm.init(jax.random.PRNGKey(seed))
    b = {k: jax.numpy.asarray(v) for k, v in
         g.synthetic_batch(cfg, B, seed=50).items()}
    _, state = jax.jit(lambda p, s, b: jm.apply(p, s, b, train=True))(
        params, state, b)
    return jm, params, state


def numpy_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


@pytest.mark.parametrize("name", ["embed_mlp_bn", "mmoe_bn"])
def test_run_eval_matches_jax(name):
    """Two batches, the last 5 rows of the second padding (``valid`` 0):
    metric values, scores and, for mmoe, the mean gate softmax."""
    cfg = config(name)
    pcfg = port_cfg(cfg)
    jm, params, state = jax_model(cfg)
    batches = [g.synthetic_batch(cfg, B, seed=s) for s in range(2)]
    batches[1]["valid"][-5:] = 0.0
    gates = name == "mmoe_bn"
    want = j_run_eval(cfg, jm, params, state, None, B,
                      data_iter=[g._as_batch(b) for b in batches],
                      collect_gates=gates)
    got = run_eval(pcfg, build_model(pcfg),
                   params_from_jax(pcfg, numpy_tree(params)), None, B,
                   data_iter=[Batch(b, [b""] * B) for b in batches],
                   collect_gates=gates, device="cpu",
                   model_state=model_state_from_jax(numpy_tree(state)))
    assert got[2].shape == got[3].shape == (2 * B - 5,)
    for k in want[0]:
        np.testing.assert_allclose(got[0][k], want[0][k], rtol=TOL,
                                   atol=TOL, err_msg=k)
    for a, b in zip(got[2:], want[2:]):
        np.testing.assert_allclose(a, np.asarray(b), rtol=TOL, atol=TOL)
    if name == "embed_mlp_bn":
        # a single-task model reports one probability for both tasks
        np.testing.assert_array_equal(got[2], got[3])


def test_collect_gates_needs_gates():
    pcfg = port_cfg(config("embed_mlp_bn"))
    with pytest.raises(ValueError, match="no expert gates"):
        run_eval(pcfg, build_model(pcfg), {}, None, B, data_iter=[],
                 collect_gates=True, device="cpu")


def test_checkpoint_round_trip_keeps_model_state(tmp_path):
    """One step of ``mmoe`` with batch norm, saved and restored: every
    leaf the same bits, the moving statistics moved from zero, and eval's
    restore reads the params and the model state."""
    pcfg = dataclasses.replace(port_cfg(config("mmoe_bn")),
                               output_path=str(tmp_path))
    tr = Trainer(pcfg, device="cpu")
    state = tr.init_state(torch.Generator().manual_seed(0))
    b = {k: torch.from_numpy(v)
         for k, v in g.synthetic_batch(pcfg, B, seed=1).items()}
    state, _, _ = tr.train_step(state, task_metrics_init(), b,
                                torch.Generator())
    tr.ckpt.save(STEP, state)
    back = tr.ckpt.restore(STEP)
    flat = jax.tree_util.tree_leaves_with_path(state)
    assert [p for p, _ in flat] == [
        p for p, _ in jax.tree_util.tree_leaves_with_path(back)]
    for (path, a), (_, b_) in zip(
            flat, jax.tree_util.tree_leaves_with_path(back)):
        assert torch.equal(a, b_), path
    mm = state["model_state"]["mmoe"]["experts"][0]["layer0"]["moving_mean"]
    assert float(mm.abs().max()) > 0
    params, mstate = _restore_for_eval(tr.ckpt, STEP)
    assert all(torch.equal(a, b_) for a, b_ in zip(
        jax.tree_util.tree_leaves(mstate),
        jax.tree_util.tree_leaves(state["model_state"])))


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Per model: the bundles' scorers, a Scorer over the checkpoint, the
    JAX Scorer on the same weights, and the requests."""
    d = tmp_path_factory.mktemp("zoo_serve")
    out = {}
    for name in MODELS:
        cfg = config(name, export_int8_rows=INT8_ROWS)
        mean, std = _norm(cfg)
        for stat, v in (("mean", mean), ("std", std)):
            (d / stat).write_text("\t".join(repr(float(x)) for x in v))
        jm, params, state = jax_model(cfg)
        pcfg = dataclasses.replace(
            port_cfg(cfg), output_path=str(d / name),
            train_data_mean_path=str(d / "mean"),
            train_data_std_path=str(d / "std"))
        pp = params_from_jax(pcfg, numpy_tree(params))
        ps = model_state_from_jax(numpy_tree(state))
        CheckpointManager(pcfg.model_path).save(
            STEP, {"params": pp, "model_state": ps})
        scale, const = export.norm_constants(mean, std)
        bundles = {}
        for kind, rows in (("f32", 0), ("int8", INT8_ROWS)):
            c = dataclasses.replace(pcfg, export_int8_rows=rows)
            bundles[kind] = export.load_scorer(
                c, export.export_model(c, STEP, str(d / f"{name}_{kind}")),
                device="cpu")
        out[name] = dict(
            cfg=cfg, pcfg=pcfg, bundles=bundles,
            scorer=export.Scorer(pcfg, pp, scale, const, device="cpu",
                                 model_state=ps),
            jax=JScorer(cfg, params, state, scale, const),
            reqs=[make_request(cfg, N, seed) for seed in range(2)])
    return out


@pytest.mark.parametrize("name", sorted(MODELS))
def test_bundle_scores_as_checkpoint_and_jax(served, name):
    s = served[name]
    for req in s["reqs"]:
        got = s["bundles"]["f32"](req)
        want = s["scorer"](req)
        jwant = s["jax"](req)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            np.testing.assert_allclose(got[k], np.asarray(jwant[k]),
                                       rtol=TOL, atol=TOL, err_msg=k)
        np.testing.assert_allclose(s["bundles"]["int8"](req)["Scores"],
                                   got["Scores"], atol=0.05)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_int8_bundle_tables(served, name):
    params = served[name]["bundles"]["int8"].params
    if name == "mlp":
        assert "emb" not in params   # nothing to quantize
        np.testing.assert_array_equal(
            served[name]["bundles"]["int8"](served[name]["reqs"][0])[
                "Scores"],
            served[name]["bundles"]["f32"](served[name]["reqs"][0])[
                "Scores"])
    else:
        assert params["emb"]["Sku"]["q"].dtype == torch.int8


def test_preprocessor_without_tables(served):
    """``mlp``: a request is its dense features alone."""
    s = served["mlp"]
    prep = export.ServingPreprocessor(s["pcfg"])
    raw = s["reqs"][0]["raw_features"]
    req = prep.assemble(N, {}, raw_features=raw)
    assert sorted(req) == ["mask", "raw_features", "valid"]
    for k, v in s["bundles"]["f32"](req).items():
        np.testing.assert_array_equal(v, s["scorer"](s["reqs"][0])[k])


def test_queue_over_a_single_task_model(served):
    s = served["embed_mlp_bn"]
    scorer = s["bundles"]["f32"]
    q = ScorerQueue(scorer, max_group=2, groups=(1, 2))
    futs = [q.submit(r) for r in s["reqs"] * 2]
    for i, fut in enumerate(futs):
        got = {k: v.numpy() for k, v in fut.result(timeout=60).items()}
        want = scorer(s["reqs"][i % 2])
        np.testing.assert_allclose(got["Scores"], want["Scores"],
                                   rtol=1e-6, atol=1e-6)
        # one probability for both tasks, so the blend is that probability
        np.testing.assert_array_equal(got["click_Scores"],
                                      got["order_Scores"])
        np.testing.assert_allclose(got["Scores"], got["click_Scores"],
                                   rtol=1e-6)
    q.close()
    assert scorer.model_state       # the bundle's moving statistics


def test_cli_chain_of_a_model_without_tables(tmp_path):
    """``cli.train`` (2 steps, then resumed to 4), ``cli.valid --once``,
    ``cli.test`` and ``cli.export`` of ``mlp`` with batch norm from
    TFRecord shards: the moving statistics survive the checkpoints and
    the bundle, and the bundle scores as a ``Scorer`` over the last
    checkpoint."""
    import chip_smoke as cs
    from cikm2020_dmt_torch.cli import export as cli_export
    from cikm2020_dmt_torch.cli import test as cli_test
    from cikm2020_dmt_torch.cli import train as cli_train
    from cikm2020_dmt_torch.cli import valid as cli_valid
    from cikm2020_dmt_torch.core.config import DMTConfig

    cfg = dataclasses.replace(port_cfg(config("mlp")), validate_step=2,
                              validation_batch_size=B, test_batch_size=B)
    data = tmp_path / "data"
    data.mkdir()
    cs.write_shards(cfg, str(data), 2, B, seed=0)
    mean, std = _norm(cfg)
    for stat, v in (("mean", mean), ("std", std)):
        (tmp_path / stat).write_text("\t".join(repr(float(x)) for x in v))
    conf = str(tmp_path / "mlp.conf")
    d = str(data) + "/"
    cs.write_conf(cfg, conf, d, str(tmp_path / "out"),
                  validation_data_path=d, test_data_path=d,
                  train_data_mean_path=str(tmp_path / "mean"),
                  train_data_std_path=str(tmp_path / "std"))
    back = DMTConfig.from_ini(conf)
    assert (back.model_type, back.is_bn, back.hidden_units) == (
        "mlp", True, cfg.hidden_units)
    args = ["--conf_file", conf, "--device", "cpu"]
    cli_train.main(args + ["--max_steps", "2"])
    cli_train.main(args + ["--max_steps", "4", "--model_ckpt",
                           "model.ckpt-2"])
    assert cli_valid.main(args + ["--once"])
    res = cli_test.main(args + ["--model_ckpt", "model.ckpt-4",
                                "--test_score_method", "rel"])
    (r,) = res.values()
    assert "gate_mean" not in r and np.isfinite(r["overall_auc"]["click"])
    bundle = export.load_scorer(back, cli_export.main(
        args[:2] + ["--model_ckpt", "model.ckpt-4"]), device="cpu")
    params, mstate = _restore_for_eval(CheckpointManager(back.model_path), 4)
    assert sorted(mstate) == ["layer0", "layer1", "out"]
    direct = export.Scorer(back, params, *export.norm_constants(mean, std),
                           device="cpu", model_state=mstate)
    req = make_request(config("mlp"), N, 0)
    for k, v in bundle(req).items():
        np.testing.assert_array_equal(v, direct(req)[k], err_msg=k)
