"""The port's eval over files, ``validation``, ``predict`` and the
``cli.valid`` / ``cli.test`` / ``cli.plot`` entry points against the JAX
package's, on the CPU.

Both sides read the same TFRecord shards written here (74 examples, so
the last batch of 16 is padded) with the same weights: a JAX
``model.init`` (Sku lane-packed at this size) saved as an Orbax
checkpoint for the JAX evaluator, and carried across by
``convert.params_from_jax`` into a port checkpoint of the same step."""

import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

import __graft_entry__ as g  # noqa: E402
import chip_smoke as cs  # noqa: E402
from cikm2020_dmt_tpu.core.checkpoint import \
    CheckpointManager as JCheckpointManager  # noqa: E402
from cikm2020_dmt_tpu.models.zoo import build_model as j_build  # noqa: E402
from cikm2020_dmt_tpu.train import evaluate as jeval  # noqa: E402
from cikm2020_dmt_tpu.train.optim import make_optimizer  # noqa: E402
from cikm2020_dmt_torch.cli import plot as cli_plot  # noqa: E402
from cikm2020_dmt_torch.cli import test as cli_test  # noqa: E402
from cikm2020_dmt_torch.cli import valid as cli_valid  # noqa: E402
from cikm2020_dmt_torch.convert import params_from_jax  # noqa: E402
from cikm2020_dmt_torch.core.checkpoint import CheckpointManager  # noqa: E402
from cikm2020_dmt_torch.core.config import DMTConfig  # noqa: E402
from cikm2020_dmt_torch.metrics.offline import ParsedHeaders  # noqa: E402
from cikm2020_dmt_torch.models.zoo import build_model  # noqa: E402
from cikm2020_dmt_torch.train import evaluate  # noqa: E402
from test_torch_serve import SMALL, port_cfg  # noqa: E402

B = 16
PER_SHARD = 37
STEP = 3
TOL = 1e-5
KW = dict(sku_rows=4096, pack_rows_threshold=1000, table_bf16_threshold=0,
          batch_size=B, validation_batch_size=B, test_batch_size=B)


def read_result(path):
    """A result file as [(key, value)] in file order; values are floats
    where they parse as one."""
    out = []
    for line in open(path).read().splitlines():
        k, _, v = line.partition(":")
        try:
            out.append((k, float(v)))
        except ValueError:
            out.append((k, v.strip()))
    return out


def assert_results_close(got_path, want_path):
    got, want = read_result(got_path), read_result(want_path)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, a), (_, b) in zip(got, want):
        if isinstance(b, float):
            np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL, err_msg=k)
        else:
            assert a == b, k


def detail_rows(path):
    rows = [line.rsplit("\t", 2) for line in open(path).read().splitlines()]
    return ([h for h, _, _ in rows],
            np.array([[float(c), float(o)] for _, c, o in rows]))


def numpy_init(jm, seed):
    """(params, model state) of the JAX model's tree, shapes and dtypes
    (lane-packed tables included), drawn from a numpy seed: normal with
    standard deviation 0.1 (the JAX ``model.init`` takes several seconds
    on the CPU; ``eval_shape`` gives its tree at once)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(
        lambda s: (0.1 * rng.normal(size=s.shape)).astype(s.dtype), shapes)


@pytest.fixture(scope="module", autouse=True)
def one_jax_step_per_variant():
    """The JAX evaluator builds a new jitted step at every ``run_eval``;
    memoized per (rel_only, collect_gates), the module compiles each
    variant once (every call here evaluates one config)."""
    real = jeval.make_eval_step
    steps = {}

    def memo(cfg, model, rel_only=False, collect_gates=False):
        key = (rel_only, collect_gates)
        if key not in steps:
            steps[key] = real(cfg, model, rel_only, collect_gates)
        return steps[key]

    jeval.make_eval_step = memo
    yield
    jeval.make_eval_step = real


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("eval_files")
    data = d / "data"
    data.mkdir()
    base = g._demo_config(**SMALL, **KW)
    cs.write_shards(port_cfg(base), str(data), 2, PER_SHARD, seed=5)
    path = str(data) + "/"
    jcfg = dataclasses.replace(base, validation_data_path=path,
                               test_data_path=path, test_data_path_ord=path,
                               output_path=str(d / "jax"))
    pcfg = dataclasses.replace(port_cfg(jcfg), output_path=str(d / "port"))
    jm = j_build(jcfg)
    params, state = numpy_init(jm, seed=7)
    JCheckpointManager(jcfg.model_path).save(STEP, {
        "params": params, "model_state": state,
        "opt_state": make_optimizer(jcfg).init(params),
        "step": np.zeros((), np.int32)})
    pp = params_from_jax(pcfg, params)
    CheckpointManager(pcfg.model_path).save(STEP, {"params": pp})
    return {"d": d, "path": path, "jcfg": jcfg, "pcfg": pcfg, "jm": jm,
            "params": params, "state": state, "pp": pp}


@pytest.fixture(scope="module")
def evals(setup):
    s = setup
    d = s["d"]
    want = jeval.run_eval(s["jcfg"], s["jm"], s["params"], s["state"],
                          s["path"], B, collect_gates=True,
                          detail_file=str(d / "jax.detail"))
    got = evaluate.run_eval(s["pcfg"], build_model(s["pcfg"]), s["pp"],
                            s["path"], B, collect_gates=True,
                            detail_file=str(d / "port.detail"), device="cpu")
    return want, got


def test_run_eval_from_files_matches_jax(evals):
    (jvals, jheaders, jclk, jord, jgate), (vals, headers, clk, ord_, gate) \
        = evals
    assert clk.shape == ord_.shape == (2 * PER_SHARD,)
    assert clk.dtype == np.float32
    np.testing.assert_allclose(clk, jclk, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(ord_, jord, rtol=TOL, atol=TOL)
    assert set(vals) == set(jvals)
    for k in jvals:
        np.testing.assert_allclose(vals[k], jvals[k], rtol=TOL, atol=TOL,
                                   err_msg=k)
    assert headers == jheaders
    assert len(headers) == 2 * PER_SHARD
    assert gate.shape == jgate.shape == (2, SMALL["num_experts"])
    np.testing.assert_allclose(gate, jgate, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(gate.sum(axis=1), 1.0, rtol=1e-6)


def test_detail_file_matches_jax(setup, evals):
    d = setup["d"]
    jh, jsc = detail_rows(d / "jax.detail")
    h, sc = detail_rows(d / "port.detail")
    assert h == jh and len(h) == 2 * PER_SHARD
    np.testing.assert_allclose(sc, jsc, rtol=TOL, atol=TOL)


def test_gates_cost_no_extra_forward(setup, monkeypatch):
    """``collect_gates`` reads the gate softmax of the same forward: one
    ``sequence_interest`` a batch, with or without it."""
    from cikm2020_dmt_torch.models import zoo
    calls = []
    real = zoo.sequence_interest
    monkeypatch.setattr(zoo, "sequence_interest",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    s = setup
    for gates in (False, True):
        calls.clear()
        evaluate.run_eval(s["pcfg"], build_model(s["pcfg"]), s["pp"],
                          s["path"], B, collect_gates=gates, device="cpu")
        assert len(calls) == -(-2 * PER_SHARD // B)


def test_collector_spills_in_run_eval(setup, evals, monkeypatch):
    """Past ``DMT_EVAL_SPILL_ROWS`` the headers come back as labels and
    group codes, and the offline metrics are the same."""
    from cikm2020_dmt_torch.metrics import offline
    s = setup
    monkeypatch.setenv("DMT_EVAL_SPILL_ROWS", "20")
    _, spilled, clk, ord_ = evaluate.run_eval(
        s["pcfg"], build_model(s["pcfg"]), s["pp"], s["path"], B,
        device="cpu")
    assert isinstance(spilled, ParsedHeaders)
    raw = evals[1][1]
    schema = s["pcfg"].header_schema
    for fn in (offline.grouped_auc, offline.overall_auc):
        assert fn(schema, spilled, clk + ord_) == fn(schema, raw, clk + ord_)
    a = offline.precision_mrr_at_n(schema, spilled, clk + ord_)
    b = offline.precision_mrr_at_n(schema, raw, clk + ord_)
    for k in b:
        np.testing.assert_array_equal(np.stack(a[k]), np.stack(b[k]))


def test_validation_matches_jax(setup):
    s = setup
    jvals = jeval.validation(s["jcfg"], once=True)
    vals = evaluate.validation(s["pcfg"], once=True, device="cpu")
    for k in jvals:
        np.testing.assert_allclose(vals[k], jvals[k], rtol=TOL, atol=TOL,
                                   err_msg=k)
    assert_results_close(s["pcfg"].validation_result_path,
                         s["jcfg"].validation_result_path)
    lines = open(s["pcfg"].validation_result_path).read().splitlines()
    assert lines[0] == f">> iter_steps:{STEP}"
    assert any(x.startswith("action_2_mrr_at_14: ") for x in lines)
    # evaluated once: a second call finds nothing newer
    assert evaluate.validation(s["pcfg"], once=True, device="cpu") is None
    assert evaluate.newest_result_step(
        s["pcfg"].validation_result_path) == STEP


@pytest.mark.parametrize("method,grid", [("rel", True), ("ctr", False)])
def test_predict_matches_jax(setup, method, grid):
    s = setup
    want = jeval.predict(s["jcfg"], STEP, test_tag="ord",
                         test_score_method=method, grid_search=grid)
    got = evaluate.predict(s["pcfg"], STEP, test_tag="ord",
                           test_score_method=method, grid_search=grid,
                           device="cpu")
    name = f"{s['pcfg'].tag}.ckpt-{STEP}.test_result_ord_{method}"
    pout = os.path.join(s["pcfg"].output_path, name)
    jout = os.path.join(s["jcfg"].output_path, name)
    assert_results_close(pout, jout)
    keys = [k for k, _ in read_result(pout)]
    assert "gate_click_expert_0" in keys and "grouped_auc_order" in keys
    assert ("max_key" in keys) == grid
    jh, jsc = detail_rows(jout + ".detail")
    h, sc = detail_rows(pout + ".detail")
    assert h == jh
    np.testing.assert_allclose(sc, jsc, rtol=TOL, atol=TOL)
    (path, r), = got.items()
    jr = want[path]
    np.testing.assert_allclose(r["gate_mean"], jr["gate_mean"], rtol=TOL,
                               atol=TOL)
    for k in ("click", "order"):
        np.testing.assert_allclose(r["overall_auc"][k], jr["overall_auc"][k],
                                   rtol=TOL, atol=TOL)
    if grid:
        assert r["grid"]["max_key"] == jr["grid"]["max_key"]


@pytest.mark.parametrize("fn", ["run_eval", "validation", "predict"])
def test_entry_points_need_cuda_by_default(setup, fn):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    s = setup
    calls = {
        "run_eval": lambda: evaluate.run_eval(
            s["pcfg"], build_model(s["pcfg"]), s["pp"], s["path"], B),
        "validation": lambda: evaluate.validation(s["pcfg"], once=True),
        "predict": lambda: evaluate.predict(s["pcfg"], STEP),
    }
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[fn]()


def test_cli_valid_test_plot(setup, tmp_path, capsys):
    """``cli.valid --once``, ``cli.test --grid_search`` and ``cli.plot``'s
    CSV on a config file, on the CPU."""
    s = setup
    out = tmp_path / "out"
    conf = str(tmp_path / "dmt.conf")
    cs.write_conf(s["pcfg"], conf, s["path"], str(out),
                  validation_data_path=s["path"], test_data_path=s["path"])
    cfg = DMTConfig.from_ini(conf)
    CheckpointManager(cfg.model_path).save(STEP, {"params": s["pp"]})
    argv = ["--conf_file", conf, "--device", "cpu"]
    vals = cli_valid.main(argv + ["--once"])
    assert vals and all(np.isfinite(v) for v in vals.values())
    lines = open(cfg.validation_result_path).read().splitlines()
    assert lines[0] == f">> iter_steps:{STEP}"
    capsys.readouterr()
    res = cli_test.main(argv + ["--model_ckpt", f"model.ckpt-{STEP}",
                                "--grid_search"])
    printed = [json.loads(x) for x in capsys.readouterr().out.splitlines()
               if x.startswith("{")]
    assert [p["path"] for p in printed] == list(res) == [s["path"]]
    assert set(printed[0]["grouped_auc"]) == {"2", "5"}
    runs = cli_plot.load_runs(cfg.summary_path)
    assert list(runs) == ["validation"]
    csv_path = str(tmp_path / "summary.csv")
    cli_plot.write_csv(runs, csv_path)
    rows = open(csv_path).read().splitlines()
    assert rows[0].startswith("run,step,time,") and len(rows) == 2
