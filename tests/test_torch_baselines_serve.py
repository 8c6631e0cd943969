"""Eval, export and serving of the paper baselines on the CPU, against the
JAX package where it has the same function:

- ``export_model`` -> ``load_scorer`` of ``din`` and ``dien``: the float32
  bundle scores as a ``Scorer`` over the checkpoint (the same bits) and
  as the JAX ``Scorer`` on the same weights, the int8 bundle within 0.05
  of the float32 one; each request has a length-0 group (the cart
  history), which DIEN's attention weighs uniformly;
- ``run_eval`` of ``din`` against JAX ``run_eval``;
- ``din`` as a user runs it: ``cli.train`` from TFRecord shards, then
  ``cli.export`` of a float32 and an int8 bundle (``export_int8_rows`` in
  the config's ``[export_model]``), each read back by ``load_scorer``."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)


import __graft_entry__ as g  # noqa: E402
from cikm2020_dmt_tpu.serve.export import Scorer as JScorer  # noqa: E402
from cikm2020_dmt_tpu.train.evaluate import \
    run_eval as j_run_eval  # noqa: E402
from cikm2020_dmt_torch.convert import (model_state_from_jax,  # noqa: E402
                                        params_from_jax)
from cikm2020_dmt_torch.core.checkpoint import \
    CheckpointManager  # noqa: E402
from cikm2020_dmt_torch.data.pipeline import Batch  # noqa: E402
from cikm2020_dmt_torch.models.zoo import build_model  # noqa: E402
from cikm2020_dmt_torch.serve import export  # noqa: E402
from cikm2020_dmt_torch.train.evaluate import (_restore_for_eval,  # noqa: E402
                                               run_eval)
from test_torch_serve import _norm, make_request, port_cfg  # noqa: E402
from test_torch_zoo_serve import (B, INT8_ROWS, N, STEP, TOL,  # noqa: E402
                                  jax_model, numpy_tree)
from test_torch_zoo_train import config  # noqa: E402

MODELS = ("din", "dien")


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Per model: the bundles' scorers, a Scorer over the checkpoint, the
    JAX Scorer on the same weights, and two requests."""
    d = tmp_path_factory.mktemp("baselines_serve")
    out = {}
    for name in MODELS:
        cfg = config(model_type=name, export_int8_rows=INT8_ROWS)
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
            bundles=bundles,
            scorer=export.Scorer(pcfg, pp, scale, const, device="cpu",
                                 model_state=ps),
            jax=JScorer(cfg, params, state, scale, const),
            reqs=[make_request(cfg, N, seed) for seed in range(2)])
    return out


@pytest.mark.parametrize("name", MODELS)
def test_bundle_scores_as_checkpoint_and_jax(served, name):
    s = served[name]
    for req in s["reqs"]:
        assert int(req["cart_seq_sku_12m_10__len"][0]) == 0
        got = s["bundles"]["f32"](req)
        want = s["scorer"](req)
        jwant = s["jax"](req)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            np.testing.assert_allclose(got[k], np.asarray(jwant[k]),
                                       rtol=TOL, atol=TOL, err_msg=k)
        np.testing.assert_allclose(s["bundles"]["int8"](req)["Scores"],
                                   got["Scores"], atol=0.05)
    int8 = s["bundles"]["int8"].params["emb"]
    assert int8["Sku"]["q"].dtype == torch.int8
    assert not isinstance(int8["Cid2"], dict)      # 500 rows: float32


def test_din_run_eval_matches_jax():
    """Two batches, the last 5 rows of the second padding: metric values
    and scores (one probability for both tasks)."""
    cfg = config(model_type="din")
    pcfg = port_cfg(cfg)
    jm, params, state = jax_model(cfg)
    batches = [g.synthetic_batch(cfg, B, seed=s) for s in range(2)]
    batches[1]["valid"][-5:] = 0.0
    want = j_run_eval(cfg, jm, params, state, None, B,
                      data_iter=[g._as_batch(b) for b in batches])
    got = run_eval(pcfg, build_model(pcfg),
                   params_from_jax(pcfg, numpy_tree(params)), None, B,
                   data_iter=[Batch(b, [b""] * B) for b in batches],
                   device="cpu")
    assert got[2].shape == (2 * B - 5,)
    for k in want[0]:
        np.testing.assert_allclose(got[0][k], want[0][k], rtol=TOL,
                                   atol=TOL, err_msg=k)
    for a, b in zip(got[2:], want[2:]):
        np.testing.assert_allclose(a, np.asarray(b), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(got[2], got[3])


def test_cli_chain_of_din(tmp_path):
    """``cli.train`` 2 steps of ``din`` from shards (lazy Adam on the four
    tables of 1,000 rows or more), then ``cli.export`` of a float32 and
    an int8 bundle from the configs' ``[export_model]``: the float32
    bundle scores as a ``Scorer`` over the checkpoint, the int8 one
    within 0.05 of it."""
    import chip_smoke as cs
    from cikm2020_dmt_torch.cli import export as cli_export
    from cikm2020_dmt_torch.cli import train as cli_train
    from cikm2020_dmt_torch.core.config import DMTConfig

    cfg = dataclasses.replace(port_cfg(config(model_type="din")),
                              validate_step=2)
    data = tmp_path / "data"
    data.mkdir()
    cs.write_shards(cfg, str(data), 2, B, seed=0)
    mean, std = _norm(cfg)
    for stat, v in (("mean", mean), ("std", std)):
        (tmp_path / stat).write_text("\t".join(repr(float(x)) for x in v))
    confs = {}
    for kind, rows in (("f32", 0), ("int8", INT8_ROWS)):
        # one model tag (the file's name) for both, as a user's two copies
        (tmp_path / kind).mkdir()
        confs[kind] = str(tmp_path / kind / "din.conf")
        cs.write_conf(dataclasses.replace(cfg, export_int8_rows=rows),
                      confs[kind], str(data) + "/", str(tmp_path / "out"),
                      train_data_mean_path=str(tmp_path / "mean"),
                      train_data_std_path=str(tmp_path / "std"))
    back = DMTConfig.from_ini(confs["f32"])
    assert back.model_type == "din" and back.export_int8_rows == 0
    cli_train.main(["--conf_file", confs["f32"], "--device", "cpu",
                    "--max_steps", "2"])
    bundles = {kind: export.load_scorer(
        DMTConfig.from_ini(conf), cli_export.main(
            ["--conf_file", conf, "--model_ckpt", "model.ckpt-2"]),
        device="cpu") for kind, conf in confs.items()}
    assert bundles["int8"].params["emb"]["Sku"]["q"].dtype == torch.int8
    params, mstate = _restore_for_eval(CheckpointManager(back.model_path), 2)
    direct = export.Scorer(back, params, *export.norm_constants(mean, std),
                           device="cpu", model_state=mstate)
    req = make_request(config(model_type="din"), N, 0)
    want = direct(req)
    for k, v in bundles["f32"](req).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    np.testing.assert_allclose(bundles["int8"](req)["Scores"],
                               want["Scores"], atol=0.05)
