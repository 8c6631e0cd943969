"""The model axis around the step: ``convert.shard_state`` and
``gather_state`` with model-split leaves (their dense Adam moments and a
sharded lazy table's moments with them), ``run_eval(mesh=)`` on a
``(2, 2)`` mesh against the one-process ``run_eval``, and a checkpoint
saved from a ``(1, 2)`` mesh that restores in one process, scores as the
ranks do and exports unchanged.  ``tests/test_torch_model_axis_train.py``'s
tables; the ranks are ``gloo`` processes that import ``torch`` and the
port only."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import __graft_entry__ as g  # noqa: E402
import torch_mesh_workers as workers  # noqa: E402
from cikm2020_dmt_torch.core.checkpoint import CheckpointManager  # noqa: E402
from cikm2020_dmt_torch.core.mesh import run_ranks  # noqa: E402
from cikm2020_dmt_torch.data.pipeline import Batch  # noqa: E402
from cikm2020_dmt_torch.serve.export import (export_model,  # noqa: E402
                                             load_scorer)
from cikm2020_dmt_torch.train.evaluate import run_eval  # noqa: E402
from cikm2020_dmt_torch.train.loop import Trainer  # noqa: E402
from test_torch_mesh_io import same_tree  # noqa: E402
from test_torch_model_axis_train import (B, SPAWN_TIMEOUT,  # noqa: E402
                                         axis_config)
from test_torch_serve import port_cfg  # noqa: E402

EVAL_B = 32


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_shard_gather_round_trip(shape):
    """Every split leaf and its optimizer state go to their shares and come
    back whole, bit for bit; ``lazy_overflow`` stays once, with rank 0."""
    data, model = shape
    cfg = port_cfg(axis_config(model))
    state = Trainer(cfg, device="cpu").init_state(
        torch.Generator().manual_seed(1))
    gen = torch.Generator().manual_seed(2)
    for tree in (state["opt"]["m"], state["opt"]["v"]):
        for leaf in workers.leaves(tree):
            leaf[1].uniform_(generator=gen)
    for sub in state["lazy_opt"].values():
        sub["mv"].uniform_(generator=gen)
    state["lazy_overflow"] = torch.tensor(7)
    out = run_ranks(workers.round_trip, data * model, cfg, state,
                    timeout_s=SPAWN_TIMEOUT, threads=1)
    for r, o in enumerate(out):
        # Sku: full mesh; Brand: full mesh over 2 ranks, sharded over (2, 2)
        assert o["rows"]["Sku"] == o["mv_rows"]["Sku"] == 8192 // (data
                                                                    * model)
        assert o["rows"]["Brand"] == o["mv_rows"]["Brand"] == 2056
        assert o["rows"]["Shopid"] == o["opt_rows"]["Shopid"] == 1024
        assert o["rows"]["Cid2"] == o["opt_rows"]["Cid2"] == 250
        assert o["rows"]["Cid3"] == o["opt_rows"]["Cid3"] == 2064
        assert o["bias_rows"] == {"Cid2": 250, "Cid3": 1024}
        assert o["overflow"] == (7 if r == 0 else 0)
        same_tree(o["whole"], state, f"rank {r}: ")


def test_run_eval_on_two_by_two_matches_one_process():
    jcfg = axis_config(2)
    cfg = port_cfg(jcfg)
    state = Trainer(cfg, device="cpu").init_state(
        torch.Generator().manual_seed(3))
    batches = [g.synthetic_batch(jcfg, EVAL_B, seed=20 + i) for i in range(2)]
    batches[-1]["valid"][-5:] = 0          # a padded last batch
    want = run_eval(cfg, Trainer(cfg, device="cpu").model, state["params"],
                    None, EVAL_B, device="cpu",
                    model_state=state["model_state"],
                    data_iter=[Batch(b, [b""] * EVAL_B) for b in batches])
    out = run_ranks(workers.eval_batches, 4, cfg, state["params"],
                    state["model_state"], batches, timeout_s=SPAWN_TIMEOUT,
                    threads=1)
    w_vals, _, w_clk, w_ord = want
    assert len(w_clk) == 2 * EVAL_B - 5
    for vals, p_clk, p_ord in out:
        np.testing.assert_allclose(p_clk, w_clk, rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(p_ord, w_ord, rtol=1e-5, atol=1e-7)
        for k in w_vals:
            np.testing.assert_allclose(vals[k], w_vals[k], rtol=1e-5,
                                       atol=1e-6, err_msg=k)


def test_checkpoint_from_the_mesh_restores_in_one_process(tmp_path):
    """Two steps on the (1, 2) mesh and a save; the checkpoint is the
    whole one-process state: one process scores from it as the ranks do
    from their shares, and ``export_model`` bundles its params as they
    are."""
    jcfg = axis_config(2)
    cfg = dataclasses.replace(port_cfg(jcfg), output_path=str(tmp_path))
    batches = [g.synthetic_batch(jcfg, B, seed=s) for s in (4, 5)]
    evals = [g.synthetic_batch(jcfg, EVAL_B, seed=6)]
    out = run_ranks(workers.train_save_eval, 2, cfg, batches, evals,
                    timeout_s=SPAWN_TIMEOUT, threads=1)
    assert [o["last_step"] for o in out] == [2, 2]
    ckpt = CheckpointManager(cfg.model_path)
    assert ckpt.has_step(2)
    whole = ckpt.restore(2)
    assert tuple(whole["params"]["emb"]["Shopid"].shape) == (2048, 16)
    assert tuple(whole["params"]["bias_net"]["emb"]["Cid3"].shape) == (2048,
                                                                        5)
    assert tuple(whole["opt"]["m"]["emb"]["Shopid"].shape) == (2048, 16)
    vals, _, clk, ord_ = run_eval(
        cfg, Trainer(cfg, device="cpu").model, whole["params"], None,
        EVAL_B, device="cpu", model_state=whole["model_state"],
        data_iter=[Batch(b, [b""] * EVAL_B) for b in evals])
    for o in out:
        r_vals, r_clk, r_ord = o["eval"]
        np.testing.assert_allclose(r_clk, clk, rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(r_ord, ord_, rtol=1e-5, atol=1e-7)
        for k in vals:
            np.testing.assert_allclose(r_vals[k], vals[k], rtol=1e-5,
                                       atol=1e-6, err_msg=k)
    stats = {}
    for name in ("mean", "std"):
        stats[name] = str(tmp_path / name)
        with open(stats[name], "w") as f:
            f.write("\t".join(["1.0"] * cfg.feature_dimension) + "\n")
    ecfg = dataclasses.replace(cfg, train_data_mean_path=stats["mean"],
                               train_data_std_path=stats["std"])
    bundle = export_model(ecfg, 2)
    scorer = load_scorer(ecfg, bundle, device="cpu")
    same_tree(scorer.params, whole["params"], "bundle: ")
