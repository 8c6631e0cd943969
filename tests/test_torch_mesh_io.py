"""The port's data mesh around the step: ``convert.shard_state`` and
``gather_state``, ``run_eval(mesh=)`` against the one-process
``run_eval`` on TFRecord shards written here, ``cli.train
--num_processes 2`` whose checkpoint restores in one process, and ranks
whose ``model_path`` differs.  The ranks
are ``gloo`` processes that import ``torch`` and the port only."""

import dataclasses
import os
import socket

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import __graft_entry__ as g  # noqa: E402
import chip_smoke as cs  # noqa: E402
import torch_mesh_workers as workers  # noqa: E402
from cikm2020_dmt_torch.core.checkpoint import CheckpointManager  # noqa: E402
from cikm2020_dmt_torch.core.config import DMTConfig  # noqa: E402
from cikm2020_dmt_torch.core.mesh import run_ranks  # noqa: E402
from cikm2020_dmt_torch.models.zoo import build_model  # noqa: E402
from cikm2020_dmt_torch.train.evaluate import run_eval  # noqa: E402
from cikm2020_dmt_torch.train.loop import Trainer  # noqa: E402
from test_torch_mesh import KW, SPAWN_TIMEOUT, mesh_config  # noqa: E402
from test_torch_serve import port_cfg  # noqa: E402

EVAL_B = 32


def same_tree(a, b, what=""):
    la, lb = dict(cs._leaves(a)), dict(cs._leaves(b))
    assert la.keys() == lb.keys(), what
    for k in la:
        assert la[k].dtype == lb[k].dtype and torch.equal(la[k], lb[k]), \
            f"{what}{k}"


@pytest.mark.parametrize("n", [2, 4])
def test_shard_gather_round_trip(n):
    """Sku of 4,093 rows (1,024 groups of 4; the last rank's share ends
    three rows short of its groups) and its moments go to their shares and
    come back whole; ``lazy_overflow`` stays once, with rank 0."""
    cfg = port_cfg(mesh_config(sku_rows=4093))
    tr = Trainer(cfg, device="cpu")
    state = tr.init_state(torch.Generator().manual_seed(1))
    gen = torch.Generator().manual_seed(2)
    for sub in state["lazy_opt"].values():
        sub["mv"].uniform_(generator=gen)
    state["lazy_overflow"] = torch.tensor(7)
    out = run_ranks(workers.round_trip, n, cfg, state,
                    timeout_s=SPAWN_TIMEOUT, threads=1)
    per = 4096 // n
    for r, o in enumerate(out):
        want = min(4093, (r + 1) * per) - r * per
        assert o["rows"]["Sku"] == o["mv_rows"]["Sku"] == want
        assert o["rows"]["Cid3"] == 2048
        assert o["overflow"] == (7 if r == 0 else 0)
        same_tree(o["whole"], state, f"rank {r}: ")


@pytest.fixture(scope="module")
def eval_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_eval")
    data = d / "data"
    data.mkdir()
    cfg = port_cfg(mesh_config())
    cs.write_shards(cfg, str(data), 2, 40, seed=9)  # 3 batches, last padded
    tr = Trainer(cfg, device="cpu")
    state = tr.init_state(torch.Generator().manual_seed(3))
    return cfg, str(data) + "/", state, d


def test_run_eval_on_the_mesh_matches_one_process(eval_files):
    cfg, path, state, d = eval_files
    want = run_eval(cfg, build_model(cfg), state["params"], path, EVAL_B,
                    device="cpu", model_state=state["model_state"],
                    detail_file=str(d / "one.detail"))
    out = run_ranks(workers.eval_split, 2, cfg, state["params"],
                    state["model_state"], path, EVAL_B,
                    str(d / "mesh.detail"), timeout_s=SPAWN_TIMEOUT,
                    threads=1)
    w_vals, w_headers, w_clk, w_ord = want
    for vals, n_headers, p_clk, p_ord in out:
        assert n_headers == len(w_headers) == 80
        np.testing.assert_allclose(p_clk, w_clk, rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(p_ord, w_ord, rtol=1e-5, atol=1e-7)
        assert vals.keys() == w_vals.keys()
        for k in w_vals:
            np.testing.assert_allclose(vals[k], w_vals[k], rtol=1e-5,
                                       atol=1e-6, err_msg=k)
    # rank 0 alone writes the detail file: one line per valid row
    one = (d / "one.detail").read_text().splitlines()
    mesh = (d / "mesh.detail").read_text().splitlines()
    assert len(mesh) == len(one) == 80
    assert [l.split("\t")[0] for l in mesh] == [l.split("\t")[0]
                                                for l in one]


def test_ranks_that_do_not_share_model_path(tmp_path):
    """Only rank 0's ``model_path`` holds the checkpoints.  Training saves
    there and ends on both ranks: the final save is decided from the run's
    own saves, not from each rank's view of the filesystem.  Resuming from
    a checkpoint that rank 1 cannot see stops both ranks with one error,
    instead of rank 0 restoring while rank 1 starts afresh."""
    jcfg = mesh_config()
    cfg = port_cfg(jcfg)
    batches = [g.synthetic_batch(jcfg, KW["batch_size"], seed=s)
               for s in (4, 5)]
    dirs = [str(tmp_path / f"rank{r}") for r in range(2)]
    out = run_ranks(workers.train_own_dir, 2, cfg, dirs, batches, None,
                    timeout_s=SPAWN_TIMEOUT, threads=1)
    assert [o["last_step"] for o in out] == [2, 2]
    assert out[0]["steps"] == [2] and out[1]["steps"] == []
    with pytest.raises(RuntimeError, match="one shared model_path") as e:
        run_ranks(workers.train_own_dir, 2, cfg, dirs, batches, 2,
                  timeout_s=SPAWN_TIMEOUT, threads=1)
    assert "rank 0:" in str(e.value) and "rank 1:" in str(e.value)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_train_on_two_processes(tmp_path):
    """``cli.train --num_processes 2 --device cpu`` over four shards (two
    a rank), 2 steps and a save: Sku (1,000,000 rows: past the default
    ``dedup_rows_threshold`` and ``shard_rows_threshold`` that a conf file
    cannot set) splits over the ranks; the checkpoint is the state the
    ranks ended with, and it restores into a one-process ``Trainer`` that
    trains on from it."""
    jcfg = g._demo_config(**{**KW, "sku_rows": 1_000_000, "batch_size": 8,
                              "validate_step": 2})
    from test_torch_serve import SMALL
    cfg = port_cfg(dataclasses.replace(jcfg, **{
        k: v for k, v in SMALL.items()}))
    data = tmp_path / "data"
    data.mkdir()
    cs.write_shards(cfg, str(data), 4, 16, seed=11)
    conf = str(tmp_path / "mesh.conf")
    cs.write_conf(cfg, conf, str(data) + "/", str(tmp_path / "out"))
    read = DMTConfig.from_ini(conf)
    argv = ["--conf_file", conf, "--device", "cpu", "--max_steps", "2",
            "--num_processes", "2", "--coordinator",
            f"127.0.0.1:{free_port()}", "--dist_backend", "gloo",
            "--log_every", "1"]
    out = run_ranks(workers.cli_train, 2, argv, backend=None,
                    timeout_s=SPAWN_TIMEOUT, threads=1)
    for o in out:
        assert not o["jax"]
        assert o["last_step"] == 2 and o["steps"] == [2]
    ranks_state = out[0]["state"]
    assert tuple(ranks_state["params"]["emb"]["Sku"].shape) == (1_000_000,
                                                                32)
    ckpt = CheckpointManager(read.model_path)
    assert ckpt.has_step(2)
    same_tree(ckpt.restore(2), ranks_state, "checkpoint: ")
    # one process takes it up and trains on
    tr = Trainer(read, device="cpu")
    tr.train(max_steps=3, resume_step=2, log_every=100)
    assert tr.last_step == 3 and ckpt.has_step(3)
    assert tuple(tr.state["params"]["emb"]["Sku"].shape) == (1_000_000, 32)
