"""The port's training loop over files (``Trainer.train``), its checkpoints,
warm start and ``cli.train`` against the JAX package's, on the CPU.

The parity runs give both trainers the same initial state (the JAX
``init_state`` written as the port's ``model.ckpt-0`` through
``convert.train_state_from_jax``; ``resume_step=0`` restores it) and the
same unshuffled batches of TFRecord shards written here (the port reads
them through its native stream, the JAX trainer through its Python
``batch_stream``), dropout off on both sides, 4 steps with a save every
2, then a resume from step 2.  One JAX step is compiled for the module.
"""

import dataclasses
import os
import signal
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

import __graft_entry__ as g  # noqa: E402
import chip_smoke as cs  # noqa: E402
from cikm2020_dmt_tpu.cli import args as jargs  # noqa: E402
from cikm2020_dmt_tpu.core.checkpoint import \
    CheckpointManager as JCheckpointManager  # noqa: E402
from cikm2020_dmt_tpu.core.checkpoint import \
    step_from_name as j_step_from_name  # noqa: E402
from cikm2020_dmt_tpu.core.config import DMTConfig as JDMTConfig  # noqa: E402
from cikm2020_dmt_tpu.data import pipeline as jpipeline  # noqa: E402
from cikm2020_dmt_tpu.nn.embedding import pack_table as j_pack  # noqa: E402
from cikm2020_dmt_tpu.nn.embedding import unpack_table as j_unpack  # noqa: E402
from cikm2020_dmt_tpu.train import warmstart as jwarm  # noqa: E402
from cikm2020_dmt_tpu.train.loop import Trainer as JTrainer  # noqa: E402
from cikm2020_dmt_torch.cli import args, train as cli_train  # noqa: E402
from cikm2020_dmt_torch.convert import train_state_from_jax  # noqa: E402
from cikm2020_dmt_torch.core import checkpoint  # noqa: E402
from cikm2020_dmt_torch.core.config import DMTConfig  # noqa: E402
from cikm2020_dmt_torch.core.mesh import build_mesh  # noqa: E402
from cikm2020_dmt_torch.data import native, pipeline  # noqa: E402
from cikm2020_dmt_torch.metrics.streaming import task_metrics_init  # noqa: E402
from cikm2020_dmt_torch.train import warmstart  # noqa: E402
from cikm2020_dmt_torch.train.loop import Trainer, pack_layout  # noqa: E402
from test_torch_serve import SMALL, port_cfg  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
B = 16
PER_SHARD = 40     # two shards: 5 batches of 16
STEPS = 4
LR = 1e-3
KW = dict(sku_rows=4096, batch_size=B, validate_step=2,
          dedup_rows_threshold=1000, pack_rows_threshold=1000,
          table_bf16_threshold=0, dropout_rate_bias=(0.0, 0.0),
          learning_rate=(LR,))


def no_dropout(cfg):
    return dataclasses.replace(cfg, transformer=dataclasses.replace(
        cfg.transformer, dropout_rate=0.0))


def to_numpy(tree):
    return jax.tree_util.tree_map(np.array, tree)


def leaves(tree):
    return dict(cs._leaves(tree))


def native_batches(cfg, path):
    return list(native.native_batch_stream(cfg, path, B))


def listing(model_path):
    """(checkpoint steps, DONE-marked steps) under ``model_path``."""
    names = os.listdir(model_path)
    return ({checkpoint.step_from_name(n) for n in names
             if n.startswith("model.ckpt-")},
            {int(n.split("-")[1].split(".")[0]) for n in names
             if n.endswith(".model.DONE")})


def results(path):
    """The blocks of a train-result file: [(step, {key: value})]."""
    blocks = []
    for line in open(path).read().splitlines():
        if line.startswith(">> iter_steps:"):
            blocks.append((int(line.split(":")[1]), {}))
        else:
            k, v = line.split(":")
            blocks[-1][1][k] = float(v)
    return blocks


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    d = tmp_path_factory.mktemp("loop_data")
    cfg = port_cfg(g._demo_config(**SMALL, **KW))
    cs.write_shards(cfg, str(d), 2, PER_SHARD, seed=3)
    return str(d) + "/"


@pytest.fixture(scope="module")
def runs(shards, tmp_path_factory):
    """Both trainers, 4 steps then a resume from step 2 to 4: the
    returned metric values, the states at step 4, the output dirs."""
    d = tmp_path_factory.mktemp("loop_runs")
    jcfg = no_dropout(g._demo_config(**SMALL, **KW, output_path=str(d / "jax"),
                                     summary_path=str(d / "jax" / "sum")))
    pcfg = dataclasses.replace(port_cfg(jcfg), output_path=str(d / "port"),
                               summary_path=str(d / "port" / "sum"))
    jbatches = list(jpipeline.batch_stream(jcfg, shards, B))
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    jt = JTrainer(jcfg, mesh=mesh)
    init = to_numpy(jt.init_state())
    out = {"jcfg": jcfg, "pcfg": pcfg}
    out["jax"] = jt.train(max_steps=STEPS, log_every=100,
                          data_iter=iter(jbatches))
    out["jax_state"] = to_numpy(jt.ckpt.restore(STEPS, init))
    out["jax_listing"] = listing(jcfg.model_path)
    out["jax_results"] = results(jcfg.train_result_path)
    out["jax_resumed"] = jt.train(max_steps=STEPS, resume_step=2,
                                  log_every=100, data_iter=iter(jbatches))
    out["jax_resumed_state"] = to_numpy(jt.ckpt.restore(STEPS, init))

    checkpoint.CheckpointManager(pcfg.model_path).save(
        0, train_state_from_jax(pcfg, init))
    tr = Trainer(pcfg, device="cpu")
    out["port"] = tr.train(max_steps=STEPS, resume_step=0, log_every=100,
                           data_iter=iter(native_batches(pcfg, shards)))
    out["port_state"] = tr.state
    out["port_last_step"] = tr.last_step
    out["port_listing"] = listing(pcfg.model_path)
    out["port_results"] = results(pcfg.train_result_path)
    tr = Trainer(pcfg, device="cpu")
    out["port_resumed"] = tr.train(
        max_steps=STEPS, resume_step=2, log_every=100,
        data_iter=iter(native_batches(pcfg, shards)))
    out["port_resumed_state"] = tr.state
    return out


# Adam moves an element by about lr per step whatever its gradient's size,
# so where another order of float32 sums flips the sign of a gradient near
# zero, the element moves up to 2 lr a step the other way
# (``tests/test_torch_train.py`` holds one step so).  The attention key
# biases are such leaves throughout (their gradient is zero in exact
# arithmetic: a softmax ignores a constant added to every score); in the
# other leaves a few elements are (6 of 735,197 in the first run of this
# test, 2.6e-5 the largest).  So: every element within that bound, all but
# 1e-4 of the other leaves' elements within 1e-5, and the gradients'
# moments, which Adam does not normalize, as the step test holds them.
NOISE_LEAVES = ("/mha/k/b",)
PARAM_TOL = 1e-5


@pytest.mark.parametrize("run", ["", "_resumed"], ids=["4_steps", "resumed"])
def test_train_matches_jax(runs, run):
    for k, v in runs["jax" + run].items():
        np.testing.assert_allclose(runs["port" + run][k], v, rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    pcfg = runs["pcfg"]
    want = train_state_from_jax(pcfg, runs[f"jax{run}_state"])
    got = runs[f"port{run}_state"]
    assert int(got["step"]) == int(want["step"]) == STEPS
    assert int(got["opt"]["count"]) == int(want["opt"]["count"])
    want_p = leaves(want["params"])
    got_p = leaves(got["params"])
    assert set(got_p) == set(want_p)
    over = total = 0
    for path, b in want_p.items():
        a = got_p[path]
        assert a.dtype == b.dtype and a.shape == b.shape, path
        d = (a.double() - b.double()).abs()
        assert float(d.max()) <= 2 * LR * STEPS, path
        if not path.endswith(NOISE_LEAVES):
            over += int((d > PARAM_TOL).sum())
            total += d.numel()
    assert over <= 1e-4 * total, (over, total)
    moments = [(leaves(got["opt"][k]), leaves(want["opt"][k]), floor)
               for k, floor in (("m", 1e-8), ("v", 1e-12))]
    for name, sub in want["lazy_opt"].items():
        mv = got["lazy_opt"][name]["mv"]
        moments += [({name: mv[0]}, {name: sub["mv"][0]}, 1e-8),
                    ({name: mv[1]}, {name: sub["mv"][1]}, 1e-12)]
    for g_, w_, floor in moments:
        for path, b in w_.items():
            atol = max(1e-4 * float(b.abs().max()), floor)
            torch.testing.assert_close(g_[path], b, rtol=0, atol=atol,
                                       msg=path)


def test_checkpoints_and_results_match_jax(runs):
    """The same checkpoint steps and DONE markers (the port's directory
    also holds the model.ckpt-0 it started from), and result blocks with
    the same keys at the same steps, values within 1e-5."""
    steps, done = runs["port_listing"]
    assert (steps - {0}, done - {0}) == runs["jax_listing"] == \
        ({2, 4}, {2, 4})
    got, want = runs["port_results"], runs["jax_results"]
    assert [s for s, _ in got] == [s for s, _ in want] == [2, 4]
    for (_, a), (_, b) in zip(got, want):
        assert set(a) == set(b)
        for k in b:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-7,
                                       err_msg=k)
    assert runs["port_last_step"] == STEPS
    summary = [line for line in open(os.path.join(
        runs["pcfg"].summary_path, "train.jsonl"))]
    assert len(summary) == 3   # steps 2 and 4, then 4 again when resumed


def test_resumed_run_has_the_uninterrupted_bits(shards, tmp_path):
    """Dropout on: a run resumed at step 2 and fed the batches of steps 3
    and 4 ends with the bits of the run that was not interrupted (the
    dropout generator is seeded from the step), and so does a second
    resumed run."""
    cfg = dataclasses.replace(port_cfg(g._demo_config(**SMALL, **KW)),
                              output_path=str(tmp_path))
    assert cfg.transformer.dropout_rate > 0
    batches = native_batches(cfg, shards)
    tr = Trainer(cfg, device="cpu")
    tr.train(max_steps=STEPS, data_iter=iter(batches[:STEPS]),
             log_every=100)
    whole = leaves(tr.state)
    for _ in range(2):
        tr = Trainer(cfg, device="cpu")
        tr.train(max_steps=STEPS, resume_step=2, log_every=100,
                 data_iter=iter(batches[2:STEPS]))
        got = leaves(tr.state)
        assert set(got) == set(whole)
        for path, t in whole.items():
            assert got[path].dtype == t.dtype and torch.equal(got[path], t), \
                path


def test_save_restore_same_bits(shards, tmp_path):
    """A state after one step (bfloat16 tables, non-zero moments) saved
    and restored: every leaf the same bits and dtype; a second save of
    the step replaces the first."""
    cfg = port_cfg(g._demo_config(**SMALL, sku_rows=4096, batch_size=B))
    tr = Trainer(cfg, device="cpu")
    state = tr.init_state(torch.Generator().manual_seed(0))
    batch = tr.device_batch(native_batches(cfg, shards)[0])
    state, _, _ = tr.train_step(state, task_metrics_init(), batch,
                                torch.Generator().manual_seed(1))
    assert state["params"]["emb"]["Sku"].dtype == torch.bfloat16
    mgr = checkpoint.CheckpointManager(str(tmp_path / "m"))
    assert not mgr.has_step(1) and mgr.latest_step() is None
    mgr.save(1, {"step": torch.zeros(())})
    path = mgr.save(1, state)
    assert path == mgr.ckpt_dir(1) and mgr.has_step(1)
    assert os.listdir(path) == [checkpoint.STATE_FILE]
    back = leaves(mgr.restore(1))
    want = leaves(state)
    assert set(back) == set(want)
    for p, t in want.items():
        assert back[p].dtype == t.dtype and torch.equal(back[p], t), p


def test_discovery_matches_jax_manager(tmp_path):
    """``all_steps``, ``latest_step``, ``newest_step_after`` (DONE-marked
    only) and ``has_step`` over one directory, read by both managers."""
    mgr = checkpoint.CheckpointManager(str(tmp_path))
    for step in (1, 2, 3, 10):
        mgr.save(step, {"w": torch.full((2,), float(step))})
    os.remove(mgr.marker_path(3))
    os.makedirs(mgr.ckpt_dir(7))              # a save cut before its marker
    open(tmp_path / "model.ckpt-9", "w").close()   # not a directory
    jmgr = JCheckpointManager(str(tmp_path))
    assert mgr.all_steps() == jmgr.all_steps() == [1, 2, 3, 7, 10]
    assert mgr.latest_step() == jmgr.latest_step() == 10
    for s in range(12):
        assert mgr.newest_step_after(s) == jmgr.newest_step_after(s), s
        assert mgr.has_step(s) == jmgr.has_step(s), s
    for name in ("model.ckpt-12", "a/model.ckpt-3", "model.ckpt-x", "ckpt"):
        assert checkpoint.step_from_name(name) == j_step_from_name(name)
    assert mgr.restore(2)["w"].tolist() == [2.0, 2.0]


def test_packed_device_batch_round_trip(shards):
    """The packed batch (one float32 and one int32 buffer) unpacks to the
    unpacked batch's tensors, contiguous views; ``unit_weights`` drops
    ``__wts``; a step from the packed batch has the unpacked step's
    bits."""
    cfg = port_cfg(g._demo_config(**SMALL, **KW))
    host = native_batches(cfg, shards)[0]
    tr = Trainer(cfg, device="cpu")
    packed = tr.device_batch(host)
    assert set(packed) == {"__packed_f32", "__packed_i32"}
    assert tr._pack_layout == pack_layout(host.arrays)
    got = Trainer.unpack_device_batch(packed, tr._pack_layout)
    want = pipeline.device_batch(host, "cpu")
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].is_contiguous(), k
        assert torch.equal(got[k], v), k
    bits = []
    for batch in (packed, want):
        state = tr.init_state(torch.Generator().manual_seed(0))
        state, _, loss = tr.train_step(state, task_metrics_init(), batch,
                                       torch.Generator().manual_seed(1))
        bits.append((float(loss), leaves(state["params"])))
    assert bits[0][0] == bits[1][0]
    for p, t in bits[0][1].items():
        assert torch.equal(t, bits[1][1][p]), p
    unit = Trainer(dataclasses.replace(cfg, unit_weights=True), "cpu")
    got = unit.unpack_device_batch(unit.device_batch(host),
                                   unit._pack_layout)
    assert set(got) == {k for k in want if not k.endswith("__wts")}
    plain = Trainer(dataclasses.replace(cfg, packed_transfer=False), "cpu")
    got = plain.device_batch(host)
    assert set(got) == set(want)
    assert all(torch.equal(got[k], v) for k, v in want.items())
    pairs = list(tr.device_prefetch(iter([host, host, host])))
    assert len(pairs) == 3 and all(b is host for b, _ in pairs)


def test_warm_start_matches_jax(tmp_path):
    """The named tables replaced as the JAX ``warm_start_embeddings``
    replaces them (its packed tables unpacked); a bfloat16 table keeps its
    dtype; an unknown table and a wrong shape raise in both."""
    cfg = port_cfg(g._demo_config(**SMALL, sku_rows=4096,
                                  table_bf16_threshold=0))
    jcfg = g._demo_config(**SMALL, sku_rows=4096, table_bf16_threshold=0)
    params = Trainer(cfg, "cpu").init_state(
        torch.Generator().manual_seed(0))["params"]
    shapes = {n: tuple(t.shape) for n, t in params["emb"].items()}
    jparams = {"emb": {n: (np.asarray(j_pack(t.numpy())) if t.shape[0]
                           >= jcfg.pack_rows_threshold else t.numpy())
                       for n, t in params["emb"].items()}}
    rng = np.random.default_rng(0)
    paths = {}
    for name in ("Sku", "Cid2"):
        arr = rng.normal(size=shapes[name]).astype(np.float32)
        np.save(tmp_path / f"{name}.npy", arr)
        paths[name] = str(tmp_path / name)
    spec = "#".join(f"{n}:{p}" for n, p in paths.items()) + "#junk"
    assert warmstart.parse_update_emb(spec) == jwarm.parse_update_emb(spec) \
        == paths
    got = warmstart.warm_start_embeddings(params, paths)["emb"]
    want = jwarm.warm_start_embeddings(jparams, paths, jcfg)["emb"]
    for name, t in got.items():
        w = want[name]
        if w.shape != shapes[name]:
            w = j_unpack(w, *shapes[name])
        np.testing.assert_array_equal(t.numpy(), np.asarray(w), err_msg=name)
    bf = dict(params)
    bf["emb"] = {**params["emb"], "Sku": params["emb"]["Sku"].bfloat16()}
    sku = warmstart.warm_start_embeddings(bf, {"Sku": paths["Sku"]})["emb"]
    assert sku["Sku"].dtype == torch.bfloat16
    assert torch.equal(sku["Sku"], torch.from_numpy(
        np.load(tmp_path / "Sku.npy")).bfloat16())
    with pytest.raises(KeyError, match="unknown embedding table"):
        warmstart.warm_start_embeddings(params, {"Nope": paths["Sku"]})
    with pytest.raises(KeyError, match="unknown embedding table"):
        jwarm.warm_start_embeddings(jparams, {"Nope": paths["Sku"]}, jcfg)
    with pytest.raises(ValueError, match="shape"):
        warmstart.warm_start_embeddings(params, {"Cid2": paths["Sku"]})
    with pytest.raises(ValueError, match="shape"):
        jwarm.warm_start_embeddings(jparams, {"Cid2": paths["Sku"]}, jcfg)
    tr = Trainer(dataclasses.replace(cfg, update_emb=spec), "cpu")
    tr.train(max_steps=0, data_iter=iter([]))
    assert torch.equal(tr.state["params"]["emb"]["Cid2"], got["Cid2"])


def test_cli_train_then_resume(shards, tmp_path):
    """``cli.train.main`` on the CPU trains 2 steps from the files, then
    resumes from ``model.ckpt-2`` to step 4."""
    cfg = port_cfg(g._demo_config(**SMALL, **KW))
    conf = str(tmp_path / "small.conf")
    cs.write_conf(cfg, conf, shards, str(tmp_path / "out"))
    read = DMTConfig.from_ini(conf)
    assert (read.embeddings, read.attention_pairs, read.attention_ts,
            read.batch_size) == (cfg.embeddings, cfg.attention_pairs,
                                 cfg.attention_ts, B)
    base = ["--conf_file", conf, "--device", "cpu", "--log_every", "1"]
    tr = cli_train.main(base + ["--max_steps", "2"])
    assert tr.last_step == 2 and tr.ckpt.all_steps() == [2]
    tr = cli_train.main(base + ["--max_steps", "4", "--model_ckpt",
                                "model.ckpt-2"])
    assert tr.last_step == 4 and int(tr.state["step"]) == 4
    assert tr.ckpt.all_steps() == [2, 4] and tr.ckpt.has_step(4)
    assert [s for s, _ in results(read.train_result_path)] == [2, 4]


def test_num_processes_raises(tmp_path):
    """Several processes run (``tests/test_torch_mesh*.py``), the model
    axis too: a ``Trainer`` takes the flagship on a ``(1, 2)`` mesh, Sku
    full-mesh, Brand and Shopid split over the model group.  A mesh that
    does not cover the processes raises, and so does ``--num_processes``
    without this process's id."""
    from cikm2020_dmt_torch.core.mesh import Mesh
    from cikm2020_dmt_torch.parallel.embedding_shard import \
        ShardedEmbeddingEngine
    cfg = dataclasses.replace(DMTConfig.from_ini(
        str(ROOT / "conf" / "dmt.conf")), mesh_model=2)
    tr = Trainer(cfg, mesh=Mesh(1, 2, 0, torch.device("cpu"), "gloo"))
    assert isinstance(tr.model.engine, ShardedEmbeddingEngine)
    assert set(tr.model.engine.split) == {"Brand", "Shopid"}
    assert list(tr.full_mesh) == ["Sku"] and not tr.sharded
    with pytest.raises(ValueError, match="does not cover"):
        build_mesh(cfg, world=3, device="cpu", rank=0)
    with pytest.raises(ValueError, match="process_id"):
        cli_train.main(["--conf_file", str(ROOT / "conf" / "dmt.conf"),
                        "--num_processes", "2", "--device", "cpu"])
    assert args.ckpt_step("model.ckpt-17") == jargs.ckpt_step(
        "model.ckpt-17") == 17
    assert args.ckpt_step("current") == jargs.ckpt_step("current") == 0


@pytest.mark.parametrize("counts,replicas", [((1000, 24, 7), 1),
                                             ((10**9, 5 * 10**8), 1),
                                             ((300,), 3)])
def test_recompute_max_steps_matches_jax(counts, replicas):
    cfg = DMTConfig.from_ini(str(ROOT / "conf" / "dmt.conf"))
    jcfg = JDMTConfig.from_ini(str(ROOT / "conf" / "dmt.conf"))
    got = cfg.recompute_max_steps(counts, replicas)
    want = jcfg.recompute_max_steps(counts, replicas)
    assert (got.max_iter_step, got.total_example_num) == \
        (want.max_iter_step, want.total_example_num)


def test_label_stats_cap_steps_like_jax(tmp_path):
    (tmp_path / "part-00000").write_text("4000\n96\n\n")
    cfg = dataclasses.replace(DMTConfig.from_ini(
        str(ROOT / "conf" / "dmt.conf")), train_data_stat_path=str(tmp_path))
    jcfg = JDMTConfig.from_ini(str(ROOT / "conf" / "dmt.conf")).replace(
        train_data_stat_path=str(tmp_path))
    got, want = args.apply_label_stats(cfg), jargs.apply_label_stats(jcfg)
    assert got.max_iter_step == want.max_iter_step == 2 * 4096 // 2048


def test_profile_window_writes_chrome_trace(shards, tmp_path):
    cfg = port_cfg(g._demo_config(**SMALL, **KW))
    tr = Trainer(dataclasses.replace(cfg, output_path=str(tmp_path)), "cpu")
    tr.train(max_steps=2, data_iter=iter(native_batches(cfg, shards)),
             profile_dir=str(tmp_path / "prof"), profile_steps=(0, 1),
             log_every=100)
    traces = list((tmp_path / "prof").glob("*.trace.json"))
    assert len(traces) == 1 and "traceEvents" in traces[0].read_text()


def test_sigterm_in_a_step_saves_that_step(shards, tmp_path):
    """SIGTERM that arrives inside step 2 is raised once the step is done:
    the emergency checkpoint holds step 2's state, the bits of a run that
    stopped there."""
    cfg = dataclasses.replace(port_cfg(g._demo_config(**SMALL, **KW)),
                              output_path=str(tmp_path), validate_step=100)
    batches = native_batches(cfg, shards)
    tr = Trainer(cfg, device="cpu")
    step = tr.train_step

    def preempted(state, *a):
        if int(state["step"]) == 1:
            # the loop's handler, or the signal would end this process
            handler = signal.getsignal(signal.SIGTERM)
            assert type(getattr(handler, "__self__", None)).__name__ == \
                "_StepSignals", handler
            signal.raise_signal(signal.SIGTERM)
        return step(state, *a)

    tr.train_step = preempted
    with pytest.raises(KeyboardInterrupt, match=f"signal {signal.SIGTERM}"):
        tr.train(max_steps=STEPS, data_iter=iter(batches), log_every=100)
    assert tr.ckpt.all_steps() == [2] and tr.ckpt.has_step(2)
    ref = Trainer(dataclasses.replace(cfg, output_path=str(tmp_path / "r")),
                  "cpu")
    ref.train(max_steps=2, data_iter=iter(batches), log_every=100)
    got = leaves(tr.ckpt.restore(2))
    for p, t in leaves(ref.state).items():
        assert torch.equal(got[p], t), p
