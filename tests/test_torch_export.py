"""The port's serving export against the JAX package's, on the CPU: int8
quantization (bit for bit, lane-packed tables in groups of ``128 // D``
rows), ``ServingPreprocessor`` over a vocab written here, ``export_model``
-> ``load_scorer`` in float32 and int8, the asynchronous scoring calls,
and ``ScorerQueue`` (with a stub scorer, as the JAX queue's tests, and
over a CPU ``Scorer``)."""

import dataclasses
import json
import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

import __graft_entry__ as g  # noqa: E402
from cikm2020_dmt_tpu.core.checkpoint import \
    CheckpointManager as JCheckpointManager  # noqa: E402
from cikm2020_dmt_tpu.models.zoo import build_model as j_build  # noqa: E402
from cikm2020_dmt_tpu.nn.embedding import unpack_table as j_unpack  # noqa: E402
from cikm2020_dmt_tpu.serve import export as jexport  # noqa: E402
from cikm2020_dmt_tpu.train.optim import make_optimizer  # noqa: E402
from cikm2020_dmt_torch.convert import params_from_jax  # noqa: E402
from cikm2020_dmt_torch.core import tracing  # noqa: E402
from cikm2020_dmt_torch.core.checkpoint import CheckpointManager  # noqa: E402
from cikm2020_dmt_torch.data import native  # noqa: E402
from cikm2020_dmt_torch.serve import export  # noqa: E402
from cikm2020_dmt_torch.serve import queue as queue_mod  # noqa: E402
from cikm2020_dmt_torch.serve.queue import ScorerQueue  # noqa: E402
from test_torch_eval_files import numpy_init  # noqa: E402
from test_torch_serve import SMALL, port_cfg  # noqa: E402

STEP = 2
N = 6           # candidates of a request
TOL = 1e-5
# Sku 4098 x 32 (packed: 1025 physical rows, the last group padded),
# Brand / Shopid 2048 x 16 (256 physical rows), Cid3 2048 x 8 (128),
# Cid2 500 x 8 (below the packing threshold: 500 rows)
KW = dict(sku_rows=4098, pack_rows_threshold=1000, table_bf16_threshold=0)
INT8_ROWS = 200
VOCAB = {"Cid3": ["unknow", "9728", "1349", "15053"],
         "Brand": ["unknow", "184144", "211780"]}


def request_ids(rng):
    """Raw string ids of one request: vocab hits and misses, a hashed
    table (Sku: no vocab file), timestamps with a non-number."""
    return {
        "item_fea_sku": [str(x).encode() for x in rng.integers(1, 10**9, N)],
        "item_c3": [b"9728", b"oov-c3", b"1349", b"15053", b"x", b"9728"],
        "item_brand": [b"184144"] * N,
        "item_c2": [b"1584"] * N,
        "near_expo_seq_c2": [b"1583", b"1584"],
        "clk_seq_sku_7d_50": [str(x).encode()
                              for x in rng.integers(1, 10**9, 20)],
        "clk_seq_c3_7d_50": [b"15053", b"9728", b"zz-oov"],
        "clk_seq_ts_7d_50": [b"134638", b"bad", b"77"],
        "ord_seq_brand_12m_10": [b"211780"],
    }


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("export")
    vocab = d / "vocab"
    vocab.mkdir()
    for name, ids in VOCAB.items():
        (vocab / f"{name}.py").write_text(f"ID_TABLES = {{{name!r}: {ids!r}}}")
    rng = np.random.default_rng(11)
    base = g._demo_config(**SMALL, **KW)
    dim = base.feature_dimension
    for name, vals in (("mean", rng.normal(0.5, 1.0, dim)),
                       ("std", rng.uniform(0.1, 3.0, dim))):
        (d / name).write_text("\t".join(repr(float(v)) for v in vals) + "\n")
    jcfg = dataclasses.replace(base, output_path=str(d / "jax"),
                               vocab_path=str(vocab),
                               train_data_mean_path=str(d / "mean"),
                               train_data_std_path=str(d / "std"))
    pcfg = dataclasses.replace(port_cfg(jcfg), output_path=str(d / "port"))
    jm = j_build(jcfg)
    params, state = numpy_init(jm, seed=13)
    JCheckpointManager(jcfg.model_path).save(STEP, {
        "params": params, "model_state": state,
        "opt_state": make_optimizer(jcfg).init(params),
        "step": np.zeros((), np.int32)})
    pp = params_from_jax(pcfg, params)
    CheckpointManager(pcfg.model_path).save(STEP, {"params": pp})
    prep = export.ServingPreprocessor(pcfg)
    reqs = [prep.assemble(N, request_ids(np.random.default_rng(s)),
                          id_wts={"clk_seq_c3_7d_50": [0.5]},
                          raw_features=np.random.default_rng(s).uniform(
                              -1.0, 6.0, (N, dim)).astype(np.float32),
                          tile_uside=False)
            for s in range(3)]
    return {"d": d, "jcfg": jcfg, "pcfg": pcfg, "params": params, "pp": pp,
            "reqs": reqs}


def test_quantize_table_equals_jax():
    rng = np.random.default_rng(3)
    t = (rng.normal(size=(64, 32)) * rng.uniform(0.01, 5, (64, 1))
         ).astype(np.float32)
    t[7] = 0.0
    got, want = export.quantize_table(t), jexport.quantize_table(t)
    for k in ("q", "scale"):
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_quantize_tables_equal_jax_with_packed_groups(setup):
    """Tables the JAX package lane-packs are quantized per group of
    ``128 // D`` logical rows, and the threshold reads physical rows."""
    s = setup
    jq, jnames = jexport.quantize_tables(s["params"], INT8_ROWS)
    pq, names = export.quantize_tables(s["pcfg"], s["pp"], INT8_ROWS)
    assert names == jnames == ["Brand", "Cid2", "Shopid", "Sku"]
    specs = {e.table: e for e in s["pcfg"].embeddings}
    for name in names:
        rows, dim = specs[name].id_size, specs[name].dim
        q, scale = pq["emb"][name]["q"], pq["emb"][name]["scale"]
        assert q.dtype == torch.int8 and q.shape == (rows, dim)
        np.testing.assert_array_equal(
            q.numpy(), j_unpack(jq["emb"][name]["q"], rows, dim))
        np.testing.assert_array_equal(scale.numpy(),
                                      jq["emb"][name]["scale"])
    assert pq["emb"]["Sku"]["scale"].shape == (1025, 1)
    assert pq["emb"]["Cid2"]["scale"].shape == (500, 1)
    for name in set(pq["emb"]) - set(names):
        assert pq["emb"][name] is s["pp"]["emb"][name]


def test_int8_gather_picks_the_group_scale(setup):
    """``take_quant`` dequantizes row ``id`` with scale ``id // (128 //
    D)``: the JAX gather of the physical row and its lane slice."""
    from cikm2020_dmt_torch.parallel.embedding_shard import take_quant
    pq, _ = export.quantize_tables(setup["pcfg"], setup["pp"], INT8_ROWS)
    jq, _ = jexport.quantize_tables(setup["params"], INT8_ROWS)
    ids = torch.tensor([[0, 3, 4, 4097], [1023, 1024, 2, 4095]])
    got = take_quant(pq["emb"]["Sku"], ids)
    phys = jq["emb"]["Sku"]
    deq = (phys["q"].astype(np.float32) * phys["scale"]).reshape(-1, 32)
    np.testing.assert_array_equal(got.numpy(), deq[ids.numpy()])


def test_preprocessor_equals_jax(setup):
    s = setup
    prep = export.ServingPreprocessor(s["pcfg"])
    jprep = jexport.ServingPreprocessor(s["jcfg"])
    assert jprep._native is not None
    for tile in (True, False):
        for seed in range(2):
            ids = request_ids(np.random.default_rng(seed))
            kw = dict(id_wts={"clk_seq_c3_7d_50": [0.5]}, tile_uside=tile,
                      raw_features=np.ones((N, 24), np.float32))
            a = prep.assemble(N, ids, **kw)
            b = jprep.assemble(N, ids, **kw)
            assert a.keys() == b.keys()
            for k in b:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    got = prep.assemble(2, {"item_c3": [b"1349", b"oov"],
                            "clk_seq_ts_7d_50": [b"1024", b"notanum"]})
    assert got["item_c3__ids"][0, 0] == 2           # a vocab hit
    assert got["item_c3__ids"][1, 0] >= len(VOCAB["Cid3"])   # an OOV bucket
    assert got["clk_seq_ts_7d_50__ids"][0, :2].tolist() == [1024, 0]


def test_preprocessor_raises_when_the_library_fails(setup, monkeypatch):
    def broken():
        raise RuntimeError("g++ not found on PATH")
    monkeypatch.setattr(native, "load_library", broken)
    with pytest.raises(RuntimeError, match="not found"):
        export.ServingPreprocessor(setup["pcfg"])


@pytest.fixture(scope="module")
def bundles(setup):
    """(port scorer, JAX scorer, port bundle dir) for f32 and int8."""
    s = setup
    out = {}
    for kind, rows in (("f32", 0), ("int8", INT8_ROWS)):
        jcfg = dataclasses.replace(s["jcfg"], export_int8_rows=rows)
        pcfg = dataclasses.replace(s["pcfg"], export_int8_rows=rows)
        jdir = jexport.export_model(jcfg, STEP, str(s["d"] / f"jax_{kind}"))
        pdir = export.export_model(pcfg, STEP, str(s["d"] / f"port_{kind}"))
        out[kind] = (export.load_scorer(pcfg, pdir, device="cpu"),
                     jexport.load_scorer(jcfg, jdir), pdir, jdir)
    return out


@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_load_scorer_matches_jax(setup, bundles, kind):
    scorer, jscorer, pdir, jdir = bundles[kind]
    pdesc = json.load(open(os.path.join(pdir, "descriptor.json")))
    jdesc = json.load(open(os.path.join(jdir, "descriptor.json")))
    assert pdesc == jdesc
    assert sorted(os.listdir(pdir)) == ["descriptor.json", "norm.npz",
                                        "params.pt"]
    for k in ("scale", "const_vec"):
        np.testing.assert_array_equal(
            np.load(os.path.join(pdir, "norm.npz"))[k],
            np.load(os.path.join(jdir, "norm.npz"))[k])
    if kind == "int8":
        sku = scorer.params["emb"]["Sku"]
        assert isinstance(sku, dict) and sku["q"].dtype == torch.int8
    for req in setup["reqs"]:
        got, want = scorer(req), jscorer(req)
        assert set(got) == set(want)
        for k in want:
            assert got[k].shape == (N,) and np.isfinite(got[k]).all()
            np.testing.assert_allclose(got[k], np.asarray(want[k]),
                                       rtol=TOL, atol=TOL, err_msg=k)


def test_int8_close_to_f32(setup, bundles):
    for req in setup["reqs"]:
        np.testing.assert_allclose(bundles["int8"][0](req)["Scores"],
                                   bundles["f32"][0](req)["Scores"],
                                   atol=0.05)


def test_async_scores_are_tensors_and_equal(setup, bundles):
    scorer = bundles["f32"][0]
    reqs = setup["reqs"]
    one = scorer.score_async(reqs[0])
    assert all(isinstance(v, torch.Tensor) for v in one.values())
    np.testing.assert_array_equal(one["Scores"].numpy(),
                                  scorer(reqs[0])["Scores"])
    group = scorer.score_group_async(reqs)
    assert group["Scores"].shape == (3 * N,)
    single = np.concatenate([scorer(r)["Scores"] for r in reqs])
    np.testing.assert_allclose(group["Scores"].numpy(), single, rtol=1e-6,
                               atol=1e-6)
    on_device = [{k: torch.as_tensor(v) for k, v in r.items()} for r in reqs]
    np.testing.assert_array_equal(
        scorer.score_group_async(on_device)["Scores"].numpy(),
        group["Scores"].numpy())
    with pytest.raises(ValueError, match="equal candidate counts"):
        scorer.score_group_async([reqs[0], {**reqs[1], "valid":
                                            np.ones(N + 1, np.float32)}])


def test_load_scorer_needs_cuda_by_default(bundles):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    scorer, _, pdir, _ = bundles["f32"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        export.load_scorer(scorer.cfg, pdir)
    # a queue is served by a Scorer, which defaults to the card too
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ScorerQueue(export.Scorer(scorer.cfg, scorer.params, scorer.scale,
                                  scorer.const_vec))


def test_queue_over_a_cpu_scorer(setup, bundles):
    """16 requests from 4 threads: each future holds its own request's
    Scores."""
    scorer = bundles["f32"][0]
    reqs = setup["reqs"]
    want = [scorer(r)["Scores"] for r in reqs]
    q = ScorerQueue(scorer, max_group=4, groups=(1, 2, 4))
    q.warmup(reqs[0])
    results = {}

    def client(t):
        for i in range(4):
            k = (t + i) % 3
            results[(t, i)] = (k, q.submit(reqs[k]))

    threads = [threading.Thread(target=client, args=(t,)) for t in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for k, fut in results.values():
        np.testing.assert_allclose(fut.result(timeout=60)["Scores"].numpy(),
                                   want[k], rtol=1e-6, atol=1e-6)
    q.close()


class StubScorer:
    """``score_group_async`` contract: ``[sum(B_i)]`` Scores in request
    order; scores are twice the rows' ``valid`` values, so a slicing error
    shows."""

    def __init__(self):
        self.group_sizes = []
        self.alone = 0

    def _score(self, batches):
        rows = np.concatenate([np.asarray(b["valid"]) for b in batches])
        return {"Scores": torch.from_numpy(rows * 2.0)}

    def score_async(self, batch):
        self.alone += 1
        return self._score([batch])

    def score_group_async(self, batches):
        if len({len(b["valid"]) for b in batches}) != 1:
            raise ValueError("unequal candidate counts")
        self.group_sizes.append(len(batches))
        return self._score(batches)


def _req(vals, dtype=np.float32):
    return {"valid": np.asarray(vals, dtype)}


class Gate:
    """Holds the stub's first group call until ``open``, so the requests
    submitted meanwhile are drained as groups; ``submit_first`` returns
    once the dispatcher is inside that call."""

    def __init__(self, stub, q):
        self.q, self.entered, self.gate = q, threading.Event(), \
            threading.Event()
        real = stub.score_group_async

        def wait_first(batches):
            self.entered.set()
            self.gate.wait(10)
            return real(batches)

        stub.score_group_async = wait_first

    def submit_first(self, batch):
        fut = self.q.submit(batch)
        assert self.entered.wait(10)
        return fut

    def open(self):
        self.gate.set()


def test_queue_resolves_per_request():
    s = StubScorer()
    q = ScorerQueue(s, max_group=4, groups=(1, 2, 4))
    futs = [q.submit(_req([i, i + 0.5])) for i in range(5)]
    res = [f.result(timeout=30)["Scores"].numpy() for f in futs]
    q.close()
    for i, r in enumerate(res):
        np.testing.assert_allclose(r, [2 * i, 2 * i + 1.0])


def test_queue_groups_and_pads_under_load():
    """The first request goes alone; the five queued behind it are
    drained as a group of 4 and one of 1 (max_group 4), and a group of 3
    would be padded to 4 by its last request."""
    s = StubScorer()
    q = ScorerQueue(s, max_group=4, groups=(1, 2, 4))
    gate = Gate(s, q)
    futs = [gate.submit_first(_req([0.0]))]
    futs += [q.submit(_req([float(i)])) for i in range(1, 6)]
    gate.open()
    for i, f in enumerate(futs):
        np.testing.assert_allclose(f.result(timeout=30)["Scores"].numpy(),
                                   [2.0 * i])
    assert s.group_sizes == [1, 4, 1]
    s2 = StubScorer()
    q2 = ScorerQueue(s2, max_group=4, groups=(1, 2, 4))
    gate = Gate(s2, q2)
    futs = [gate.submit_first(_req([0.0]))]
    futs += [q2.submit(_req([float(i)])) for i in range(1, 4)]
    gate.open()
    for i, f in enumerate(futs):
        np.testing.assert_allclose(f.result(timeout=30)["Scores"].numpy(),
                                   [2.0 * i])
    assert s2.group_sizes == [1, 4]     # 3 requests padded to 4
    q.close()
    q2.close()


@pytest.mark.parametrize("odd", ["count", "dtype", "key"])
def test_queue_scores_a_mismatched_request_alone(odd):
    """A request whose keys, shapes or dtypes differ from its group's
    first is scored alone before it can reach a group; its neighbours are
    grouped as usual."""
    s = StubScorer()
    q = ScorerQueue(s, max_group=4, groups=(1, 2, 4))
    gate = Gate(s, q)
    bad = {"count": _req([1.0, 2.0]), "dtype": _req([1.0], np.float64),
           "key": {**_req([1.0]), "extra": np.zeros(1)}}[odd]
    f_warm = gate.submit_first(_req([9.0]))
    f_good = q.submit(_req([1.0]))
    f_bad = q.submit(bad)
    f_good2 = q.submit(_req([3.0]))
    gate.open()
    np.testing.assert_allclose(f_warm.result(timeout=30)["Scores"], [18.0])
    np.testing.assert_allclose(f_good.result(timeout=30)["Scores"], [2.0])
    np.testing.assert_allclose(f_good2.result(timeout=30)["Scores"], [6.0])
    np.testing.assert_allclose(f_bad.result(timeout=30)["Scores"],
                               2.0 * np.asarray(bad["valid"]))
    q.close()
    assert s.group_sizes == [1, 2] and s.alone == 1


@pytest.mark.parametrize("odd", ["count", "dtype", "key"])
def test_queue_counts_the_mismatched_request_as_odd(odd):
    """The test above, recorded: of its 4 requests, ``queue.odd`` counts
    the mismatched one."""
    tracing.snapshot()
    with tracing.recording():
        test_queue_scores_a_mismatched_request_alone(odd)
    c = tracing.snapshot()["counters"]
    assert c["queue.odd"] == 1 and c["queue.requests"] == 4


def _str_signature(batch: dict) -> tuple:
    """The reference grouping: (key, shape, ``str(dtype)``) of every
    array, sorted."""
    return tuple(sorted((k, tuple(v.shape), str(v.dtype))
                        for k, v in batch.items()))


def _layout_pair(case: str) -> tuple:
    """Two requests of two keys; the second differs from the first as
    ``case`` says."""
    ids = np.arange(5, dtype=np.int32)[None]
    a = {"valid": np.asarray([1.0, 2.0], np.float32), "ids": ids}
    b = {"same": {"valid": np.asarray([3.0, 4.0], np.float32),
                  "ids": ids + 1},
         "shape": {**a, "ids": np.zeros((1, 6), np.int32)},
         "dtype": {**a, "ids": ids.astype(np.int64)},
         "key": {**a, "extra": np.zeros(1, np.float32)},
         "torch": {**a, "ids": torch.from_numpy(ids)},
         "order": {"ids": ids, "valid": np.asarray([5.0, 6.0],
                                                  np.float32)}}[case]
    return a, b


@pytest.mark.parametrize("case, grouped", [
    ("same", True), ("shape", False), ("dtype", False), ("key", False),
    ("torch", False), ("order", True)])
def test_layout_groups_as_string_signatures(case, grouped):
    """Two requests share a group exactly where their string signatures
    are equal: a torch tensor differs from a NumPy array of its dtype, the
    order of the keys does not count."""
    a, b = _layout_pair(case)
    assert (_str_signature(a) == _str_signature(b)) is grouped
    assert (queue_mod._layout(a) == queue_mod._layout(b)) is grouped
    s = StubScorer()
    q = ScorerQueue(s, max_group=4, groups=(1, 2, 4))
    gate = Gate(s, q)
    f_warm = gate.submit_first(a)
    f_a, f_b = q.submit(a), q.submit(b)
    gate.open()
    for f, r in ((f_warm, a), (f_a, a), (f_b, b)):
        np.testing.assert_allclose(f.result(timeout=30)["Scores"],
                                   2.0 * np.asarray(r["valid"]))
    q.close()
    assert s.group_sizes == ([1, 2] if grouped else [1, 1])
    assert s.alone == (0 if grouped else 1)


def test_layout_equals_string_signature_for_every_dtype_pair():
    """Over NumPy and torch dtypes, byte orders included, two one-array
    requests have equal layouts if and only if their string signatures
    are equal."""
    dtypes = [np.dtype(t) for t in ("float32", "float64", "int32", "int64",
                                    ">f4", "bool", "uint8")]
    dtypes += [torch.float32, torch.float64, torch.bfloat16, torch.int32,
               torch.int64, torch.bool, torch.uint8]
    reqs = [{"x": (np.zeros(3, t) if isinstance(t, np.dtype)
                   else torch.zeros(3, dtype=t))} for t in dtypes]
    for a in reqs:
        for b in reqs:
            assert ((queue_mod._layout(a) == queue_mod._layout(b))
                    == (_str_signature(a) == _str_signature(b))), (a, b)


def test_queue_builds_one_layout_per_request(monkeypatch):
    """Five submits behind the gate (one alone, then a group of 4) build
    five layouts, each at its submit."""
    built = []
    real = queue_mod._layout

    def counted(batch):
        built.append(threading.current_thread().name)
        return real(batch)

    monkeypatch.setattr(queue_mod, "_layout", counted)
    s = StubScorer()
    q = ScorerQueue(s, max_group=4, groups=(1, 2, 4))
    gate = Gate(s, q)
    futs = [gate.submit_first(_req([0.0]))]
    futs += [q.submit(_req([float(i)])) for i in range(1, 5)]
    gate.open()
    for i, f in enumerate(futs):
        np.testing.assert_allclose(f.result(timeout=30)["Scores"], [2.0 * i])
    q.close()
    assert s.group_sizes == [1, 4]
    assert built == [threading.current_thread().name] * 5


def test_queue_retries_a_failed_group_one_by_one():
    """An error raised on the host by the group call fails no request
    that scores alone."""
    s = StubScorer()

    def fail(batches):
        raise RuntimeError("host-side failure")

    s.score_group_async = fail
    q = ScorerQueue(s, max_group=2, groups=(1, 2))
    futs = [q.submit(_req([float(i)])) for i in range(3)]
    for i, f in enumerate(futs):
        np.testing.assert_allclose(f.result(timeout=30)["Scores"], [2.0 * i])
    q.close()


def test_queue_submit_after_close_raises():
    q = ScorerQueue(StubScorer(), max_group=2, groups=(1, 2))
    q.close()
    with pytest.raises(RuntimeError, match="closed"):
        q.submit(_req([1.0]))
    q.close()  # idempotent
    with pytest.raises(ValueError, match="group sizes"):
        ScorerQueue(StubScorer(), max_group=3, groups=(1, 2))
