"""The port's data path (``cikm2020_dmt_torch/data``) against the JAX
package's on the same inputs: record framing, the Example codec, vocabs,
propensity weights, ``batch_stream`` over TFRecord shards the test writes
(``chip_smoke.write_shards``), ``prefetch``, and ``device_batch`` into a
CPU ``Trainer`` step.  Every file is written here; no reference data is
read."""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import __graft_entry__ as g  # noqa: E402
import chip_smoke as cs  # noqa: E402
from cikm2020_dmt_tpu.data import example as jexample  # noqa: E402
from cikm2020_dmt_tpu.data import pipeline as jpipeline  # noqa: E402
from cikm2020_dmt_tpu.data import propensity as jpropensity  # noqa: E402
from cikm2020_dmt_tpu.data import tfrecord as jtfrecord  # noqa: E402
from cikm2020_dmt_tpu.data import vocab as jvocab  # noqa: E402
from cikm2020_dmt_torch.data import example, pipeline, propensity  # noqa: E402
from cikm2020_dmt_torch.data import tfrecord, vocab  # noqa: E402
from test_torch_serve import SMALL, port_cfg  # noqa: E402

PER_SHARD = 37   # two shards of 37 examples: batches of 16 leave 10
BATCH = 16


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """(JAX config, port config, directory, examples by shard): two shards
    of the small flagship config's schema, written by the port."""
    jcfg = g._demo_config(**SMALL, sku_rows=4096, shuffle_size=7)
    cfg = port_cfg(jcfg)
    d = tmp_path_factory.mktemp("shards")
    parts = cs.write_shards(cfg, str(d), 2, PER_SHARD, seed=5)
    return jcfg, cfg, str(d) + "/", parts


def test_crc32c_known_vector_and_jax():
    # RFC 3720: crc32c of 32 zero bytes
    assert tfrecord.crc32c(b"\x00" * 32) == 0x8A9136AA
    data = np.random.default_rng(0).bytes(1000)
    assert tfrecord.crc32c(data) == jtfrecord.crc32c(data)
    assert tfrecord.masked_crc32c(data) == jtfrecord.masked_crc32c(data)


def test_records_round_trip_and_match_jax(tmp_path):
    recs = [b"hello", b"", b"\x00" * 1000, b"world" * 99]
    path, jpath = str(tmp_path / "a.tfrecord"), str(tmp_path / "b.tfrecord")
    assert tfrecord.write_records(path, recs) == 4
    jtfrecord.write_records(jpath, recs)
    with open(path, "rb") as f, open(jpath, "rb") as h:
        assert f.read() == h.read()
    assert list(tfrecord.read_records(path, verify_crc=True)) == recs
    assert list(jtfrecord.read_records(path, verify_crc=True)) == recs


FEATURES = {"ids": [b"a", b"bb", b"unknow"], "names": ["x", "yy"],
            "wts": [1.0, 2.5, 0.125], "cnt": [3, -7, 1 << 40],
            "empty": [], "one": [0.5]}


def test_encode_example_bytes_match_jax():
    assert example.encode_example(FEATURES) == \
        jexample.encode_example(FEATURES)


def test_parse_example_selective_matches_jax():
    payload = jexample.encode_example(FEATURES)
    wanted = frozenset({b"ids", b"cnt", b"one", b"absent"})
    got = example.parse_example(payload, wanted)
    assert got == jexample.parse_example(payload, wanted)
    assert set(got) == {"ids", "cnt", "one"}
    assert got["cnt"] == [3, -7, 1 << 40]
    assert example.parse_example(payload) == jexample.parse_example(payload)


@pytest.mark.parametrize("id_size,vocab_list,values", [
    (10, ["unknow", "7", "9"], [b"unknow", b"7", b"9"]),          # in vocab
    (10, ["unknow", "7", "9"], [b"8", b"123456", b"x"]),         # buckets
    (3, ["unknow", "7", "9"], [b"8", b"123456"]),                # no buckets
    (1000, None, [b"42694196051", b"", b"7"]),                   # hashing
])
def test_vocab_lookups_match_jax(id_size, vocab_list, values):
    v = vocab.Vocab("T", id_size, vocab_list)
    jv = jvocab.Vocab("T", id_size, vocab_list)
    got = [v.lookup_one(x) for x in values]
    assert got == [jv.lookup_one(x) for x in values]
    assert np.array_equal(v.lookup(values), jv.lookup(values))
    assert all(0 <= i < id_size for i in got)
    if vocab_list is not None and id_size <= len(vocab_list):
        assert all(i == 0 for i, x in zip(got, values)
                   if x.decode() not in vocab_list)
    for x in values:
        assert vocab.fnv1a64(x) == jvocab.fnv1a64(x)


def test_load_id_table_file_and_vocab_set_match_jax(tmp_path):
    (tmp_path / "Cid2.py").write_text(
        "# vocab\nID_TABLES = {'Cid2': ['unknow', '13362', 1315, '7']}\n")
    path = str(tmp_path / "Cid2.py")
    got = vocab.load_id_table_file(path, "Cid2")
    assert got == jvocab.load_id_table_file(path, "Cid2")
    assert got == ["unknow", "13362", "1315", "7"]
    jcfg = g._demo_config(**SMALL)
    cfg = port_cfg(jcfg)
    vs = vocab.VocabSet(cfg.embeddings + cfg.embeddings_bias, str(tmp_path))
    jvs = jvocab.VocabSet(jcfg.embeddings + jcfg.embeddings_bias,
                          str(tmp_path))
    assert set(vs.by_feature) == set(jvs.by_feature)
    for name, v in vs.by_feature.items():
        jv = jvs.by_feature[name]
        assert (v.name, v.vocab_size, v.num_oov) == \
            (jv.name, jv.vocab_size, jv.num_oov)
        for x in (b"unknow", b"13362", b"1315", b"99", b"abc"):
            assert v.lookup_one(x) == jv.lookup_one(x)
    assert vs.by_feature["item_c2"].lookup_one(b"1315") == 2


def test_propensity_weights_match_jax(tmp_path):
    path = tmp_path / "unbias.py"
    page = [round(0.05 + 0.9 / (1 + i), 4) for i in range(101)]
    path.write_text(f"propensity_em_position = {[0.5] * 401}\n"
                    "propensity_em_page = [\n  "
                    + ",\n  ".join(map(str, page)) + "\n]\n")
    rng = np.random.default_rng(0)
    pos = rng.integers(0, 500, 50).astype(np.int32)
    pages = rng.integers(0, 120, 50).astype(np.int32)
    labels = rng.choice([0.0, 1.0, 4.0], 50).astype(np.float32)
    for em in ("page", "position"):
        m = propensity.PropensityModel.from_file(str(path), em)
        jm = jpropensity.PropensityModel.from_file(str(path), em)
        for a, b in zip(m.weights(pos, pages, labels),
                        jm.weights(pos, pages, labels)):
            np.testing.assert_array_equal(a, b)
    w = propensity.PropensityModel("page").weights(pos, pages, labels)
    assert all((x == 1.0).all() for x in w)
    assert (propensity.MAX_POSITION, propensity.MAX_PAGE) == \
        (jpropensity.MAX_POSITION, jpropensity.MAX_PAGE)


def _batches(mod, cfg, path, **kw):
    return list(mod.batch_stream(cfg, path, BATCH, **kw))


# each mode: the keyword arguments of both batch_stream calls
STREAM_MODES = {
    "drop_remainder": {},
    "pad_remainder": dict(drop_remainder=False),
    "short_remainder": dict(drop_remainder=False, pad_remainder=False),
    "shuffle": dict(shuffle=True, seed=11, epochs=2),
    "shard": dict(num_shards=2, shard_index=1, drop_remainder=False),
}


@pytest.mark.parametrize("mode", list(STREAM_MODES))
def test_batch_stream_matches_jax(shards, mode):
    """Every array of every batch equal to the JAX ``batch_stream``'s, and
    the headers equal."""
    jcfg, cfg, path, _ = shards
    kw = STREAM_MODES[mode]
    got = _batches(pipeline, cfg, path, **kw)
    want = _batches(jpipeline, jcfg, path, **kw)
    assert len(got) == len(want) > 0
    for b, jb in zip(got, want):
        assert set(b.arrays) == set(jb.arrays)
        for k, v in b.arrays.items():
            assert v.dtype == jb[k].dtype, k
            np.testing.assert_array_equal(v, jb[k], err_msg=k)
        assert b.headers == jb.headers
    n = 2 * PER_SHARD
    sizes = [int(b["valid"].sum()) for b in got]
    if mode == "drop_remainder":
        assert sizes == [BATCH] * (n // BATCH)
    elif mode == "pad_remainder":
        assert sum(sizes) == n and got[-1].size == BATCH
    elif mode == "short_remainder":
        assert got[-1].size == n % BATCH
    elif mode == "shard":
        assert sum(sizes) == PER_SHARD
    elif mode == "shuffle":
        in_order = [h for b in _batches(pipeline, cfg, path) for h in
                    b.headers]
        assert [h for b in got for h in b.headers][:BATCH] != \
            in_order[:BATCH]


def test_batch_stream_round_trips_what_was_written(shards):
    """The unshuffled batches hold what ``write_shards`` wrote, in file
    order (``chip_smoke.check_file_batch``: ids are the ``VocabSet``
    lookups of the written strings)."""
    _, cfg, path, parts = shards
    exs = parts[0] + parts[1]
    vs = vocab.VocabSet(cfg.embeddings + cfg.embeddings_bias, "")
    for i, b in enumerate(_batches(pipeline, cfg, path)):
        cs.check_file_batch(cfg, b, exs[i * BATCH:(i + 1) * BATCH], vs)


def test_expand_files_refuses_hdfs(shards, tmp_path):
    path = shards[2]
    files = pipeline.expand_files(path)
    assert files == jpipeline.expand_files(path)
    assert [os.path.basename(f) for f in files] == ["part-r-00000",
                                                    "part-r-00001"]
    (tmp_path / "_SUCCESS").write_text("")
    assert pipeline.expand_files(str(tmp_path) + "/") == []
    with pytest.raises(ValueError, match="HDFS path .* not supported"):
        pipeline.expand_files("hdfs://namenode:9000/user/recsys/train/")
    with pytest.raises(ValueError, match="not supported"):
        pipeline.expand_files(f"{path}, viewfs://cluster/data/")
    with pytest.raises(FileNotFoundError):
        next(pipeline.batch_stream(shards[1], str(tmp_path) + "/", BATCH))


def test_prefetch_equals_direct_stream(shards):
    _, cfg, path, _ = shards
    direct = _batches(pipeline, cfg, path)
    fetched = list(pipeline.prefetch(pipeline.batch_stream(cfg, path,
                                                           BATCH)))
    assert len(direct) == len(fetched)
    for a, b in zip(direct, fetched):
        for k, v in a.arrays.items():
            np.testing.assert_array_equal(v, b[k])
        assert a.headers == b.headers


def test_prefetch_raises_and_stops():
    def failing():
        yield 1
        raise OSError("disk")

    it = pipeline.prefetch(failing())
    assert next(it) == 1
    with pytest.raises(OSError, match="disk"):
        next(it)
    it = pipeline.prefetch(iter(range(10**6)), size=2)
    assert next(it) == 0
    it.close()   # joins the thread: it stops after its current item


def test_device_batch_like_synthetic_batch(shards):
    """On the CPU: the keys, dtypes and shapes that the training step takes
    from ``chip_smoke.synthetic_batch``; every array as the batch holds it;
    the headers stay on the host."""
    _, cfg, path, _ = shards
    b = _batches(pipeline, cfg, path)[0]
    db = pipeline.device_batch(b, "cpu")
    like = cs.synthetic_batch(cfg, BATCH, 0, "cpu")
    for k, v in like.items():
        assert (db[k].dtype, db[k].shape, db[k].device) == \
            (v.dtype, v.shape, v.device), k
    assert set(db) == set(b.arrays)
    for k, v in b.arrays.items():
        np.testing.assert_array_equal(db[k].numpy(), v)


def test_trainer_step_from_file_batch(shards):
    """One CPU ``Trainer`` step from a batch read from the shards equals
    the step from the same arrays handed in directly."""
    from cikm2020_dmt_torch.metrics.streaming import task_metrics_init
    from cikm2020_dmt_torch.nn.layers import tree_map
    from cikm2020_dmt_torch.train.loop import Trainer

    _, cfg, path, _ = shards
    cfg = dataclasses.replace(cfg, batch_size=BATCH)
    b = _batches(pipeline, cfg, path)[0]
    tr = Trainer(cfg, device="cpu")
    state = tr.init_state(torch.Generator().manual_seed(0))
    results = []
    for batch in (pipeline.device_batch(b, "cpu"),
                  {k: torch.from_numpy(v.copy()) for k, v in
                   b.arrays.items()}):
        s = tree_map(lambda t: t.clone(), state)
        s, _, loss = tr.train_step(s, task_metrics_init(), batch,
                                   torch.Generator().manual_seed(1))
        results.append((float(loss), s))
    (la, sa), (lb, sb) = results
    assert np.isfinite(la) and la == lb
    leaves_a, leaves_b = list(cs._leaves(sa)), list(cs._leaves(sb))
    assert len(leaves_a) == len(leaves_b) > 0
    for (pa, ta), (pb, tb) in zip(leaves_a, leaves_b):
        assert pa == pb and torch.equal(ta, tb), pa
