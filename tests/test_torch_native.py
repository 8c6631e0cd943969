"""The port's C++ batch assembler (``cikm2020_dmt_torch/data/native.py``,
``cikm2020_dmt_torch/native/dmtdata.cc``) against the JAX package's Python
``batch_stream`` and the port's own Python path, on TFRecord shards of the
small flagship schema written here: OOV strings, unknown features, weight
lists longer than the ids or all zero, junk header fields.

The port's library is built with ``g++`` (about 2 s).  The JAX package's
native library is never built: the shuffled order is checked by running
the JAX ``native_batch_stream`` with the port's assembler and, patched in,
the port's ``scan_file``, so that only its Python ordering runs."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import __graft_entry__ as g  # noqa: E402
from cikm2020_dmt_tpu.data import native as jnative  # noqa: E402
from cikm2020_dmt_tpu.data import pipeline as jpipeline  # noqa: E402
from cikm2020_dmt_tpu.data import vocab as jvocab  # noqa: E402
from cikm2020_dmt_torch.data import example, native, pipeline  # noqa: E402
from cikm2020_dmt_torch.data import tfrecord  # noqa: E402
from cikm2020_dmt_torch.data.schema import FeatureSchema  # noqa: E402
from cikm2020_dmt_torch.train import loop  # noqa: E402
from test_torch_serve import SMALL, port_cfg  # noqa: E402

BATCH = 16
PER_SHARD = 45          # three shards: 135 examples, batches of 16 leave 7
VOCAB = {"Cid2": 21, "Brand": 30}   # tables with a vocab file: its size


def _random_example(rng, schema, ts_feats):
    """One Example of ``schema`` with the cases the two assemblers must
    agree on: absent fields and features, more dense values or mask entries
    than the schema's, id lists past the cap, ids from a small pool (some
    in the vocab files, some OOV, some empty), weight lists absent, all
    zero or longer than the ids, junk positions and timestamps, and
    features the schema does not name."""
    feats = {}
    r = rng.random()
    if r > 0.1:
        fields = [f"f{j}-{rng.integers(1e6)}" for j in range(13)]
        fields[4] = str(rng.integers(-5, 500))      # pos (clipped at 400)
        fields[11] = str(rng.integers(-5, 200))     # page (clipped at 100)
        if r > 0.9:
            fields[4] = "junk"
        feats["header"] = [("\t".join(fields)).encode()]
    if rng.random() > 0.05:
        feats["label"] = [float(rng.choice([0, 1, 2, 4, 5]))]
    if rng.random() > 0.05:
        feats["mask"] = list(rng.random(int(rng.choice(
            [schema.num_classes, schema.num_classes + 3]))).astype(float))
    if rng.random() > 0.05:
        feats["features"] = list(rng.random(int(rng.choice(
            [schema.dense_dim, schema.dense_dim + 40]))).astype(float))
    for f in schema.id_features:
        r = rng.random()
        if r < 0.15:
            continue
        k = int(rng.integers(0, 2 * f.max_len))
        if f.name in ts_feats:
            vals = [str(rng.integers(-10, 10**7)).encode() for _ in range(k)]
            if k and r > 0.9:
                vals[0] = b"notanumber"
            if k and r > 0.95:
                vals[-1] = b"123.000000"
        else:
            vals = [f"id{rng.integers(0, 50)}".encode() for _ in range(k)]
            if k and r > 0.9:
                vals[0] = b""
        feats[f.name] = vals
        wr = rng.random()
        if wr < 0.3:
            pass
        elif wr < 0.5:
            feats[f.name + "Wts"] = [0.0] * k
        else:
            feats[f.name + "Wts"] = list(
                rng.random(k + int(rng.integers(0, 3))).astype(float))
    if rng.random() > 0.8:
        feats["unknown_feature"] = [b"ignored", b"values"]
    return feats


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """(JAX config, port config, path spec): three shards of random
    Examples and vocab files for two tables."""
    d = tmp_path_factory.mktemp("native")
    vocab_dir = d / "vocab"
    vocab_dir.mkdir()
    for table, n in VOCAB.items():
        words = ["unknow"] + [f"id{i}" for i in range(n - 1)]
        (vocab_dir / f"{table}.py").write_text(
            f"ID_TABLES = {{{table!r}: {words!r}}}\n")
    jcfg = g._demo_config(**SMALL, vocab_path=str(vocab_dir))
    cfg = port_cfg(jcfg)
    schema = FeatureSchema.from_config(cfg)
    ts = set(cfg.attention_ts)
    rng = np.random.default_rng(20261017)
    data = d / "data"
    data.mkdir()
    for s in range(3):
        tfrecord.write_records(str(data / f"part-r-{s:05d}"), [
            example.encode_example(_random_example(rng, schema, ts))
            for _ in range(PER_SHARD)])
    return jcfg, cfg, str(data) + "/"


def _assert_same(got, want):
    assert len(got) == len(want) > 0
    for b, w in zip(got, want):
        assert set(b.arrays) == set(w.arrays)
        for k, v in b.arrays.items():
            assert v.dtype == w[k].dtype, k
            np.testing.assert_array_equal(v, w[k], err_msg=k)
        assert b.headers == w.headers


@pytest.mark.parametrize("mode", [
    dict(),                                             # drop_remainder
    dict(drop_remainder=False),                         # pad_remainder
    dict(drop_remainder=False, pad_remainder=False),    # short remainder
], ids=["drop_remainder", "pad_remainder", "short_remainder"])
def test_native_stream_matches_python_streams(shards, mode):
    """Two epochs, array for array and header for header: the port's
    native stream, the JAX Python ``batch_stream`` and the port's."""
    jcfg, cfg, path = shards
    got = list(native.native_batch_stream(cfg, path, BATCH, epochs=2,
                                          **mode))
    _assert_same(got, list(jpipeline.batch_stream(jcfg, path, BATCH,
                                                  epochs=2, **mode)))
    _assert_same(got, list(pipeline.batch_stream(cfg, path, BATCH, epochs=2,
                                                 **mode)))
    n = 2 * 3 * PER_SHARD
    assert sum(int(b["valid"].sum()) for b in got) == \
        (n if mode else n - n % BATCH)


def test_without_headers_same_arrays(shards):
    _, cfg, path = shards
    with_h = list(native.native_batch_stream(cfg, path, BATCH))
    without = list(native.native_batch_stream(cfg, path, BATCH,
                                              with_headers=False))
    assert all(h == b"" for b in without for h in b.headers)
    for a, b in zip(with_h, without):
        for k, v in a.arrays.items():
            np.testing.assert_array_equal(v, b[k], err_msg=k)


def test_shuffled_order_matches_jax_native_stream(shards, monkeypatch):
    """The shuffled file order and record windows, batch for batch: the
    JAX ``native_batch_stream``'s ordering over the port's scan and
    assembler."""
    jcfg, cfg, path = shards
    monkeypatch.setattr(jnative, "scan_file", native.scan_file)
    kw = dict(epochs=2, shuffle=True, drop_remainder=False, seed=7)
    got = list(native.native_batch_stream(cfg, path, BATCH, **kw))
    want = list(jnative.native_batch_stream(
        jcfg, path, BATCH, assembler=native.NativeAssembler(cfg), **kw))
    _assert_same(got, want)
    unshuffled = list(native.native_batch_stream(cfg, path, BATCH, epochs=2,
                                                 drop_remainder=False))
    assert [h for b in got for h in b.headers] != \
        [h for b in unshuffled for h in b.headers]
    assert sorted(h for b in got for h in b.headers) == \
        sorted(h for b in unshuffled for h in b.headers)


@pytest.mark.parametrize("workers", [3, 8])
def test_workers_give_the_same_batches(shards, workers):
    _, cfg, path = shards
    kw = dict(epochs=2, shuffle=True, drop_remainder=False)
    one = list(native.native_batch_stream(cfg, path, BATCH, num_workers=1,
                                          **kw))
    many = list(native.native_batch_stream(cfg, path, BATCH,
                                           num_workers=workers, **kw))
    _assert_same(many, one)


def test_lookup_ids_match_jax_vocabs(shards):
    jcfg, cfg, _ = shards
    asm = native.NativeAssembler(cfg)
    jvs = jvocab.VocabSet(jcfg.embeddings + jcfg.embeddings_bias,
                          jcfg.vocab_path)
    values = [f"id{i}".encode() for i in range(60)] + [b"", b"unknow",
                                                        b"42694196051"]
    for feature in ("item_c2", "item_brand", "clk_seq_sku_7d_50"):
        want = [jvs.by_feature[feature].lookup_one(v) for v in values]
        np.testing.assert_array_equal(asm.lookup_ids(feature, values), want)
    assert asm.lookup_ids("item_c2", []).shape == (0,)
    with pytest.raises(ValueError, match="ts feature"):
        asm.lookup_ids("clk_seq_ts_7d_50", values)


def test_assemble_records_pads_like_the_stream(shards):
    """``assemble_records`` of one file's last records, padded to the batch
    size, equals the Python path's padded last batch of that file."""
    _, cfg, path = shards
    asm = native.NativeAssembler(cfg)
    blob, offs, lens = native.scan_file(path + "part-r-00000")
    tail = PER_SHARD % BATCH
    got = asm.assemble_records(blob, offs[-tail:], lens[-tail:],
                               target_size=BATCH)
    want = list(pipeline.batch_stream(cfg, path + "part-r-00000*", BATCH,
                                      drop_remainder=False))[-1]
    assert got.size == BATCH and int(got["valid"].sum()) == tail
    _assert_same([got], [want])


def test_header_cap_truncates_bytes_not_positions(tmp_path):
    """A header longer than ``HEADER_CAP`` is cut in the batch's header
    bytes, but pos and page still parse from the whole record."""
    cfg = port_cfg(g._demo_config(**SMALL))
    fields = ["x" * 200] * 4 + ["321"] + ["y" * 900] * 6 + ["77", "z"]
    hdr = ("\t".join(fields)).encode()
    assert len(hdr) > native.HEADER_CAP
    tfrecord.write_records(str(tmp_path / "h.tfrecord"), [
        example.encode_example({"header": [hdr], "label": [1.0]})] * 4)
    b = next(native.native_batch_stream(cfg, str(tmp_path / "*.tfrecord"),
                                        4, drop_remainder=False))
    assert b.headers[0] == hdr[:native.HEADER_CAP]
    assert b["em_position"][0] == 321
    assert b["em_page"][0] == 77


def test_corrupt_framing_same_verdict_as_python(tmp_path):
    """Trailing bytes shorter than a frame header are ignored and a cut
    record raises ``IOError``, as the Python readers (the port's and the
    JAX package's) do."""
    from cikm2020_dmt_tpu.data.tfrecord import read_records as j_read
    good = str(tmp_path / "good.tfrecord")
    tfrecord.write_records(good, [example.encode_example(
        {"label": [1.0]})] * 3)
    data = open(good, "rb").read()
    tail = str(tmp_path / "tail.tfrecord")
    with open(tail, "wb") as f:
        f.write(data + b"\x00" * 8)
    assert len(list(j_read(tail))) == len(list(tfrecord.read_records(tail)))
    _, offs, lens = native.scan_file(tail)
    assert len(offs) == 3
    trunc = str(tmp_path / "trunc.tfrecord")
    with open(trunc, "wb") as f:
        f.write(data[:-10])
    for read in (j_read, tfrecord.read_records):
        with pytest.raises(IOError):
            list(read(trunc))
    with pytest.raises(IOError):
        native.scan_file(trunc)
    cfg = port_cfg(g._demo_config(**SMALL))
    with pytest.raises(IOError):
        list(native.native_batch_stream(cfg, trunc, 2))


@pytest.fixture
def no_compiler(monkeypatch, tmp_path):
    """No ``g++`` on the PATH and an empty build directory; the loaded
    library is forgotten before and after."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    native.load_library.cache_clear()
    yield
    native.load_library.cache_clear()


def test_failed_build_raises_without_fallback(shards, no_compiler):
    """No library, no stream: the build, the assembler and the trainer's
    input stream raise; the Python stream runs only when asked for by
    name."""
    _, cfg, path = shards
    with pytest.raises(RuntimeError, match="g.. not found"):
        native.load_library()
    with pytest.raises(RuntimeError, match="g.. not found"):
        native.NativeAssembler(cfg)
    with pytest.raises(RuntimeError, match="g.. not found"):
        loop.make_input_stream(cfg, path, BATCH)
    got = list(loop.make_input_stream(cfg, path, BATCH, native=False,
                                      with_headers=False))
    _assert_same(got, list(pipeline.batch_stream(cfg, path, BATCH)))


def test_compiler_error_raises(monkeypatch, tmp_path):
    """A source that does not compile raises with the compiler's
    message."""
    bad = tmp_path / "dmtdata.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="g\\+\\+ exited"):
        native.build_library()
    assert not list((tmp_path / "_build").glob("*"))


def test_input_stream_is_the_native_stream(shards):
    _, cfg, path = shards
    got = list(loop.make_input_stream(cfg, path, BATCH, epochs=1))
    _assert_same(got, list(native.native_batch_stream(cfg, path, BATCH)))
