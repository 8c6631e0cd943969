"""The port's offline metrics (``metrics/offline.py``, ``offline_ext.py``)
and its C header factorizer against the JAX package's, bit for bit: both
are float64 numpy over the same seeded headers and scores, and the port
numbers groups in the same order without pandas."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from cikm2020_dmt_tpu.data import native as jnative  # noqa: E402
from cikm2020_dmt_tpu.metrics import offline as joff  # noqa: E402
from cikm2020_dmt_tpu.metrics import offline_ext as jext  # noqa: E402
from cikm2020_dmt_torch.data import native  # noqa: E402
from cikm2020_dmt_torch.metrics import offline as off  # noqa: E402
from cikm2020_dmt_torch.metrics import offline_ext as ext  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
SCHEMA = ("expid", "pin", "expo_time", "sid", "pos", "sku", "uuid",
          "click_time", "order_id", "label", "reqsig", "page", "index")


def headers_and_scores(n, seed, ties=False):
    """``n`` header lines of sessions of 1-20 rows (users of 1-4
    sessions), labels 0-5, and two float32 score columns; with ``ties``
    the scores take 8 values, so every group has ties."""
    rng = np.random.default_rng(seed)
    sess = np.repeat(np.arange(n), rng.integers(1, 21, n))[:n]
    rng.shuffle(sess)
    users = sess // rng.integers(1, 5)
    labels = rng.choice([0, 0, 0, 1, 2, 4, 5], n)
    headers = [("\t".join(["e", "p", "t", f"s{s}", "1", "sku", f"u{u}", "-1",
                           "o", str(lab), "r", "2", "0"])).encode()
               for s, u, lab in zip(sess, users, labels)]
    clk = rng.random(n).astype(np.float32)
    ord_ = rng.random(n).astype(np.float32)
    if ties:
        clk = np.round(clk * 7) / 7
        ord_ = np.round(ord_ * 7) / 7
    return headers, clk, ord_


def same(a, b):
    """Equal nested results: dicts, tuples and arrays, float bits."""
    if isinstance(b, dict):
        assert set(a) == set(b)
        for k in b:
            same(a[k], b[k])
    elif isinstance(b, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            same(x, y)
    elif isinstance(b, np.ndarray):
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b and type(a) is type(b)


CASES = [(300, 0, False), (300, 1, True), (5000, 2, False), (5000, 3, True)]
IDS = ["300", "300_ties", "5000_native", "5000_native_ties"]


@pytest.mark.parametrize("n,seed,ties", CASES, ids=IDS)
def test_session_and_grouped_metrics_equal_jax(n, seed, ties):
    headers, clk, ord_ = headers_and_scores(n, seed, ties)
    total = clk + ord_
    same(off.precision_mrr_at_n(SCHEMA, headers, total),
         joff.precision_mrr_at_n(SCHEMA, headers, total))
    for method in ("uuid", "sid"):
        same(off.grouped_auc(SCHEMA, headers, total, method),
             joff.grouped_auc(SCHEMA, headers, total, method))
    same(off.overall_auc(SCHEMA, headers, clk),
         joff.overall_auc(SCHEMA, headers, clk))


@pytest.mark.parametrize("n,seed,ties", CASES, ids=IDS)
def test_parse_headers_equals_jax(n, seed, ties):
    """Labels and every group key's codes; from 4096 lines through the C
    factorizer on both sides, and the raw columns parsed on demand."""
    headers, _, _ = headers_and_scores(n, seed, ties)
    got = off.parse_headers(SCHEMA, headers)
    want = joff.parse_headers(SCHEMA, headers)
    np.testing.assert_array_equal(got.labels, want.labels)
    for key in ("sid", "uuid", ("uuid", "sid")):
        np.testing.assert_array_equal(got.codes(key), want.codes(key))
    np.testing.assert_array_equal(got.sids, want.sids)
    np.testing.assert_array_equal(got.uuids, want.uuids)


def test_factorize_headers_equals_jax():
    headers, _, _ = headers_and_scores(5000, 4)
    for a, b in zip(native.factorize_headers(SCHEMA, headers),
                    jnative.factorize_headers(SCHEMA, headers)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype == np.int64


def test_factorize_headers_raises_on_short_lines():
    """Where the JAX package returns None and falls back to pandas, the
    port raises."""
    headers, _, _ = headers_and_scores(5000, 5)
    headers[17] = b"too\tfew\tfields"
    assert jnative.factorize_headers(SCHEMA, headers) is None
    with pytest.raises(ValueError, match="do not parse"):
        native.factorize_headers(SCHEMA, headers)
    with pytest.raises(ValueError, match="do not parse"):
        off.parse_headers(SCHEMA, headers)


@pytest.mark.parametrize("spill_rows", [1, 333, 10**9])
def test_header_collector_equals_jax(spill_rows):
    """Fed in chunks of 97 lines; past ``spill_rows`` both return labels
    and codes, below it the raw lines."""
    headers, clk, ord_ = headers_and_scores(2000, 6)
    port = off.HeaderCollector(SCHEMA, spill_rows=spill_rows)
    jax_ = joff.HeaderCollector(SCHEMA, spill_rows=spill_rows)
    for i in range(0, len(headers), 97):
        port.extend(headers[i:i + 97])
        jax_.extend(headers[i:i + 97])
    got, want = port.result(), jax_.result()
    assert len(port) == len(headers)
    if spill_rows > len(headers):
        assert got == want == headers
        return
    assert isinstance(got, off.ParsedHeaders)
    np.testing.assert_array_equal(got.labels, want.labels)
    for key in ("sid", "uuid", ("uuid", "sid")):
        np.testing.assert_array_equal(got.codes(key), want.codes(key))
    same(off.precision_mrr_at_n(SCHEMA, got, clk + ord_),
         joff.precision_mrr_at_n(SCHEMA, want, clk + ord_))
    with pytest.raises(RuntimeError, match="streaming collector"):
        got.sids


def test_collector_raises_when_the_library_fails(monkeypatch):
    """No quiet fallback to holding every line: a failed build raises."""
    def broken():
        raise RuntimeError("g++ not found on PATH")
    monkeypatch.setattr(native, "load_library", broken)
    c = off.HeaderCollector(SCHEMA, spill_rows=10)
    headers, _, _ = headers_and_scores(20, 7)
    with pytest.raises(RuntimeError, match="g..? not found"):
        c.extend(headers)
    with pytest.raises(RuntimeError, match="g..? not found"):
        off.parse_headers(SCHEMA, headers_and_scores(4096, 7)[0])


@pytest.mark.parametrize("n,seed,ties", CASES[:3], ids=IDS[:3])
def test_grid_search_equals_jax(n, seed, ties, tmp_path):
    headers, clk, ord_ = headers_and_scores(n, seed, ties)
    got = ext.grid_search(SCHEMA, headers, clk, ord_,
                          out_file=str(tmp_path / "port"))
    want = jext.grid_search(SCHEMA, headers, clk, ord_,
                            out_file=str(tmp_path / "jax"))
    same(got, want)
    assert (tmp_path / "port").read_text() == (tmp_path / "jax").read_text()
    for fn in (ext.mix_auc, ext.weighted_grouped_auc):
        same(fn(SCHEMA, headers, clk), getattr(jext, fn.__name__)(
            SCHEMA, headers, clk))
    same(ext.weighted_grouped_auc(SCHEMA, headers, clk,
                                  weight_method="click"),
         jext.weighted_grouped_auc(SCHEMA, headers, clk,
                                   weight_method="click"))


@pytest.mark.parametrize("n", [300, 5000])
def test_save_scores_csv_equals_jax(n, tmp_path):
    """The port's ``csv`` dump is the JAX package's pandas dump, byte for
    byte."""
    headers, clk, ord_ = headers_and_scores(n, 8)
    ext.save_scores_csv(str(tmp_path / "port"), SCHEMA, headers, clk, ord_)
    jext.save_scores_csv(str(tmp_path / "jax"), SCHEMA, headers, clk, ord_)
    assert (tmp_path / "port").read_bytes() == (tmp_path / "jax").read_bytes()


def test_port_never_imports_pandas():
    """No module of the port names pandas, and running the metrics in a
    fresh interpreter leaves it unimported."""
    for path in sorted((ROOT / "cikm2020_dmt_torch").rglob("*.py")) + [
            ROOT / "chip_smoke.py"]:
        tree = ast.parse(path.read_text())
        names = [a.name for n in ast.walk(tree)
                 if isinstance(n, ast.Import) for a in n.names]
        names += [n.module or "" for n in ast.walk(tree)
                  if isinstance(n, ast.ImportFrom) and n.level == 0]
        assert not [m for m in names if m.split(".")[0] == "pandas"], path
    code = (
        "import sys, numpy as np\n"
        "from cikm2020_dmt_torch.metrics import offline_ext\n"
        "h = [b'e\\tp\\tt\\ts%d\\t1\\tk\\tu%d\\t-1\\to\\t%d\\tr\\t2\\t0'"
        " % (i // 5, i // 9, i % 6) for i in range(5000)]\n"
        "s = np.linspace(0, 1, 5000)\n"
        f"offline_ext.grid_search({SCHEMA!r}, h, s, s[::-1])\n"
        "offline_ext.save_scores_csv(sys.argv[1], "
        f"{SCHEMA!r}, h, s, s)\n"
        "assert 'pandas' not in sys.modules, 'pandas imported'\n")
    subprocess.run([sys.executable, "-c", code, os.devnull], check=True,
                   cwd=ROOT)
