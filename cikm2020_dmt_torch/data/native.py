"""The data path's native half: the ctypes binding and the build of the
package's C++ batch assembler (``native/dmtdata.cc``, the port's own copy
of the JAX package's ``data/native.py``).

The shared library is compiled with ``g++`` at first use into
``cikm2020_dmt_torch/_build/`` (listed in ``.gitignore``), under a name
keyed by a hash of the source and the flags.  A missing compiler or a
failed build raises: nothing falls back to the Python path on its own.

``NativeAssembler`` produces the batches of the Python ``BatchAssembler``
array for array (``tests/test_torch_native.py``); ``native_batch_stream``
is the stream the trainer and the evaluator read.  ``factorize_headers``
and ``HeaderFactorizer`` parse eval header lines into labels and group
codes for the offline metrics (``metrics/offline.py``).
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import random
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Iterator, Optional

import numpy as np

from ..core.config import DMTConfig
from .pipeline import IDS, LEN, WTS, Batch, expand_files, shard_files
from .propensity import PropensityModel
from .schema import FeatureSchema
from .vocab import VocabSet

PKG_DIR = Path(__file__).resolve().parent.parent
SRC = PKG_DIR / "native" / "dmtdata.cc"
BUILD_DIR = PKG_DIR / "_build"
GXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
             "-pthread")

# Max stored header bytes per example: longer headers are TRUNCATED in
# Batch.headers.  em_position / em_page are not: the C scanner parses them
# from the full record value, not the truncated copy.
HEADER_CAP = 1024


def library_path() -> Path:
    key = hashlib.sha256(SRC.read_bytes() + " ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libdmtdata-{key.hexdigest()[:16]}.so"


def build_library() -> Path:
    """The assembler's shared library, compiled first if it is not there.
    Processes that build it at once (test workers) each write their own file
    and rename it into place."""
    out = library_path()
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH: the native data path "
                           f"({SRC.name}) cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([gxx, *GXX_FLAGS, str(SRC), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {SRC.name} failed (g++ exited "
                           f"{proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


@functools.cache
def load_library() -> ctypes.CDLL:
    """The built library with the argument and result types of every
    function it exports."""
    lib = ctypes.CDLL(str(build_library()))
    c = ctypes
    lib.dmt_ctx_create.restype = c.c_void_p
    lib.dmt_ctx_create.argtypes = [c.c_int] * 6
    lib.dmt_ctx_destroy.argtypes = [c.c_void_p]
    lib.dmt_ctx_add_table.restype = c.c_int
    lib.dmt_ctx_add_table.argtypes = [c.c_void_p, c.c_int64]
    lib.dmt_table_add_vocab.argtypes = [
        c.c_void_p, c.c_int, c.c_char_p, c.POINTER(c.c_int64), c.c_int64]
    lib.dmt_ctx_add_feature.restype = c.c_int
    lib.dmt_ctx_add_feature.argtypes = [c.c_void_p, c.c_char_p, c.c_int,
                                        c.c_int]
    lib.dmt_ctx_finalize.argtypes = [c.c_void_p]
    lib.dmt_lookup_batch.argtypes = [
        c.c_void_p, c.c_int, c.c_char_p, c.POINTER(c.c_int64), c.c_int64,
        c.POINTER(c.c_int32)]
    lib.dmt_factorize_headers.restype = c.c_int64
    lib.dmt_factorize_headers.argtypes = [
        c.c_char_p, c.c_int64, c.c_int64, c.c_int, c.c_int, c.c_int,
        c.POINTER(c.c_int64), c.POINTER(c.c_int32), c.POINTER(c.c_int32),
        c.POINTER(c.c_int64)]
    lib.dmt_hfact_create.restype = c.c_void_p
    lib.dmt_hfact_create.argtypes = []
    lib.dmt_hfact_feed.restype = c.c_int64
    lib.dmt_hfact_feed.argtypes = [
        c.c_void_p, c.c_char_p, c.c_int64, c.c_int64, c.c_int, c.c_int,
        c.c_int, c.POINTER(c.c_int64), c.POINTER(c.c_int32),
        c.POINTER(c.c_int32)]
    lib.dmt_hfact_uniques.restype = c.c_int64
    lib.dmt_hfact_uniques.argtypes = [c.c_void_p, c.c_int]
    lib.dmt_hfact_destroy.argtypes = [c.c_void_p]
    lib.dmt_scan_tfrecord.restype = c.c_int64
    lib.dmt_scan_tfrecord.argtypes = [
        c.c_char_p, c.c_int64, c.POINTER(c.c_int64), c.POINTER(c.c_int64),
        c.c_int64]
    lib.dmt_parse_batch.argtypes = [
        c.c_void_p, c.c_char_p, c.POINTER(c.c_int64), c.POINTER(c.c_int64),
        c.c_int64,
        c.POINTER(c.c_float), c.POINTER(c.c_float), c.POINTER(c.c_float),
        c.POINTER(c.c_uint8), c.POINTER(c.c_int32),
        c.POINTER(c.c_int32), c.POINTER(c.c_int32),
        c.POINTER(c.POINTER(c.c_int32)), c.POINTER(c.POINTER(c.c_float)),
        c.POINTER(c.POINTER(c.c_int32))]
    return lib


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


class NativeAssembler:
    """C++ batch assembly with the output contract of
    ``pipeline.BatchAssembler``."""

    def __init__(self, cfg: DMTConfig, schema: Optional[FeatureSchema] = None,
                 vocabs: Optional[VocabSet] = None,
                 propensity: Optional[PropensityModel] = None,
                 num_threads: int = 0):
        self.schema = schema or FeatureSchema.from_config(cfg)
        vocabs = vocabs or VocabSet(cfg.embeddings + cfg.embeddings_bias,
                                    cfg.vocab_path)
        self.propensity = propensity or PropensityModel(cfg.propensity_em_type)
        lib = load_library()
        self._lib = lib
        hidx = self.schema.header_index
        self._ctx = lib.dmt_ctx_create(
            self.schema.dense_dim, self.schema.num_classes, HEADER_CAP,
            hidx.get("pos", 4), hidx.get("page", 11), num_threads)
        ts_feats = set(cfg.attention_ts)
        table_ids: dict[str, int] = {}
        for f in self.schema.id_features:
            if f.name in ts_feats:
                table = -1
            else:
                if f.table not in table_ids:
                    vocab = vocabs.by_table[f.table]
                    tid = lib.dmt_ctx_add_table(self._ctx, vocab.id_size)
                    if vocab._map is not None:
                        keys = sorted(vocab._map.items(), key=lambda kv: kv[1])
                        blob = b"".join(k for k, _ in keys)
                        offs = np.zeros(len(keys) + 1, np.int64)
                        np.cumsum([len(k) for k, _ in keys], out=offs[1:])
                        lib.dmt_table_add_vocab(
                            self._ctx, tid, blob, _ptr(offs, ctypes.c_int64),
                            len(keys))
                    table_ids[f.table] = tid
                table = table_ids[f.table]
            lib.dmt_ctx_add_feature(self._ctx, f.name.encode(), f.max_len,
                                    table)
        lib.dmt_ctx_finalize(self._ctx)
        self._feature_table = {
            f.name: (-1 if f.name in ts_feats else table_ids[f.table])
            for f in self.schema.id_features}

    def lookup_ids(self, feature: str, values: list[bytes]) -> np.ndarray:
        """The vocab / OOV-bucket / hash ids of raw byte ids in one C call.
        ``feature`` must not be a raw-int timestamp feature."""
        table = self._feature_table[feature]
        if table < 0:
            raise ValueError(f"{feature} is a raw-int ts feature")
        out = np.empty(len(values), np.int32)
        if not values:
            return out
        blob = b"".join(values)
        offs = np.zeros(len(values) + 1, np.int64)
        np.cumsum([len(v) for v in values], out=offs[1:])
        self._lib.dmt_lookup_batch(self._ctx, table, blob,
                                   _ptr(offs, ctypes.c_int64), len(values),
                                   _ptr(out, ctypes.c_int32))
        return out

    def __del__(self):
        ctx, self._ctx = getattr(self, "_ctx", None), None
        if ctx:
            self._lib.dmt_ctx_destroy(ctx)

    def assemble_records(self, blob: bytes, offsets: np.ndarray,
                         lengths: np.ndarray,
                         target_size: Optional[int] = None,
                         with_headers: bool = True) -> Batch:
        return self.assemble_segments([(blob, offsets, lengths)],
                                      target_size, with_headers)

    def assemble_segments(self, segments, target_size: Optional[int] = None,
                          with_headers: bool = True) -> Batch:
        """One batch from ``[(blob, offsets, lengths), ...]``.

        Each segment parses straight into its rows of the output arrays
        (row-sliced numpy views), so a batch that spans files needs no
        staging copy.  ``with_headers=False`` skips the per-row header
        bytes (training never reads them); em_position / em_page are
        parsed from the records either way."""
        n = sum(len(o) for _, o, _ in segments)
        b = target_size or n
        s = self.schema
        a: dict[str, np.ndarray] = {
            "features": np.zeros((b, s.dense_dim), np.float32),
            "label": np.zeros((b,), np.float32),
            "mask": np.zeros((b, s.num_classes), np.float32),
            "valid": np.zeros((b,), np.float32),
            "em_position": np.zeros((b,), np.int32),
            "em_page": np.zeros((b,), np.int32),
        }
        a["valid"][:n] = 1.0
        if with_headers:
            header_buf = np.zeros((b, HEADER_CAP), np.uint8)
            header_len = np.zeros((b,), np.int32)
        feat_ids, feat_wts, feat_len = [], [], []
        for f in s.id_features:
            a[f.name + IDS] = np.zeros((b, f.max_len), np.int32)
            a[f.name + WTS] = np.zeros((b, f.max_len), np.float32)
            a[f.name + LEN] = np.zeros((b,), np.int32)
            feat_ids.append(a[f.name + IDS])
            feat_wts.append(a[f.name + WTS])
            feat_len.append(a[f.name + LEN])

        nf = len(s.id_features)
        row = 0
        for blob, offsets, lengths in segments:
            k = len(offsets)
            if k == 0:
                continue
            ids_arr = (ctypes.POINTER(ctypes.c_int32) * nf)(
                *[_ptr(x[row:], ctypes.c_int32) for x in feat_ids])
            wts_arr = (ctypes.POINTER(ctypes.c_float) * nf)(
                *[_ptr(x[row:], ctypes.c_float) for x in feat_wts])
            len_arr = (ctypes.POINTER(ctypes.c_int32) * nf)(
                *[_ptr(x[row:], ctypes.c_int32) for x in feat_len])
            offsets = np.ascontiguousarray(offsets, np.int64)
            lengths = np.ascontiguousarray(lengths, np.int64)
            self._lib.dmt_parse_batch(
                self._ctx, blob, _ptr(offsets, ctypes.c_int64),
                _ptr(lengths, ctypes.c_int64), k,
                _ptr(a["features"][row:], ctypes.c_float),
                _ptr(a["label"][row:], ctypes.c_float),
                _ptr(a["mask"][row:], ctypes.c_float),
                _ptr(header_buf[row:], ctypes.c_uint8)
                if with_headers else None,
                _ptr(header_len[row:], ctypes.c_int32)
                if with_headers else None,
                _ptr(a["em_position"][row:], ctypes.c_int32),
                _ptr(a["em_page"][row:], ctypes.c_int32),
                ids_arr, wts_arr, len_arr)
            row += k

        p, w, w_pos, w_mul = self.propensity.weights(
            a["em_position"], a["em_page"], a["label"])
        a["propensity"] = p
        a["propensity_weight"] = w
        a["propensity_weight_positive"] = w_pos
        a["propensity_weight_mul"] = w_mul
        if with_headers:
            headers = [bytes(header_buf[i, :header_len[i]])
                       for i in range(n)]
            headers.extend(b"" for _ in range(b - n))
        else:
            headers = [b""] * b
        return Batch(a, headers)


def _header_fields(header_schema) -> tuple[int, int, int]:
    """(label, sid, uuid) column indices; uuid falls back to sid."""
    idx = {name: i for i, name in enumerate(header_schema)}
    return idx["label"], idx["sid"], idx.get("uuid", idx["sid"])


def factorize_headers(header_schema, headers) -> tuple:
    """One C pass over eval header lines: (labels int64 [n], sid codes
    int64 [n], uuid codes int64 [n]), the codes numbered in order of first
    occurrence, with no Python string per row.  Raises ``ValueError`` on
    lines it cannot parse (too few fields, an embedded newline) and
    ``RuntimeError`` when the library does not build: nothing falls back
    to a slower parse on its own."""
    lib = load_library()
    label_i, sid_i, uuid_i = _header_fields(header_schema)
    n = len(headers)
    blob = b"\n".join(headers)
    labels = np.empty(n, np.int64)
    sid_codes = np.empty(n, np.int32)
    uuid_codes = np.empty(n, np.int32)
    n_uniq = np.zeros(2, np.int64)
    r = lib.dmt_factorize_headers(
        blob, len(blob), n, label_i, sid_i, uuid_i,
        _ptr(labels, ctypes.c_int64), _ptr(sid_codes, ctypes.c_int32),
        _ptr(uuid_codes, ctypes.c_int32), _ptr(n_uniq, ctypes.c_int64))
    if r != n:
        raise ValueError(f"header factorize: {n} lines do not parse as "
                         f"{len(header_schema)}-field headers")
    return labels, sid_codes.astype(np.int64), uuid_codes.astype(np.int64)


class HeaderFactorizer:
    """``factorize_headers`` over a stream of chunks: codes stay numbered
    across chunks, and only the distinct sid and uuid bytes stay resident
    (in the library's hash arenas), so each chunk's lines can be dropped
    once fed.  Raises as ``factorize_headers`` does."""

    def __init__(self, header_schema):
        self._fields = _header_fields(header_schema)
        self._lib = load_library()
        self._h = self._lib.dmt_hfact_create()
        self._labels: list[np.ndarray] = []
        self._sid: list[np.ndarray] = []
        self._uuid: list[np.ndarray] = []
        self.rows = 0

    def feed(self, headers) -> None:
        """Consumes one chunk of header byte lines."""
        n = len(headers)
        if n == 0:
            return
        blob = b"\n".join(headers)
        labels = np.empty(n, np.int64)
        sid_codes = np.empty(n, np.int32)
        uuid_codes = np.empty(n, np.int32)
        r = self._lib.dmt_hfact_feed(
            self._h, blob, len(blob), n, *self._fields,
            _ptr(labels, ctypes.c_int64), _ptr(sid_codes, ctypes.c_int32),
            _ptr(uuid_codes, ctypes.c_int32))
        if r != n:
            raise ValueError(f"header factorize: a chunk of {n} lines does "
                             "not parse")
        self._labels.append(labels)
        self._sid.append(sid_codes)
        self._uuid.append(uuid_codes)
        self.rows += n

    def result(self) -> tuple:
        """(labels int64 [n], sid codes int64 [n], uuid codes int64 [n])
        over every chunk fed."""
        if not self._labels:
            return tuple(np.zeros(0, np.int64) for _ in range(3))
        return (np.concatenate(self._labels),
                np.concatenate(self._sid).astype(np.int64),
                np.concatenate(self._uuid).astype(np.int64))

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h is not None:
            self._lib.dmt_hfact_destroy(h)


def scan_file(path: str) -> tuple[bytes, np.ndarray, np.ndarray]:
    """One TFRecord file read and frame-scanned natively: (the file's
    bytes, record offsets, record lengths).  Raises ``IOError`` on a
    truncated record."""
    lib = load_library()
    with open(path, "rb") as f:
        blob = f.read()
    cap = max(16, len(blob) // 64)  # records are >=64B in practice
    while True:
        offs = np.zeros(cap, np.int64)
        lens = np.zeros(cap, np.int64)
        n = lib.dmt_scan_tfrecord(blob, len(blob), _ptr(offs, ctypes.c_int64),
                                  _ptr(lens, ctypes.c_int64), cap)
        if n < 0:
            raise IOError(f"corrupt TFRecord framing in {path}")
        if n < cap:  # n == cap: the scan may have stopped at the cap
            return blob, offs[:n], lens[:n]
        cap *= 4


def native_batch_stream(
    cfg: DMTConfig,
    path_spec: str,
    batch_size: int,
    epochs: int = 1,
    shuffle: bool = False,
    drop_remainder: bool = True,
    pad_remainder: bool = True,
    num_shards: int = 1,
    shard_index: int = 0,
    assembler: Optional[NativeAssembler] = None,
    seed: Optional[int] = None,
    with_headers: bool = True,
    num_workers: Optional[int] = None,
    cache_bytes: Optional[int] = None,
) -> Iterator[Batch]:
    """Batches from a native framing scan and a parallel native parse.

    The shuffle permutes the file order every epoch and the records within
    a sliding window of the last two files (``random.Random(seed)``, then a
    ``np.random.default_rng`` permutation drawn from it per file), so a
    shuffled epoch yields the JAX package's native stream batch for batch.

    - Pending records are kept as numpy arrays of (file, record) indices;
      a batch is cut from them with array operations.
    - ``num_workers`` assembler threads (``cfg.data_workers``; 0 = one per
      core, at most 8) assemble whole batches: the C++ parse drops the
      GIL.  Batches are submitted and yielded first in, first out, so the
      stream is the same for any worker count.
    - A scan cache of ``cache_bytes`` (``cfg.data_cache_bytes``, least
      recently used out first) keeps whole files and their framing scans
      across epochs.
    - One thread reads the next file while the current one is parsed.
    """
    files = shard_files(expand_files(path_spec), num_shards, shard_index)
    if not files:
        raise FileNotFoundError(f"no input files match {path_spec!r}")
    rng = random.Random(cfg.seed if seed is None else seed)
    if num_workers is None:
        num_workers = cfg.data_workers
    if num_workers <= 0:
        num_workers = min(8, os.cpu_count() or 4)
    if assembler is None:
        # split the cores between the stream's workers and each call's
        # own parse pool: nested pools as wide as the host oversubscribe it
        per_call = max(1, (os.cpu_count() or 4) // max(1, num_workers))
        assembler = NativeAssembler(cfg, num_threads=per_call)
    if cache_bytes is None:
        cache_bytes = cfg.data_cache_bytes

    # ---- bounded LRU of (blob, offs, lens) keyed by path ----
    cache: "collections.OrderedDict[str, tuple]" = collections.OrderedDict()
    cache_lock = threading.Lock()
    cache_total = 0

    def get_file(path: str):
        nonlocal cache_total
        with cache_lock:
            ent = cache.get(path)
            if ent is not None:
                cache.move_to_end(path)
                return ent
        ent = scan_file(path)
        if cache_bytes > 0:
            with cache_lock:
                if path not in cache:
                    cache[path] = ent
                    cache_total += len(ent[0])
                    while cache_total > cache_bytes and len(cache) > 1:
                        _, old = cache.popitem(last=False)
                        cache_total -= len(old[0])
        return ent

    # ---- pending records: (file index, record index) arrays ----
    blob_reg: dict[int, tuple] = {}
    next_bi = 0
    pend_bi = np.empty(0, np.int64)
    pend_ri = np.empty(0, np.int64)

    def split_segments(tb: np.ndarray, tr: np.ndarray):
        """Consecutive same-file runs -> [(blob, offs, lens), ...]."""
        cuts = np.flatnonzero(np.diff(tb)) + 1
        lo_hi = zip(np.concatenate([[0], cuts]),
                    np.concatenate([cuts, [len(tb)]]))
        segs = []
        for lo, hi in lo_hi:
            blob, offs, lens = blob_reg[int(tb[lo])]
            idx = tr[lo:hi]
            segs.append((blob, offs[idx], lens[idx]))
        return segs

    def take_batches(flush_partial: bool):
        """(segments, target size) work items off the pending arrays."""
        nonlocal pend_bi, pend_ri
        while (len(pend_bi) >= batch_size
               or (flush_partial and len(pend_bi))):
            n = min(batch_size, len(pend_bi))
            tb, tr = pend_bi[:n].copy(), pend_ri[:n].copy()
            pend_bi = pend_bi[n:].copy()
            pend_ri = pend_ri[n:].copy()
            target = (batch_size
                      if (pad_remainder and n < batch_size) else None)
            yield split_segments(tb, tr), target
        if not len(pend_bi):
            # submitted work holds its own references to its files' bytes;
            # the registry is needed only for records still pending
            blob_reg.clear()

    pool = (ThreadPoolExecutor(max_workers=num_workers)
            if num_workers > 1 else None)
    inflight: collections.deque = collections.deque()

    def emit(final: bool) -> Iterator[Batch]:
        """``final``, the end of the stream: flush the partial batch
        (unless ``drop_remainder``) and drain every batch in flight."""
        for segs, target in take_batches(final and not drop_remainder):
            if pool is None:
                yield assembler.assemble_segments(segs, target,
                                                  with_headers)
                continue
            inflight.append(pool.submit(
                assembler.assemble_segments, segs, target, with_headers))
            while len(inflight) > num_workers:
                yield inflight.popleft().result()
        if final:
            while inflight:
                yield inflight.popleft().result()

    def epoch_files():
        epoch_iter = range(epochs) if epochs >= 0 else iter(int, 1)
        for _ in epoch_iter:
            order = list(files)
            if shuffle:
                rng.shuffle(order)
            yield from order

    readahead = ThreadPoolExecutor(max_workers=1)
    try:
        file_iter = epoch_files()
        futures = []
        for path in file_iter:
            futures.append(readahead.submit(get_file, path))
            if len(futures) >= 2:
                break
        while futures:
            blob, offs, lens = futures.pop(0).result()
            nxt = next(file_iter, None)
            if nxt is not None:
                futures.append(readahead.submit(get_file, nxt))
            bi = next_bi
            next_bi += 1
            blob_reg[bi] = (blob, offs, lens)
            k = len(offs)
            pend_bi = np.concatenate([pend_bi, np.full(k, bi, np.int64)])
            pend_ri = np.concatenate([pend_ri, np.arange(k, dtype=np.int64)])
            if shuffle and k:
                # permute the tail window so records mix across the last
                # two files (a record-level shuffle buffer)
                w = min(len(pend_bi), 2 * k)
                perm = np.random.default_rng(
                    rng.getrandbits(63)).permutation(w)
                pend_bi[-w:] = pend_bi[-w:][perm]
                pend_ri[-w:] = pend_ri[-w:][perm]
            yield from emit(final=False)
        yield from emit(final=True)
    finally:
        if pool is not None:
            pool.shutdown(wait=False, cancel_futures=True)
        readahead.shutdown(wait=False, cancel_futures=True)
