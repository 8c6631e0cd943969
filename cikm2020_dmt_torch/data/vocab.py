"""String id -> embedding-row index (the port's own copy of
``cikm2020_dmt_tpu/data/vocab.py``): one vocab per embedding table, read
from the reference's ``ID_TABLES = {name: [...]}`` literal files, with
out-of-vocabulary buckets.  The mapping runs on the host while a batch is
assembled; ids never reach the card as strings.

- value in vocab           -> its position in the vocab list (0 = 'unknow')
- value OOV, buckets > 0   -> len(vocab) + fnv1a64(value) % buckets
- value OOV, buckets == 0  -> 0  (the reference's default_value)
- no vocab file at all     -> fnv1a64(value) % id_size  (pure hashing)

FNV-1a is deterministic across processes and hosts; its bucket assignment
differs from TensorFlow's Fingerprint64, its spread over the OOV range
does not.
"""

from __future__ import annotations

import ast
import os
import re
from functools import lru_cache
from typing import Iterable, Sequence

import numpy as np

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_MASK64 = (1 << 64) - 1


def fnv1a64(data: bytes) -> int:
    h = _FNV_OFFSET
    for b in data:
        h = ((h ^ b) * _FNV_PRIME) & _MASK64
    return h


_ID_TABLES_RE = re.compile(rb"ID_TABLES\s*=")


def load_id_table_file(path: str, table_name: str) -> list[str]:
    """Parse a reference-format ``ID_TABLES = {name: [...]}`` literal file
    without importing it as a module."""
    with open(path, "rb") as f:
        src = f.read()
    m = _ID_TABLES_RE.search(src)
    if not m:
        raise ValueError(f"no ID_TABLES literal in {path}")
    literal = src[m.end():].decode("utf-8", "replace").strip()
    tables = ast.literal_eval(literal)
    return [str(v) for v in tables[table_name]]


class Vocab:
    """Mapping for one embedding table."""

    def __init__(self, name: str, id_size: int, vocab: Sequence[str] | None):
        self.name = name
        self.id_size = int(id_size)
        if vocab is not None and len(vocab) > self.id_size:
            vocab = vocab[: self.id_size]
        self._map: dict[bytes, int] | None = None
        self.vocab_size = 0
        if vocab is not None:
            self._map = {
                (v.encode() if isinstance(v, str) else bytes(v)): i
                for i, v in enumerate(vocab)
            }
            self.vocab_size = len(self._map)
        self.num_oov = self.id_size - self.vocab_size

    def lookup_one(self, value: bytes) -> int:
        if self._map is None:
            return fnv1a64(value) % self.id_size
        idx = self._map.get(value)
        if idx is not None:
            return idx
        if self.num_oov > 0:
            return self.vocab_size + fnv1a64(value) % self.num_oov
        return 0

    def lookup(self, values: Iterable[bytes]) -> np.ndarray:
        return np.fromiter(
            (self.lookup_one(v) for v in values), dtype=np.int32)


class VocabSet:
    """All vocabs for a config; table -> Vocab, feature -> Vocab.

    Mirrors the reference's ``LookupTables`` two-level maps
    (data_feed/index_tables.py:13-35).
    """

    def __init__(self, specs, vocab_path: str = ""):
        self.by_table: dict[str, Vocab] = {}
        self.by_feature: dict[str, Vocab] = {}
        for spec in specs:
            if spec.table not in self.by_table:
                vocab = _load_vocab(vocab_path, spec.table)
                self.by_table[spec.table] = Vocab(spec.table, spec.id_size, vocab)
            self.by_feature.setdefault(spec.feature, self.by_table[spec.table])


@lru_cache(maxsize=64)
def _cached_table(path: str, name: str) -> tuple[str, ...]:
    return tuple(load_id_table_file(path, name))


def _load_vocab(vocab_path: str, table: str):
    if not vocab_path:
        return None
    path = os.path.join(vocab_path, table + ".py")
    if not os.path.exists(path):
        return None
    return _cached_table(path, table)
