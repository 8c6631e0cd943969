"""Host-side input pipeline: TFRecord shards -> fixed-shape batches -> the
card (the port's own copy of ``cikm2020_dmt_tpu/data/pipeline.py``, its
Python path).

- ``expand_files`` and ``shard_files`` pick each process's files;
- ``example_stream`` parses Examples selectively (``data/example.py``) in
  the reference's order of operations: repeat, then a buffered shuffle;
- ``BatchAssembler`` maps string ids through the vocabs (``data/vocab.py``)
  and pads every ragged feature to its fixed cap;
- ``batch_stream`` cuts the stream into batches, ``prefetch`` overlaps the
  host's parsing with the card's steps on a thread;
- ``device_batch`` moves a batch to the card.

Batch layout (numpy):
    features      f32[B, D]           pre-normalized dense features
    label         f32[B]
    mask          f32[B, C]           one-hot over the label classes
    valid         f32[B]              1 for real rows, 0 for padding
    em_position   i32[B], em_page i32[B]
    propensity / propensity_weight / propensity_weight_positive /
    propensity_weight_mul             f32[B]
    {feat}__ids   i32[B, L]  {feat}__wts f32[B, L]  {feat}__len i32[B]
plus host-only ``headers: list[bytes]``.
"""

from __future__ import annotations

import glob as globlib
import os
import queue as queuelib
import random
import threading
from dataclasses import dataclass, field
from typing import Iterable, Iterator, Optional

import numpy as np
import torch

from ..core.config import DMTConfig
from .example import parse_example
from .propensity import MAX_PAGE, MAX_POSITION, PropensityModel
from .schema import FeatureSchema
from .tfrecord import read_records
from .vocab import VocabSet

IDS = "__ids"
WTS = "__wts"
LEN = "__len"


@dataclass
class Batch:
    arrays: dict[str, np.ndarray]
    headers: list[bytes] = field(default_factory=list)

    @property
    def size(self) -> int:
        return int(self.arrays["label"].shape[0])

    def __getitem__(self, k: str) -> np.ndarray:
        return self.arrays[k]


def expand_files(path_spec: str) -> list[str]:
    """Each comma-separated entry is a directory prefix globbed with a
    trailing ``*``; plain globs and single files also work; ``_SUCCESS``
    markers and directories are left out.

    ``hdfs://`` and ``viewfs://`` URIs raise: the data must be staged to a
    local or NFS path first, and a silent glob miss would only surface
    later as "no input files"."""
    files: list[str] = []
    for entry in path_spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        if entry.startswith(("hdfs://", "viewfs://")):
            raise ValueError(
                f"HDFS path {entry!r} is not supported: this build reads "
                "local/NFS paths only (the reference's hdfsToLocal staging "
                "is environment-specific). Stage the data locally, e.g. "
                "`hdfs dfs -get`, and point the config at the local copy.")
        if entry.endswith("/") or not any(c in entry for c in "*?["):
            entry = entry.rstrip("/") + "/*"
        matches = [
            f for f in globlib.glob(entry)
            if os.path.isfile(f) and not f.endswith("_SUCCESS")
        ]
        files.extend(sorted(matches))
    return files


def shard_files(files: list[str], num_shards: int, shard_index: int) -> list[str]:
    return files[shard_index::num_shards] if num_shards > 1 else files


# ---------------------------------------------------------------------------
# Assembly
# ---------------------------------------------------------------------------


class BatchAssembler:
    def __init__(self, cfg: DMTConfig, schema: FeatureSchema,
                 vocabs: VocabSet, propensity: Optional[PropensityModel] = None):
        self.cfg = cfg
        self.schema = schema
        self.vocabs = vocabs
        self.propensity = propensity or PropensityModel(cfg.propensity_em_type)
        self.pos_field = schema.header_index.get("pos", 4)
        self.page_field = schema.header_index.get("page", 11)
        # timestamp sequences carry raw time deltas that the model
        # log2-bucketizes on the card (nn/embedding.py); they bypass the
        # vocabs
        self.ts_features = set(cfg.attention_ts)

    def assemble(self, examples: list[dict], target_size: int | None = None) -> Batch:
        n = len(examples)
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
        for f in s.id_features:
            a[f.name + IDS] = np.zeros((b, f.max_len), np.int32)
            a[f.name + WTS] = np.zeros((b, f.max_len), np.float32)
            a[f.name + LEN] = np.zeros((b,), np.int32)

        headers: list[bytes] = []
        a["valid"][:n] = 1.0
        for i, ex in enumerate(examples):
            dense = ex.get("features")
            if dense is not None:
                a["features"][i, : s.dense_dim] = dense[: s.dense_dim]
            lab = ex.get("label")
            if lab:
                a["label"][i] = lab[0]
            mask = ex.get("mask")
            if mask is not None:
                a["mask"][i, : s.num_classes] = mask[: s.num_classes]
            hdr = ex.get("header")
            hdr_bytes = hdr[0] if hdr else b""
            headers.append(hdr_bytes)
            fields = hdr_bytes.split(b"\t")
            if len(fields) > self.pos_field:
                a["em_position"][i] = min(_to_int(fields[self.pos_field]), MAX_POSITION)
            if len(fields) > self.page_field:
                a["em_page"][i] = min(_to_int(fields[self.page_field]), MAX_PAGE)

            for f in s.id_features:
                vals = ex.get(f.name)
                if not vals:
                    continue
                k = min(len(vals), f.max_len)
                ids_row = a[f.name + IDS][i]
                if f.name in self.ts_features:
                    for j in range(k):
                        ids_row[j] = min(_to_int(vals[j]), 2**31 - 1)
                else:
                    vocab = self.vocabs.by_feature[f.name]
                    for j in range(k):
                        ids_row[j] = vocab.lookup_one(vals[j])
                wts = ex.get(f.name + "Wts")
                if wts:
                    a[f.name + WTS][i, :k] = wts[:k]
                else:
                    a[f.name + WTS][i, :k] = 1.0
                a[f.name + LEN][i] = k

        p, w, w_pos, w_mul = self.propensity.weights(
            a["em_position"], a["em_page"], a["label"])
        a["propensity"] = p
        a["propensity_weight"] = w
        a["propensity_weight_positive"] = w_pos
        a["propensity_weight_mul"] = w_mul
        # pad headers to batch size for alignment
        headers.extend(b"" for _ in range(b - n))
        return Batch(a, headers)


def _to_int(v: bytes) -> int:
    try:
        return int(float(v))
    except ValueError:
        return 0


# ---------------------------------------------------------------------------
# Streams
# ---------------------------------------------------------------------------


def example_stream(
    files: list[str],
    schema: FeatureSchema,
    epochs: int = 1,
    shuffle: bool = False,
    shuffle_buffer: int = 0,
    seed: int = 131,
) -> Iterator[dict]:
    """Parsed examples across files; repeat, then a buffered shuffle, as
    the reference orders them."""
    wanted = schema.wanted_feature_names()
    rng = random.Random(seed)
    epoch_iter = range(epochs) if epochs >= 0 else iter(int, 1)

    def records() -> Iterator[bytes]:
        for _ in epoch_iter:
            order = list(files)
            if shuffle:
                rng.shuffle(order)
            for path in order:
                yield from read_records(path)

    if shuffle and shuffle_buffer > 1:
        buf: list[bytes] = []
        for rec in records():
            buf.append(rec)
            if len(buf) >= shuffle_buffer:
                j = rng.randrange(len(buf))
                buf[j], buf[-1] = buf[-1], buf[j]
                yield parse_example(buf.pop(), wanted)
        rng.shuffle(buf)
        for rec in buf:
            yield parse_example(rec, wanted)
    else:
        for rec in records():
            yield parse_example(rec, wanted)


def batch_stream(
    cfg: DMTConfig,
    path_spec: str,
    batch_size: int,
    epochs: int = 1,
    shuffle: bool = False,
    drop_remainder: bool = True,
    pad_remainder: bool = True,
    num_shards: int = 1,
    shard_index: int = 0,
    schema: Optional[FeatureSchema] = None,
    assembler: Optional[BatchAssembler] = None,
    seed: Optional[int] = None,
) -> Iterator[Batch]:
    schema = schema or FeatureSchema.from_config(cfg)
    if assembler is None:
        vocabs = VocabSet(cfg.embeddings + cfg.embeddings_bias, cfg.vocab_path)
        assembler = BatchAssembler(cfg, schema, vocabs)
    files = shard_files(expand_files(path_spec), num_shards, shard_index)
    if not files:
        raise FileNotFoundError(f"no input files match {path_spec!r}")
    stream = example_stream(
        files, schema, epochs=epochs, shuffle=shuffle,
        shuffle_buffer=cfg.shuffle_size if shuffle else 0,
        seed=cfg.seed if seed is None else seed)
    buf: list[dict] = []
    for ex in stream:
        buf.append(ex)
        if len(buf) == batch_size:
            yield assembler.assemble(buf)
            buf = []
    if buf and not drop_remainder:
        yield assembler.assemble(buf, batch_size if pad_remainder else None)


def prefetch(it: Iterable, size: int = 2) -> Iterator:
    """The items of ``it`` in order, produced ``size`` ahead on a thread
    (the host-side counterpart of ``dataset.prefetch``).  An exception of
    ``it`` is raised here; closing this generator early stops the thread
    after the item it is producing."""
    q: queuelib.Queue = queuelib.Queue(maxsize=size)
    done = object()
    err: list[BaseException] = []
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queuelib.Full:
                pass
        return False

    def worker() -> None:
        try:
            for item in it:
                if not put(item):
                    return
        except BaseException as e:  # raised in the consumer
            err.append(e)
        finally:
            put(done)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is done:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()
        t.join()


# ---------------------------------------------------------------------------
# To the card
# ---------------------------------------------------------------------------


def device_batch(batch: Batch, device) -> dict:
    """The batch's arrays (numpy arrays, or tensors on any device) as
    tensors on ``device``, keyed and typed as ``Trainer.train_step`` and
    ``run_eval`` take them (float32 and int32, as
    ``chip_smoke.synthetic_batch`` makes them); the headers stay on the
    host.  The counterpart of the ``device_put`` in the JAX
    ``Trainer.device_prefetch``.  To a CUDA device each array goes from
    pinned host memory by a ``non_blocking`` copy on the current stream,
    so the copies overlap the host's work until a step reads them."""
    device = torch.device(device)
    out = {}
    for k, v in batch.arrays.items():
        t = (v if isinstance(v, torch.Tensor)
             else torch.from_numpy(np.ascontiguousarray(v)))
        if device.type == "cuda" and t.device.type == "cpu":
            t = t.pin_memory().to(device, non_blocking=True)
        else:
            t = t.to(device)
        out[k] = t
    return out
