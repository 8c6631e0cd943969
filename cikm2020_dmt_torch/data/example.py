"""``tf.train.Example`` protobuf codec, selective, no TensorFlow (the
port's own copy of ``cikm2020_dmt_tpu/data/example.py``).

The parser only materializes the requested feature names and skips every
other entry byte-wise: JD records carry ~108 features, of which a model
config uses ~30.

Wire schema (proto3):
    Example  { Features features = 1 }
    Features { map<string, Feature> feature = 1 }
    Feature  { BytesList bytes_list = 1 | FloatList float_list = 2
               | Int64List int64_list = 3 }
    BytesList{ repeated bytes value = 1 }
    FloatList{ repeated float value = 1 [packed] }
    Int64List{ repeated int64 value = 1 [packed] }
"""

from __future__ import annotations

import struct
from typing import Iterable, Mapping, Optional, Sequence, Union

FeatureValue = Union[list[bytes], list[float], list[int]]

_F32 = struct.Struct("<f")


def _read_varint(buf: bytes, i: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[i]
        i += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, i
        shift += 7


def _skip_field(buf: bytes, i: int, wire_type: int) -> int:
    if wire_type == 0:  # varint
        while buf[i] & 0x80:
            i += 1
        return i + 1
    if wire_type == 1:  # 64-bit
        return i + 8
    if wire_type == 2:  # length-delimited
        ln, i = _read_varint(buf, i)
        return i + ln
    if wire_type == 5:  # 32-bit
        return i + 4
    raise ValueError(f"unsupported wire type {wire_type}")


def _parse_feature(buf: bytes, start: int, end: int) -> FeatureValue:
    """Parse a Feature message body -> python list of values."""
    i = start
    out: FeatureValue = []
    while i < end:
        tag, i = _read_varint(buf, i)
        field, wt = tag >> 3, tag & 7
        if wt != 2:
            i = _skip_field(buf, i, wt)
            continue
        ln, i = _read_varint(buf, i)
        body_end = i + ln
        if field == 1:  # BytesList
            j = i
            while j < body_end:
                t2, j = _read_varint(buf, j)
                l2, j = _read_varint(buf, j)
                out.append(buf[j:j + l2])
                j += l2
        elif field == 2:  # FloatList
            j = i
            while j < body_end:
                t2, j = _read_varint(buf, j)
                if t2 & 7 == 2:  # packed
                    l2, j = _read_varint(buf, j)
                    out.extend(struct.unpack_from(f"<{l2 // 4}f", buf, j))
                    j += l2
                else:  # unpacked single float (wire type 5)
                    out.append(_F32.unpack_from(buf, j)[0])
                    j += 4
        elif field == 3:  # Int64List
            j = i
            while j < body_end:
                t2, j = _read_varint(buf, j)
                if t2 & 7 == 2:  # packed
                    l2, j = _read_varint(buf, j)
                    stop = j + l2
                    while j < stop:
                        v, j = _read_varint(buf, j)
                        if v >= 1 << 63:
                            v -= 1 << 64
                        out.append(v)
                else:
                    v, j = _read_varint(buf, j)
                    if v >= 1 << 63:
                        v -= 1 << 64
                    out.append(v)
        i = body_end
    return out


def parse_example(
    payload: bytes,
    wanted: Optional[frozenset[bytes]] = None,
) -> dict[str, FeatureValue]:
    """Decode an Example; if ``wanted`` is given, only those feature names
    (as bytes) are materialized — all other entries are skipped without
    value parsing."""
    out: dict[str, FeatureValue] = {}
    i = 0
    n = len(payload)
    while i < n:
        tag, i = _read_varint(payload, i)
        field, wt = tag >> 3, tag & 7
        if field != 1 or wt != 2:
            i = _skip_field(payload, i, wt)
            continue
        ln, i = _read_varint(payload, i)
        feats_end = i + ln
        # Features message: repeated map entries (field 1)
        j = i
        while j < feats_end:
            t2, j = _read_varint(payload, j)
            if t2 & 7 != 2:
                j = _skip_field(payload, j, t2 & 7)
                continue
            l2, j = _read_varint(payload, j)
            entry_end = j + l2
            # map entry: key (field 1, bytes), value (field 2, Feature)
            k = j
            key: bytes = b""
            val_start = val_end = -1
            while k < entry_end:
                t3, k = _read_varint(payload, k)
                f3, w3 = t3 >> 3, t3 & 7
                if w3 != 2:
                    k = _skip_field(payload, k, w3)
                    continue
                l3, k = _read_varint(payload, k)
                if f3 == 1:
                    key = payload[k:k + l3]
                elif f3 == 2:
                    val_start, val_end = k, k + l3
                k += l3
            if val_start >= 0 and (wanted is None or key in wanted):
                out[key.decode()] = _parse_feature(payload, val_start, val_end)
            j = entry_end
        i = feats_end
    return out


# ---------------------------------------------------------------------------
# Encoder (test fixtures / synthetic data)
# ---------------------------------------------------------------------------


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _ld(field: int, body: bytes) -> bytes:
    return _varint((field << 3) | 2) + _varint(len(body)) + body


def encode_example(features: Mapping[str, Union[Sequence[bytes], Sequence[str], Sequence[float], Sequence[int]]]) -> bytes:
    """Encode a feature dict into Example wire bytes.

    Value type is inferred: bytes/str -> BytesList, float -> FloatList,
    int -> Int64List, as the JD TFRecords are written.
    """
    entries = []
    for name, values in features.items():
        values = list(values)
        if values and isinstance(values[0], (bytes, str)):
            body = b"".join(
                _ld(1, v.encode() if isinstance(v, str) else v) for v in values)
            feat = _ld(1, body)
        elif values and isinstance(values[0], float):
            packed = struct.pack(f"<{len(values)}f", *values)
            feat = _ld(2, _ld(1, packed))
        else:
            packed = b"".join(_varint(v & ((1 << 64) - 1)) for v in values)
            feat = _ld(3, _ld(1, packed))
        entry = _ld(1, name.encode()) + _ld(2, feat)
        entries.append(_ld(1, entry))
    return _ld(1, b"".join(entries))
