"""TFRecord container framing, pure Python (the port's own copy of
``cikm2020_dmt_tpu/data/tfrecord.py``; no TensorFlow):

    each record:  uint64 length (LE) | uint32 masked-crc32c(length)
                  | payload bytes    | uint32 masked-crc32c(payload)

CRC verification is off by default on read (the hot path); the writer always
emits valid CRCs so fixtures round-trip through any TFRecord reader.
"""

from __future__ import annotations

import struct
from typing import Iterable, Iterator

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli), table-driven; TFRecord "masks" the CRC.
# ---------------------------------------------------------------------------

_CRC_TABLE = []


def _build_table() -> None:
    poly = 0x82F63B78
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ (poly if crc & 1 else 0)
        _CRC_TABLE.append(crc)


_build_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    table = _CRC_TABLE
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Reader / writer
# ---------------------------------------------------------------------------


def read_records(path: str, verify_crc: bool = False) -> Iterator[bytes]:
    """Yield raw record payloads from one TFRecord file."""
    with open(path, "rb") as f:
        unpack_u64 = struct.Struct("<Q").unpack
        unpack_u32 = struct.Struct("<I").unpack
        while True:
            header = f.read(12)
            if len(header) < 12:
                return
            (length,) = unpack_u64(header[:8])
            if verify_crc:
                (expect,) = unpack_u32(header[8:12])
                if masked_crc32c(header[:8]) != expect:
                    raise IOError(f"corrupt length CRC in {path}")
            payload = f.read(length)
            if len(payload) < length:
                raise IOError(f"truncated record in {path}")
            footer = f.read(4)
            if verify_crc:
                (expect,) = unpack_u32(footer)
                if masked_crc32c(payload) != expect:
                    raise IOError(f"corrupt payload CRC in {path}")
            yield payload


def write_records(path: str, records: Iterable[bytes]) -> int:
    """Write records as a valid TFRecord file; returns record count."""
    n = 0
    pack_u64 = struct.Struct("<Q").pack
    pack_u32 = struct.Struct("<I").pack
    with open(path, "wb") as f:
        for payload in records:
            header = pack_u64(len(payload))
            f.write(header)
            f.write(pack_u32(masked_crc32c(header)))
            f.write(payload)
            f.write(pack_u32(masked_crc32c(payload)))
            n += 1
    return n
