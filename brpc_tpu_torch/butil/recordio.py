"""recordio — a file of length-prefixed records.

Copy of brpc_tpu/butil/recordio.py, byte for byte in its format, so each
package reads the other's files: a record is the magic ``"RIO1"``, then
``>III`` (meta length, payload length, crc32 of meta + payload), then the
meta as JSON and the payload. ``rpc_dump`` writes its requests this way
and the rpcz SpanDB its spans; a replay reads them back.
"""
from __future__ import annotations

import json
import struct
import zlib
from typing import Iterator, Optional, Tuple

MAGIC = b"RIO1"
_HEADER = struct.Struct(">4sIII")


class RecordWriter:
    """Appends records to ``path``."""

    def __init__(self, path: str):
        self._f = open(path, "ab")

    def write(self, meta: dict, payload: bytes) -> None:
        meta_bytes = json.dumps(meta).encode()
        crc = zlib.crc32(meta_bytes + payload) & 0xFFFFFFFF
        self._f.write(_HEADER.pack(MAGIC, len(meta_bytes), len(payload), crc))
        self._f.write(meta_bytes)
        self._f.write(payload)

    def flush(self):
        self._f.flush()

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class RecordReader:
    """Reads the records of ``path`` in order. A record cut short at the
    end of the file ends the read; a bad magic or checksum raises
    ValueError."""

    def __init__(self, path: str):
        self._f = open(path, "rb")

    def read(self) -> Optional[Tuple[dict, bytes]]:
        header = self._f.read(_HEADER.size)
        if len(header) < _HEADER.size:
            return None
        magic, meta_len, payload_len, crc = _HEADER.unpack(header)
        if magic != MAGIC:
            raise ValueError("corrupt recordio stream: bad magic")
        meta_bytes = self._f.read(meta_len)
        payload = self._f.read(payload_len)
        if len(meta_bytes) < meta_len or len(payload) < payload_len:
            return None  # a tail cut short
        if zlib.crc32(meta_bytes + payload) & 0xFFFFFFFF != crc:
            raise ValueError("corrupt recordio record: crc mismatch")
        return json.loads(meta_bytes), payload

    def __iter__(self) -> Iterator[Tuple[dict, bytes]]:
        while True:
            rec = self.read()
            if rec is None:
                return
            yield rec

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
