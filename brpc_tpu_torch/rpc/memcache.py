"""The memcache binary protocol's messages and a server-side store.

Port of brpc_tpu/rpc/memcache.py, byte-compatible with it: ``pack_op``
and ``parse_op`` write and read one binary packet (a 24-byte header,
then extras, key and value); ``MemcacheRequest`` batches get, set, add,
replace, delete, incr, decr and version; ``MemcacheResponse`` pops
their typed results in order; ``MemcacheService`` answers the same
packets from a dict, standing in for memcached.
"""
from __future__ import annotations

import struct
import threading
from typing import Dict, List, Optional, Tuple

MAGIC_REQUEST = 0x80
MAGIC_RESPONSE = 0x81

OP_GET = 0x00
OP_SET = 0x01
OP_ADD = 0x02
OP_REPLACE = 0x03
OP_DELETE = 0x04
OP_INCREMENT = 0x05
OP_DECREMENT = 0x06
OP_VERSION = 0x0B

STATUS_OK = 0x0000
STATUS_KEY_NOT_FOUND = 0x0001
STATUS_KEY_EXISTS = 0x0002
STATUS_ITEM_NOT_STORED = 0x0005

_HEADER = struct.Struct(">BBHBBHIIQ")  # 24 bytes


def pack_op(opcode: int, key: bytes = b"", value: bytes = b"",
            extras: bytes = b"", opaque: int = 0, cas: int = 0,
            magic: int = MAGIC_REQUEST, status: int = 0) -> bytes:
    body_len = len(extras) + len(key) + len(value)
    return _HEADER.pack(magic, opcode, len(key), len(extras), 0, status,
                        body_len, opaque, cas) + extras + key + value


def parse_op(data: bytes, pos: int) -> Optional[Tuple[dict, int]]:
    """Parse one binary packet at data[pos:]; None if incomplete."""
    if len(data) - pos < _HEADER.size:
        return None
    (magic, opcode, key_len, extras_len, _dtype, status, body_len, opaque,
     cas) = _HEADER.unpack_from(data, pos)
    total = _HEADER.size + body_len
    if len(data) - pos < total:
        return None
    body = data[pos + _HEADER.size: pos + total]
    extras = body[:extras_len]
    key = body[extras_len: extras_len + key_len]
    value = body[extras_len + key_len:]
    return ({"magic": magic, "opcode": opcode, "status": status,
             "extras": extras, "key": key, "value": value,
             "opaque": opaque, "cas": cas}, pos + total)


class MemcacheRequest:
    """Batched ops (memcache.h MemcacheRequest::Get/Set/...)."""

    def __init__(self):
        self._ops: List[bytes] = []
        self._opcodes: List[int] = []

    def _push(self, opcode: int, packet: bytes):
        self._ops.append(packet)
        self._opcodes.append(opcode)

    def get(self, key) -> "MemcacheRequest":
        self._push(OP_GET, pack_op(OP_GET, _b(key)))
        return self

    def set(self, key, value, flags: int = 0, exptime: int = 0,
            cas: int = 0) -> "MemcacheRequest":
        extras = struct.pack(">II", flags, exptime)
        self._push(OP_SET, pack_op(OP_SET, _b(key), _b(value), extras,
                                   cas=cas))
        return self

    def add(self, key, value, flags: int = 0, exptime: int = 0):
        extras = struct.pack(">II", flags, exptime)
        self._push(OP_ADD, pack_op(OP_ADD, _b(key), _b(value), extras))
        return self

    def replace(self, key, value, flags: int = 0, exptime: int = 0):
        extras = struct.pack(">II", flags, exptime)
        self._push(OP_REPLACE, pack_op(OP_REPLACE, _b(key), _b(value), extras))
        return self

    def delete(self, key) -> "MemcacheRequest":
        self._push(OP_DELETE, pack_op(OP_DELETE, _b(key)))
        return self

    def incr(self, key, delta: int = 1, initial: int = 0,
             exptime: int = 0) -> "MemcacheRequest":
        extras = struct.pack(">QQI", delta, initial, exptime)
        self._push(OP_INCREMENT, pack_op(OP_INCREMENT, _b(key), b"", extras))
        return self

    def decr(self, key, delta: int = 1, initial: int = 0, exptime: int = 0):
        extras = struct.pack(">QQI", delta, initial, exptime)
        self._push(OP_DECREMENT, pack_op(OP_DECREMENT, _b(key), b"", extras))
        return self

    def version(self) -> "MemcacheRequest":
        self._push(OP_VERSION, pack_op(OP_VERSION))
        return self

    @property
    def op_count(self) -> int:
        return len(self._ops)

    def serialize(self) -> bytes:
        return b"".join(self._ops)


class MemcacheResponse:
    """Typed result popper (memcache.h MemcacheResponse::PopGet/...)."""

    def __init__(self):
        self._results: List[dict] = []
        self._pop_index = 0

    def add_result(self, result: dict):
        self._results.append(result)

    @property
    def result_count(self) -> int:
        return len(self._results)

    def _pop(self) -> Optional[dict]:
        if self._pop_index >= len(self._results):
            return None
        r = self._results[self._pop_index]
        self._pop_index += 1
        return r

    def pop_get(self) -> Tuple[bool, Optional[bytes]]:
        r = self._pop()
        if r is None or r["status"] != STATUS_OK:
            return False, None
        return True, r["value"]

    def pop_store(self) -> bool:  # set/add/replace/delete
        r = self._pop()
        return r is not None and r["status"] == STATUS_OK

    pop_set = pop_store
    pop_delete = pop_store

    def pop_counter(self) -> Tuple[bool, int]:  # incr/decr
        r = self._pop()
        if r is None or r["status"] != STATUS_OK or len(r["value"]) != 8:
            return False, 0
        return True, struct.unpack(">Q", r["value"])[0]

    def pop_version(self) -> Tuple[bool, str]:
        r = self._pop()
        if r is None or r["status"] != STATUS_OK:
            return False, ""
        return True, r["value"].decode()


def _b(v) -> bytes:
    return v if isinstance(v, bytes) else str(v).encode()


class MemcacheService:
    """Server-side binary-protocol KV (test double for memcached)."""

    VERSION = "brpc_tpu-memcache-0.1"

    def __init__(self):
        self._data: Dict[bytes, Tuple[bytes, int]] = {}  # key -> (value, flags)
        self._lock = threading.Lock()

    def handle(self, op: dict) -> bytes:
        opcode = op["opcode"]
        key, value, extras = op["key"], op["value"], op["extras"]
        opaque = op["opaque"]

        def resp(status=STATUS_OK, value=b"", extras=b""):
            return pack_op(opcode, b"", value, extras, opaque=opaque,
                           magic=MAGIC_RESPONSE, status=status)

        with self._lock:
            if opcode == OP_GET:
                entry = self._data.get(key)
                if entry is None:
                    return resp(STATUS_KEY_NOT_FOUND)
                v, flags = entry
                return resp(value=v, extras=struct.pack(">I", flags))
            if opcode in (OP_SET, OP_ADD, OP_REPLACE):
                flags = struct.unpack(">II", extras)[0] if len(extras) >= 8 else 0
                exists = key in self._data
                if opcode == OP_ADD and exists:
                    return resp(STATUS_KEY_EXISTS)
                if opcode == OP_REPLACE and not exists:
                    return resp(STATUS_ITEM_NOT_STORED)
                self._data[key] = (value, flags)
                return resp()
            if opcode == OP_DELETE:
                if self._data.pop(key, None) is None:
                    return resp(STATUS_KEY_NOT_FOUND)
                return resp()
            if opcode in (OP_INCREMENT, OP_DECREMENT):
                delta, initial, _exp = struct.unpack(">QQI", extras)
                entry = self._data.get(key)
                if entry is None:
                    n = initial
                else:
                    try:
                        n = int(entry[0])
                    except ValueError:
                        return resp(STATUS_ITEM_NOT_STORED)
                    n = n + delta if opcode == OP_INCREMENT else max(0, n - delta)
                self._data[key] = (str(n).encode(), 0)
                return resp(value=struct.pack(">Q", n))
            if opcode == OP_VERSION:
                return resp(value=self.VERSION.encode())
        return resp(STATUS_ITEM_NOT_STORED)
