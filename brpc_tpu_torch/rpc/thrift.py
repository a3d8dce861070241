"""Thrift's framed TBinary codec and a server-side method table.

Port of brpc_tpu/rpc/thrift.py, byte-compatible with it: a struct is a
dict ``{field_id: (ttype, value)}`` written in field-id order (bool,
byte, double, i16, i32, i64, string, struct and list); a message is a
4-byte frame length, the strict version word with the message type, the
method name, the seqid and the struct. ``ThriftService`` runs a handler
per method name, ``ThriftMessage`` carries a call's name and struct on
the client. ``pack_message_struct`` frames a struct already written
(the channel writes it once, then frames it per attempt).
"""
from __future__ import annotations

import struct
import threading
from typing import Callable, Dict, Tuple

VERSION_1 = 0x80010000

MSG_CALL = 1
MSG_REPLY = 2
MSG_EXCEPTION = 3
MSG_ONEWAY = 4

T_STOP = 0
T_BOOL = 2
T_BYTE = 3
T_DOUBLE = 4
T_I16 = 6
T_I32 = 8
T_I64 = 10
T_STRING = 11
T_STRUCT = 12
T_LIST = 15

# struct value := {field_id: (ttype, python_value)}
ThriftStruct = Dict[int, Tuple[int, object]]


class _Writer:
    def __init__(self):
        self._parts = []

    def write(self, b: bytes):
        self._parts.append(b)

    def i8(self, v):
        self.write(struct.pack(">b", v))

    def i16(self, v):
        self.write(struct.pack(">h", v))

    def i32(self, v):
        self.write(struct.pack(">i", v))

    def u32(self, v):
        self.write(struct.pack(">I", v & 0xFFFFFFFF))

    def i64(self, v):
        self.write(struct.pack(">q", v))

    def double(self, v):
        self.write(struct.pack(">d", v))

    def string(self, v):
        raw = v.encode() if isinstance(v, str) else bytes(v)
        self.i32(len(raw))
        self.write(raw)

    def bytes(self) -> bytes:
        return b"".join(self._parts)


class _Reader:
    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos

    def take(self, n) -> bytes:
        out = self.data[self.pos:self.pos + n]
        if len(out) < n:
            raise EOFError("truncated thrift payload")
        self.pos += n
        return out

    def i8(self):
        return struct.unpack(">b", self.take(1))[0]

    def i16(self):
        return struct.unpack(">h", self.take(2))[0]

    def i32(self):
        return struct.unpack(">i", self.take(4))[0]

    def u32(self):
        return struct.unpack(">I", self.take(4))[0]

    def i64(self):
        return struct.unpack(">q", self.take(8))[0]

    def double(self):
        return struct.unpack(">d", self.take(8))[0]

    def string(self) -> bytes:
        return self.take(self.i32())


def _write_value(w: _Writer, ttype: int, value):
    if ttype == T_BOOL:
        w.i8(1 if value else 0)
    elif ttype == T_BYTE:
        w.i8(value)
    elif ttype == T_DOUBLE:
        w.double(value)
    elif ttype == T_I16:
        w.i16(value)
    elif ttype == T_I32:
        w.i32(value)
    elif ttype == T_I64:
        w.i64(value)
    elif ttype == T_STRING:
        w.string(value)
    elif ttype == T_STRUCT:
        write_struct(w, value)
    elif ttype == T_LIST:
        etype, items = value
        w.i8(etype)
        w.i32(len(items))
        for item in items:
            _write_value(w, etype, item)
    else:
        raise ValueError(f"unsupported thrift type {ttype}")


def _read_value(r: _Reader, ttype: int):
    if ttype == T_BOOL:
        return bool(r.i8())
    if ttype == T_BYTE:
        return r.i8()
    if ttype == T_DOUBLE:
        return r.double()
    if ttype == T_I16:
        return r.i16()
    if ttype == T_I32:
        return r.i32()
    if ttype == T_I64:
        return r.i64()
    if ttype == T_STRING:
        return r.string()
    if ttype == T_STRUCT:
        return read_struct(r)
    if ttype == T_LIST:
        etype = r.i8()
        n = r.i32()
        return (etype, [_read_value(r, etype) for _ in range(n)])
    raise ValueError(f"unsupported thrift type {ttype}")


def write_struct(w: _Writer, s: ThriftStruct):
    for fid in sorted(s):
        ttype, value = s[fid]
        w.i8(ttype)
        w.i16(fid)
        _write_value(w, ttype, value)
    w.i8(T_STOP)


def read_struct(r: _Reader) -> ThriftStruct:
    out: ThriftStruct = {}
    while True:
        ttype = r.i8()
        if ttype == T_STOP:
            return out
        fid = r.i16()
        out[fid] = (ttype, _read_value(r, ttype))


def struct_bytes(body: ThriftStruct) -> bytes:
    w = _Writer()
    write_struct(w, body)
    return w.bytes()


def pack_message_struct(name: str, msg_type: int, seqid: int,
                        body: bytes) -> bytes:
    """A framed message around ``body``, a struct's bytes."""
    w = _Writer()
    w.u32(VERSION_1 | msg_type)
    w.string(name)
    w.i32(seqid)
    head = w.bytes()
    return struct.pack(">I", len(head) + len(body)) + head + body


def pack_message(name: str, msg_type: int, seqid: int,
                 body: ThriftStruct) -> bytes:
    return pack_message_struct(name, msg_type, seqid, struct_bytes(body))


def unpack_message(payload: bytes):
    """-> (name, msg_type, seqid, struct)."""
    r = _Reader(payload)
    version = r.u32()
    if version & 0xFFFF0000 != VERSION_1 & 0xFFFF0000:  # unframed/old: reject
        raise ValueError("bad thrift version")
    msg_type = version & 0xFF
    name = r.string().decode()
    seqid = r.i32()
    body = read_struct(r)
    return name, msg_type, seqid, body


class ThriftService:
    """Server side: register python handlers per thrift method
    (ThriftService::ProcessThriftFramedRequest role)."""

    def __init__(self):
        self._methods: Dict[str, Callable[[ThriftStruct], ThriftStruct]] = {}
        self._lock = threading.Lock()

    def add_method(self, name: str, handler):
        with self._lock:
            self._methods[name] = handler

    def dispatch(self, name: str, body: ThriftStruct):
        handler = self._methods.get(name)
        if handler is None:
            raise KeyError(f"unknown thrift method {name!r}")
        return handler(body)


class ThriftMessage:
    """Client request/response carrier (thrift_message.h role)."""

    def __init__(self, method_name: str = "", body: ThriftStruct = None):
        self.method_name = method_name
        self.body: ThriftStruct = body or {}
