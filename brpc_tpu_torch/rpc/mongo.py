"""mongo — the MongoDB wire protocol's types, for a server that speaks it.

Port of brpc_tpu/rpc/mongo.py, byte-compatible with it: the 16-byte
little-endian message head ``{i32 message_length, request_id,
response_to, op_code}``, the opcodes, a small BSON codec (double, string,
document, array, binary, bool, null, int32, int64: enough for
command-style documents, so an adaptor works with dicts) and
``MongoServiceAdaptor``, the server's hook (rpc/mongo_protocol.py).
"""
from __future__ import annotations

import struct
from typing import Callable, Dict, List, Optional

OP_REPLY = 1
OP_MSG_OLD = 1000
OP_UPDATE = 2001
OP_INSERT = 2002
OP_QUERY = 2004
OP_GET_MORE = 2005
OP_DELETE = 2006
OP_KILL_CURSORS = 2007
OP_COMMAND = 2010
OP_COMMANDREPLY = 2011
OP_MSG = 2013

_VALID_OPCODES = {OP_REPLY, OP_MSG_OLD, OP_UPDATE, OP_INSERT, OP_QUERY,
                  OP_GET_MORE, OP_DELETE, OP_KILL_CURSORS, OP_COMMAND,
                  OP_COMMANDREPLY, OP_MSG}

_HEAD = struct.Struct("<iiii")  # message_length, request_id, response_to, op_code
HEAD_SIZE = _HEAD.size


def is_mongo_opcode(op: int) -> bool:
    return op in _VALID_OPCODES


class MongoHead:
    __slots__ = ("message_length", "request_id", "response_to", "op_code")

    def __init__(self, message_length=0, request_id=0, response_to=0,
                 op_code=OP_QUERY):
        self.message_length = message_length
        self.request_id = request_id
        self.response_to = response_to
        self.op_code = op_code

    def pack(self) -> bytes:
        return _HEAD.pack(self.message_length, self.request_id,
                          self.response_to, self.op_code)

    @classmethod
    def unpack(cls, raw: bytes) -> "MongoHead":
        return cls(*_HEAD.unpack(raw[:HEAD_SIZE]))


# -- BSON ------------------------------------------------------------------

def bson_encode(doc: Dict) -> bytes:
    body = bytearray()
    for key, value in doc.items():
        body += _encode_element(str(key), value)
    return struct.pack("<i", len(body) + 5) + bytes(body) + b"\x00"


def _encode_element(key: str, value) -> bytes:
    k = key.encode() + b"\x00"
    if isinstance(value, bool):
        return b"\x08" + k + (b"\x01" if value else b"\x00")
    if isinstance(value, float):
        return b"\x01" + k + struct.pack("<d", value)
    if isinstance(value, str):
        vb = value.encode()
        return b"\x02" + k + struct.pack("<i", len(vb) + 1) + vb + b"\x00"
    if isinstance(value, dict):
        return b"\x03" + k + bson_encode(value)
    if isinstance(value, (list, tuple)):
        return b"\x04" + k + bson_encode(
            {str(i): v for i, v in enumerate(value)})
    if isinstance(value, (bytes, bytearray)):
        return (b"\x05" + k + struct.pack("<i", len(value)) + b"\x00"
                + bytes(value))
    if value is None:
        return b"\x0a" + k
    if isinstance(value, int):
        if -(1 << 31) <= value < (1 << 31):
            return b"\x10" + k + struct.pack("<i", value)
        return b"\x12" + k + struct.pack("<q", value)
    raise TypeError(f"bson: unsupported type {type(value)!r} for {key!r}")


def bson_decode(data: bytes, offset: int = 0):
    """Decode one document at data[offset:]; returns (dict, end_offset)."""
    (doc_len,) = struct.unpack_from("<i", data, offset)
    if doc_len < 5 or offset + doc_len > len(data):
        raise ValueError("bson: truncated document")
    end = offset + doc_len - 1  # position of trailing NUL
    pos = offset + 4
    out: Dict = {}
    while pos < end:
        etype = data[pos]
        pos += 1
        nul = data.index(b"\x00", pos)
        key = data[pos:nul].decode()
        pos = nul + 1
        if etype == 0x01:
            (out[key],) = struct.unpack_from("<d", data, pos)
            pos += 8
        elif etype == 0x02:
            (slen,) = struct.unpack_from("<i", data, pos)
            out[key] = data[pos + 4:pos + 4 + slen - 1].decode()
            pos += 4 + slen
        elif etype in (0x03, 0x04):
            sub, pos = bson_decode(data, pos)
            out[key] = ([sub[str(i)] for i in range(len(sub))]
                        if etype == 0x04 else sub)
        elif etype == 0x05:
            (blen,) = struct.unpack_from("<i", data, pos)
            out[key] = bytes(data[pos + 5:pos + 5 + blen])
            pos += 5 + blen
        elif etype == 0x08:
            out[key] = bool(data[pos])
            pos += 1
        elif etype == 0x0A:
            out[key] = None
        elif etype == 0x10:
            (out[key],) = struct.unpack_from("<i", data, pos)
            pos += 4
        elif etype == 0x12:
            (out[key],) = struct.unpack_from("<q", data, pos)
            pos += 8
        else:
            raise ValueError(f"bson: unsupported element type 0x{etype:02x}")
    return out, end + 1


# -- request and response -----------------------------------------------------

class MongoRequest:
    """Header + raw body; for OP_QUERY the flags/collection/skip/limit and
    query document are pre-parsed for the adaptor's convenience."""

    __slots__ = ("head", "body", "flags", "collection", "number_to_skip",
                 "number_to_return", "query")

    def __init__(self, head: MongoHead, body: bytes):
        self.head = head
        self.body = body
        self.flags = 0
        self.collection = ""
        self.number_to_skip = 0
        self.number_to_return = 0
        self.query: Optional[Dict] = None
        if head.op_code == OP_QUERY and len(body) >= 4:
            (self.flags,) = struct.unpack_from("<i", body, 0)
            nul = body.index(b"\x00", 4)
            self.collection = body[4:nul].decode()
            pos = nul + 1
            self.number_to_skip, self.number_to_return = struct.unpack_from(
                "<ii", body, pos)
            pos += 8
            if pos < len(body):
                self.query, _ = bson_decode(body, pos)


class MongoResponse:
    """The fields of an OP_REPLY."""

    __slots__ = ("response_flags", "cursor_id", "starting_from",
                 "number_returned", "documents")

    def __init__(self):
        self.response_flags = 0
        self.cursor_id = 0
        self.starting_from = 0
        self.number_returned = 0
        self.documents: List[Dict] = []

    def pack(self, request_id: int, response_to: int) -> bytes:
        docs = b"".join(bson_encode(d) for d in self.documents)
        n = self.number_returned or len(self.documents)
        body = struct.pack("<iqii", self.response_flags, self.cursor_id,
                           self.starting_from, n) + docs
        head = MongoHead(HEAD_SIZE + len(body), request_id, response_to,
                         OP_REPLY)
        return head.pack() + body


class MongoServiceAdaptor:
    """The server's hook: ``process_mongo_request`` answers each message
    (``done()`` sends the response), ``create_socket_context`` makes a
    connection's context at its first message (``cntl.mongo_session_data``),
    ``serialize_error`` the reply of a failed call."""

    def process_mongo_request(self, cntl, request: MongoRequest,
                              response: MongoResponse, done: Callable):
        raise NotImplementedError

    def create_socket_context(self):
        return None

    def serialize_error(self, response_to: int) -> bytes:
        resp = MongoResponse()
        resp.response_flags = 2  # QueryFailure
        resp.documents = [{"$err": "internal error", "code": 1, "ok": 0.0}]
        return resp.pack(0, response_to)
