"""Protocol — the registry of wire formats a connection may speak.

Port of brpc_tpu/rpc/protocol.py: a protocol is a bundle of parse /
serialize_request / pack_request / process_request / process_response
functions registered under a ProtocolType. A server port tries every
server-side protocol on the first bytes of a connection, in a fixed
priority order, and keeps the one that matched; ``process_inline`` marks a protocol whose messages run
at once in the reading task, in wire order (the device handshake must be
done before the first request of its connection runs).

The port registers seventeen protocols: ``tpu_std``
(rpc/tpu_std_protocol.py), ``streaming`` (rpc/streaming_protocol.py),
``device_handshake`` (rpc/tensor_service.py), ``http``
(rpc/http_protocol.py), ``h2:grpc`` (rpc/h2_protocol.py),
``hulu_pbrpc``, ``sofa_pbrpc``, ``redis``, ``memcache``, ``thrift``,
``mongo``, ``nshead``, ``esp`` and ``rtmp`` (rpc/<name>_protocol.py),
and the client protocols ``nova_pbrpc``, ``public_pbrpc`` and ``ubrpc``
(rpc/legacy_nshead_family.py). HTTP comes after the three
framings: they claim a short first read that could still become their
magic ("T" of "TRPC") before HTTP sees it. h2 follows HTTP: its preface
``PRI * ...`` is no HTTP/1 request line, and a first read of "P" that
HTTP claims (it could begin ``POST``) goes to h2 once the next bytes
show it cannot; so does an "H" (``HEAD``) that turns into hulu's
"HU". The magic-led protocols come next, then thrift, whose magic is in
bytes 4-5, mongo (a length and a known opcode in bytes 12-15, on a
server with a mongo adaptor), nshead, whose magic sits at offset 24, so
it claims a short first read that nothing else claimed, and esp last:
it has no magic and is tried only on a server with an esp service.
RTMP comes after it, as in the reference: it claims a connection whose
first byte is 0x03, on a server with an rtmp service only, and holds the
whole conversation in its parse. A channel packs through any of them
but the stream frames, the handshake and RTMP. ``on_pinned`` is the
hook of a protocol whose client speaks first: it runs on a new
connection before the connection joins the event dispatcher (h2 sends
its preface there).
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from enum import IntEnum
from typing import Callable, Dict, List, Optional


class ProtocolType(IntEnum):
    UNKNOWN = 0
    TPU_STD = 1  # framed pb-meta protocol (baidu_std's role)
    STREAMING = 2  # stream frames (streaming_rpc's role)
    HTTP = 3  # HTTP/1.1: pb over HTTP and the builtin console
    H2 = 4  # HTTP/2 with the gRPC unary mapping
    REDIS = 5
    MEMCACHE = 6  # the binary protocol
    THRIFT = 7  # framed TBinary
    ESP = 8  # a 32-byte head, no magic
    TENSOR = 9  # the device handshake of the tensor lane
    NSHEAD = 10  # the 36-byte-header legacy framing
    HULU = 11  # hulu_pbrpc
    SOFA = 12  # sofa_pbrpc
    MONGO = 13  # the MongoDB wire protocol (a server's adaptor)
    NOVA = 14  # nova_pbrpc over nshead (client; servers by an adaptor)
    PUBLIC = 15  # public_pbrpc over nshead (likewise)
    UBRPC = 16  # ubrpc over nshead and mcpack (likewise)
    RTMP = 17  # RTMP media relay (a server's rtmp service)


class ParseResult:
    OK = 0
    NOT_ENOUGH_DATA = 1  # keep reading
    TRY_OTHERS = 2  # not this protocol
    ERROR = 3  # corrupt stream: close the connection

    __slots__ = ("status", "message")

    def __init__(self, status: int, message=None):
        self.status = status
        self.message = message

    @classmethod
    def ok(cls, message) -> "ParseResult":
        return cls(cls.OK, message)

    @classmethod
    def not_enough(cls) -> "ParseResult":
        return cls(cls.NOT_ENOUGH_DATA)

    @classmethod
    def try_others(cls) -> "ParseResult":
        return cls(cls.TRY_OTHERS)

    @classmethod
    def error_(cls) -> "ParseResult":
        return cls(cls.ERROR)


class InputMessageBase:
    """A cut message; the messenger fills ``socket``, ``protocol`` and
    ``arg`` (the server on the server side) before processing it."""

    __slots__ = ("socket", "protocol", "arg")

    def __init__(self):
        self.socket = None
        self.protocol = None
        self.arg = None


@dataclass
class Protocol:
    """The function bundle of one wire format."""

    name: str
    type: ProtocolType
    # parse(portal, socket, read_eof, arg) -> ParseResult
    parse: Callable = None
    # serialize_request(request, controller) -> payload bytes  [client]
    serialize_request: Callable = None
    # pack_request(payload, controller, correlation_id) -> IOBuf  [client]
    pack_request: Callable = None
    process_request: Callable = None  # server
    process_response: Callable = None  # client
    support_client: bool = True
    support_server: bool = True
    # True: processed in the reading task, before the rest of the read is
    # cut (must not block for long)
    process_inline: bool = False
    # on_packed(socket, controller, correlation_id) [client]: runs under
    # the socket's write lock as the request is queued
    on_packed: Callable = None
    # on_pinned(socket) [client]: runs as a connection is made, before it
    # joins the dispatcher, and again when it is revived
    on_pinned: Callable = None


_protocols: Dict[ProtocolType, Protocol] = {}
_lock = threading.Lock()
_init_lock = threading.RLock()
_globally_initialized = False


def register_protocol(protocol: Protocol):
    with _lock:
        if protocol.type in _protocols:
            raise ValueError(f"protocol {protocol.type} already registered")
        _protocols[protocol.type] = protocol


def find_protocol(ptype: ProtocolType) -> Optional[Protocol]:
    return _protocols.get(ptype)


def find_protocol_by_name(name: str) -> Optional[Protocol]:
    for p in _protocols.values():
        if p.name == name:
            return p
    return None


# the order a server port tries the protocols in, whatever the import order
_PARSE_PRIORITY = {
    ProtocolType.TPU_STD: 0,
    ProtocolType.STREAMING: 1,
    ProtocolType.TENSOR: 2,
    ProtocolType.HTTP: 3,
    ProtocolType.H2: 4,
    ProtocolType.HULU: 5,
    ProtocolType.SOFA: 6,
    ProtocolType.REDIS: 7,
    ProtocolType.MEMCACHE: 8,
    ProtocolType.THRIFT: 9,  # weak magic: 0x8001 after a length
    ProtocolType.MONGO: 10,  # weak magic: a length and an opcode
    ProtocolType.NSHEAD: 11,  # weak magic: 0xfb709394 at offset 24
    ProtocolType.ESP: 12,  # no magic: only when the server asks
    ProtocolType.RTMP: 13,  # first byte 0x03: last, only when the server asks
}


def list_server_protocols() -> List[Protocol]:
    """Protocols a server port tries, in fixed priority order."""
    ps = [p for p in _protocols.values() if p.support_server and p.parse]
    ps.sort(key=lambda p: _PARSE_PRIORITY.get(p.type, 99))
    return ps


def globally_initialize():
    """Register every protocol once. The done flag flips only after every
    registering import completed, so a concurrent caller never sees half
    a registry."""
    global _globally_initialized
    if _globally_initialized:
        return
    with _init_lock:
        if _globally_initialized:
            return
        from brpc_tpu_torch.rpc import esp_protocol  # noqa: F401
        from brpc_tpu_torch.rpc import h2_protocol  # noqa: F401
        from brpc_tpu_torch.rpc import http_protocol  # noqa: F401
        from brpc_tpu_torch.rpc import hulu_protocol  # noqa: F401
        from brpc_tpu_torch.rpc import legacy_nshead_family  # noqa: F401
        from brpc_tpu_torch.rpc import memcache_protocol  # noqa: F401
        from brpc_tpu_torch.rpc import mongo_protocol  # noqa: F401
        from brpc_tpu_torch.rpc import nshead_protocol  # noqa: F401
        from brpc_tpu_torch.rpc import redis_protocol  # noqa: F401
        from brpc_tpu_torch.rpc import rtmp_protocol  # noqa: F401
        from brpc_tpu_torch.rpc import sofa_protocol  # noqa: F401
        from brpc_tpu_torch.rpc import streaming_protocol  # noqa: F401
        from brpc_tpu_torch.rpc import tensor_service  # noqa: F401
        from brpc_tpu_torch.rpc import thrift_protocol  # noqa: F401
        from brpc_tpu_torch.rpc import tpu_std_protocol  # noqa: F401
        _globally_initialized = True
