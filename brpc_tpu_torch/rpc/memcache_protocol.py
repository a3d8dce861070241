"""The memcache binary protocol over a channel, and a server that speaks
it.

Port of brpc_tpu/rpc/memcache_protocol.py. A client call sends its
``MemcacheRequest``'s packets in one write, and the packets that come
back answer the connection's calls first in, first out: each call
queues (attempt id, number of packets) under the socket's write lock
(``on_packed``), so many threads may pipeline calls on one connection.
A read is cut at its last whole packet; a packet's header gives its
length, so a large value is not copied again at every read. A server
answers each packet in order, in the reading task itself
(``process_inline``): with ``ServerOptions.memcache_service``, or with
ITEM_NOT_STORED without one.
"""
from __future__ import annotations

import struct
from collections import deque

from brpc_tpu_torch.butil.iobuf import IOBuf
from brpc_tpu_torch.rpc.controller import Controller, lock_attempt
from brpc_tpu_torch.rpc.memcache import (
    MAGIC_REQUEST,
    MAGIC_RESPONSE,
    STATUS_ITEM_NOT_STORED,
    MemcacheRequest,
    MemcacheResponse,
    pack_op,
    parse_op,
)
from brpc_tpu_torch.rpc.protocol import (
    InputMessageBase,
    ParseResult,
    Protocol,
    ProtocolType,
    register_protocol,
)

HEADER_LEN = 24


class MemcacheMessage(InputMessageBase):
    __slots__ = ("ops", "is_request")

    def __init__(self, ops, is_request):
        super().__init__()
        self.ops = ops
        self.is_request = is_request


def parse(portal: IOBuf, sock, read_eof: bool, arg) -> ParseResult:
    if portal.empty():
        return ParseResult.not_enough()
    if portal.copy_to_bytes(1)[0] not in (MAGIC_REQUEST, MAGIC_RESPONSE):
        return ParseResult.try_others()
    n, end = len(portal), 0
    while n - end >= HEADER_LEN:
        (body_len,) = struct.unpack(">I", portal.copy_to_bytes(4, end + 8))
        if n - end < HEADER_LEN + body_len:
            break
        end += HEADER_LEN + body_len
    if end == 0:
        return ParseResult.not_enough()
    data = bytes(portal.cutn_bytes(end))
    ops, pos = [], 0
    while pos < end:
        op, pos = parse_op(data, pos)
        ops.append(op)
    return ParseResult.ok(MemcacheMessage(ops,
                                          ops[0]["magic"] == MAGIC_REQUEST))


def serialize_request(request, cntl: Controller) -> bytes:
    if isinstance(request, MemcacheRequest):
        cntl._memcache_op_count = request.op_count
        return request.serialize()
    if isinstance(request, (bytes, bytearray)):
        return bytes(request)
    raise TypeError("memcache channel takes a MemcacheRequest")


def pack_request(payload: bytes, cntl: Controller, correlation_id: int) -> IOBuf:
    return IOBuf(payload)


def on_packed(sock, cntl: Controller, correlation_id: int):
    q = getattr(sock, "_mc_pipeline", None)
    if q is None:
        q = sock._mc_pipeline = deque()
    q.append((correlation_id, getattr(cntl, "_memcache_op_count", 1)))


def process_response(msg: MemcacheMessage):
    sock = msg.socket
    q = getattr(sock, "_mc_pipeline", None)
    pending = getattr(sock, "_mc_pending", None)
    if pending is None:
        pending = sock._mc_pending = []
    pending.extend(msg.ops)
    while q:
        cid, want = q[0]
        if len(pending) < want:
            return
        ops, pending = pending[:want], pending[want:]
        sock._mc_pending = pending
        q.popleft()
        cntl = lock_attempt(cid)
        if cntl is None:
            continue  # its call ended; the packets were its own
        if isinstance(cntl._response, MemcacheResponse):
            for op in ops:
                cntl._response.add_result(op)
        cntl._on_protocol_response(sock, cid)


def process_request(msg: MemcacheMessage):
    server = msg.arg
    service = getattr(server, "memcache_service", None) if server else None
    out = IOBuf()
    for op in msg.ops:
        if service is None:
            out.append(pack_op(op["opcode"], magic=MAGIC_RESPONSE,
                               status=STATUS_ITEM_NOT_STORED,
                               opaque=op["opaque"]))
        else:
            out.append(service.handle(op))
    msg.socket.write(out)


register_protocol(Protocol(
    name="memcache",
    type=ProtocolType.MEMCACHE,
    parse=parse,
    serialize_request=serialize_request,
    pack_request=pack_request,
    process_request=process_request,
    process_response=process_response,
    process_inline=True,
    on_packed=on_packed,
))
