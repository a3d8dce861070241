"""The redis protocol: RESP command batches over a channel, and a server
that speaks redis.

Port of brpc_tpu/rpc/redis_protocol.py. A client call sends its
``RedisRequest``'s commands in one write; RESP carries no id, so the
replies of a connection answer its calls first in, first out: each call
queues (attempt id, number of commands) under the socket's write lock
(``on_packed``), and the replies as they are parsed go to the calls in
that order, so many threads may pipeline calls on one connection. A
reply that is an error fails its call with EREQUEST, the replies kept.

A server parses redis only with ``ServerOptions.redis_service`` set (a
port without one leaves the bytes to the protocols behind it), and
answers every command of a read in order, in the reading task itself
(``process_inline``).
"""
from __future__ import annotations

from collections import deque

from brpc_tpu_torch.butil.iobuf import IOBuf
from brpc_tpu_torch.rpc import errors
from brpc_tpu_torch.rpc.controller import Controller, lock_attempt
from brpc_tpu_torch.rpc.protocol import (
    InputMessageBase,
    ParseResult,
    Protocol,
    ProtocolType,
    register_protocol,
)
from brpc_tpu_torch.rpc.redis import (
    RedisReply,
    RedisRequest,
    RedisResponse,
    parse_reply,
)

_TYPE_BYTES = (b"*", b"+", b"-", b":", b"$")


class RedisMessage(InputMessageBase):
    __slots__ = ("replies", "commands", "is_request")

    def __init__(self, replies=None, commands=None):
        super().__init__()
        self.replies = replies
        self.commands = commands
        self.is_request = commands is not None


def parse(portal: IOBuf, sock, read_eof: bool, arg) -> ParseResult:
    if portal.empty():
        return ParseResult.not_enough()
    server_side = arg is not None and getattr(arg, "redis_service", None)
    if arg is not None and not server_side:
        return ParseResult.try_others()
    if bytes(portal.copy_to_bytes(1)) not in _TYPE_BYTES:
        return ParseResult.try_others()
    data = bytes(portal.copy_to_bytes())
    # every whole value of the read, as one message
    values = []
    pos = 0
    try:
        while pos < len(data):
            r = parse_reply(data, pos)
            if r is None:
                break
            value, pos = r
            values.append(value)
    except ValueError:
        return ParseResult.error_()
    if not values:
        return ParseResult.not_enough()
    portal.pop_front(pos)
    if server_side and any(v.kind == "array" for v in values):
        return ParseResult.ok(RedisMessage(commands=[
            [item.value for item in v.value]
            for v in values if v.kind == "array"]))
    return ParseResult.ok(RedisMessage(replies=values))


def serialize_request(request, cntl: Controller) -> bytes:
    if isinstance(request, RedisRequest):
        cntl._redis_command_count = request.command_count
        return request.serialize()
    if isinstance(request, (bytes, bytearray)):
        return bytes(request)
    raise TypeError("redis channel takes a RedisRequest")


def pack_request(payload: bytes, cntl: Controller, correlation_id: int) -> IOBuf:
    return IOBuf(payload)


def on_packed(sock, cntl: Controller, correlation_id: int):
    q = getattr(sock, "_redis_pipeline", None)
    if q is None:
        q = sock._redis_pipeline = deque()
    q.append((correlation_id, getattr(cntl, "_redis_command_count", 1)))


def process_response(msg: RedisMessage):
    sock = msg.socket
    q = getattr(sock, "_redis_pipeline", None)
    pending = getattr(sock, "_redis_pending", None)
    if pending is None:
        pending = sock._redis_pending = []
    pending.extend(msg.replies or [])
    while q:
        cid, want = q[0]
        if len(pending) < want:
            return
        replies, pending = pending[:want], pending[want:]
        sock._redis_pending = pending
        q.popleft()
        cntl = lock_attempt(cid)
        if cntl is None:
            continue  # its call ended; the replies were its own
        if isinstance(cntl._response, RedisResponse):
            for r in replies:
                cntl._response.add(r)
        first_err = next((r for r in replies if r.is_error()), None)
        if first_err is not None:
            cntl.set_failed(errors.EREQUEST, str(first_err.value))
        cntl._on_protocol_response(sock, cid)


def process_request(msg: RedisMessage):
    """Answer every command of the message, in order."""
    server = msg.arg
    service = getattr(server, "redis_service", None) if server else None
    out = IOBuf()
    for args in msg.commands or []:
        reply = (service.dispatch(args) if service is not None
                 else RedisReply.error("ERR no redis service"))
        out.append(reply.encode())
    msg.socket.write(out)


register_protocol(Protocol(
    name="redis",
    type=ProtocolType.REDIS,
    parse=parse,
    serialize_request=serialize_request,
    pack_request=pack_request,
    process_request=process_request,
    process_response=process_response,
    process_inline=True,
    on_packed=on_packed,
))
