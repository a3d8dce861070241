"""esp — a 32-byte little-endian head, then the body.

Port of brpc_tpu/rpc/esp_protocol.py, byte-compatible with it: the head
``{u64 from, u64 to, u32 msg, u64 msg_id, i32 body_len}`` (packed).

The client sends an ``EspMessage`` and gets one back. esp frames carry
no call id the reference uses: it parks one call on a pooled socket.
The port queues each call's attempt id under the socket's write lock, as
it does nshead's, so calls share a connection and replies answer them
first in, first out (ROADMAP queue C #30). A client connection is read
as esp only once an esp call went out on it.

The server side is the reference's own extension: a server with a
``ServerOptions.esp_service`` (an ``EspService``, whose default echoes
the body) answers each frame in the reading task, in order, with the
request's ``msg_id``. esp has no magic, so it is tried last, and only on
such a server.
"""
from __future__ import annotations

import struct
import time
from collections import deque
from typing import Callable

from brpc_tpu_torch.butil.iobuf import IOBuf
from brpc_tpu_torch.rpc.controller import Controller, lock_attempt
from brpc_tpu_torch.rpc.protocol import (
    InputMessageBase,
    ParseResult,
    Protocol,
    ProtocolType,
    register_protocol,
)

_HEAD = struct.Struct("<QQIQi")
HEAD_SIZE = _HEAD.size  # 32
MAX_BODY = 64 << 20


class EspMessage:
    """The head's fields and the body."""

    __slots__ = ("from_addr", "to_addr", "msg", "msg_id", "body")

    def __init__(self, body: bytes = b"", to_addr: int = 0, msg: int = 0,
                 msg_id: int = 0, from_addr: int = 0):
        self.from_addr = from_addr
        self.to_addr = to_addr
        self.msg = msg
        self.msg_id = msg_id
        self.body = body

    def serialize(self) -> bytes:
        return _HEAD.pack(self.from_addr, self.to_addr, self.msg,
                          self.msg_id, len(self.body)) + self.body


class EspInputMessage(InputMessageBase):
    __slots__ = ("msg", "is_request")

    def __init__(self, msg: EspMessage, is_request: bool):
        super().__init__()
        self.msg = msg
        self.is_request = is_request


def parse(portal: IOBuf, sock, read_eof: bool, arg) -> ParseResult:
    if arg is not None:
        if getattr(getattr(arg, "options", None), "esp_service",
                   None) is None:
            return ParseResult.try_others()
    elif getattr(sock, "_esp_pipeline", None) is None:
        return ParseResult.try_others()  # no esp call went out here
    if len(portal) < HEAD_SIZE:
        return ParseResult.not_enough()
    from_addr, to_addr, msg, msg_id, body_len = _HEAD.unpack(
        bytes(portal.copy_to_bytes(HEAD_SIZE)))
    if body_len < 0 or body_len > MAX_BODY:
        return ParseResult.error_()
    if len(portal) < HEAD_SIZE + body_len:
        return ParseResult.not_enough()
    portal.pop_front(HEAD_SIZE)
    body = bytes(portal.cutn_bytes(body_len))
    return ParseResult.ok(EspInputMessage(
        EspMessage(body, to_addr, msg, msg_id, from_addr),
        is_request=arg is not None))


def serialize_request(request, cntl: Controller):
    if isinstance(request, EspMessage):
        return request
    raise TypeError("esp channel takes an EspMessage request")


def pack_request(request: EspMessage, cntl: Controller,
                 correlation_id: int) -> IOBuf:
    return IOBuf(request.serialize())


def on_packed(sock, cntl: Controller, correlation_id: int):
    q = getattr(sock, "_esp_pipeline", None)
    if q is None:
        q = sock._esp_pipeline = deque()
    q.append(correlation_id)


def process_response(msg: EspInputMessage):
    sock = msg.socket
    q = getattr(sock, "_esp_pipeline", None)
    if not q:
        return
    cid = q.popleft()
    cntl = lock_attempt(cid)
    if cntl is None:
        return
    resp = cntl._response
    if isinstance(resp, EspMessage):
        src = msg.msg
        resp.from_addr = src.from_addr
        resp.to_addr = src.to_addr
        resp.msg = src.msg
        resp.msg_id = src.msg_id
        resp.body = src.body
    cntl._on_protocol_response(sock, cid)


class EspService:
    """A server's esp handler: override process_esp_request(cntl, request,
    done); the default echoes the body."""

    def process_esp_request(self, cntl, request: EspMessage, done: Callable):
        done(EspMessage(request.body, msg=request.msg,
                        msg_id=request.msg_id))


def process_request(msg: EspInputMessage):
    server = msg.arg
    sock = msg.socket
    service = server.options.esp_service
    cntl = Controller()
    cntl.server = server
    cntl.remote_side = sock.remote_side
    cntl.server_start_time = time.monotonic()
    responded = [False]

    def done(response: EspMessage = None):
        if responded[0]:
            return
        responded[0] = True
        out = response or EspMessage(msg=msg.msg.msg, msg_id=msg.msg.msg_id)
        out.msg_id = msg.msg.msg_id
        sock.write(IOBuf(out.serialize()))

    try:
        service.process_esp_request(cntl, msg.msg, done)
    except Exception as e:
        if not responded[0]:
            done(EspMessage(f"error: {e}".encode(), msg=msg.msg.msg))


register_protocol(Protocol(
    name="esp",
    type=ProtocolType.ESP,
    parse=parse,
    serialize_request=serialize_request,
    pack_request=pack_request,
    process_request=process_request,
    process_response=process_response,
    process_inline=True,
    on_packed=on_packed,
))
