"""nshead — Baidu's classic 36-byte-header framing.

Port of brpc_tpu/rpc/nshead_protocol.py, byte-compatible with it: the
header ``{u16 id, u16 version, u32 log_id, char provider[16], u32 magic
0xfb709394, u32 reserved, u32 body_len}`` (little-endian), then the
body. The magic sits at offset 24, so a first read shorter than 28
bytes is claimed while nothing else claims it, and given up once the
magic shows otherwise.

nshead has no correlation id: the responses of a connection answer its
calls first in, first out. Each call queues its attempt id under the
socket's write lock (``on_packed``), so many threads may pipeline calls
on one connection; the reference queues it as the request is packed,
outside that lock, where two threads can queue in one order and write
in the other (ROADMAP queue C #26). Frames are processed in the reading
task, in order (``process_inline``).

A server answers with its ``ServerOptions.nshead_service``, an
``NsheadService`` whose ``process_nshead_request(cntl, request, done)``
gets the request's ``NsheadMessage`` (the default echoes the body); the
response carries the request's ``log_id``. ``NsheadPbServiceAdaptor``
puts a message front end on the bodies by mcpack (brpc_tpu_torch/
mcpack2pb.py): made with (request class, response class, handler) as in
the reference, or with ``for_method("Service.Method")``, which runs a
method of the server through rpc/pb_dispatch.py, so the call is counted
on ``/status`` as the method's other calls are. On a connection of a
server without a service, a frame is taken as a response.
"""
from __future__ import annotations

import struct
from collections import deque
from typing import Callable, Optional

from brpc_tpu_torch.butil.iobuf import IOBuf
from brpc_tpu_torch.rpc.controller import Controller, lock_attempt
from brpc_tpu_torch.rpc.protocol import (
    InputMessageBase,
    ParseResult,
    Protocol,
    ProtocolType,
    register_protocol,
)

NSHEAD_MAGICNUM = 0xFB709394
_HEAD = struct.Struct("<HHI16sIII")  # 36 bytes
HEAD_SIZE = _HEAD.size
MAX_BODY = 64 << 20


class NsheadMessage:
    """The head's fields and the body."""

    def __init__(self, body: bytes = b"", id_: int = 0, version: int = 0,
                 log_id: int = 0, provider: bytes = b"brpc_tpu",
                 reserved: int = 0):
        self.id = id_
        self.version = version
        self.log_id = log_id
        self.provider = provider[:16]
        self.reserved = reserved
        self.body = body

    def head(self) -> bytes:
        return _HEAD.pack(self.id, self.version, self.log_id,
                          self.provider.ljust(16, b"\x00"), NSHEAD_MAGICNUM,
                          self.reserved, len(self.body))

    def serialize(self) -> bytes:
        return self.head() + self.body


class NsheadInputMessage(InputMessageBase):
    __slots__ = ("msg", "is_request")

    def __init__(self, msg: NsheadMessage):
        super().__init__()
        self.msg = msg
        self.is_request = True  # the connection's side decides


def parse(portal: IOBuf, sock, read_eof: bool, arg) -> ParseResult:
    if len(portal) < HEAD_SIZE:
        head = bytes(portal.copy_to_bytes(min(28, len(portal))))
        if len(head) < 28:
            return ParseResult.not_enough()  # the magic is not in yet
        (magic,) = struct.unpack_from("<I", head, 24)
        return (ParseResult.not_enough() if magic == NSHEAD_MAGICNUM
                else ParseResult.try_others())
    raw = bytes(portal.copy_to_bytes(HEAD_SIZE))
    id_, version, log_id, provider, magic, res, body_len = _HEAD.unpack(raw)
    if magic != NSHEAD_MAGICNUM:
        return ParseResult.try_others()
    if body_len > MAX_BODY:
        return ParseResult.error_()
    if len(portal) < HEAD_SIZE + body_len:
        return ParseResult.not_enough()
    portal.pop_front(HEAD_SIZE)
    body = bytes(portal.cutn_bytes(body_len))
    return ParseResult.ok(NsheadInputMessage(NsheadMessage(
        body, id_, version, log_id, provider.rstrip(b"\x00"), reserved=res)))


def serialize_request(request, cntl: Controller) -> bytes:
    if isinstance(request, NsheadMessage):
        return request.body
    if isinstance(request, (bytes, bytearray)):
        return bytes(request)
    raise TypeError("nshead channel takes an NsheadMessage or bytes")


def pack_request(payload: bytes, cntl: Controller, correlation_id: int) -> IOBuf:
    msg = NsheadMessage(payload, log_id=cntl.log_id & 0xFFFFFFFF)
    out = IOBuf(msg.head())
    if payload:
        out.append(payload)
    return out


def on_packed(sock, cntl: Controller, correlation_id: int):
    q = getattr(sock, "_nshead_pipeline", None)
    if q is None:
        q = sock._nshead_pipeline = deque()
    q.append(correlation_id)


def next_attempt(sock):
    """(attempt id, its controller locked) of the oldest call waiting on
    ``sock``; the controller is None when no call waits or it has ended
    (a reply that came too late). The protocols riding nshead
    (rpc/legacy_nshead_family.py) share it."""
    q = getattr(sock, "_nshead_pipeline", None)
    if not q:
        return 0, None
    cid = q.popleft()
    return cid, lock_attempt(cid)


def process_response(msg: NsheadInputMessage):
    sock = msg.socket
    cid, cntl = next_attempt(sock)
    if cntl is None:
        return
    resp = cntl._response
    if isinstance(resp, NsheadMessage):
        resp.body = msg.msg.body
        resp.id = msg.msg.id
        resp.log_id = msg.msg.log_id
    cntl._on_protocol_response(sock, cid)


def process_request(msg: NsheadInputMessage):
    server = msg.arg
    service = getattr(server, "nshead_service", None) if server else None
    sock = msg.socket
    if service is None:
        # no service: the frame answers a call of ours
        return process_response(msg)
    cntl = Controller()
    cntl.server = server
    cntl.remote_side = sock.remote_side
    cntl.log_id = msg.msg.log_id
    cntl._server_socket = sock
    responded = [False]

    def done(response: Optional[NsheadMessage] = None):
        if responded[0]:
            return
        responded[0] = True
        out = response or NsheadMessage()
        out.log_id = msg.msg.log_id
        packet = IOBuf(out.head())
        if out.body:
            packet.append(out.body)
        sock.write(packet)

    try:
        service.process_nshead_request(cntl, msg.msg, done)
    except Exception as e:
        if not responded[0]:
            done(NsheadMessage(f"error: {e}".encode()))


class NsheadService:
    """Base of nshead servers: override process_nshead_request(cntl,
    request_msg, done)."""

    def process_nshead_request(self, cntl, request: NsheadMessage,
                               done: Callable):
        done(NsheadMessage(request.body))  # the default echoes


class NsheadPbServiceAdaptor(NsheadService):
    """Bodies are messages in mcpack. ``handler(cntl, request,
    response)`` sees them decoded; an adaptor made by ``for_method``
    runs a method of the server instead."""

    def __init__(self, request_class, response_class, handler):
        self.request_class = request_class
        self.response_class = response_class
        self.handler = handler  # (cntl, request, response) -> None
        self.method = None  # (service, method) of for_method

    @classmethod
    def for_method(cls, full_name: str) -> "NsheadPbServiceAdaptor":
        """Each body calls ``full_name`` ("Service.Method") of the server
        the adaptor serves, as a pb-rpc call would (pb_dispatch): looked
        up, limited and counted on the method's status. A failed call
        answers with a body ``error <code>: <text>``."""
        adaptor = cls(None, None, None)
        service, _, method = full_name.rpartition(".")
        adaptor.method = (service, method)
        return adaptor

    def process_nshead_request(self, cntl, request: NsheadMessage, done):
        from brpc_tpu_torch.mcpack2pb import mcpack_to_pb, pb_to_mcpack

        if self.method is not None:
            return self._dispatch(cntl, request, done)
        try:
            req_pb = mcpack_to_pb(request.body, self.request_class)
        except (ValueError, IndexError, KeyError) as e:
            done(NsheadMessage(f"bad mcpack body: {e}".encode()))
            return
        resp_pb = self.response_class()
        self.handler(cntl, req_pb, resp_pb)
        done(NsheadMessage(pb_to_mcpack(resp_pb)))

    def _dispatch(self, cntl, request: NsheadMessage, done):
        from brpc_tpu_torch.mcpack2pb import mcpack_to_pb, pb_to_mcpack
        from brpc_tpu_torch.rpc.pb_dispatch import dispatch_pb_request

        service, method = self.method
        entry = cntl.server.find_method(service, method)
        payload = b""
        if entry is not None:
            try:
                payload = mcpack_to_pb(request.body,
                                       entry[1].request_class
                                       ).SerializeToString()
            except (ValueError, IndexError, KeyError) as e:
                done(NsheadMessage(f"bad mcpack body: {e}".encode()))
                return

        def send_response(c, response):
            if c.failed():
                done(NsheadMessage(
                    f"error {c.error_code_value}: {c.error_text_value}"
                    .encode()))
            else:
                done(NsheadMessage(pb_to_mcpack(response)))

        dispatch_pb_request(cntl.server, cntl._server_socket, service,
                            method, payload, 0, send_response, cntl)


register_protocol(Protocol(
    name="nshead",
    type=ProtocolType.NSHEAD,
    parse=parse,
    serialize_request=serialize_request,
    pack_request=pack_request,
    process_request=process_request,
    process_response=process_response,
    process_inline=True,
    on_packed=on_packed,
))
