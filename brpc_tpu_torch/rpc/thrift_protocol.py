"""Framed thrift over a channel, and a server that speaks it.

Port of brpc_tpu/rpc/thrift_protocol.py, byte-compatible with it. A
call's ``ThriftMessage`` is written as its struct once
(``serialize_request``) and framed per attempt with the attempt id's low
31 bits as the seqid; the connection maps seqid to attempt, so replies
may come in any order. A reply of type EXCEPTION fails the call with
EREQUEST "thrift exception: <text>". A server runs the method of its
``ServerOptions.thrift_service``; an unknown method, a handler that
raises, or a port without a service answers with an EXCEPTION naming
it. The magic is weak (a 4-byte length, then 0x8001), so a first read
of four bytes or less is claimed until byte 5 shows otherwise. The
reference decides on byte 5 only once byte 6 is in, and gives up a
thrift frame whose first read ends at byte 5 (ROADMAP queue C #27).
"""
from __future__ import annotations

import struct

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
from brpc_tpu_torch.rpc.thrift import (
    MSG_CALL,
    MSG_EXCEPTION,
    MSG_ONEWAY,
    MSG_REPLY,
    T_STRING,
    ThriftMessage,
    pack_message,
    pack_message_struct,
    struct_bytes,
    unpack_message,
)

MAX_FRAME = 64 << 20


class ThriftInputMessage(InputMessageBase):
    __slots__ = ("name", "msg_type", "seqid", "body", "is_request")

    def __init__(self, name, msg_type, seqid, body):
        super().__init__()
        self.name = name
        self.msg_type = msg_type
        self.seqid = seqid
        self.body = body
        self.is_request = msg_type in (MSG_CALL, MSG_ONEWAY)


def parse(portal: IOBuf, sock, read_eof: bool, arg) -> ParseResult:
    if len(portal) < 8:
        # bytes 5 and 6 decide, each as soon as it is in
        version = bytes(portal.copy_to_bytes())[4:6]
        return (ParseResult.not_enough() if b"\x80\x01".startswith(version)
                else ParseResult.try_others())
    header = bytes(portal.copy_to_bytes(8))
    if header[4:6] != b"\x80\x01":
        return ParseResult.try_others()
    (length,) = struct.unpack(">I", header[:4])
    if length > MAX_FRAME:
        return ParseResult.error_()
    if len(portal) < 4 + length:
        return ParseResult.not_enough()
    portal.pop_front(4)
    payload = bytes(portal.cutn_bytes(length))
    try:
        name, msg_type, seqid, body = unpack_message(payload)
    except (ValueError, EOFError):
        return ParseResult.error_()
    return ParseResult.ok(ThriftInputMessage(name, msg_type, seqid, body))


def serialize_request(request, cntl: Controller) -> bytes:
    if isinstance(request, ThriftMessage):
        cntl._thrift_method = request.method_name
        return struct_bytes(request.body)
    raise TypeError("thrift channel takes a ThriftMessage")


def pack_request(payload: bytes, cntl: Controller, correlation_id: int) -> IOBuf:
    seqid = correlation_id & 0x7FFFFFFF
    sock = cntl._current_sock
    cids = getattr(sock, "_thrift_cids", None)
    if cids is None:
        cids = sock._thrift_cids = {}
    cids[seqid] = correlation_id
    return IOBuf(pack_message_struct(cntl._thrift_method, MSG_CALL, seqid,
                                     payload))


def process_response(msg: ThriftInputMessage):
    sock = msg.socket
    cid = (getattr(sock, "_thrift_cids", None) or {}).pop(msg.seqid, None)
    if cid is None:
        return
    cntl = lock_attempt(cid)
    if cntl is None:
        return
    if msg.msg_type == MSG_EXCEPTION:
        text = msg.body.get(1, (0, b""))[1]
        if isinstance(text, bytes):
            text = text.decode("utf-8", "replace")
        cntl.set_failed(errors.EREQUEST, f"thrift exception: {text}")
    elif isinstance(cntl._response, ThriftMessage):
        cntl._response.method_name = msg.name
        cntl._response.body = msg.body
    cntl._on_protocol_response(sock, cid)


def process_request(msg: ThriftInputMessage):
    server = msg.arg
    service = getattr(server, "thrift_service", None) if server else None
    if service is None:
        out = pack_message(msg.name, MSG_EXCEPTION, msg.seqid,
                           {1: (T_STRING, b"no thrift service")})
    else:
        try:
            result = service.dispatch(msg.name, msg.body)
            out = pack_message(msg.name, MSG_REPLY, msg.seqid, result or {})
        except Exception as e:
            out = pack_message(msg.name, MSG_EXCEPTION, msg.seqid,
                               {1: (T_STRING, str(e).encode())})
    msg.socket.write(IOBuf(out))


register_protocol(Protocol(
    name="thrift",
    type=ProtocolType.THRIFT,
    parse=parse,
    serialize_request=serialize_request,
    pack_request=pack_request,
    process_request=process_request,
    process_response=process_response,
))
