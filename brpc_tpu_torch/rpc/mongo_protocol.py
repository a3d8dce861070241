"""mongo — a server port that speaks the MongoDB wire protocol.

Port of brpc_tpu/rpc/mongo_protocol.py: server-side only, as in the
reference, and only on a server with a ``ServerOptions.
mongo_service_adaptor`` (without one the bytes go to other protocols).
A frame is claimed by its head: a known opcode and a length from 16
bytes to 48 MiB. Its magic is weak, so mongo is tried after thrift and
before nshead. The first message of a connection makes the adaptor's
context for it; each request runs the adaptor with a ``done`` that
sends the OP_REPLY answering the request's id (the adaptor's error
reply when the controller failed).
"""
from __future__ import annotations

import time

from brpc_tpu_torch.butil.iobuf import IOBuf
from brpc_tpu_torch.rpc import errors
from brpc_tpu_torch.rpc.controller import Controller
from brpc_tpu_torch.rpc.mongo import (
    HEAD_SIZE,
    MongoHead,
    MongoRequest,
    MongoResponse,
    is_mongo_opcode,
)
from brpc_tpu_torch.rpc.protocol import (
    InputMessageBase,
    ParseResult,
    Protocol,
    ProtocolType,
    register_protocol,
)

MAX_BODY = 48 << 20  # mongo's own limit


class MongoInputMessage(InputMessageBase):
    __slots__ = ("req",)

    def __init__(self, req: MongoRequest):
        super().__init__()
        self.req = req


def parse(portal: IOBuf, sock, read_eof: bool, arg) -> ParseResult:
    adaptor = getattr(getattr(arg, "options", None),
                      "mongo_service_adaptor", None)
    if adaptor is None:
        return ParseResult.try_others()
    if len(portal) < HEAD_SIZE:
        return ParseResult.not_enough()
    head = MongoHead.unpack(bytes(portal.copy_to_bytes(HEAD_SIZE)))
    if (not is_mongo_opcode(head.op_code)
            or head.message_length < HEAD_SIZE
            or head.message_length > MAX_BODY):
        return ParseResult.try_others()
    if len(portal) < head.message_length:
        return ParseResult.not_enough()
    portal.pop_front(HEAD_SIZE)
    body = bytes(portal.cutn_bytes(head.message_length - HEAD_SIZE))
    if getattr(sock, "mongo_context", None) is None:
        sock.mongo_context = adaptor.create_socket_context()
    try:
        req = MongoRequest(head, body)
    except (ValueError, IndexError, UnicodeDecodeError):
        return ParseResult.error_()  # a malformed body closes the connection
    return ParseResult.ok(MongoInputMessage(req))


def process_request(msg: MongoInputMessage):
    server = msg.arg
    sock = msg.socket
    adaptor = server.options.mongo_service_adaptor
    cntl = Controller()
    cntl.server = server
    cntl.remote_side = sock.remote_side
    cntl._server_socket = sock
    cntl.server_start_time = time.monotonic()
    cntl.mongo_session_data = getattr(sock, "mongo_context", None)
    response = MongoResponse()
    responded = [False]
    request_id = msg.req.head.request_id

    def done():
        if responded[0]:
            return
        responded[0] = True
        if cntl.failed():
            out = adaptor.serialize_error(request_id)
        else:
            out = response.pack(request_id, request_id)
        sock.write(IOBuf(out))
        if cntl.close_connection_flag:
            sock.set_failed(errors.ECLOSE, "close_connection requested")

    try:
        adaptor.process_mongo_request(cntl, msg.req, response, done)
    except Exception as e:
        if not responded[0]:
            cntl.set_failed(errors.EINVAL, f"mongo adaptor raised: {e}")
            done()


register_protocol(Protocol(
    name="mongo",
    type=ProtocolType.MONGO,
    parse=parse,
    process_request=process_request,
    support_client=False,
))
