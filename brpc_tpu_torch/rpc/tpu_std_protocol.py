"""tpu_std — the framed protocol of the tensor lane.

Port of brpc_tpu/rpc/tpu_std_protocol.py, byte-compatible with it: a
12-byte header ``"TRPC" + body_size + meta_size`` (``>II``), then an
``RpcMeta``, the payload, and an attachment whose size rides in the meta.
The attachment carries the tensors that ``meta.tensors`` describes.

Left out in this slice: authentication, interceptors, compression other
than 0 (a request asking for it is refused with EREQUEST) and streams.
"""
from __future__ import annotations

import struct
import time

from brpc_tpu_torch.bthread import id as bthread_id
from brpc_tpu_torch.butil.iobuf import IOBuf
from brpc_tpu_torch.rpc import errors
from brpc_tpu_torch.rpc.controller import Controller
from brpc_tpu_torch.rpc.protocol import InputMessageBase, ParseResult
from brpc_tpu_torch.rpc.proto.wire import DecodeError, RpcMeta

MAGIC = b"TRPC"
HEADER_LEN = 12
MAX_BODY = 512 * 1024 * 1024


class RpcMessage(InputMessageBase):
    __slots__ = ("meta", "payload", "attachment", "is_request")

    def __init__(self, meta, payload: bytes, attachment: IOBuf):
        super().__init__()
        self.meta = meta
        self.payload = payload
        self.attachment = attachment
        self.is_request = meta.HasField("request")


def pack_frame(meta, payload: bytes, attachment: IOBuf) -> IOBuf:
    meta.attachment_size = len(attachment)
    meta_bytes = meta.SerializeToString()
    body_size = len(meta_bytes) + len(payload) + len(attachment)
    out = IOBuf()
    out.append(MAGIC + struct.pack(">II", body_size, len(meta_bytes)))
    out.append(meta_bytes)
    if payload:
        out.append(payload)
    if len(attachment):
        out.append(attachment)  # shares the blocks, tensors included
    return out


def parse(portal: IOBuf, sock, read_eof: bool, arg) -> ParseResult:
    """Cut one frame off the front of ``portal``."""
    if len(portal) < HEADER_LEN:
        head = portal.copy_to_bytes(min(4, len(portal)))
        if MAGIC.startswith(head):
            return ParseResult.not_enough()
        return ParseResult.try_others()
    header = portal.copy_to_bytes(HEADER_LEN)
    if header[:4] != MAGIC:
        return ParseResult.try_others()
    body_size, meta_size = struct.unpack(">II", header[4:12])
    if body_size > MAX_BODY or meta_size > body_size:
        return ParseResult.error_()
    if len(portal) < HEADER_LEN + body_size:
        return ParseResult.not_enough()
    portal.pop_front(HEADER_LEN)
    meta = RpcMeta()
    try:
        meta.ParseFromString(portal.cutn_bytes(meta_size))
    except DecodeError:
        return ParseResult.error_()
    att_size = meta.attachment_size
    payload_size = body_size - meta_size - att_size
    if att_size < 0 or payload_size < 0:
        return ParseResult.error_()
    payload = bytes(portal.cutn_bytes(payload_size))
    attachment = portal.cut(att_size)
    return ParseResult.ok(RpcMessage(meta, payload, attachment))


# -- client side -----------------------------------------------------------

def pack_request(payload: bytes, cntl: Controller, correlation_id: int) -> IOBuf:
    """The frame of one attempt. Its tensors are packed on the attempt's
    connection (``cntl._current_sock``), into a copy of the request
    attachment, so a retry does not carry the first attempt's bytes too;
    the send is recorded on the controller, which releases the sends of
    the attempts that lose."""
    meta = RpcMeta()
    service, _, method = cntl._method_full_name.rpartition(".")
    meta.request.service_name = service
    meta.request.method_name = method
    meta.request.log_id = cntl.log_id
    if cntl._deadline is not None:
        remain_ms = max(0, int((cntl._deadline - time.monotonic()) * 1000))
        meta.request.timeout_ms = remain_ms
    meta.correlation_id = correlation_id
    meta.compress_type = cntl.compress_type
    attachment = cntl.request_attachment
    if cntl._outbound_tensors:
        # the connection's DeviceEndpoint (or a per-call one) fills
        # meta.tensors + the attachment
        from brpc_tpu_torch.rpc.device_transport import DeviceEndpoint

        sock = cntl._current_sock
        ep = sock.app_state if sock is not None else None
        if not isinstance(ep, DeviceEndpoint):
            ep = sock = None
        attachment = IOBuf()
        attachment.append(cntl.request_attachment)
        seq = (ep or DeviceEndpoint()).prepare_send(cntl._outbound_tensors,
                                                     meta, attachment)
        if seq and ep is not None:
            cntl._sends.append((correlation_id, sock, ep, seq))
    return pack_frame(meta, payload, attachment)


def process_response(msg: RpcMessage):
    """Client completion: lock the attempt's version of the call id and
    hand the controller the response. A response whose id is stale (its
    RPC ended: a late answer to a timed-out or losing attempt) is dropped,
    after it releases the send its attempt left on the connection."""
    cid = msg.meta.correlation_id
    try:
        cntl = bthread_id.lock(cid)
    except (KeyError, TimeoutError):
        msg.socket.take_abandoned(cid)
        return
    cntl._on_response(msg.meta, msg.payload, msg.attachment, msg.socket)


# -- server side -----------------------------------------------------------

def send_rpc_response(sock, correlation_id: int, cntl: Controller,
                      response, attachment: IOBuf):
    # Handlers may have pre-filled tensors into the response meta.
    meta = cntl._response_meta or RpcMeta()
    meta.correlation_id = correlation_id
    meta.response.error_code = cntl.error_code_value
    if cntl.error_code_value:
        meta.response.error_text = cntl.error_text_value
    payload = b""
    if response is not None and not cntl.failed():
        payload = response.SerializeToString()
    meta.compress_type = cntl.compress_type
    sock.write(pack_frame(meta, payload, attachment))


def process_request(msg: RpcMessage):
    """Run one request: find the method, parse the request, call the
    handler with a ``done`` closure that sends the response."""
    server = msg.arg
    meta = msg.meta
    cid = meta.correlation_id
    sock = msg.socket
    cntl = Controller()
    cntl.server = server
    cntl.remote_side = sock.remote_side
    cntl.service_name = meta.request.service_name
    cntl.method_name = meta.request.method_name
    cntl.log_id = meta.request.log_id
    cntl.request_attachment = msg.attachment
    cntl._server_socket = sock
    cntl._rpc_meta = meta
    cntl._response_meta = RpcMeta()
    if meta.request.timeout_ms > 0:
        cntl.timeout_ms = meta.request.timeout_ms

    if meta.compress_type != 0:
        cntl.set_failed(errors.EREQUEST,
                        f"compress_type {meta.compress_type} not supported")
        return send_rpc_response(sock, cid, cntl, None, IOBuf())

    entry = server.find_method(cntl.service_name, cntl.method_name)
    if entry is None:
        missing_service = server.find_service(cntl.service_name) is None
        cntl.set_failed(
            errors.ENOSERVICE if missing_service else errors.ENOMETHOD,
            f"unknown {cntl.service_name}.{cntl.method_name}",
        )
        return send_rpc_response(sock, cid, cntl, None, IOBuf())
    service_obj, method_info = entry

    request = method_info.request_class()
    try:
        if msg.payload:
            request.ParseFromString(msg.payload)
    except DecodeError as e:
        cntl.set_failed(errors.EREQUEST, f"fail to parse request: {e}")
        return send_rpc_response(sock, cid, cntl, None, IOBuf())

    response = method_info.response_class()
    responded = [False]

    def done():
        if responded[0]:
            return
        responded[0] = True
        send_rpc_response(sock, cid, cntl, response, cntl.response_attachment)

    # The handler owns `done`; respond for it only if it raises first.
    try:
        method_info.handler(service_obj, cntl, request, response, done)
    except Exception as e:
        if not responded[0]:
            cntl.set_failed(errors.EINVAL, f"method raised: {e}")
            done()
