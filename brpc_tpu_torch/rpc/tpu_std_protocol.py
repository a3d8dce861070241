"""tpu_std — the framed protocol of the tensor lane.

Port of brpc_tpu/rpc/tpu_std_protocol.py, byte-compatible with it: a
12-byte header ``"TRPC" + body_size + meta_size`` (``>II``), then an
``RpcMeta``, the payload, and an attachment whose size rides in the meta.
The attachment carries the tensors that ``meta.tensors`` describes.

The server path runs the interceptor, finds the method, asks its
MethodStatus (a limiter's refusal is ELIMIT), decompresses and parses the
request (a failure of either is EREQUEST "fail to parse request"), opens
the call's rpcz server span, lends the session data, runs the handler
with the span as the parent of its own client calls, and when the
handler is done ends the span, records the call's latency and sends the
response, compressed as the request was; ``close_connection()`` then
closes the connection (ECLOSE). A request carries the client span's
``trace_id`` and ``span_id`` (never ``parent_span_id``, as in the
reference). A frame compresses its payload only: tensors in the
attachment go as they are, so a compressed push lands bit-equal. A
response whose meta carries the SHUTDOWN bit (field 8) marks its
connection lame duck. A channel with ``auth`` puts its credential in
``meta.request.auth_data``; a server with ``auth`` verifies it first
(before the interceptor), answers EAUTH when it fails, and hands the
handler its ``cntl.auth_context``.
"""
from __future__ import annotations

import struct
import time

import torch

from brpc_tpu_torch import rpcz
from brpc_tpu_torch.bthread import id as bthread_id
from brpc_tpu_torch.butil.iobuf import IOBuf
from brpc_tpu_torch.rpc import compress, errors
from brpc_tpu_torch.rpc.controller import (
    Controller,
    client_credential,
    verify_credential,
)
from brpc_tpu_torch.rpc.protocol import (
    InputMessageBase,
    ParseResult,
    Protocol,
    ProtocolType,
    register_protocol,
)
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


def _meta_shutdown_bit(meta_bytes: bytes) -> bool:
    """The lame-duck SHUTDOWN bit: top-level RpcMeta varint field 8, a
    draining server's signal. RpcMeta does not declare the field, so the
    raw bytes are walked tag by tag."""
    i, n = 0, len(meta_bytes)

    def varint(i):
        v = s = 0
        while i < n:
            b = meta_bytes[i]
            i += 1
            v |= (b & 0x7F) << s
            if not b & 0x80:
                return v, i
            s += 7
        return None, i

    while i < n:
        tag, i = varint(i)
        if tag is None:
            return False
        field, wire = tag >> 3, tag & 7
        if field == 8 and wire == 0:
            v, i = varint(i)
            return bool(v)
        if wire == 0:
            v, i = varint(i)
            if v is None:
                return False
        elif wire == 2:
            ln, i = varint(i)
            if ln is None or i + ln > n:
                return False
            i += ln
        elif wire == 1:
            i += 8
        elif wire == 5:
            i += 4
        else:
            return False
    return False


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
    meta_bytes = portal.cutn_bytes(meta_size)
    meta = RpcMeta()
    try:
        meta.ParseFromString(meta_bytes)
    except DecodeError:
        return ParseResult.error_()
    # a draining server: new calls go elsewhere, the ones in flight on
    # this connection complete
    if meta.HasField("response") and _meta_shutdown_bit(bytes(meta_bytes)):
        sock.mark_lame_duck()
    att_size = meta.attachment_size
    payload_size = body_size - meta_size - att_size
    if att_size < 0 or payload_size < 0:
        return ParseResult.error_()
    payload = bytes(portal.cutn_bytes(payload_size))
    attachment = portal.cut(att_size)
    return ParseResult.ok(RpcMessage(meta, payload, attachment))


# -- tensor attachment helpers ----------------------------------------------

def attach_arrays(cntl_attachment: IOBuf, meta, arrays):
    """Describe tensors in ``meta.tensors`` and append them to an
    attachment (read to the host when the frame is written)."""
    from brpc_tpu_torch.rpc.device_transport import dtype_name

    for arr in arrays:
        t = meta.tensors.add()
        t.dtype = dtype_name(arr.dtype)
        t.shape.extend(int(d) for d in arr.shape)
        t.nbytes = arr.numel() * arr.element_size()
        cntl_attachment.append_device_array(arr)


def extract_arrays(attachment: IOBuf, meta):
    """Host tensors from a tensor-bearing attachment, cut off its front;
    a meta that does not describe its bytes raises ValueError."""
    from brpc_tpu_torch.rpc.device_transport import _tensor_spec

    out = []
    for t in meta.tensors:
        dtype, shape, nbytes = _tensor_spec(t)
        if nbytes > len(attachment):
            raise ValueError(f"tensor of {nbytes} bytes past the attachment")
        raw = attachment.cutn_bytes(nbytes)
        host = (torch.frombuffer(raw, dtype=torch.uint8) if nbytes
                else torch.empty(0, dtype=torch.uint8))
        out.append(host.view(dtype).reshape(shape))
    return out


# -- client side -----------------------------------------------------------

def serialize_request(request, cntl: Controller) -> bytes:
    """A message's bytes; bytes are sent as they are (a replay)."""
    if request is None:
        return b""
    if isinstance(request, (bytes, bytearray)):
        return bytes(request)
    return request.SerializeToString()


def pack_request(payload: bytes, cntl: Controller, correlation_id: int) -> IOBuf:
    """The frame of one attempt. Its tensors are packed on the attempt's
    connection (``cntl._current_sock``), into a copy of the request
    attachment, so a retry does not carry the first attempt's bytes too;
    the send is recorded on the controller, which releases the sends of
    the attempts that lose. The payload is compressed after the tensors
    are packed, and the meta keeps the controller's ``compress_type``
    (the reference's ``prepare_send`` resets it to 0 while its payload
    stays compressed: ROADMAP queue C #18)."""
    meta = RpcMeta()
    service, _, method = cntl._method_full_name.rpartition(".")
    meta.request.service_name = service
    meta.request.method_name = method
    meta.request.log_id = cntl.log_id
    meta.request.trace_id = cntl.trace_id
    meta.request.span_id = cntl.span_id
    if cntl._deadline is not None:
        remain_ms = max(0, int((cntl._deadline - time.monotonic()) * 1000))
        meta.request.timeout_ms = remain_ms
    cred = client_credential(cntl)
    if cred is not None:
        meta.request.auth_data = cred
    meta.correlation_id = correlation_id
    if cntl._request_stream is not None:
        meta.stream_id = cntl._request_stream.stream_id
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
    meta.compress_type = cntl.compress_type
    payload = compress.compress(payload, cntl.compress_type)
    return pack_frame(meta, payload, attachment)


def process_response(msg: RpcMessage):
    """Client completion: lock the attempt's version of the call id and
    hand the controller the response. A response whose id is stale (its
    RPC ended: a late answer to a timed-out or losing attempt) is dropped,
    after it releases the send its attempt left on the connection. A
    payload that does not decompress fails the RPC with EREQUEST."""
    cid = msg.meta.correlation_id
    try:
        cntl = bthread_id.lock(cid)
    except (KeyError, TimeoutError):
        msg.socket.take_abandoned(cid)
        return
    try:
        payload = compress.decompress(msg.payload, msg.meta.compress_type)
    except ValueError as e:
        cntl.set_failed(errors.EREQUEST, f"fail to parse response: {e}")
        payload = b""
    cntl._on_response(msg.meta, payload, msg.attachment, msg.socket)


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
        payload = compress.compress(response.SerializeToString(),
                                    cntl.compress_type)
    meta.compress_type = cntl.compress_type
    if cntl._accepted_stream is not None:
        meta.stream_id = cntl._accepted_stream.stream_id
    sock.write(pack_frame(meta, payload, attachment))
    if cntl.close_connection_flag:
        sock.set_failed(errors.ECLOSE, "close_connection requested")


def process_request(msg: RpcMessage):
    """Run one request: the interceptor, the method, its MethodStatus (a
    limiter's refusal is ELIMIT), the request's decompression and parse,
    the server span, then the handler with a ``done`` closure that ends
    the span, records the latency, returns the session data and sends the
    response."""
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
    cntl.trace_id = meta.request.trace_id
    cntl.compress_type = meta.compress_type
    cntl.request_attachment = msg.attachment
    cntl._server_socket = sock
    cntl._rpc_meta = meta
    cntl._remote_stream_id = meta.stream_id
    cntl._response_meta = RpcMeta()
    cntl.server_start_time = time.monotonic()
    if meta.request.timeout_ms > 0:
        cntl.timeout_ms = meta.request.timeout_ms

    if server is None:
        cntl.set_failed(errors.EINVAL, "no server bound to connection")
        return send_rpc_response(sock, cid, cntl, None, IOBuf())

    if not verify_credential(server, cntl, meta.request.auth_data, sock):
        return send_rpc_response(sock, cid, cntl, None, IOBuf())

    if server.interceptor is not None:
        try:
            ok, code, text = server.interceptor(cntl)
        except Exception as e:
            ok, code, text = False, errors.EINVAL, f"interceptor raised: {e}"
        if not ok:
            cntl.set_failed(code or errors.EPERM, text or "rejected")
            return send_rpc_response(sock, cid, cntl, None, IOBuf())

    entry = server.find_method(cntl.service_name, cntl.method_name)
    if entry is None:
        missing_service = server.find_service(cntl.service_name) is None
        cntl.set_failed(
            errors.ENOSERVICE if missing_service else errors.ENOMETHOD,
            f"unknown {cntl.service_name}.{cntl.method_name}",
        )
        return send_rpc_response(sock, cid, cntl, None, IOBuf())
    service_obj, method_info, method_status = entry

    if not method_status.on_requested():
        cntl.set_failed(errors.ELIMIT, "reached max_concurrency")
        return send_rpc_response(sock, cid, cntl, None, IOBuf())

    request = method_info.request_class()
    try:
        payload = compress.decompress(msg.payload, meta.compress_type)
        if payload:
            request.ParseFromString(payload)
    except (DecodeError, ValueError) as e:
        method_status.on_response(errors.EREQUEST, cntl.server_start_time)
        cntl.set_failed(errors.EREQUEST, f"fail to parse request: {e}")
        return send_rpc_response(sock, cid, cntl, None, IOBuf())

    response = method_info.response_class()
    responded = [False]
    span = rpcz.start_server_span(
        f"{cntl.service_name}.{cntl.method_name}", meta, sock.remote_side)
    cntl.span = span
    if span is not None:
        span.request_size = len(msg.payload)  # as sent: compressed
    if server.session_pool is not None:
        cntl.session_local_data = server.session_pool.borrow()

    def done():
        if responded[0]:
            return
        responded[0] = True
        method_status.on_response(cntl.error_code_value,
                                  cntl.server_start_time)
        if span is not None:
            span.end(cntl.error_code_value)
        if server.session_pool is not None:
            server.session_pool.return_(cntl.session_local_data)
            cntl.session_local_data = None
        send_rpc_response(sock, cid, cntl, response, cntl.response_attachment)

    # The handler owns `done`; respond for it only if it raises first. Its
    # own client calls take the server span as their parent.
    try:
        with rpcz.parent_scope(span):
            method_info.handler(service_obj, cntl, request, response, done)
    except Exception as e:
        if not responded[0]:
            cntl.set_failed(errors.EINVAL, f"method raised: {e}")
            done()


register_protocol(Protocol(
    name="tpu_std",
    type=ProtocolType.TPU_STD,
    parse=parse,
    serialize_request=serialize_request,
    pack_request=pack_request,
    process_request=process_request,
    process_response=process_response,
))
