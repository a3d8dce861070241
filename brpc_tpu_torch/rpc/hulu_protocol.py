"""hulu_pbrpc — Baidu's legacy pb-rpc framing.

Port of brpc_tpu/rpc/hulu_protocol.py, byte-compatible with it: a
12-byte header ``"HULU" + u32le(meta_size + payload_size) +
u32le(meta_size)``, then a ``HuluRpcRequestMeta`` or
``HuluRpcResponseMeta`` (rpc/proto/legacy_meta.py), then the payload. A
serving connection carries request metas, a client connection response
metas. Correlation rides in the meta, so calls share a connection.

Methods travel as the unqualified service name, the method's index and
its name. Servers of either package dispatch by name and fall back on
the index when the name is empty. The reference reads the index from
protobuf's descriptor pool, which holds none of its Python services
(so it sends 0), and resolves a received index against the method
names sorted; the port has no descriptors and takes a service's
methods in the order they are declared (``Service.declared_methods``)
both ways, which is what a descriptor's index is (ROADMAP queue C #25).
``cntl.hulu_method_index`` overrides the index, as in the reference.

The compression codes differ from the registry's: hulu numbers snappy
1, gzip 2 and zlib 3. A server answers uncompressed unless its handler
sets ``cntl.compress_type``, as the reference's does.
``user_message_size`` splits the (compressed) message from an
attachment that follows it in the payload.

A channel with ``auth`` sends its credential in ``credential_data`` (a
proto2 ``bytes`` field: the credential's UTF-8), and a server with
``auth`` verifies it before dispatch (EAUTH on failure), as tpu_std
does. The reference sets that field to the credential's ``str``, which
its protobuf refuses, so its client fails to pack, and its server hands
the field's bytes to the authenticator, which takes a ``str``, so it
refuses every credential (ROADMAP queue C #28).
"""
from __future__ import annotations

import struct

from brpc_tpu_torch.butil.iobuf import IOBuf
from brpc_tpu_torch.rpc import compress, errors
from brpc_tpu_torch.rpc.controller import (
    Controller,
    client_credential,
    lock_attempt,
    verify_credential,
)
from brpc_tpu_torch.rpc.pb_dispatch import (
    dispatch_pb_request,
    serialize_request,
)
from brpc_tpu_torch.rpc.proto.legacy_meta import (
    HuluRpcRequestMeta,
    HuluRpcResponseMeta,
)
from brpc_tpu_torch.rpc.protocol import (
    InputMessageBase,
    ParseResult,
    Protocol,
    ProtocolType,
    register_protocol,
)
from brpc_tpu_torch.rpc.service import declared_service

MAGIC = b"HULU"
HEADER_LEN = 12
MAX_BODY = 64 << 20

# hulu's compress enum (hulu_pbrpc_protocol.cpp:58-96) <-> registry codes
_HULU_NONE, _HULU_SNAPPY, _HULU_GZIP, _HULU_ZLIB = 0, 1, 2, 3
_FROM_HULU = {_HULU_NONE: compress.COMPRESS_NONE,
              _HULU_SNAPPY: compress.COMPRESS_SNAPPY,
              _HULU_GZIP: compress.COMPRESS_GZIP,
              _HULU_ZLIB: compress.COMPRESS_ZLIB}
_TO_HULU = {v: k for k, v in _FROM_HULU.items()}


def method_index(service: str, method: str):
    """The index of ``method`` among the declared methods of the service
    declared last under ``service`` in this process; None when neither is
    known."""
    cls = declared_service(service)
    if cls is None:
        return None
    names = cls.declared_methods()
    return names.index(method) if method in names else None


class HuluMessage(InputMessageBase):
    __slots__ = ("meta", "payload", "is_request")

    def __init__(self, meta, payload: bytes, is_request: bool):
        super().__init__()
        self.meta = meta
        self.payload = payload
        self.is_request = is_request


def _pack_frame(meta, payload: bytes) -> IOBuf:
    meta_bytes = meta.SerializeToString()
    out = IOBuf()
    out.append(MAGIC + struct.pack("<II", len(meta_bytes) + len(payload),
                                   len(meta_bytes)))
    out.append(meta_bytes)
    if payload:
        out.append(payload)
    return out


def parse(portal: IOBuf, sock, read_eof: bool, arg) -> ParseResult:
    if len(portal) < HEADER_LEN:
        head = bytes(portal.copy_to_bytes(min(4, len(portal))))
        if MAGIC.startswith(head):
            return ParseResult.not_enough()
        return ParseResult.try_others()
    header = bytes(portal.copy_to_bytes(HEADER_LEN))
    if header[:4] != MAGIC:
        return ParseResult.try_others()
    body_size, meta_size = struct.unpack("<II", header[4:12])
    if body_size > MAX_BODY or meta_size > body_size:
        return ParseResult.error_()
    if len(portal) < HEADER_LEN + body_size:
        return ParseResult.not_enough()
    portal.pop_front(HEADER_LEN)
    meta_bytes = bytes(portal.cutn_bytes(meta_size))
    payload = bytes(portal.cutn_bytes(body_size - meta_size))
    is_server_conn = arg is not None
    meta = HuluRpcRequestMeta() if is_server_conn else HuluRpcResponseMeta()
    try:
        meta.ParseFromString(meta_bytes)
    except ValueError:
        return ParseResult.error_()
    return ParseResult.ok(HuluMessage(meta, payload, is_server_conn))


def pack_request(payload: bytes, cntl: Controller, correlation_id: int) -> IOBuf:
    meta = HuluRpcRequestMeta()
    service, _, method = cntl._method_full_name.rpartition(".")
    # stock hulu sends the unqualified name (hulu_pbrpc_protocol.cpp:444)
    meta.service_name = service.rpartition(".")[2]
    idx = getattr(cntl, "hulu_method_index", None)
    if idx is None:
        idx = method_index(meta.service_name, method)
    meta.method_index = idx if idx is not None else 0
    meta.method_name = method
    meta.correlation_id = correlation_id
    meta.log_id = cntl.log_id
    if cntl.trace_id:
        meta.trace_id = cntl.trace_id
        meta.span_id = cntl.span_id
    cred = client_credential(cntl)
    if cred is not None:
        meta.credential_data = cred.encode()
    if cntl.compress_type:
        meta.compress_type = _TO_HULU.get(cntl.compress_type, _HULU_NONE)
    payload = compress.compress(payload, cntl.compress_type)
    if len(cntl.request_attachment):
        # the message, then the attachment (hulu_pbrpc_protocol.cpp:354-359)
        meta.user_message_size = len(payload)
        payload = payload + bytes(cntl.request_attachment.copy_to_bytes(
            len(cntl.request_attachment)))
    return _pack_frame(meta, payload)


def _split_attachment(meta, payload: bytes, into: IOBuf) -> bytes:
    """The message's bytes; the attachment after them goes to ``into``.
    The split comes before decompression: only the message is
    compressed."""
    if (meta.HasField("user_message_size")
            and 0 <= meta.user_message_size <= len(payload)):
        into.append(payload[meta.user_message_size:])
        return payload[:meta.user_message_size]
    return payload


def process_response(msg: HuluMessage):
    meta = msg.meta
    cid = meta.correlation_id
    cntl = lock_attempt(cid)
    if cntl is None:
        return
    try:
        if meta.error_code:
            cntl.set_failed(meta.error_code, meta.error_text or "hulu error")
        else:
            payload = _split_attachment(meta, msg.payload,
                                        cntl.response_attachment)
            payload = compress.decompress(
                payload, _FROM_HULU.get(meta.compress_type, 0))
            if cntl._response is not None and payload:
                cntl._response.ParseFromString(payload)
    except Exception as e:
        cntl.set_failed(errors.ERESPONSE, f"fail to parse response: {e}")
    cntl._on_protocol_response(msg.socket, cid)


def _send_response(sock, cid: int, cntl: Controller, response):
    meta = HuluRpcResponseMeta()
    meta.correlation_id = cid
    if cntl.failed():
        meta.error_code = cntl.error_code_value
        meta.error_text = cntl.error_text_value
        payload = b""
    else:
        payload = (response.SerializeToString()
                   if response is not None else b"")
        if cntl.compress_type:
            meta.compress_type = _TO_HULU.get(cntl.compress_type, 0)
            payload = compress.compress(payload, cntl.compress_type)
        if len(cntl.response_attachment):
            meta.user_message_size = len(payload)
            payload = payload + bytes(cntl.response_attachment.copy_to_bytes(
                len(cntl.response_attachment)))
    sock.write(_pack_frame(meta, payload))
    if cntl.close_connection_flag:
        sock.set_failed(errors.ECLOSE, "close_connection requested")


def process_request(msg: HuluMessage):
    server = msg.arg
    meta = msg.meta
    cid = meta.correlation_id
    sock = msg.socket
    cntl = Controller()
    cntl.log_id = meta.log_id
    cntl.trace_id = meta.trace_id
    ctype = _FROM_HULU.get(meta.compress_type, 0)
    payload = _split_attachment(meta, msg.payload, cntl.request_attachment)
    if server is not None and not verify_credential(
            server, cntl, meta.credential_data, sock):
        return _send_response(sock, cid, cntl, None)
    method_name = meta.method_name
    if server is not None and not method_name:
        service = server.find_service(meta.service_name)
        if service is not None:
            names = service.declared_methods()
            if 0 <= meta.method_index < len(names):
                method_name = names[meta.method_index]
    dispatch_pb_request(
        server, sock, meta.service_name, method_name, payload, ctype,
        lambda c, response: _send_response(sock, cid, c, response), cntl)


register_protocol(Protocol(
    name="hulu_pbrpc",
    type=ProtocolType.HULU,
    parse=parse,
    serialize_request=serialize_request,
    pack_request=pack_request,
    process_request=process_request,
    process_response=process_response,
))
