"""sofa_pbrpc — the sofa-pbrpc framing.

Port of brpc_tpu/rpc/sofa_protocol.py, byte-compatible with it: a
24-byte header ``"SOFA" + u32le(meta_size) + u64le(body_size) +
u64le(meta_size + body_size)``, then one ``SofaRpcMeta``
(rpc/proto/legacy_meta.py) for both directions, told apart by its
``type``, then the payload. Correlation is ``sequence_id``; a method
travels as its full name ("pkg.Service.Method"), and a server that
holds no service of the qualified name tries the unqualified one. The
compression codes are sofa's (gzip 1, zlib 2, snappy 3, the registry's
own); a server answers uncompressed unless its handler sets
``cntl.compress_type``, as the reference's does.
"""
from __future__ import annotations

import struct

from brpc_tpu_torch.butil.iobuf import IOBuf
from brpc_tpu_torch.rpc import compress, errors
from brpc_tpu_torch.rpc.controller import Controller, lock_attempt
from brpc_tpu_torch.rpc.pb_dispatch import (
    dispatch_pb_request,
    serialize_request,
)
from brpc_tpu_torch.rpc.proto import legacy_meta as lm
from brpc_tpu_torch.rpc.protocol import (
    InputMessageBase,
    ParseResult,
    Protocol,
    ProtocolType,
    register_protocol,
)

MAGIC = b"SOFA"
HEADER_LEN = 24
MAX_BODY = 64 << 20
MAX_META = 1 << 20

# SofaCompressType (sofa_pbrpc_meta.proto:26-32) <-> registry codes
_FROM_SOFA = {lm.SOFA_COMPRESS_TYPE_NONE: compress.COMPRESS_NONE,
              lm.SOFA_COMPRESS_TYPE_GZIP: compress.COMPRESS_GZIP,
              lm.SOFA_COMPRESS_TYPE_ZLIB: compress.COMPRESS_ZLIB,
              lm.SOFA_COMPRESS_TYPE_SNAPPY: compress.COMPRESS_SNAPPY}
_TO_SOFA = {v: k for k, v in _FROM_SOFA.items()}


class SofaMessage(InputMessageBase):
    __slots__ = ("meta", "payload", "is_request")

    def __init__(self, meta, payload: bytes):
        super().__init__()
        self.meta = meta
        self.payload = payload
        self.is_request = meta.type == lm.SofaRpcMeta.REQUEST


def _pack_frame(meta, payload: bytes) -> IOBuf:
    meta_bytes = meta.SerializeToString()
    out = IOBuf()
    out.append(MAGIC + struct.pack("<IQQ", len(meta_bytes), len(payload),
                                   len(meta_bytes) + len(payload)))
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
    meta_size, body_size, msg_size = struct.unpack("<IQQ", header[4:24])
    if msg_size != meta_size + body_size:
        return ParseResult.try_others()
    if body_size > MAX_BODY or meta_size > MAX_META:
        return ParseResult.error_()
    if len(portal) < HEADER_LEN + msg_size:
        return ParseResult.not_enough()
    portal.pop_front(HEADER_LEN)
    meta_bytes = bytes(portal.cutn_bytes(meta_size))
    payload = bytes(portal.cutn_bytes(body_size))
    meta = lm.SofaRpcMeta()
    try:
        meta.ParseFromString(meta_bytes)
    except ValueError:
        return ParseResult.error_()
    return ParseResult.ok(SofaMessage(meta, payload))


def pack_request(payload: bytes, cntl: Controller, correlation_id: int) -> IOBuf:
    meta = lm.SofaRpcMeta()
    meta.type = lm.SofaRpcMeta.REQUEST
    meta.sequence_id = correlation_id
    meta.method = cntl._method_full_name
    if cntl.compress_type:
        meta.compress_type = _TO_SOFA.get(cntl.compress_type,
                                          lm.SOFA_COMPRESS_TYPE_NONE)
    payload = compress.compress(payload, cntl.compress_type)
    return _pack_frame(meta, payload)


def process_response(msg: SofaMessage):
    meta = msg.meta
    cid = meta.sequence_id
    cntl = lock_attempt(cid)
    if cntl is None:
        return
    try:
        if meta.failed:
            cntl.set_failed(meta.error_code or errors.EINVAL,
                            meta.reason or "sofa rpc failed")
        else:
            payload = compress.decompress(
                msg.payload, _FROM_SOFA.get(meta.compress_type, 0))
            if cntl._response is not None and payload:
                cntl._response.ParseFromString(payload)
    except Exception as e:
        cntl.set_failed(errors.ERESPONSE, f"fail to parse response: {e}")
    cntl._on_protocol_response(msg.socket, cid)


def _send_response(sock, seq: int, cntl: Controller, response):
    meta = lm.SofaRpcMeta()
    meta.type = lm.SofaRpcMeta.RESPONSE
    meta.sequence_id = seq
    if cntl.failed():
        meta.failed = True
        meta.error_code = cntl.error_code_value
        meta.reason = cntl.error_text_value
        payload = b""
    else:
        payload = (response.SerializeToString()
                   if response is not None else b"")
        if cntl.compress_type:
            meta.compress_type = _TO_SOFA.get(cntl.compress_type, 0)
            payload = compress.compress(payload, cntl.compress_type)
    sock.write(_pack_frame(meta, payload))
    if cntl.close_connection_flag:
        sock.set_failed(errors.ECLOSE, "close_connection requested")


def process_request(msg: SofaMessage):
    server = msg.arg
    meta = msg.meta
    seq = meta.sequence_id
    sock = msg.socket
    service_name, _, method_name = meta.method.rpartition(".")
    if (server is not None and service_name
            and server.find_service(service_name) is None):
        # stock sofa clients send the package-qualified name
        unqualified = service_name.rpartition(".")[2]
        if server.find_service(unqualified) is not None:
            service_name = unqualified
    dispatch_pb_request(
        server, sock, service_name, method_name, msg.payload,
        _FROM_SOFA.get(meta.compress_type, 0),
        lambda c, response: _send_response(sock, seq, c, response))


register_protocol(Protocol(
    name="sofa_pbrpc",
    type=ProtocolType.SOFA,
    parse=parse,
    serialize_request=serialize_request,
    pack_request=pack_request,
    process_request=process_request,
    process_response=process_response,
))
