"""The metas of the legacy Baidu pb-rpc family, on the hand codec.

Port of ``brpc_tpu/rpc/proto/legacy_meta.proto:13-61`` (``package
brpc_tpu.policy``, proto2): ``HuluRpcRequestMeta``,
``HuluRpcResponseMeta``, ``SofaRpcMeta`` and the ``SofaCompressType``
enum. proto2 keeps explicit presence, so a field assigned its default is
still written, and a hulu or sofa meta serializes to the bytes of
``legacy_meta_pb2``'s ``SerializeToString`` (``rpc/proto/wire.py``).
The Public* messages (``legacy_meta.proto:63-106``) are public_pbrpc's
envelope (rpc/legacy_nshead_family.py).
"""
from __future__ import annotations

from brpc_tpu_torch.rpc.proto.wire import (
    BOOL,
    BYTES,
    ENUM,
    INT32,
    INT64,
    MESSAGE,
    REPEATED_MESSAGE,
    SINT32,
    SINT64,
    STRING,
    UINT32,
    UINT64,
    Message,
)

# SofaCompressType (sofa_pbrpc_meta.proto:26-32)
SOFA_COMPRESS_TYPE_NONE = 0
SOFA_COMPRESS_TYPE_GZIP = 1
SOFA_COMPRESS_TYPE_ZLIB = 2
SOFA_COMPRESS_TYPE_SNAPPY = 3
SOFA_COMPRESS_TYPE_LZ4 = 4
_SOFA_COMPRESS = frozenset(range(5))


class HuluRpcRequestMeta(Message):
    PROTO2 = True
    REQUIRED = ("service_name", "method_index")
    FIELDS = (
        (1, "service_name", STRING, None),
        (2, "method_index", INT32, None),
        (3, "compress_type", INT32, None),
        (4, "correlation_id", INT64, None),
        (5, "log_id", INT64, None),
        (7, "trace_id", INT64, None),
        (8, "parent_span_id", INT64, None),
        (9, "span_id", INT64, None),
        (11, "user_data", BYTES, None),
        (12, "user_message_size", INT32, None),
        (14, "method_name", STRING, None),
        (15, "credential_data", BYTES, None),
    )


class HuluRpcResponseMeta(Message):
    PROTO2 = True
    FIELDS = (
        (1, "error_code", INT32, None),
        (2, "error_text", STRING, None),
        (3, "correlation_id", SINT64, None),
        (4, "compress_type", INT32, None),
        (7, "user_data", BYTES, None),
        (8, "user_message_size", INT32, None),
    )


class SofaRpcMeta(Message):
    # SofaRpcMeta.Type
    REQUEST = 0
    RESPONSE = 1

    PROTO2 = True
    REQUIRED = ("type", "sequence_id")
    FIELDS = (
        (1, "type", ENUM, frozenset((0, 1))),
        (2, "sequence_id", UINT64, None),
        (100, "method", STRING, None),
        (200, "failed", BOOL, None),
        (201, "error_code", INT32, None),
        (202, "reason", STRING, None),
        (300, "compress_type", ENUM, _SOFA_COMPRESS),
        (301, "expected_response_compress_type", ENUM, _SOFA_COMPRESS),
    )


class PublicRequestHead(Message):
    PROTO2 = True
    FIELDS = (
        (1, "from_host", STRING, None),
        (2, "content_type", UINT32, None),
        (3, "connection", BOOL, None),
        (4, "charset", STRING, None),
        (5, "accept_charset", STRING, None),
        (6, "create_time", STRING, None),
        (7, "log_id", UINT64, None),
        (8, "compress_type", UINT32, None),
    )


class PublicRequestBody(Message):
    PROTO2 = True
    REQUIRED = ("service", "method_id", "id")
    FIELDS = (
        (1, "version", STRING, None),
        (2, "charset", STRING, None),
        (3, "service", STRING, None),
        (4, "method_id", UINT32, None),
        (5, "id", UINT64, None),
        (6, "serialized_request", BYTES, None),
    )


class PublicPbrpcRequest(Message):
    PROTO2 = True
    FIELDS = (
        (1, "requestHead", MESSAGE, PublicRequestHead),
        (2, "requestBody", REPEATED_MESSAGE, PublicRequestBody),
    )


class PublicResponseHead(Message):
    PROTO2 = True
    REQUIRED = ("code",)
    FIELDS = (
        (1, "code", SINT32, None),
        (2, "text", STRING, None),
        (3, "from_host", STRING, None),
        (4, "compress_type", UINT32, None),
    )


class PublicResponseBody(Message):
    PROTO2 = True
    REQUIRED = ("id",)
    FIELDS = (
        (1, "serialized_response", BYTES, None),
        (2, "version", STRING, None),
        (3, "error", INT32, None),
        (4, "id", UINT64, None),
    )


class PublicPbrpcResponse(Message):
    PROTO2 = True
    FIELDS = (
        (1, "responseHead", MESSAGE, PublicResponseHead),
        (2, "responseBody", REPEATED_MESSAGE, PublicResponseBody),
    )


for _cls in (HuluRpcRequestMeta, HuluRpcResponseMeta, SofaRpcMeta,
             PublicRequestHead, PublicRequestBody, PublicPbrpcRequest,
             PublicResponseHead, PublicResponseBody, PublicPbrpcResponse):
    _cls.PROTO_FILE = "legacy_meta.proto"
    _cls.FULL_NAME = f"brpc_tpu.policy.{_cls.__name__}"
