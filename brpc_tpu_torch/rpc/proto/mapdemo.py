"""The map fixture of the mcpack2pb generator, on the hand codec.

Port of ``brpc_tpu/rpc/proto/mapdemo.proto`` (``package brpc_tpu.test``,
proto3): ``MapInner`` and ``MapDemo``, whose maps and repeated string the
generator's tests walk (rpc/proto/wire.py's ``MAP`` and
``REPEATED_STRING`` kinds).
"""
from __future__ import annotations

from brpc_tpu_torch.rpc.proto.wire import (
    INT32,
    INT64,
    MAP,
    MESSAGE,
    REPEATED_STRING,
    STRING,
    Message,
)


class MapInner(Message):
    FIELDS = ((1, "label", STRING, None), (2, "rank", INT32, None))


class MapDemo(Message):
    FIELDS = (
        (1, "counts", MAP, (STRING, INT32, None)),
        (2, "shards", MAP, (INT64, MESSAGE, MapInner)),
        (3, "tags", REPEATED_STRING, None),
    )


for _cls in (MapInner, MapDemo):
    _cls.PROTO_FILE = "mapdemo.proto"
    _cls.FULL_NAME = f"brpc_tpu.test.{_cls.__name__}"
