"""Hand-written proto3 codec for the messages of the tensor lane.

The port runs where no protobuf package exists, so it cannot use the
reference's generated ``rpc_meta_pb2`` / ``tensor_service_pb2``. This
module encodes and decodes exactly the messages of
``brpc_tpu/rpc/proto/rpc_meta.proto`` (``RpcMeta``, ``RpcRequestMeta``,
``RpcResponseMeta``, ``TensorMeta``), ``tensor_service.proto`` (the six
``Tensor*`` messages) and ``echo.proto`` (``EchoRequest``,
``EchoResponse``: the fixture of the channel tests), byte for byte as
protobuf does:

* fields are written in field-number order;
* proto3 implicit presence: a scalar equal to its default (0, "", False)
  is omitted;
* a singular sub-message is written when it is present, and it becomes
  present as soon as any of its fields is assigned (even to the default),
  as protobuf's Python API does; a present empty sub-message is written
  as tag + zero length;
* ``repeated int64`` is packed; elements of a repeated message are always
  written;
* int32/int64 negatives are sign-extended to ten varint bytes.

Decoding accepts packed and unpacked repeated scalars and skips unknown
fields and fields of an unexpected wire type, as protobuf does (the
lame-duck field 8 a native server may set in ``RpcMeta`` is one).

The message classes keep the generated API the lane uses: attribute
access, keyword construction, ``SerializeToString``, ``ParseFromString``,
``MergeFrom`` (the combo channels' default merger), ``HasField`` and ``tensors.add()``.
"""
from __future__ import annotations

from typing import Dict, Tuple

# field kinds
STRING = "string"
INT32 = "int32"
INT64 = "int64"
BOOL = "bool"
PACKED_INT64 = "repeated int64"
MESSAGE = "message"
REPEATED_MESSAGE = "repeated message"

_DEFAULTS = {STRING: "", INT32: 0, INT64: 0, BOOL: False}
_MASK64 = (1 << 64) - 1


class DecodeError(ValueError):
    pass


def _varint(v: int) -> bytes:
    v &= _MASK64
    out = bytearray()
    while v > 0x7F:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def _read_varint(buf, i: int) -> Tuple[int, int]:
    v = shift = 0
    n = len(buf)
    while True:
        if i >= n or shift > 63:
            raise DecodeError("truncated or overlong varint")
        b = buf[i]
        i += 1
        v |= (b & 0x7F) << shift
        if not b & 0x80:
            return v & _MASK64, i
        shift += 7


def _signed(v: int, bits: int) -> int:
    v &= (1 << bits) - 1
    return v - (1 << bits) if v >> (bits - 1) else v


class RepeatedMessage(list):
    """A repeated message field: a list whose ``add()`` appends a new
    element, as protobuf's repeated composite container does."""

    def __init__(self, cls):
        super().__init__()
        self._cls = cls

    def add(self, **kwargs):
        m = self._cls(**kwargs)
        self.append(m)
        return m


class Message:
    """Base of the hand-written messages. A subclass lists its fields in
    ``FIELDS`` as ``(number, name, kind, message class or None)``."""

    FIELDS: Tuple = ()
    _BY_NAME: Dict[str, Tuple] = {}
    _BY_NUMBER: Dict[int, Tuple] = {}

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        cls._BY_NAME = {f[1]: f for f in cls.FIELDS}
        cls._BY_NUMBER = {f[0]: f for f in cls.FIELDS}

    def __init__(self, **kwargs):
        d = self.__dict__
        d["_present"] = False  # set once any field is assigned
        d["_parent"] = None
        for _, name, kind, sub in self.FIELDS:
            if kind == PACKED_INT64:
                d[name] = []
            elif kind == REPEATED_MESSAGE:
                d[name] = RepeatedMessage(sub)
            elif kind == MESSAGE:
                child = sub()
                child.__dict__["_parent"] = self
                d[name] = child
            else:
                d[name] = _DEFAULTS[kind]
        for k, v in kwargs.items():
            setattr(self, k, v)

    def _mark(self):
        m = self
        while m is not None and not m._present:
            m.__dict__["_present"] = True
            m = m._parent

    def __setattr__(self, name, value):
        f = self._BY_NAME.get(name)
        if f is None:
            raise AttributeError(f"{type(self).__name__} has no field {name!r}")
        kind = f[2]
        if kind in (MESSAGE, REPEATED_MESSAGE, PACKED_INT64):
            raise AttributeError(
                f"assignment not allowed to composite field {name!r}")
        if kind == STRING:
            if isinstance(value, bytes):
                value = value.decode()
            if not isinstance(value, str):
                raise TypeError(f"{name}: expected str, got {type(value)}")
        elif kind == BOOL:
            value = bool(value)
        else:
            value = int(value)
            bits = 32 if kind == INT32 else 64
            if not -(1 << (bits - 1)) <= value < (1 << (bits - 1)):
                raise ValueError(f"{name}: {value} out of int{bits} range")
        self.__dict__[name] = value
        self._mark()

    def HasField(self, name: str) -> bool:
        f = self._BY_NAME.get(name)
        if f is None or f[2] != MESSAGE:
            raise ValueError(f"{name!r} is not a singular message field")
        return self.__dict__[name]._present

    # -- encoding ----------------------------------------------------------
    def SerializeToString(self) -> bytes:
        out = bytearray()
        for number, name, kind, _ in self.FIELDS:
            v = self.__dict__[name]
            if kind == STRING:
                if v:
                    b = v.encode()
                    out += _varint(number << 3 | 2) + _varint(len(b)) + b
            elif kind in (INT32, INT64, BOOL):
                if v:
                    out += _varint(number << 3) + _varint(int(v))
            elif kind == PACKED_INT64:
                if v:
                    body = b"".join(_varint(int(x)) for x in v)
                    out += _varint(number << 3 | 2) + _varint(len(body)) + body
            elif kind == MESSAGE:
                if v._present:
                    body = v.SerializeToString()
                    out += _varint(number << 3 | 2) + _varint(len(body)) + body
            else:  # REPEATED_MESSAGE
                for m in v:
                    body = m.SerializeToString()
                    out += _varint(number << 3 | 2) + _varint(len(body)) + body
        return bytes(out)

    # -- decoding ----------------------------------------------------------
    def ParseFromString(self, data) -> int:
        """Merge ``data`` into this message (protobuf's ParseFromString
        clears first; every caller here parses into a fresh message)."""
        buf = bytes(data)
        self._merge(buf, 0, len(buf))
        self._mark()
        return len(buf)

    def MergeFrom(self, other: "Message"):
        """protobuf's merge: set scalars of ``other`` overwrite, repeated
        fields append, sub-messages merge."""
        if type(other) is not type(self):
            raise TypeError(f"cannot merge {type(other).__name__} into "
                            f"{type(self).__name__}")
        self.ParseFromString(other.SerializeToString())

    def _merge(self, buf, i: int, end: int):
        d = self.__dict__
        while i < end:
            tag, i = _read_varint(buf, i)
            number, wire = tag >> 3, tag & 7
            f = self._BY_NUMBER.get(number)
            kind = f[2] if f is not None else None
            if wire == 0:
                v, i = _read_varint(buf, i)
                if kind == BOOL:
                    d[f[1]] = bool(v)
                elif kind in (INT32, INT64):
                    d[f[1]] = _signed(v, 32 if kind == INT32 else 64)
                elif kind == PACKED_INT64:  # unpacked encoding
                    d[f[1]].append(_signed(v, 64))
            elif wire == 2:
                ln, i = _read_varint(buf, i)
                j = i + ln
                if j > end:
                    raise DecodeError("length-delimited field past the end")
                if kind == STRING:
                    try:
                        d[f[1]] = bytes(buf[i:j]).decode()
                    except UnicodeDecodeError as e:
                        raise DecodeError(str(e)) from None
                elif kind == PACKED_INT64:
                    k = i
                    while k < j:
                        v, k = _read_varint(buf, k)
                        d[f[1]].append(_signed(v, 64))
                    if k != j:
                        raise DecodeError("packed field overruns its length")
                elif kind == MESSAGE:
                    d[f[1]]._merge(buf, i, j)
                    d[f[1]]._mark()
                elif kind == REPEATED_MESSAGE:
                    d[f[1]].add()._merge(buf, i, j)
                i = j
            elif wire == 1:
                i += 8
            elif wire == 5:
                i += 4
            else:
                raise DecodeError(f"unsupported wire type {wire}")
        if i != end:
            raise DecodeError("field past the end of the message")

    def __eq__(self, other):
        if type(other) is not type(self):
            return NotImplemented
        return self.SerializeToString() == other.SerializeToString()

    def __repr__(self):
        parts = []
        for _, name, kind, _ in self.FIELDS:
            v = self.__dict__[name]
            if kind == MESSAGE:
                if v._present:
                    parts.append(f"{name}={v!r}")
            elif v != _DEFAULTS.get(kind, []):
                parts.append(f"{name}={list(v) if isinstance(v, list) else v!r}")
        return f"{type(self).__name__}({', '.join(parts)})"


# -- rpc_meta.proto ---------------------------------------------------------

class RpcRequestMeta(Message):
    FIELDS = (
        (1, "service_name", STRING, None),
        (2, "method_name", STRING, None),
        (3, "log_id", INT64, None),
        (4, "trace_id", INT64, None),
        (5, "span_id", INT64, None),
        (6, "parent_span_id", INT64, None),
        (7, "timeout_ms", INT32, None),
        (8, "request_id", STRING, None),
        (9, "auth_data", STRING, None),
    )


class RpcResponseMeta(Message):
    FIELDS = (
        (1, "error_code", INT32, None),
        (2, "error_text", STRING, None),
    )


class TensorMeta(Message):
    FIELDS = (
        (1, "dtype", STRING, None),
        (2, "shape", PACKED_INT64, None),
        (3, "sharding_spec", STRING, None),
        (4, "nbytes", INT64, None),
    )


class RpcMeta(Message):
    FIELDS = (
        (1, "request", MESSAGE, RpcRequestMeta),
        (2, "response", MESSAGE, RpcResponseMeta),
        (3, "compress_type", INT32, None),
        (4, "correlation_id", INT64, None),
        (5, "attachment_size", INT64, None),
        (6, "tensors", REPEATED_MESSAGE, TensorMeta),
        (7, "stream_id", INT32, None),
    )


# -- tensor_service.proto ---------------------------------------------------

class TensorPushRequest(Message):
    FIELDS = ((1, "name", STRING, None),)


class TensorPushResponse(Message):
    FIELDS = ((1, "ok", BOOL, None), (2, "ack_seq", INT64, None))


class TensorPullRequest(Message):
    FIELDS = ((1, "name", STRING, None),)


class TensorPullResponse(Message):
    FIELDS = ((1, "found", BOOL, None),)


class TensorAckRequest(Message):
    FIELDS = ((1, "seq", INT64, None),)


class TensorAckResponse(Message):
    FIELDS = ((1, "ok", BOOL, None),)


# -- echo.proto -------------------------------------------------------------

class EchoRequest(Message):
    FIELDS = ((1, "message", STRING, None), (2, "sleep_us", INT32, None),
              (3, "code", INT32, None))


class EchoResponse(Message):
    FIELDS = ((1, "message", STRING, None),)
