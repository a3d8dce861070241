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
* ``repeated int64`` is packed; elements of a repeated message or a
  repeated string are always written; a map's entries are written in the
  order of its dict, key and value each time;
* int32/int64 (and enum) negatives are sign-extended to ten varint
  bytes; ``sint32`` and ``sint64`` are zigzag-encoded; ``bytes`` stay
  ``bytes``.

A class with ``PROTO2 = True`` follows proto2 instead (the legacy metas
of ``rpc/proto/legacy_meta.py``): a scalar is written whenever it was
assigned or parsed, default or not, ``HasField`` answers for scalars
too, and ``SerializeToString`` raises ``EncodeError`` with protobuf's
text while a field named in ``REQUIRED`` is unset. An enum field lists
its values in the fourth slot of its ``FIELDS`` entry: assigning any
other raises ``ValueError``, and parsing one drops it, as protobuf does
with a closed enum.

Decoding accepts packed and unpacked repeated scalars and skips unknown
fields and fields of an unexpected wire type, as protobuf does (the
lame-duck field 8 a native server may set in ``RpcMeta`` is one). Bytes
that do not decode raise ``DecodeError`` with protobuf's text ("Error
parsing message with type '<full name>'").

The message classes keep the generated API the lane uses: attribute
access, keyword construction, ``SerializeToString``, ``ParseFromString``,
``MergeFrom`` (the combo channels' default merger), ``HasField`` and ``tensors.add()``.
Each class carries its proto full name and file (``FULL_NAME``,
``PROTO_FILE``), which the console's ``/protobufs`` lists.
"""
from __future__ import annotations

from typing import Dict, Tuple

# field kinds
STRING = "string"
BYTES = "bytes"
INT32 = "int32"
INT64 = "int64"
UINT32 = "uint32"
UINT64 = "uint64"
SINT32 = "sint32"  # zigzag
SINT64 = "sint64"  # zigzag
ENUM = "enum"  # an int32 on the wire
BOOL = "bool"
PACKED_INT64 = "repeated int64"
REPEATED_STRING = "repeated string"
MESSAGE = "message"
REPEATED_MESSAGE = "repeated message"
# map<K, V>: the fourth slot of its FIELDS entry is (key kind, value kind,
# value message class or None); a map's entry is written as a message
# with the key in field 1 and the value in field 2, both always written
MAP = "map"

_DEFAULTS = {STRING: "", BYTES: b"", INT32: 0, INT64: 0, UINT32: 0,
             UINT64: 0, SINT32: 0, SINT64: 0, ENUM: 0, BOOL: False}
_VARINT_KINDS = (INT32, INT64, UINT32, UINT64, SINT32, SINT64, ENUM, BOOL)
_RANGES = {INT32: (-(1 << 31), 1 << 31), ENUM: (-(1 << 31), 1 << 31),
           SINT32: (-(1 << 31), 1 << 31),
           INT64: (-(1 << 63), 1 << 63), SINT64: (-(1 << 63), 1 << 63),
           UINT32: (0, 1 << 32), UINT64: (0, 1 << 64)}
_COMPOSITE = (MESSAGE, REPEATED_MESSAGE, PACKED_INT64, REPEATED_STRING, MAP)
_MASK64 = (1 << 64) - 1


class DecodeError(ValueError):
    pass


class EncodeError(ValueError):
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


def _length_delimited(number: int, body: bytes) -> bytes:
    return _varint(number << 3 | 2) + _varint(len(body)) + body


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


class MessageMap(dict):
    """A map field whose values are messages: reading a missing key adds
    a new message under it, as protobuf's message map does."""

    def __init__(self, cls):
        super().__init__()
        self._cls = cls

    def __missing__(self, key):
        m = self[key] = self._cls()
        return m


def _encode_scalar(number: int, kind: str, v) -> bytes:
    if kind in (STRING, BYTES):
        b = v.encode() if kind == STRING else v
        return _varint(number << 3 | 2) + _varint(len(b)) + b
    if kind == SINT64:
        return _varint(number << 3) + _varint((v << 1) ^ (v >> 63))
    if kind == SINT32:
        return _varint(number << 3) + _varint(((v << 1) ^ (v >> 31))
                                              & 0xFFFFFFFF)
    return _varint(number << 3) + _varint(int(v))


def _decode_varint_kind(kind: str, v: int):
    if kind == BOOL:
        return bool(v)
    if kind in (INT32, ENUM):
        return _signed(v, 32)
    if kind == INT64:
        return _signed(v, 64)
    if kind == SINT64:
        return (v >> 1) ^ -(v & 1)
    if kind == SINT32:
        v &= 0xFFFFFFFF
        return (v >> 1) ^ -(v & 1)
    if kind == UINT32:
        return v & 0xFFFFFFFF
    return v


class Message:
    """Base of the hand-written messages. A subclass lists its fields in
    ``FIELDS`` as ``(number, name, kind, message class or None)``."""

    FIELDS: Tuple = ()
    FULL_NAME = ""  # "<package>.<message>" of its .proto
    PROTO_FILE = ""
    PROTO2 = False  # explicit presence of scalars
    REQUIRED: Tuple = ()  # proto2 fields SerializeToString insists on
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
        d["_has"] = set()  # proto2: the scalars assigned or parsed
        for _, name, kind, sub in self.FIELDS:
            if kind in (PACKED_INT64, REPEATED_STRING):
                d[name] = []
            elif kind == MAP:
                d[name] = MessageMap(sub[2]) if sub[2] is not None else {}
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
        if kind in _COMPOSITE:
            raise AttributeError(
                f"assignment not allowed to composite field {name!r}")
        if kind == STRING:
            if isinstance(value, bytes):
                value = value.decode()
            if not isinstance(value, str):
                raise TypeError(f"{name}: expected str, got {type(value)}")
            value.encode()  # a lone surrogate fails here, as in protobuf
        elif kind == BYTES:
            if not isinstance(value, (bytes, bytearray)):
                raise TypeError(f"{name}: expected bytes, "
                                f"{type(value).__name__} found")
            value = bytes(value)
        elif kind == BOOL:
            value = bool(value)
        else:
            value = int(value)
            lo, hi = _RANGES[kind]
            if not lo <= value < hi:
                raise ValueError(f"{name}: {value} out of {kind} range")
            if kind == ENUM and value not in f[3]:
                raise ValueError(f"{name}: invalid enumerator {value}")
        self.__dict__[name] = value
        if self.PROTO2:
            self.__dict__["_has"].add(name)
        self._mark()

    def HasField(self, name: str) -> bool:
        f = self._BY_NAME.get(name)
        if f is not None and f[2] == MESSAGE:
            return self.__dict__[name]._present
        if f is not None and self.PROTO2 and f[2] in _DEFAULTS:
            return name in self._has
        raise ValueError(f"{name!r} is not a singular message field")

    # -- encoding ----------------------------------------------------------
    def SerializeToString(self) -> bytes:
        missing = self._missing("")
        if missing:
            raise EncodeError(f"Message {self.FULL_NAME} is missing required "
                              f"fields: {','.join(missing)}")
        return self._serialize()

    def _missing(self, prefix: str):
        """The required fields unset here and in present sub-messages, by
        protobuf's paths (``head.code``, ``body[0].id``)."""
        out = [prefix + n for n in self.REQUIRED if n not in self._has]
        for _, name, kind, _ in self.FIELDS:
            v = self.__dict__[name]
            if kind == MESSAGE and v._present:
                out += v._missing(f"{prefix}{name}.")
            elif kind == REPEATED_MESSAGE:
                for i, m in enumerate(v):
                    out += m._missing(f"{prefix}{name}[{i}].")
        return out

    def _serialize(self) -> bytes:
        out = bytearray()
        has = self._has if self.PROTO2 else None
        for number, name, kind, _ in self.FIELDS:
            v = self.__dict__[name]
            if kind in _DEFAULTS and not (name in has if has is not None
                                          else v):
                continue
            if kind in _DEFAULTS:
                out += _encode_scalar(number, kind, v)
            elif kind == REPEATED_STRING:
                for x in v:
                    out += _encode_scalar(number, STRING, x)
            elif kind == MAP:
                key_kind, value_kind, _ = self._BY_NAME[name][3]
                for k, x in v.items():
                    body = _encode_scalar(1, key_kind, k) + (
                        _encode_scalar(2, value_kind, x)
                        if value_kind != MESSAGE else
                        _length_delimited(2, x._serialize()))
                    out += _length_delimited(number, body)
            elif kind == PACKED_INT64:
                if v:
                    body = b"".join(_varint(int(x)) for x in v)
                    out += _varint(number << 3 | 2) + _varint(len(body)) + body
            elif kind == MESSAGE:
                if v._present:
                    body = v._serialize()
                    out += _varint(number << 3 | 2) + _varint(len(body)) + body
            else:  # REPEATED_MESSAGE
                for m in v:
                    body = m._serialize()
                    out += _varint(number << 3 | 2) + _varint(len(body)) + body
        return bytes(out)

    # -- decoding ----------------------------------------------------------
    def ParseFromString(self, data) -> int:
        """Merge ``data`` into this message (protobuf's ParseFromString
        clears first; every caller here parses into a fresh message)."""
        buf = bytes(data)
        try:
            self._merge(buf, 0, len(buf))
        except DecodeError as e:
            # protobuf's text, naming the message; the cause stays chained
            raise DecodeError(f"Error parsing message with type "
                              f"'{self.FULL_NAME}'") from e
        self._mark()
        return len(buf)

    def MergeFrom(self, other: "Message"):
        """protobuf's merge: set scalars of ``other`` overwrite, repeated
        fields append, sub-messages merge."""
        if type(other) is not type(self):
            raise TypeError(f"cannot merge {type(other).__name__} into "
                            f"{type(self).__name__}")
        self.ParseFromString(other._serialize())

    def _merge(self, buf, i: int, end: int):
        d = self.__dict__
        while i < end:
            tag, i = _read_varint(buf, i)
            number, wire = tag >> 3, tag & 7
            f = self._BY_NUMBER.get(number)
            kind = f[2] if f is not None else None
            if wire == 0:
                v, i = _read_varint(buf, i)
                if kind == PACKED_INT64:  # unpacked encoding
                    d[f[1]].append(_signed(v, 64))
                    continue
                if kind not in _VARINT_KINDS:
                    continue
                v = _decode_varint_kind(kind, v)
                if kind == ENUM and v not in f[3]:
                    continue  # a closed enum drops what it lacks
                d[f[1]] = v
                d["_has"].add(f[1])
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
                    d["_has"].add(f[1])
                elif kind == BYTES:
                    d[f[1]] = bytes(buf[i:j])
                    d["_has"].add(f[1])
                elif kind == REPEATED_STRING:
                    try:
                        d[f[1]].append(bytes(buf[i:j]).decode())
                    except UnicodeDecodeError as e:
                        raise DecodeError(str(e)) from None
                elif kind == MAP:
                    self._merge_map_entry(f, buf, i, j)
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

    def _merge_map_entry(self, f, buf, i: int, end: int):
        key_kind, value_kind, value_cls = f[3]
        key = _DEFAULTS[key_kind]
        value = value_cls() if value_kind == MESSAGE else _DEFAULTS[value_kind]
        while i < end:
            tag, i = _read_varint(buf, i)
            number, wire = tag >> 3, tag & 7
            kind = key_kind if number == 1 else value_kind
            if wire == 0:
                v, i = _read_varint(buf, i)
                v = _decode_varint_kind(kind, v)
            elif wire == 2:
                ln, i = _read_varint(buf, i)
                j = i + ln
                if j > end:
                    raise DecodeError("length-delimited field past the end")
                if kind == MESSAGE:
                    value._merge(buf, i, j)
                    value._mark()
                    v = value
                else:
                    v = bytes(buf[i:j])
                    if kind == STRING:
                        try:
                            v = v.decode()
                        except UnicodeDecodeError as e:
                            raise DecodeError(str(e)) from None
                i = j
            else:
                raise DecodeError(f"unsupported wire type {wire} in a map")
            if number == 1:
                key = v
            elif number == 2:
                value = v
        if i != end:
            raise DecodeError("field past the end of the map entry")
        dict.__setitem__(self.__dict__[f[1]], key, value)

    def __eq__(self, other):
        if type(other) is not type(self):
            return NotImplemented
        return self._serialize() == other._serialize()

    def __repr__(self):
        parts = []
        for _, name, kind, _ in self.FIELDS:
            v = self.__dict__[name]
            if kind == MESSAGE:
                if v._present:
                    parts.append(f"{name}={v!r}")
            elif kind in _DEFAULTS and v != _DEFAULTS[kind]:
                parts.append(f"{name}={v!r}")
            elif kind not in _DEFAULTS and v:
                plain = dict(v) if isinstance(v, dict) else list(v)
                parts.append(f"{name}={plain!r}")
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


def _declare(proto_file: str, package: str, *classes):
    for cls in classes:
        cls.PROTO_FILE = proto_file
        cls.FULL_NAME = f"{package}.{cls.__name__}"


_declare("rpc_meta.proto", "brpc_tpu", RpcRequestMeta, RpcResponseMeta,
         TensorMeta, RpcMeta)
_declare("tensor_service.proto", "brpc_tpu", TensorPushRequest,
         TensorPushResponse, TensorPullRequest, TensorPullResponse,
         TensorAckRequest, TensorAckResponse)
_declare("echo.proto", "brpc_tpu.test", EchoRequest, EchoResponse)
