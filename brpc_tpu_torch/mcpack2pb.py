"""mcpack2pb — the mcpack codec, with messages as its front end.

Port of brpc_tpu/mcpack2pb.py, byte-compatible with it. mcpack is
Baidu's TLV wire format; ``dumps`` and ``loads`` map Python values (an
object at the top) to and from mcpack v2 bytes, and the typed ``enc_*``
primitives write one field of an exact wire type. ``pb_to_mcpack`` and
``mcpack_to_pb`` map a message by its field names: the port has no
protobuf descriptors, so they walk the field table of
``rpc/proto/wire.Message`` (as json2pb does), taking the fields that
protobuf's ``ListFields`` would list, in field-number order.

Wire layout (field_type.h:28-78, serializer.cpp:29-88):
  FieldFixedHead { u8 type, u8 name_size }            + name + value
  FieldShortHead { u8 type|0x80, u8 name_size, u8 value_size }
  FieldLongHead  { u8 type, u8 name_size, u32 value_size }   (little-endian)
  OBJECT/ARRAY   = FieldLongHead + name + ItemsHead{u32 count} + items
  names and strings are NUL-terminated; name_size counts the NUL.
"""
from __future__ import annotations

import struct
from typing import Dict, Tuple

from brpc_tpu_torch.rpc.proto.wire import (
    BOOL,
    BYTES,
    MAP,
    MESSAGE,
    PACKED_INT64,
    REPEATED_MESSAGE,
    REPEATED_STRING,
    STRING,
)

FIELD_OBJECT = 0x10
FIELD_ARRAY = 0x20
FIELD_STRING = 0x50
FIELD_BINARY = 0x60
FIELD_INT8 = 0x11
FIELD_INT16 = 0x12
FIELD_INT32 = 0x14
FIELD_INT64 = 0x18
FIELD_UINT8 = 0x21
FIELD_UINT16 = 0x22
FIELD_UINT32 = 0x24
FIELD_UINT64 = 0x28
FIELD_BOOL = 0x31
FIELD_FLOAT = 0x44
FIELD_DOUBLE = 0x48
FIELD_NULL = 0x61
SHORT_MASK = 0x80
FIXED_MASK = 0x0F

_INT_PACK = {
    FIELD_INT8: "<b", FIELD_INT16: "<h", FIELD_INT32: "<i",
    FIELD_INT64: "<q", FIELD_UINT8: "<B", FIELD_UINT16: "<H",
    FIELD_UINT32: "<I", FIELD_UINT64: "<Q",
}


def _encode_field(name: str, value) -> bytes:
    nbytes = name.encode() + b"\x00" if name else b""
    if isinstance(value, bool):
        return bytes([FIELD_BOOL, len(nbytes)]) + nbytes + (b"\x01" if value else b"\x00")
    if isinstance(value, int):
        for t in (FIELD_INT32, FIELD_INT64):
            try:
                packed = struct.pack(_INT_PACK[t], value)
                return bytes([t, len(nbytes)]) + nbytes + packed
            except struct.error:
                continue
        packed = struct.pack("<Q", value)
        return bytes([FIELD_UINT64, len(nbytes)]) + nbytes + packed
    if isinstance(value, float):
        return bytes([FIELD_DOUBLE, len(nbytes)]) + nbytes + struct.pack("<d", value)
    if isinstance(value, str):
        raw = value.encode() + b"\x00"
        if len(raw) <= 255:
            return bytes([FIELD_STRING | SHORT_MASK, len(nbytes),
                          len(raw)]) + nbytes + raw
        return bytes([FIELD_STRING, len(nbytes)]) + struct.pack(
            "<I", len(raw)) + nbytes + raw
    if isinstance(value, (bytes, bytearray)):
        raw = bytes(value)
        if len(raw) <= 255:
            return bytes([FIELD_BINARY | SHORT_MASK, len(nbytes),
                          len(raw)]) + nbytes + raw
        return bytes([FIELD_BINARY, len(nbytes)]) + struct.pack(
            "<I", len(raw)) + nbytes + raw
    if value is None:
        return bytes([FIELD_NULL, len(nbytes)]) + nbytes + b"\x00"
    if isinstance(value, dict):
        items = b"".join(_encode_field(k, v) for k, v in value.items())
        body = struct.pack("<I", len(value)) + items
        return bytes([FIELD_OBJECT, len(nbytes)]) + struct.pack(
            "<I", len(body)) + nbytes + body
    if isinstance(value, (list, tuple)):
        items = b"".join(_encode_field("", v) for v in value)
        body = struct.pack("<I", len(value)) + items
        return bytes([FIELD_ARRAY, len(nbytes)]) + struct.pack(
            "<I", len(body)) + nbytes + body
    raise TypeError(f"mcpack cannot encode {type(value)}")


def dumps(obj: dict) -> bytes:
    """Top-level value is an OBJECT (as mcpack requests are)."""
    if not isinstance(obj, dict):
        raise TypeError("mcpack top-level must be a dict")
    return _encode_field("", obj)


# -- typed serializer primitives (serializer.cpp:29-88's put_* surface) -----
# Generated code (mcpack2pb_gen) calls these so each pb field gets its
# EXACT mcpack wire type, like the reference's generated put_int32/put_str
# calls — the reflective dict path above auto-sizes instead.

def _enc_typed_int(name: str, value: int, ftype: int) -> bytes:
    nbytes = name.encode() + b"\x00" if name else b""
    return bytes([ftype, len(nbytes)]) + nbytes + struct.pack(
        _INT_PACK[ftype], value)


def enc_int32(name: str, v: int) -> bytes:
    return _enc_typed_int(name, v, FIELD_INT32)


def enc_int64(name: str, v: int) -> bytes:
    return _enc_typed_int(name, v, FIELD_INT64)


def enc_uint32(name: str, v: int) -> bytes:
    return _enc_typed_int(name, v, FIELD_UINT32)


def enc_uint64(name: str, v: int) -> bytes:
    return _enc_typed_int(name, v, FIELD_UINT64)


def enc_bool(name: str, v: bool) -> bytes:
    nbytes = name.encode() + b"\x00" if name else b""
    return bytes([FIELD_BOOL, len(nbytes)]) + nbytes + (
        b"\x01" if v else b"\x00")


def enc_float(name: str, v: float) -> bytes:
    nbytes = name.encode() + b"\x00" if name else b""
    return bytes([FIELD_FLOAT, len(nbytes)]) + nbytes + struct.pack("<f", v)


def enc_double(name: str, v: float) -> bytes:
    nbytes = name.encode() + b"\x00" if name else b""
    return bytes([FIELD_DOUBLE, len(nbytes)]) + nbytes + struct.pack("<d", v)


def enc_str(name: str, v: str) -> bytes:
    return _encode_field(name, str(v))


def enc_bytes(name: str, v: bytes) -> bytes:
    return _encode_field(name, bytes(v))


def enc_object(name: str, fields) -> bytes:
    """fields: iterable of already-encoded member field bytes."""
    fields = list(fields)
    items = b"".join(fields)
    nbytes = name.encode() + b"\x00" if name else b""
    body = struct.pack("<I", len(fields)) + items
    return bytes([FIELD_OBJECT, len(nbytes)]) + struct.pack(
        "<I", len(body)) + nbytes + body


def enc_array(name: str, items_encoded) -> bytes:
    items_encoded = list(items_encoded)
    items = b"".join(items_encoded)
    nbytes = name.encode() + b"\x00" if name else b""
    body = struct.pack("<I", len(items_encoded)) + items
    return bytes([FIELD_ARRAY, len(nbytes)]) + struct.pack(
        "<I", len(body)) + nbytes + body


def _decode_field(data: bytes, pos: int) -> Tuple[str, object, int]:
    ftype = data[pos]
    short = bool(ftype & SHORT_MASK)
    base = ftype & ~SHORT_MASK
    name_size = data[pos + 1]
    if base in (FIELD_OBJECT, FIELD_ARRAY, FIELD_STRING, FIELD_BINARY) and not short:
        (value_size,) = struct.unpack_from("<I", data, pos + 2)
        head = 6
    elif short:
        value_size = data[pos + 2]
        head = 3
    else:  # fixed
        value_size = ftype & FIXED_MASK
        head = 2
    name_start = pos + head
    name = data[name_start:name_start + max(0, name_size - 1)].decode(
        "utf-8", "replace") if name_size else ""
    vpos = name_start + name_size
    raw = data[vpos:vpos + value_size]
    end = vpos + value_size
    if base == FIELD_STRING:
        return name, raw[:-1].decode("utf-8", "replace"), end
    if base == FIELD_BINARY:
        return name, bytes(raw), end
    if base == FIELD_BOOL:
        return name, bool(raw[0]), end
    if base in _INT_PACK:
        return name, struct.unpack(_INT_PACK[base], raw)[0], end
    if base == FIELD_DOUBLE:
        return name, struct.unpack("<d", raw)[0], end
    if base == FIELD_FLOAT:
        return name, struct.unpack("<f", raw)[0], end
    if base == FIELD_NULL:
        return name, None, end
    if base in (FIELD_OBJECT, FIELD_ARRAY):
        (count,) = struct.unpack_from("<I", data, vpos)
        ipos = vpos + 4
        if base == FIELD_OBJECT:
            out: Dict[str, object] = {}
            for _ in range(count):
                k, v, ipos = _decode_field(data, ipos)
                out[k] = v
            return name, out, end
        arr = []
        for _ in range(count):
            _, v, ipos = _decode_field(data, ipos)
            arr.append(v)
        return name, arr, end
    raise ValueError(f"unknown mcpack type {ftype:#x}")


def loads(data: bytes) -> dict:
    _, value, _ = _decode_field(data, 0)
    if not isinstance(value, dict):
        raise ValueError("mcpack top-level is not an object")
    return value


# -- protobuf front-end (the mcpack2pb generator's role) --------------------

def pb_to_mcpack(message) -> bytes:
    """Serialize a protobuf message as mcpack (field names as keys)."""
    return dumps(_pb_to_dict(message))


def mcpack_to_pb(data: bytes, message_class):
    """Parse mcpack into a protobuf message by field-name match."""
    obj = loads(data)
    msg = message_class()
    _dict_to_pb(obj, msg)
    return msg


def _pb_to_dict(message) -> dict:
    out = {}
    present = message._has if message.PROTO2 else None
    for _, name, kind, sub in message.FIELDS:
        value = getattr(message, name)
        if kind == MESSAGE:
            if value._present:
                out[name] = _pb_to_dict(value)
        elif kind == REPEATED_MESSAGE:
            if value:
                out[name] = [_pb_to_dict(v) for v in value]
        elif kind in (PACKED_INT64, REPEATED_STRING):
            if value:
                out[name] = list(value)
        elif kind == MAP:
            if value:
                out[name] = {str(k): (_pb_to_dict(v) if sub[1] == MESSAGE
                                      else v) for k, v in value.items()}
        elif (name in present) if present is not None else value:
            out[name] = value
    return out


def _map_from_dict(obj: dict, target, sub):
    key_kind, value_kind, _ = sub
    for k, v in obj.items():
        key = k if key_kind in (STRING, BYTES) else (
            k == "True" if key_kind == BOOL else int(k))
        if value_kind == MESSAGE:
            _dict_to_pb(v, target[key])
        else:
            target[key] = v


def _dict_to_pb(obj: dict, msg):
    for _, name, kind, sub in msg.FIELDS:
        if name not in obj:
            continue
        value = obj[name]
        if kind == REPEATED_MESSAGE:
            target = getattr(msg, name)
            for item in value or []:
                _dict_to_pb(item, target.add())
        elif kind in (PACKED_INT64, REPEATED_STRING):
            getattr(msg, name).extend(value or [])
        elif kind == MAP:
            _map_from_dict(value or {}, getattr(msg, name), sub)
        elif kind == MESSAGE:
            _dict_to_pb(value, getattr(msg, name))
        else:
            setattr(msg, name, value)
