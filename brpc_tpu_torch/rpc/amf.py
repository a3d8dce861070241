"""AMF0 — Action Message Format, the payload of RTMP's command messages.

Port of brpc_tpu/rpc/amf.py, byte-equal to it: the AMF0 types RTMP's
commands use (number, boolean, string, long string, object, ECMA array,
null, undefined, strict array), and the same ``AmfError`` on the same
bad input.

Python mapping: float <-> number, bool <-> boolean, str <-> string,
dict <-> object (ordered), None <-> null, list <-> strict array.
"""
from __future__ import annotations

import struct
from typing import Any, List, Tuple

AMF0_NUMBER = 0x00
AMF0_BOOLEAN = 0x01
AMF0_STRING = 0x02
AMF0_OBJECT = 0x03
AMF0_NULL = 0x05
AMF0_UNDEFINED = 0x06
AMF0_ECMA_ARRAY = 0x08
AMF0_OBJECT_END = 0x09
AMF0_STRICT_ARRAY = 0x0A
AMF0_LONG_STRING = 0x0C


class AmfError(ValueError):
    pass


def _enc_str_body(s: str) -> bytes:
    raw = s.encode("utf-8")
    if len(raw) > 0xFFFF:
        raise AmfError("use long string")
    return struct.pack(">H", len(raw)) + raw


def encode(value: Any) -> bytes:
    """One AMF0 value."""
    if value is None:
        return bytes([AMF0_NULL])
    if isinstance(value, bool):
        return bytes([AMF0_BOOLEAN, 1 if value else 0])
    if isinstance(value, (int, float)):
        return bytes([AMF0_NUMBER]) + struct.pack(">d", float(value))
    if isinstance(value, str):
        raw = value.encode("utf-8")
        if len(raw) > 0xFFFF:
            return (bytes([AMF0_LONG_STRING]) + struct.pack(">I", len(raw))
                    + raw)
        return bytes([AMF0_STRING]) + _enc_str_body(value)
    if isinstance(value, dict):
        out = bytearray([AMF0_OBJECT])
        for k, v in value.items():
            out += _enc_str_body(str(k))
            out += encode(v)
        out += _enc_str_body("")
        out.append(AMF0_OBJECT_END)
        return bytes(out)
    if isinstance(value, (list, tuple)):
        out = bytearray([AMF0_STRICT_ARRAY]) + struct.pack(">I", len(value))
        for v in value:
            out += encode(v)
        return bytes(out)
    raise AmfError(f"unencodable AMF0 value: {type(value).__name__}")


def encode_many(*values: Any) -> bytes:
    return b"".join(encode(v) for v in values)


def _dec_str_body(data: bytes, pos: int) -> Tuple[str, int]:
    if pos + 2 > len(data):
        raise AmfError("truncated string length")
    (n,) = struct.unpack_from(">H", data, pos)
    pos += 2
    if pos + n > len(data):
        raise AmfError("truncated string body")
    return data[pos:pos + n].decode("utf-8", errors="replace"), pos + n


def decode(data: bytes, pos: int = 0) -> Tuple[Any, int]:
    """One AMF0 value; returns (value, next_pos)."""
    if pos >= len(data):
        raise AmfError("truncated value")
    marker = data[pos]
    pos += 1
    if marker == AMF0_NUMBER:
        if pos + 8 > len(data):
            raise AmfError("truncated number")
        (v,) = struct.unpack_from(">d", data, pos)
        return v, pos + 8
    if marker == AMF0_BOOLEAN:
        if pos >= len(data):
            raise AmfError("truncated boolean")
        return data[pos] != 0, pos + 1
    if marker == AMF0_STRING:
        return _dec_str_body(data, pos)
    if marker == AMF0_LONG_STRING:
        if pos + 4 > len(data):
            raise AmfError("truncated long string")
        (n,) = struct.unpack_from(">I", data, pos)
        pos += 4
        if pos + n > len(data):
            raise AmfError("truncated long string body")
        return data[pos:pos + n].decode("utf-8", errors="replace"), pos + n
    if marker in (AMF0_NULL, AMF0_UNDEFINED):
        return None, pos
    if marker in (AMF0_OBJECT, AMF0_ECMA_ARRAY):
        if marker == AMF0_ECMA_ARRAY:
            if pos + 4 > len(data):
                raise AmfError("truncated ecma array")
            pos += 4  # count hint; the end marker is authoritative
        obj = {}
        while True:
            key, pos = _dec_str_body(data, pos)
            if key == "" and pos < len(data) and data[pos] == AMF0_OBJECT_END:
                return obj, pos + 1
            obj[key], pos = decode(data, pos)
    if marker == AMF0_STRICT_ARRAY:
        if pos + 4 > len(data):
            raise AmfError("truncated strict array")
        (n,) = struct.unpack_from(">I", data, pos)
        pos += 4
        arr = []
        for _ in range(n):
            v, pos = decode(data, pos)
            arr.append(v)
        return arr, pos
    raise AmfError(f"unsupported AMF0 marker 0x{marker:02x}")


def decode_all(data: bytes) -> List[Any]:
    out = []
    pos = 0
    while pos < len(data):
        v, pos = decode(data, pos)
        out.append(v)
    return out
