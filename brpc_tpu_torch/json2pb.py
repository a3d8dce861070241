"""json2pb — JSON to and from the port's messages.

Port of brpc_tpu/json2pb.py over the hand-written codec
(``brpc_tpu_torch.rpc.proto.wire``): the port runs where no protobuf
package exists, so it walks ``Message.FIELDS`` where the reference walks
protobuf descriptors. The codec's field kinds are string, int32, int64,
bool, packed int64, message and repeated message, all proto3; for them
the reference's semantics hold:

* proto field names on output; on input the field name or its JSON
  (lowerCamelCase) name;
* int64 written as a JSON number, parsed from a number or a decimal
  string; an integral float is taken, out-of-range values fail with the
  field's path;
* a scalar equal to its default is left out unless
  ``always_print_primitive_fields``; an empty repeated field unless
  ``jsonify_empty_array``; a sub-message when it is not present;
* unknown JSON fields and JSON null are ignored;
* every failure is a ``ParseError`` whose text names the field's path.

The reference's options about bytes and enums are left out: the codec
has no such field.
"""
from __future__ import annotations

import json
from typing import Optional, Type

from brpc_tpu_torch.rpc.proto.wire import (
    BOOL,
    INT32,
    INT64,
    MESSAGE,
    PACKED_INT64,
    REPEATED_MESSAGE,
    STRING,
)


class ParseError(ValueError):
    """Malformed JSON or JSON that cannot map onto the message."""


class Pb2JsonOptions:
    def __init__(self, jsonify_empty_array: bool = False,
                 always_print_primitive_fields: bool = False):
        self.jsonify_empty_array = jsonify_empty_array
        self.always_print_primitive_fields = always_print_primitive_fields


class Json2PbOptions:
    """Accepted where the reference takes it; its options act on bytes
    fields only, so none acts here."""


_INT_RANGES = {
    INT32: (-(1 << 31), (1 << 31) - 1),
    INT64: (-(1 << 63), (1 << 63) - 1),
    PACKED_INT64: (-(1 << 63), (1 << 63) - 1),
}
_DEFAULTS = {STRING: "", INT32: 0, INT64: 0, BOOL: False}


def _json_name(name: str) -> str:
    """protobuf's default json_name: lowerCamelCase of the field name."""
    head, *rest = name.split("_")
    return head + "".join(p[:1].upper() + p[1:] for p in rest)


# -- pb -> json ----------------------------------------------------------------

def _scalar_to_json(kind: str, value):
    if kind == BOOL:
        return bool(value)
    if kind in (INT32, INT64, PACKED_INT64):
        return int(value)
    return value  # string


def _message_to_obj(msg, opts: Pb2JsonOptions) -> dict:
    out = {}
    for _, name, kind, _ in msg.FIELDS:
        value = getattr(msg, name)
        if kind in (PACKED_INT64, REPEATED_MESSAGE):
            if not value and not opts.jsonify_empty_array:
                continue
            out[name] = [_message_to_obj(v, opts) if kind == REPEATED_MESSAGE
                         else _scalar_to_json(kind, v) for v in value]
        elif kind == MESSAGE:
            if msg.HasField(name):
                out[name] = _message_to_obj(value, opts)
        elif value != _DEFAULTS[kind] or opts.always_print_primitive_fields:
            out[name] = _scalar_to_json(kind, value)
    return out


def pb_to_json(message, options: Optional[Pb2JsonOptions] = None) -> str:
    """ProtoMessageToJson (pb_to_json.h)."""
    return json.dumps(_message_to_obj(message, options or Pb2JsonOptions()))


# -- json -> pb ----------------------------------------------------------------

def _parse_int(kind: str, value, path: str) -> int:
    if isinstance(value, bool):
        raise ParseError(f"{path}: expected integer, got bool")
    if isinstance(value, str):
        try:
            value = int(value, 10)  # decimal only, like the reference
        except ValueError:
            raise ParseError(f"{path}: invalid integer string {value!r}")
    if isinstance(value, float):
        if not value.is_integer():
            raise ParseError(f"{path}: expected integer, got {value}")
        value = int(value)
    if not isinstance(value, int):
        raise ParseError(f"{path}: expected integer, got "
                         f"{type(value).__name__}")
    lo, hi = _INT_RANGES[kind]
    if not lo <= value <= hi:
        raise ParseError(f"{path}: {value} out of range [{lo}, {hi}]")
    return value


def _parse_scalar(kind: str, value, path: str):
    if kind == BOOL:
        if isinstance(value, bool):
            return value
        if value in ("true", "True", 1):
            return True
        if value in ("false", "False", 0):
            return False
        raise ParseError(f"{path}: expected bool, got {value!r}")
    if kind in _INT_RANGES:
        return _parse_int(kind, value, path)
    if not isinstance(value, str):
        raise ParseError(f"{path}: expected string, got "
                         f"{type(value).__name__}")
    return value


def _fill_message(obj, msg, path: str):
    if not isinstance(obj, dict):
        raise ParseError(f"{path or '<root>'}: expected JSON object, got "
                         f"{type(obj).__name__}")
    by_json = {_json_name(f[1]): f for f in msg.FIELDS}
    for key, value in obj.items():
        field = msg._BY_NAME.get(key) or by_json.get(key)
        if field is None:
            continue  # unknown fields ignored (the reference's tolerance)
        _, name, kind, _ = field
        fpath = f"{path}.{name}" if path else name
        if value is None:
            continue  # JSON null clears nothing, like the reference
        if kind in (PACKED_INT64, REPEATED_MESSAGE):
            if not isinstance(value, list):
                raise ParseError(f"{fpath}: repeated field expects an array")
            target = getattr(msg, name)
            for i, item in enumerate(value):
                if kind == REPEATED_MESSAGE:
                    _fill_message(item, target.add(), f"{fpath}[{i}]")
                else:
                    target.append(_parse_scalar(kind, item, f"{fpath}[{i}]"))
        elif kind == MESSAGE:
            _fill_message(value, getattr(msg, name), fpath)
        else:
            parsed = _parse_scalar(kind, value, fpath)
            try:
                setattr(msg, name, parsed)
            except (ValueError, TypeError) as e:
                raise ParseError(f"{fpath}: {e}") from e


def json_to_pb(json_text: str, message_class: Type,
               options: Optional[Json2PbOptions] = None):
    """JsonToProtoMessage (json_to_pb.h); raises ParseError on malformed
    input."""
    try:
        obj = json.loads(json_text)
    except json.JSONDecodeError as e:
        raise ParseError(f"invalid JSON: {e}") from e
    msg = message_class()
    _fill_message(obj, msg, "")
    return msg


def json_to_pb_inplace(json_text: str, message,
                       options: Optional[Json2PbOptions] = None) -> bool:
    try:
        obj = json.loads(json_text)
        _fill_message(obj, message, "")
        return True
    except (ParseError, json.JSONDecodeError):
        return False
