"""mcpack2pb code generator: a codec written out for each message.

Port of brpc_tpu/mcpack2pb_gen.py. Given message classes, it emits Python
source with a serializer and a parser per message, each field written
with its exact mcpack type through the typed primitives of mcpack2pb.py
(``enc_int32``, ``enc_str``, ...), plus, for a ``Service``, an nshead
adaptor whose dispatch is unrolled per method. The bytes a generated
codec writes equal those of the reference's generated codec for the
same message.

The reference walks protobuf descriptors; the port has none and walks
the ``FIELDS`` tables of ``rpc/proto/wire.Message`` (nested message
classes are pulled in from their entries). Fields go in the table's
order, which is the field numbers' order; a proto2 scalar is written
when it was set (``HasField``), a proto3 one when it is not its default,
a sub-message when present, a repeated field or a map when not empty (a
map as an mcpack object keyed by ``str(key)``). The generated module
imports ``brpc_tpu_torch.mcpack2pb`` and each message class's own
module, so it imports on its own in a fresh interpreter.

    src = generate_codec_source([wire.EchoRequest])
    module = compile_codec(src, "echo_mcpack")
    data = module.serialize_echo_request(request)

    src = generate_nshead_adaptor_source(EchoService)
    adaptor = compile_codec(src, "echo_adaptor").EchoServiceNsheadAdaptor
    # ServerOptions(nshead_service=adaptor(EchoService()))

``tools/mcpack2pb_gen.py`` is the command line.
"""
from __future__ import annotations

import re
import sys
import types
from typing import Dict, List

from brpc_tpu_torch.rpc.proto.wire import (
    BOOL,
    BYTES,
    ENUM,
    INT32,
    INT64,
    MAP,
    MESSAGE,
    PACKED_INT64,
    REPEATED_MESSAGE,
    REPEATED_STRING,
    SINT32,
    SINT64,
    STRING,
    UINT32,
    UINT64,
)

# field kind -> (mcpack primitive, parse coercion)
_TYPE_MAP = {
    INT32: ("enc_int32", "int"),
    SINT32: ("enc_int32", "int"),
    ENUM: ("enc_int32", "int"),
    INT64: ("enc_int64", "int"),
    SINT64: ("enc_int64", "int"),
    UINT32: ("enc_uint32", "int"),
    UINT64: ("enc_uint64", "int"),
    BOOL: ("enc_bool", "bool"),
    STRING: ("enc_str", "_to_str"),
    BYTES: ("enc_bytes", "_to_bytes"),
}
# a repeated scalar kind -> its element's kind
_REPEATED_SCALAR = {PACKED_INT64: INT64, REPEATED_STRING: STRING}


def _snake(name: str) -> str:
    return re.sub(r"(?<=[a-z0-9])([A-Z])", r"_\1", name).lower()


def _full_name(cls) -> str:
    return cls.FULL_NAME or f"{cls.__module__}.{cls.__qualname__}"


def _defining_module(cls) -> str:
    """An importable module that holds ``cls`` under its name: its own, or
    the longest-named one exposing it."""
    candidates = [n for n, m in list(sys.modules.items())
                  if m is not None and n != "__main__"
                  and getattr(m, cls.__name__, None) is cls]
    return max(candidates, key=len) if candidates else ""


def _collect_and_name(message_classes):
    """Every message class reached (nested ones too), each with a unique
    symbol stem: its snake name, or its full name's when two share one."""
    seen: Dict[str, type] = {}

    def collect(cls):
        if _full_name(cls) in seen:
            return
        seen[_full_name(cls)] = cls
        for _, _, kind, sub in cls.FIELDS:
            if kind in (MESSAGE, REPEATED_MESSAGE):
                collect(sub)
            elif kind == MAP and sub[1] == MESSAGE:
                collect(sub[2])

    for cls in message_classes:
        collect(cls)
    names, taken = {}, set()
    for full_name, cls in seen.items():
        stem = _snake(cls.__name__)
        if stem in taken:
            stem = _snake(full_name.replace(".", "_"))
        taken.add(stem)
        names[full_name] = stem
    return seen, names


def _emit_serializer(lines: List[str], cls, fn_name: str, names):
    lines.append(f"def {fn_name}(msg):")
    lines.append(f'    """Serialize {_full_name(cls)} as mcpack '
                 '(generated)."""')
    lines.append("    fields = []")
    for _, name, kind, sub in cls.FIELDS:
        if kind == MAP:
            key_kind, value_kind, value_cls = sub
            if value_kind == MESSAGE:
                inner = f"serialize_{names[_full_name(value_cls)]}_fields"
                item = f"mp.enc_object(str(k), {inner}(v))"
            else:
                item = f"mp.{_TYPE_MAP[value_kind][0]}(str(k), v)"
            lines.append(f"    if msg.{name}:")
            lines.append(f"        fields.append(mp.enc_object({name!r}, "
                         f"[{item} for k, v in msg.{name}.items()]))")
        elif kind in (MESSAGE, REPEATED_MESSAGE):
            inner = f"serialize_{names[_full_name(sub)]}_fields"
            if kind == REPEATED_MESSAGE:
                lines.append(f"    if msg.{name}:")
                lines.append(
                    f"        fields.append(mp.enc_array({name!r}, "
                    f"[mp.enc_object('', {inner}(v)) for v in msg.{name}]))")
            else:
                lines.append(f"    if msg.HasField({name!r}):")
                lines.append(f"        fields.append(mp.enc_object({name!r}, "
                             f"{inner}(msg.{name})))")
        elif kind in _REPEATED_SCALAR:
            enc = _TYPE_MAP[_REPEATED_SCALAR[kind]][0]
            lines.append(f"    if msg.{name}:")
            lines.append(f"        fields.append(mp.enc_array({name!r}, "
                         f"[mp.{enc}('', v) for v in msg.{name}]))")
        else:
            gate = (f"msg.HasField({name!r})" if cls.PROTO2
                    else f"msg.{name}")
            lines.append(f"    if {gate}:")
            lines.append(f"        fields.append(mp.{_TYPE_MAP[kind][0]}("
                         f"{name!r}, msg.{name}))")
    lines += ["    return fields", "", ""]


def _emit_parser(lines: List[str], cls, fn_name: str, cls_expr: str, names):
    lines.append(f"def {fn_name}_into(obj, msg):")
    lines.append(f'    """Fill a {_full_name(cls)} from a decoded mcpack '
                 'object (generated)."""')
    for _, name, kind, sub in cls.FIELDS:
        lines.append(f"    v = obj.get({name!r})")
        lines.append("    if v is not None:")
        if kind == MAP:
            key_kind, value_kind, value_cls = sub
            kcoerce = ("_bool_key" if key_kind == BOOL
                       else _TYPE_MAP[key_kind][1])
            lines.append("        for k, item in v.items():")
            if value_kind == MESSAGE:
                inner = f"parse_{names[_full_name(value_cls)]}_into"
                lines.append(f"            {inner}(item, msg.{name}"
                             f"[{kcoerce}(k)])")
            else:
                lines.append(f"            msg.{name}[{kcoerce}(k)] = "
                             f"{_TYPE_MAP[value_kind][1]}(item)")
        elif kind in (MESSAGE, REPEATED_MESSAGE):
            inner = f"parse_{names[_full_name(sub)]}_into"
            if kind == REPEATED_MESSAGE:
                lines.append("        for item in v:")
                lines.append(f"            {inner}(item, msg.{name}.add())")
            else:
                lines.append(f"        {inner}(v, msg.{name})")
        elif kind in _REPEATED_SCALAR:
            coerce = _TYPE_MAP[_REPEATED_SCALAR[kind]][1]
            lines.append(f"        msg.{name}.extend({coerce}(x) for x in v)")
        else:
            lines.append(f"        msg.{name} = {_TYPE_MAP[kind][1]}(v)")
    lines += ["    return msg", "", ""]
    lines.append(f"def {fn_name}(data):")
    lines.append(f"    return {fn_name}_into(mp.loads(data), {cls_expr}())")
    lines += ["", ""]


_PRELUDE = '''\
"""GENERATED by brpc_tpu_torch.mcpack2pb_gen: do not edit.
A codec per message, in mcpack."""
from brpc_tpu_torch import mcpack2pb as mp


def _to_str(v):
    return v if isinstance(v, str) else bytes(v).decode()


def _to_bytes(v):
    return v.encode() if isinstance(v, str) else bytes(v)


def _bool_key(v):
    return v == "True" if isinstance(v, str) else bool(v)


'''


def generate_codec_source(message_classes) -> str:
    """A module with serialize_<msg> and parse_<msg> for each message
    class and every message class it holds."""
    seen, names = _collect_and_name(message_classes)
    lines = [_PRELUDE]
    files = sorted({c.PROTO_FILE for c in seen.values() if c.PROTO_FILE})
    lines.append(f"# sources: {', '.join(files)}")
    modules = {}
    for full_name, cls in seen.items():
        module = _defining_module(cls)
        if not module:
            raise ValueError(f"{cls.__qualname__} is in no importable module")
        modules[full_name] = module
    for module in sorted(set(modules.values())):
        lines.append(f"import {module}  # noqa: F401")
    for full_name, cls in seen.items():
        lines.append(f"_cls_{names[full_name]} = "
                     f"{modules[full_name]}.{cls.__name__}")
    lines += ["", ""]
    body: List[str] = []
    for full_name, cls in seen.items():
        sn = names[full_name]
        _emit_serializer(body, cls, f"serialize_{sn}_fields", names)
        body.append(f"def serialize_{sn}(msg):")
        body.append(f"    return mp.enc_object('', serialize_{sn}_fields(msg))")
        body += ["", ""]
        _emit_parser(body, cls, f"parse_{sn}", f"_cls_{sn}", names)
    return "\n".join(lines) + "\n".join(body)


def generate_nshead_adaptor_source(service_class) -> str:
    """A codec module plus an ``NsheadService`` adaptor for a Service: a
    body is an mcpack object with a ``method`` member and the request's
    fields; the reply is the response's object."""
    methods = service_class.methods()
    message_classes = []
    for minfo in methods.values():
        message_classes += [minfo.request_class, minfo.response_class]
    src = generate_codec_source(message_classes)
    _, names = _collect_and_name(message_classes)
    name = re.sub(r"\W", "_", service_class.__name__)
    lines = [
        "",
        "",
        "from brpc_tpu_torch.rpc.nshead_protocol import NsheadMessage, "
        "NsheadService",
        "",
        "",
        f"class {name}NsheadAdaptor(NsheadService):",
        f'    """Generated front end of {name} over nshead and mcpack."""',
        "",
        "    def __init__(self, service):",
        "        self.service = service",
        "",
        "    def process_nshead_request(self, cntl, request, done):",
        "        try:",
        "            obj = mp.loads(request.body)",
        "        except (ValueError, IndexError, KeyError) as e:",
        "            done(NsheadMessage(('bad mcpack body: %s' % e)"
        ".encode()))",
        "            return",
        "        method = obj.get('method')",
        "        if isinstance(method, bytes):",
        "            method = method.decode()",
    ]
    for i, (mname, minfo) in enumerate(sorted(methods.items())):
        req_sn = names[_full_name(minfo.request_class)]
        resp_sn = names[_full_name(minfo.response_class)]
        cond = "if" if i == 0 else "elif"
        default = " or method is None" if len(methods) == 1 else ""
        lines += [
            f"        {cond} method == {mname!r}{default}:",
            f"            req = parse_{req_sn}_into(obj, _cls_{req_sn}())",
            f"            resp = _cls_{resp_sn}()",
            "            def _done(resp=resp):",
            f"                body = mp.enc_object('', "
            f"serialize_{resp_sn}_fields(resp))",
            "                done(NsheadMessage(body, "
            "log_id=request.log_id))",
            f"            self.service.{mname}(cntl, req, resp, _done)",
        ]
    lines += [
        "        else:",
        "            done(NsheadMessage(b'unknown method'))",
        "",
    ]
    return src + "\n".join(lines)


def compile_codec(source: str, module_name: str):
    """Execute generated source into a new module object."""
    module = types.ModuleType(module_name)
    exec(compile(source, f"<generated {module_name}>", "exec"),
         module.__dict__)
    return module
