"""The port's pb-rpc family and key-value protocols held against
brpc_tpu's, on the CPU.

* Codecs, exact: the hulu and sofa metas against ``legacy_meta_pb2``
  (proto2 presence, the sint64, uint64, bytes and enum fields, required
  fields); hulu and sofa request frames; RESP commands, replies and
  their parse; memcache packets and the store's answers; thrift
  messages; mcpack ``dumps``/``loads``, the typed primitives,
  ``pb_to_mcpack``/``mcpack_to_pb``; the nshead header.
* Live, on one port server and one reference server (module fixtures),
  each answering hulu, sofa, redis, memcache, thrift and nshead (an
  mcpack adaptor over the Echo service) beside tpu_std: every protocol
  both ways on one connection, the port's one port also over HTTP, h2
  and a raw redis PING, each protocol's first frame sent one byte at a
  time (mongo's and esp's too: the port server has a mongo adaptor and an
  esp service beside the others), pipelined calls from 8 threads on one connection (redis,
  memcache, nshead), 1 MiB values, errors (ENOMETHOD, ENOSERVICE, the
  thrift exception, a redis error reply), hulu and sofa compressed with
  each codec, the Echo calls counted on the method's status, a client
  connection matched to its protocol again after a revival, and the
  nshead adaptor in the reference's handler form.
* Kept mismatches, pinned on both packages: a hulu method index resolves
  by declaration order in the port and by sorted name in the reference
  (ROADMAP queue C #25); a thrift frame whose first read ends at its
  fifth byte (#27).
* The four example twins against the reference's scripts.

Threads only, no spawned process; every wait has a deadline.
"""
import contextlib
import http.client
import io
import json
import os
import re
import runpy
import socket as pysocket
import struct
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from brpc_tpu import mcpack2pb as ref_mcpack
from brpc_tpu import native as ref_native
from brpc_tpu import rpc as ref_rpc
from brpc_tpu.bthread import get_task_control as ref_get_task_control
from brpc_tpu.butil.iobuf import IOBuf as RefIOBuf
from brpc_tpu.bvar import native_vars as ref_native_vars
from brpc_tpu.rpc import hulu_protocol as ref_hulu
from brpc_tpu.rpc import memcache as ref_memcache
from brpc_tpu.rpc import nshead_protocol as ref_nshead
from brpc_tpu.rpc import redis as ref_redis
from brpc_tpu.rpc import sofa_protocol as ref_sofa
from brpc_tpu.rpc import thrift as ref_thrift
from brpc_tpu.rpc import thrift_protocol as ref_thrift_protocol
from brpc_tpu.rpc.controller import Controller as RefController
from brpc_tpu.rpc.proto import echo_pb2, legacy_meta_pb2
from brpc_tpu_torch import native as port_native
from brpc_tpu_torch import mcpack2pb
from brpc_tpu_torch import rpc
from brpc_tpu_torch.butil.iobuf import IOBuf
from brpc_tpu_torch.examples import (
    legacy_pbrpc_echo,
    memcache_kv,
    redis_kv,
    thrift_echo,
)
from brpc_tpu_torch.rpc import errors, esp_protocol, mongo
from brpc_tpu_torch.rpc import hulu_protocol as hulu
from brpc_tpu_torch.rpc import memcache
from brpc_tpu_torch.rpc import memcache_protocol
from brpc_tpu_torch.rpc import nshead_protocol as nshead
from brpc_tpu_torch.rpc import redis
from brpc_tpu_torch.rpc import redis_protocol
from brpc_tpu_torch.rpc import sofa_protocol as sofa
from brpc_tpu_torch.rpc import thrift
from brpc_tpu_torch.rpc import thrift_protocol
from brpc_tpu_torch.rpc.proto import legacy_meta, wire
from brpc_tpu_torch.rpc.protocol import ParseResult

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT_S = 3.0
ECHO = "EchoService.Echo"
PROTOCOLS = ("hulu_pbrpc", "sofa_pbrpc", "redis", "memcache", "thrift",
             "nshead")
# the port server also speaks the weak- and no-magic mongo and esp, so
# every first frame below is read beside them
FIRST_FRAMES = PROTOCOLS + ("mongo", "esp")

# -- codecs ------------------------------------------------------------------


def _value(rng, kind, sub):
    if kind == wire.STRING:
        return ["", "x", "EchoService", "é" * 3][int(rng.integers(4))]
    if kind == wire.BYTES:
        return rng.integers(0, 256, int(rng.integers(0, 5)),
                            dtype=np.uint8).tobytes()
    if kind == wire.BOOL:
        return bool(rng.integers(2))
    if kind == wire.ENUM:
        return sorted(sub)[int(rng.integers(len(sub)))]
    if kind == wire.UINT64:
        return [0, 1, (1 << 64) - 1, 1 << 40][int(rng.integers(4))]
    if kind == wire.INT32:
        return [0, 1, -1, (1 << 31) - 1, -(1 << 31)][int(rng.integers(5))]
    return [0, 1, -1, (1 << 63) - 1, -(1 << 63), 123456789][
        int(rng.integers(6))]


@pytest.mark.parametrize("name", ["HuluRpcRequestMeta", "HuluRpcResponseMeta",
                                  "SofaRpcMeta"])
def test_legacy_metas_are_protobufs(name):
    """Seeded field sets, defaults included: the same bytes as protobuf,
    or the same refusal of a missing required field; each parses the
    other's bytes to the same values and the same presence."""
    ours, ref = getattr(legacy_meta, name), getattr(legacy_meta_pb2, name)
    rng = np.random.default_rng(12)
    refused = 0
    for _ in range(150):
        a, b = ours(), ref()
        for _, field, kind, sub in ours.FIELDS:
            if rng.random() < 0.5:
                v = _value(rng, kind, sub)
                setattr(a, field, v)
                setattr(b, field, v)
        try:
            want = b.SerializeToString()
        except Exception:
            refused += 1
            with pytest.raises(wire.EncodeError, match="missing required"):
                a.SerializeToString()
            continue
        assert a.SerializeToString() == want
        c, d = ours(), ref()
        c.ParseFromString(want)
        d.ParseFromString(a.SerializeToString())
        for _, field, _, _ in ours.FIELDS:
            assert getattr(c, field) == getattr(d, field) == getattr(b, field)
            assert c.HasField(field) == d.HasField(field) == b.HasField(field)
    assert (refused > 0) == (name != "HuluRpcResponseMeta")


def test_legacy_meta_field_kinds():
    """bytes stay bytes and refuse str; sint64 zigzags; uint64 takes the
    full range; an enum refuses what it lacks and a parse drops it."""
    a, b = legacy_meta.HuluRpcResponseMeta(), legacy_meta_pb2.HuluRpcResponseMeta()
    for m in (a, b):
        m.correlation_id = -5
        m.user_data = b"\xff\x00"
    assert a.SerializeToString() == b.SerializeToString() == b"\x18\x09:\x02\xff\x00"
    c = legacy_meta.HuluRpcResponseMeta()
    c.ParseFromString(b.SerializeToString())
    assert type(c.user_data) is bytes and c.correlation_id == -5
    with pytest.raises(TypeError):
        a.user_data = "text"
    with pytest.raises(TypeError):
        b.user_data = "text"
    s, t = legacy_meta.SofaRpcMeta(), legacy_meta_pb2.SofaRpcMeta()
    for m in (s, t):
        m.type = m.RESPONSE
        m.sequence_id = (1 << 64) - 1
        m.compress_type = legacy_meta.SOFA_COMPRESS_TYPE_SNAPPY
    assert s.SerializeToString() == t.SerializeToString()
    with pytest.raises(ValueError):
        s.compress_type = 9
    with pytest.raises(ValueError):
        t.compress_type = 9
    with pytest.raises(ValueError):
        s.sequence_id = 1 << 64
    # field 300 carrying 9, unknown to the enum: dropped by both
    raw = t.SerializeToString() + b"\xe0\x12\x09"
    u, v = legacy_meta.SofaRpcMeta(), legacy_meta_pb2.SofaRpcMeta()
    u.ParseFromString(raw)
    v.ParseFromString(raw)
    assert u.compress_type == v.compress_type == 3


@pytest.mark.parametrize("ctype", [0, 1, 2, 3])
@pytest.mark.parametrize("mods", [(hulu, ref_hulu), (sofa, ref_sofa)],
                         ids=["hulu", "sofa"])
def test_request_frames_are_the_references(mods, ctype):
    frames = []
    for ctl_cls, mod in ((rpc.Controller, mods[0]), (RefController, mods[1])):
        cntl = ctl_cls()
        cntl._method_full_name = ECHO
        cntl.log_id, cntl.trace_id, cntl.span_id = 77, 5, 6
        cntl.compress_type = ctype
        cntl.request_attachment.append(b"att")
        frames.append(bytes(mod.pack_request(b"payload " * 40, cntl,
                                             (3 << 32) | 9).to_bytes()))
    assert frames[0] == frames[1]


def _reply(rng, depth=0):
    k = int(rng.integers(0, 6 if depth < 2 else 5))
    if k == 0:
        return "status", "OK" * int(rng.integers(0, 3))
    if k == 1:
        return "error", "ERR x"
    if k == 2:
        return "integer", int(rng.integers(-1 << 40, 1 << 40))
    if k == 3:
        return "string", rng.integers(0, 256, int(rng.integers(0, 40)),
                                      dtype=np.uint8).tobytes()
    if k == 4:
        return "nil", None
    return "array", [_reply(rng, depth + 1)
                     for _ in range(int(rng.integers(0, 4)))]


def _build(mod, spec):
    kind, value = spec
    if kind == "array":
        return mod.RedisReply.array([_build(mod, s) for s in value])
    if kind == "nil":
        return mod.RedisReply.nil()
    return getattr(mod.RedisReply, kind)(value)


def _flat(r):
    return (r.kind, [_flat(x) for x in r.value] if r.kind == "array"
            else r.value)


@pytest.mark.parametrize("seed", range(4))
def test_resp_codec(seed):
    rng = np.random.default_rng(seed)
    for _ in range(20):
        args = tuple(rng.integers(0, 256, int(rng.integers(0, 9)),
                                  dtype=np.uint8).tobytes()
                     if rng.random() < 0.5 else int(rng.integers(-99, 99))
                     for _ in range(int(rng.integers(1, 5))))
        assert redis.encode_command(args) == ref_redis.encode_command(args)
        spec = _reply(rng)
        enc = _build(redis, spec).encode()
        assert enc == _build(ref_redis, spec).encode()
        ours, end = redis.parse_reply(bytearray(enc), 0)
        theirs, ref_end = ref_redis.parse_reply(enc, 0)
        assert end == ref_end == len(enc)
        assert _flat(ours) == _flat(theirs)
        assert redis.parse_reply(enc[:-1], 0) is None
        assert ref_redis.parse_reply(enc[:-1], 0) is None
    req, ref_req = redis.RedisRequest(), ref_redis.RedisRequest()
    for r in (req, ref_req):
        r.add_command("SET k v")
        r.add_command("GET", "k")
    assert req.serialize() == ref_req.serialize()


def _memcache_ops(mod):
    return (mod.MemcacheRequest().set("a", "1", flags=7).get("a")
            .add("a", "2").replace("b", "3").incr("n", 5, initial=2)
            .incr("n", 5).decr("n", 100).delete("a").get("a").version())


def test_memcache_codec():
    ours, theirs = _memcache_ops(memcache), _memcache_ops(ref_memcache)
    assert ours.serialize() == theirs.serialize()
    svc, ref_svc = memcache.MemcacheService(), ref_memcache.MemcacheService()
    data, pos, ref_pos = ours.serialize(), 0, 0
    while pos < len(data):
        op, pos = memcache.parse_op(data, pos)
        ref_op, ref_pos = ref_memcache.parse_op(data, ref_pos)
        assert (op, pos) == (ref_op, ref_pos)
        assert svc.handle(op) == ref_svc.handle(ref_op)
    assert memcache.parse_op(data[:30], 0) is None


def _struct(rng, depth=0):
    out = {}
    for fid in rng.choice(40, int(rng.integers(0, 6)), replace=False):
        k = int(rng.integers(0, 9 if depth < 2 else 8))
        t = [thrift.T_BOOL, thrift.T_BYTE, thrift.T_DOUBLE, thrift.T_I16,
             thrift.T_I32, thrift.T_I64, thrift.T_STRING, thrift.T_LIST,
             thrift.T_STRUCT][k]
        if t == thrift.T_STRUCT:
            v = _struct(rng, depth + 1)
        elif t == thrift.T_LIST:
            v = (thrift.T_I32, [int(x) for x in rng.integers(-9, 9, 3)])
        elif t == thrift.T_STRING:
            v = rng.integers(0, 256, int(rng.integers(0, 9)),
                             dtype=np.uint8).tobytes()
        elif t == thrift.T_DOUBLE:
            v = float(rng.standard_normal())
        elif t == thrift.T_BOOL:
            v = bool(rng.integers(2))
        else:
            v = int(rng.integers(-100, 100))
        out[int(fid)] = (t, v)
    return out


@pytest.mark.parametrize("seed", range(3))
def test_thrift_codec(seed):
    rng = np.random.default_rng(seed)
    for i in range(12):
        body = _struct(rng)
        msg = thrift.pack_message(f"M{i}", thrift.MSG_CALL, i * 7, body)
        assert msg == ref_thrift.pack_message(f"M{i}", ref_thrift.MSG_CALL,
                                              i * 7, body)
        assert (thrift.unpack_message(msg[4:])
                == ref_thrift.unpack_message(msg[4:])
                == (f"M{i}", thrift.MSG_CALL, i * 7, body))


MCPACK_OBJECTS = [
    {"int": 42, "negative": -7, "big": 1 << 40, "huge": (1 << 64) - 1,
     "float": 2.5, "string": "hello", "binary": b"\x00\x01", "flag": True,
     "none": None},
    {"nested": {"a": 1, "b": "two"}, "list": [1, 2, 3],
     "objlist": [{"x": 1}, {"x": 2}], "longstr": "y" * 1000,
     "bigbin": b"z" * 1000},
]


def test_mcpack_codec():
    for obj in MCPACK_OBJECTS:
        enc = mcpack2pb.dumps(obj)
        assert enc == ref_mcpack.dumps(obj)
        assert mcpack2pb.loads(enc) == ref_mcpack.loads(enc) == obj
    for fn, v in (("enc_int32", -3), ("enc_int64", 1 << 40),
                  ("enc_uint32", 7), ("enc_uint64", 1 << 63),
                  ("enc_bool", True), ("enc_float", 0.5),
                  ("enc_double", 2.25), ("enc_str", "s"),
                  ("enc_bytes", b"b")):
        assert getattr(mcpack2pb, fn)("f", v) == getattr(ref_mcpack, fn)("f", v)
    assert (mcpack2pb.enc_object("o", [mcpack2pb.enc_int32("i", 1)])
            == ref_mcpack.enc_object("o", [ref_mcpack.enc_int32("i", 1)]))
    for kw in ({}, {"message": "mc"}, {"message": "mc", "code": 7},
               {"sleep_us": -1}):
        enc = mcpack2pb.pb_to_mcpack(wire.EchoRequest(**kw))
        assert enc == ref_mcpack.pb_to_mcpack(echo_pb2.EchoRequest(**kw))
        back = mcpack2pb.mcpack_to_pb(enc, wire.EchoRequest)
        assert back.SerializeToString() == ref_mcpack.mcpack_to_pb(
            enc, echo_pb2.EchoRequest).SerializeToString()
    meta = legacy_meta.HuluRpcResponseMeta(error_code=0, user_data=b"u")
    ref_meta = legacy_meta_pb2.HuluRpcResponseMeta(error_code=0, user_data=b"u")
    assert (mcpack2pb.pb_to_mcpack(meta) == ref_mcpack.pb_to_mcpack(ref_meta))


def test_nshead_header():
    msg = nshead.NsheadMessage(b"body", id_=3, version=2, log_id=99,
                               reserved=5)
    ref = ref_nshead.NsheadMessage(b"body", id_=3, version=2, log_id=99,
                                   reserved=5)
    assert msg.serialize() == ref.serialize()
    assert len(msg.head()) == nshead.HEAD_SIZE == 36
    r = nshead.parse(IOBuf(ref.serialize()), None, False, None)
    got = r.message.msg
    assert (got.body, got.id, got.version, got.log_id, got.reserved,
            got.provider) == (b"body", 3, 2, 99, 5, b"brpc_tpu")
    short = IOBuf(ref.serialize()[:28])
    assert nshead.parse(short, None, False, None).status == \
        ParseResult.NOT_ENOUGH_DATA
    bad = bytearray(ref.serialize())
    bad[24] ^= 1
    assert nshead.parse(IOBuf(bytes(bad[:30])), None, False,
                        None).status == ParseResult.TRY_OTHERS


def test_thrift_first_read_at_the_fifth_byte():
    """ROADMAP queue C #27: the first five bytes of a thrift frame; the
    reference gives them up, the port waits for the rest."""
    frame = thrift.pack_message("E", thrift.MSG_CALL, 5, {})
    assert ref_thrift_protocol.parse(RefIOBuf(frame[:5]), None, False,
                                     None).error.name == "TRY_OTHERS"
    for n in range(1, len(frame)):
        assert thrift_protocol.parse(IOBuf(frame[:n]), None, False,
                                     None).status == ParseResult.NOT_ENOUGH_DATA
    assert thrift_protocol.parse(IOBuf(b"\x00\x00\x00\x12\x81"), None, False,
                                 None).status == ParseResult.TRY_OTHERS


# -- live --------------------------------------------------------------------

class PortEcho(rpc.Service):
    SERVICE_NAME = "EchoService"

    @rpc.rpc_method(wire.EchoRequest, wire.EchoResponse)
    def Echo(self, cntl, request, response, done):
        if request.code:
            cntl.set_failed(request.code, "requested failure")
        response.message = request.message
        done()


class RefEcho(ref_rpc.Service):
    SERVICE_NAME = "EchoService"

    @ref_rpc.rpc_method(echo_pb2.EchoRequest, echo_pb2.EchoResponse)
    def Echo(self, cntl, request, response, done):
        if request.code:
            cntl.set_failed(request.code, "requested failure")
        response.message = request.message
        done()


def _order_service(pkg, req, resp):
    """Methods declared Zeta then Alpha: hulu's index 0 is Zeta by
    declaration, Alpha by name."""

    class OrderService(pkg.Service):
        @pkg.rpc_method(req, resp)
        def Zeta(self, cntl, request, response, done):
            response.message = "zeta"
            done()

        @pkg.rpc_method(req, resp)
        def Alpha(self, cntl, request, response, done):
            response.message = "alpha"
            done()

    return OrderService()


def _thrift_service(mod):
    svc = mod.ThriftService()
    svc.add_method("Echo", lambda body: {0: body.get(1, (mod.T_STRING, b""))})
    return svc


class _PingAdaptor(mongo.MongoServiceAdaptor):
    def process_mongo_request(self, cntl, request, response, done):
        response.documents = [{"ok": 1.0 if "ping" in (request.query or {})
                               else 0.0}]
        done()


PORT = SimpleNamespace(rpc=rpc, redis=redis, memcache=memcache, thrift=thrift,
                       nshead=nshead, mcpack=mcpack2pb, Req=wire.EchoRequest,
                       Resp=wire.EchoResponse)
REF = SimpleNamespace(rpc=ref_rpc, redis=ref_redis, memcache=ref_memcache,
                      thrift=ref_thrift, nshead=ref_nshead, mcpack=ref_mcpack,
                      Req=echo_pb2.EchoRequest, Resp=echo_pb2.EchoResponse)


@pytest.fixture(scope="module")
def servers():
    ref_get_task_control()  # the reference's bthread pool, sized first
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BRPC_TPU_FABRIC", "0")
        mp.setattr(ref_native_vars, "native_status_lines", lambda: [])
        mp.setattr(ref_native, "available", lambda: False)
        # and the port's pages show no native section, whether or not
        # an earlier test of this process loaded the port's library
        mp.setattr(port_native, "is_loaded", lambda: False)
        port = rpc.Server(rpc.ServerOptions(
            num_threads=4, device="cpu",
            redis_service=redis.DictRedisService(),
            memcache_service=memcache.MemcacheService(),
            thrift_service=_thrift_service(thrift),
            nshead_service=nshead.NsheadPbServiceAdaptor.for_method(ECHO),
            mongo_service_adaptor=_PingAdaptor(),
            esp_service=esp_protocol.EspService()))
        port.add_service(PortEcho())
        port.add_service(_order_service(rpc, wire.EchoRequest,
                                        wire.EchoResponse))
        assert port.start("127.0.0.1:0") == 0

        def ref_echo(cntl, request, response):
            response.message = request.message

        ref = ref_rpc.Server(ref_rpc.ServerOptions(
            num_threads=4, has_builtin_services=False,
            redis_service=ref_redis.DictRedisService(),
            memcache_service=ref_memcache.MemcacheService(),
            thrift_service=_thrift_service(ref_thrift),
            nshead_service=ref_nshead.NsheadPbServiceAdaptor(
                echo_pb2.EchoRequest, echo_pb2.EchoResponse, ref_echo)))
        ref.add_service(RefEcho())
        ref.add_service(_order_service(ref_rpc, echo_pb2.EchoRequest,
                                       echo_pb2.EchoResponse))
        assert ref.start("127.0.0.1:0") == 0
        yield {"port": port, "ref": ref}
        ref.stop()
        port.stop()


def _channel(pkg, protocol, target):
    ch = pkg.rpc.Channel(pkg.rpc.ChannelOptions(
        protocol=protocol, timeout_ms=WAIT_S * 1000))
    assert ch.init(str(target)) == 0
    return ch


def _call(pkg, ch, protocol, tag: str, **kw):
    """One call of ``protocol`` on ``ch``; (controller, the answer's text).
    Echo answers ``tag``; redis and memcache store ``tag`` upper-cased
    under ``tag`` and read it back."""
    cntl = pkg.rpc.Controller()
    cntl.timeout_ms = WAIT_S * 1000
    for k, v in kw.items():
        setattr(cntl, k, v)
    if protocol in ("hulu_pbrpc", "sofa_pbrpc"):
        resp = pkg.Resp()
        ch.call_method(ECHO, cntl, pkg.Req(message=tag), resp)
        return cntl, resp.message
    if protocol == "redis":
        req, resp = pkg.redis.RedisRequest(), pkg.redis.RedisResponse()
        req.add_command("SET", tag, tag.upper())
        req.add_command("GET", tag)
        ch.call_method("redis", cntl, req, resp)
        return cntl, (resp.reply(1).value.decode()
                      if resp.reply_count == 2 else None)
    if protocol == "memcache":
        resp = pkg.memcache.MemcacheResponse()
        ch.call_method("memcache", cntl, pkg.memcache.MemcacheRequest()
                       .set(tag, tag.upper()).get(tag), resp)
        ok = resp.pop_set()
        got, value = resp.pop_get()
        return cntl, value.decode() if ok and got else None
    if protocol == "thrift":
        resp = pkg.thrift.ThriftMessage()
        ch.call_method("thrift", cntl, pkg.thrift.ThriftMessage(
            "Echo", {1: (pkg.thrift.T_STRING, tag.encode())}), resp)
        return cntl, resp.body.get(0, (0, b""))[1].decode()
    resp = pkg.nshead.NsheadMessage()
    ch.call_method("nshead", cntl, pkg.nshead.NsheadMessage(
        pkg.mcpack.pb_to_mcpack(pkg.Req(message=tag))), resp)
    return cntl, pkg.mcpack.mcpack_to_pb(resp.body, pkg.Resp).message


def _want(protocol, tag):
    return tag.upper() if protocol in ("redis", "memcache") else tag


@pytest.mark.parametrize("direction", ["port_to_ref", "ref_to_port"])
@pytest.mark.parametrize("protocol", PROTOCOLS)
def test_interop_on_one_connection(servers, protocol, direction):
    pkg, server = ((PORT, servers["ref"]) if direction == "port_to_ref"
                   else (REF, servers["port"]))
    ch = _channel(pkg, protocol, server.listen_endpoint)
    try:
        for i in range(3):
            cntl, got = _call(pkg, ch, protocol, f"{direction}-{i}")
            assert not cntl.failed(), cntl.error_text
            assert got == _want(protocol, f"{direction}-{i}")
    finally:
        ch.close()


def test_one_port_answers_every_protocol(servers):
    srv = servers["port"]
    ep, port = srv.listen_endpoint, srv.listen_endpoint.port
    for protocol in ("tpu_std", "h2:grpc", "hulu_pbrpc", "sofa_pbrpc"):
        ch = _channel(PORT, protocol, ep)
        cntl, resp = ch.call(ECHO, wire.EchoRequest(message=protocol),
                             wire.EchoResponse)
        ch.close()
        assert not cntl.failed() and resp.message == protocol, cntl.error_text
    for protocol in ("redis", "memcache", "thrift", "nshead"):
        ch = _channel(PORT, protocol, ep)
        cntl, got = _call(PORT, ch, protocol, f"one-{protocol}")
        ch.close()
        assert not cntl.failed(), cntl.error_text
        assert got == _want(protocol, f"one-{protocol}")
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=WAIT_S)
    conn.request("POST", "/EchoService/Echo",
                 body=json.dumps({"message": "http"}),
                 headers={"Content-Type": "application/json"})
    assert json.loads(conn.getresponse().read())["message"] == "http"
    conn.close()
    with pysocket.create_connection(("127.0.0.1", port), timeout=WAIT_S) as s:
        s.sendall(redis.encode_command(("PING",)))
        assert s.recv(64) == b"+PONG\r\n"


def _echo_text(payload: bytes) -> str:
    resp = wire.EchoResponse()
    resp.ParseFromString(payload)
    return resp.message


def _mongo_reply_parse(portal, sock, read_eof, arg):
    """A whole OP_REPLY, as bytes."""
    if len(portal) < mongo.HEAD_SIZE:
        return ParseResult.not_enough()
    head = mongo.MongoHead.unpack(bytes(portal.copy_to_bytes(16)))
    if len(portal) < head.message_length:
        return ParseResult.not_enough()
    return ParseResult.ok(bytes(portal.cutn_bytes(head.message_length)))


def _mongo_ping() -> bytes:
    body = (struct.pack("<i", 0) + b"admin.$cmd\x00" + struct.pack("<ii", 0, 1)
            + mongo.bson_encode({"ping": 1}))
    return mongo.MongoHead(mongo.HEAD_SIZE + len(body), 7, 0,
                           mongo.OP_QUERY).pack() + body


def _first_frames():
    """Each protocol's first request frame, its parse, and a check of the
    answer."""
    hm = legacy_meta.HuluRpcRequestMeta(service_name="EchoService",
                                        method_index=0, method_name="Echo",
                                        correlation_id=7)
    sm = legacy_meta.SofaRpcMeta(type=0, sequence_id=7, method=ECHO)
    body = wire.EchoRequest(message="split").SerializeToString()

    def echo_of(payload):
        return _echo_text(payload) == "split"

    return {
        "hulu_pbrpc": (bytes(hulu._pack_frame(hm, body).to_bytes()),
                       hulu.parse,
                       lambda m: (m.meta.correlation_id == 7
                                  and m.meta.error_code == 0
                                  and echo_of(m.payload))),
        "sofa_pbrpc": (bytes(sofa._pack_frame(sm, body).to_bytes()),
                       sofa.parse,
                       lambda m: (m.meta.sequence_id == 7 and not m.meta.failed
                                  and echo_of(m.payload))),
        "redis": (redis.encode_command(("PING",)), redis_protocol.parse,
                  lambda m: _flat(m.replies[0]) == ("status", "PONG")),
        "memcache": (memcache.pack_op(memcache.OP_VERSION, opaque=3),
                     memcache_protocol.parse,
                     lambda m: (m.ops[0]["opaque"] == 3
                                and m.ops[0]["value"] == b"brpc_tpu-memcache-0.1")),
        # 18 bytes: shorter than nshead's 28 (queue C #27)
        "thrift": (thrift.pack_message("E", thrift.MSG_CALL, 7, {}),
                   thrift_protocol.parse,
                   lambda m: (m.seqid == 7
                              and m.msg_type == thrift.MSG_EXCEPTION)),
        "nshead": (nshead.NsheadMessage(mcpack2pb.pb_to_mcpack(
                       wire.EchoRequest(message="split")), log_id=4).serialize(),
                   nshead.parse,
                   lambda m: (m.msg.log_id == 4 and mcpack2pb.mcpack_to_pb(
                       m.msg.body, wire.EchoResponse).message == "split")),
        # a length and an opcode (bytes 12-15): weak magic
        "mongo": (_mongo_ping(), _mongo_reply_parse,
                  lambda m: (mongo.MongoHead.unpack(m).response_to == 7
                             and mongo.bson_decode(m, mongo.HEAD_SIZE + 20)[0]
                             == {"ok": 1.0})),
        # no magic at all: tried last
        "esp": (esp_protocol.EspMessage(b"split", msg=3, msg_id=5).serialize(),
                lambda buf, s, eof, arg: esp_protocol.parse(
                    buf, SimpleNamespace(_esp_pipeline=()), eof, arg),
                lambda m: (m.msg.body, m.msg.msg, m.msg.msg_id) == (
                    b"split", 3, 5)),
    }


def _wait_for(cond, what: str):
    end = time.monotonic() + WAIT_S
    while not (got := cond()):
        assert time.monotonic() < end, f"waited {WAIT_S} s for {what}"
        time.sleep(0.0005)
    return got


@pytest.mark.parametrize("protocol", FIRST_FRAMES)
def test_first_frame_one_byte_at_a_time(servers, protocol):
    frame, parse, ok = _first_frames()[protocol]
    srv = servers["port"]
    port = srv.listen_endpoint.port
    with pysocket.create_connection(("127.0.0.1", port), timeout=WAIT_S) as s:
        s.setsockopt(pysocket.IPPROTO_TCP, pysocket.TCP_NODELAY, 1)
        mine = s.getsockname()[1]
        conn = _wait_for(lambda: next(
            (c for c in srv.list_connections()
             if c.remote_side is not None and c.remote_side.port == mine),
            None), "the server's end of the connection")
        for i in range(len(frame)):
            s.sendall(frame[i:i + 1])
            if i + 1 < len(frame):
                # the server read this byte alone (and cut what it could)
                # before the next one goes
                _wait_for(lambda: len(conn.read_portal) == i + 1,
                          f"byte {i} read")
        got, end = IOBuf(), time.monotonic() + WAIT_S
        while True:
            r = parse(got, None, False, None)
            if r.status == ParseResult.OK:
                break
            assert r.status == ParseResult.NOT_ENOUGH_DATA, r.status
            assert time.monotonic() < end, f"{protocol}: no answer"
            got.append(s.recv(65536))
    assert ok(r.message)


@pytest.mark.parametrize("protocol", ["thrift", "nshead"])
def test_client_connection_pinned_and_again_on_revival(servers, protocol):
    """A client connection is matched to its channel's protocol before
    any response, and again after a revival dropped the match."""
    from brpc_tpu_torch.rpc.socket import Socket

    ch = _channel(PORT, protocol, servers["port"].listen_endpoint)
    try:
        cntl, got = _call(PORT, ch, protocol, "pin")
        assert not cntl.failed() and got == "pin", cntl.error_text
        sock = Socket.address(ch._single_sid)
        assert sock.matched_protocol is ch._protocol
        sock.set_failed(errors.ECLOSE, "test")
        assert sock.revive() == 0
        assert sock.matched_protocol is ch._protocol
        cntl, got = _call(PORT, ch, protocol, "again")
        assert not cntl.failed() and got == "again", cntl.error_text
    finally:
        ch.close()


@pytest.mark.parametrize("protocol", ["redis", "memcache", "nshead"])
def test_pipelined_calls_from_threads_on_one_connection(servers, protocol):
    ch = _channel(PORT, protocol, servers["port"].listen_endpoint)
    errs = []

    def worker(i):
        for j in range(8):
            cntl, got = _call(PORT, ch, protocol, f"p{i}-{j}")
            if cntl.failed() or got != _want(protocol, f"p{i}-{j}"):
                errs.append((i, j, cntl.error_text, got))

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(4 * WAIT_S)
    assert not any(t.is_alive() for t in threads)
    ch.close()
    assert not errs, errs[:4]


def test_large_values(servers):
    """1 MiB through redis, memcache and thrift: cut over many reads."""
    value = np.random.default_rng(5).integers(0, 256, 1 << 20,
                                              dtype=np.uint8).tobytes()
    ep = servers["port"].listen_endpoint
    ch = _channel(PORT, "redis", ep)
    req, resp, cntl = redis.RedisRequest(), redis.RedisResponse(), rpc.Controller()
    req.add_command("SET", "big", value)
    req.add_command("GET", "big")
    ch.call_method("redis", cntl, req, resp)
    assert not cntl.failed() and resp.reply(1).value == value
    ch.close()
    ch = _channel(PORT, "memcache", ep)
    mresp, cntl = memcache.MemcacheResponse(), rpc.Controller()
    ch.call_method("memcache", cntl,
                   memcache.MemcacheRequest().set("big", value).get("big"),
                   mresp)
    assert not cntl.failed() and mresp.pop_set()
    assert mresp.pop_get() == (True, value)
    ch.close()
    ch = _channel(PORT, "thrift", ep)
    tresp, cntl = thrift.ThriftMessage(), rpc.Controller()
    ch.call_method("thrift", cntl, thrift.ThriftMessage(
        "Echo", {1: (thrift.T_STRING, value)}), tresp)
    assert not cntl.failed() and tresp.body[0][1] == value
    ch.close()


@pytest.mark.parametrize("pkg_name", ["port", "ref"])
def test_errors(servers, pkg_name):
    """The port's client against both servers: the same codes and texts."""
    server = servers[pkg_name]
    ep = server.listen_endpoint
    for protocol in ("hulu_pbrpc", "sofa_pbrpc"):
        ch = _channel(PORT, protocol, ep)
        cntl, _ = ch.call("EchoService.Nope", wire.EchoRequest(message="x"),
                          wire.EchoResponse)
        assert cntl.error_code == errors.ENOMETHOD, cntl.error_text
        cntl, _ = ch.call("NoSuchService.Echo", wire.EchoRequest(message="x"),
                          wire.EchoResponse)
        assert cntl.error_code == errors.ENOSERVICE, cntl.error_text
        cntl, _ = ch.call(ECHO, wire.EchoRequest(message="x", code=42),
                          wire.EchoResponse)
        assert (cntl.error_code, cntl.error_text) == (42, "requested failure")
        ch.close()
    ch = _channel(PORT, "thrift", ep)
    cntl = rpc.Controller()
    ch.call_method("thrift", cntl, thrift.ThriftMessage("Nope", {}),
                   thrift.ThriftMessage())
    assert (cntl.error_code, cntl.error_text) == (
        errors.EREQUEST,
        "thrift exception: \"unknown thrift method 'Nope'\"")
    ch.close()
    ch = _channel(PORT, "redis", ep)
    req, resp, cntl = redis.RedisRequest(), redis.RedisResponse(), rpc.Controller()
    req.add_command("BOGUS", "x")
    req.add_command("PING")
    ch.call_method("redis", cntl, req, resp)
    assert (cntl.error_code, cntl.error_text) == (
        errors.EREQUEST, "ERR unknown command 'bogus'")
    assert [_flat(resp.reply(i)) for i in range(2)] == [
        ("error", "ERR unknown command 'bogus'"), ("status", "PONG")]
    ch.close()


@pytest.mark.parametrize("ctype", [1, 2, 3], ids=["gzip", "zlib", "snappy"])
@pytest.mark.parametrize("protocol", ["hulu_pbrpc", "sofa_pbrpc"])
def test_compressed_echo(servers, protocol, ctype):
    msg = "".join(chr(65 + i % 26) for i in range(4096))
    for server in (servers["port"], servers["ref"]):
        ch = _channel(PORT, protocol, server.listen_endpoint)
        cntl, got = _call(PORT, ch, protocol, msg, compress_type=ctype)
        ch.close()
        assert not cntl.failed() and got == msg, cntl.error_text


def test_echo_calls_are_counted(servers):
    srv = servers["port"]
    rec = srv.method_statuses()[ECHO].latency_recorder
    before = rec.count()
    n = 0
    for protocol in ("hulu_pbrpc", "sofa_pbrpc", "nshead"):
        ch = _channel(PORT, protocol, srv.listen_endpoint)
        for i in range(3):
            cntl, _ = _call(PORT, ch, protocol, f"count{i}")
            assert not cntl.failed(), cntl.error_text
            n += 1
        ch.close()
    assert rec.count() - before == n


def test_nshead_adaptor_with_a_handler(servers):
    """The reference's way to make the adaptor, a handler over decoded
    messages, on a port server; the reference's client calls it."""
    def handler(cntl, request, response):
        response.message = request.message[::-1]

    srv = rpc.Server(rpc.ServerOptions(
        num_threads=4, device="cpu", has_builtin_services=False,
        nshead_service=nshead.NsheadPbServiceAdaptor(
            wire.EchoRequest, wire.EchoResponse, handler)))
    assert srv.start("127.0.0.1:0") == 0
    try:
        ch = _channel(REF, "nshead", srv.listen_endpoint)
        cntl, got = _call(REF, ch, "nshead", "handler")
        ch.close()
        assert not cntl.failed() and got == "reldnah", cntl.error_text
        with pysocket.create_connection(
                ("127.0.0.1", srv.listen_endpoint.port), timeout=WAIT_S) as s:
            s.sendall(nshead.NsheadMessage(b"\xff").serialize())
            buf, end = IOBuf(), time.monotonic() + WAIT_S
            while (r := nshead.parse(buf, None, False, None)).status != \
                    ParseResult.OK:
                assert time.monotonic() < end
                buf.append(s.recv(4096))
        assert r.message.msg.body.startswith(b"bad mcpack body: ")
    finally:
        srv.stop()


def test_hulu_method_index_by_declaration(servers):
    """ROADMAP queue C #25: a hulu request with no method name and index
    0 runs the first declared method in the port, the first by name in
    the reference; the port's client derives the index the same way."""
    assert hulu.method_index("OrderService", "Zeta") == 0
    assert hulu.method_index("OrderService", "Alpha") == 1
    assert hulu.method_index("NoSuchService", "Echo") is None
    meta = legacy_meta.HuluRpcRequestMeta(service_name="OrderService",
                                          method_index=0, correlation_id=9)
    frame = bytes(hulu._pack_frame(meta, b"").to_bytes())
    got = {}
    for name in ("port", "ref"):
        port = servers[name].listen_endpoint.port
        with pysocket.create_connection(("127.0.0.1", port),
                                        timeout=WAIT_S) as s:
            s.sendall(frame)
            buf, end = IOBuf(), time.monotonic() + WAIT_S
            while (r := hulu.parse(buf, None, False, None)).status != \
                    ParseResult.OK:
                assert time.monotonic() < end
                buf.append(s.recv(4096))
        got[name] = _echo_text(r.message.payload)
    assert got == {"port": "zeta", "ref": "alpha"}


# -- examples -----------------------------------------------------------------

def _run_reference(name):
    buf = io.StringIO()
    code = 0
    with contextlib.redirect_stdout(buf), \
            pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", [f"examples/{name}.py"])
        mp.chdir(REPO)  # the reference's scripts put "." on sys.path
        try:
            runpy.run_path(os.path.join(REPO, "examples", f"{name}.py"),
                           run_name="__main__")
        except SystemExit as e:
            code = e.code or 0
    return code, buf.getvalue()


@pytest.mark.parametrize("module", [redis_kv, memcache_kv, thrift_echo,
                                    legacy_pbrpc_echo],
                         ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_examples_print_the_references_lines(servers, module):
    name = module.__name__.rsplit(".", 1)[1]
    ref_code, ref_out = _run_reference(name)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = module.main(["--device", "cpu"])

    def mask(text):
        return re.sub(r"\d+us", "Nus", text)

    assert ref_code == code == 0, (ref_out, buf.getvalue())
    assert mask(buf.getvalue()) == mask(ref_out)
