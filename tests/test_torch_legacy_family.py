"""The port's nshead family, mcpack2pb generator, mongo and esp held
against brpc_tpu's, on the CPU.

* Codecs, exact: the Public* metas against ``legacy_meta_pb2`` (seeded
  field sets, required fields, the sint32 and uint32 fields); nova,
  public and ubrpc request frames; BSON on seeded documents; the
  generated mcpack codec against the reference generator's for
  ``EchoRequest``, ``MapDemo`` (maps, a nested message, a repeated
  string) and ``PublicPbrpcRequest`` (proto2 presence, a repeated
  nested message).
* Live, on three port and three reference servers (module fixture), one
  per adaptor (a port has one nshead service), the nova servers also
  with a mongo adaptor and an esp service: nova (plain and snappy),
  public and ubrpc calls both ways and port to port, their ENOMETHOD,
  calls from 8 threads on one connection; a mongo ping and an esp round
  trip both ways; the generated adaptor serving calls of both packages.
* The generator's command line, its output imported in a fresh
  interpreter (nothing of brpc_tpu, jax or protobuf), and the
  ``nshead_extension`` twin against the reference's script.

Threads only, but for the one fresh interpreter; every wait has a
deadline.
"""
import contextlib
import io
import os
import runpy
import socket as pysocket
import struct
import subprocess
import sys
import threading
from types import SimpleNamespace

import numpy as np
import pytest

from brpc_tpu import mcpack2pb as ref_mcpack
from brpc_tpu import mcpack2pb_gen as ref_gen
from brpc_tpu import native as ref_native
from brpc_tpu import rpc as ref_rpc
from brpc_tpu.bthread import get_task_control as ref_get_task_control
from brpc_tpu.bvar import native_vars as ref_native_vars
from brpc_tpu.rpc import esp_protocol as ref_esp
from brpc_tpu.rpc import legacy_nshead_family as ref_family
from brpc_tpu.rpc import mongo as ref_mongo
from brpc_tpu.rpc import nshead_protocol as ref_nshead
from brpc_tpu.rpc.controller import Controller as RefController
from brpc_tpu.rpc.proto import echo_pb2, legacy_meta_pb2, mapdemo_pb2
from brpc_tpu_torch import native as port_native
from brpc_tpu_torch import mcpack2pb, mcpack2pb_gen, rpc
from brpc_tpu_torch.examples import nshead_extension
from brpc_tpu_torch.rpc import errors, esp_protocol
from brpc_tpu_torch.rpc import legacy_nshead_family as family
from brpc_tpu_torch.rpc import mongo
from brpc_tpu_torch.rpc import nshead_protocol as nshead
from brpc_tpu_torch.rpc.proto import legacy_meta, mapdemo, wire
from brpc_tpu_torch.tools import mcpack2pb_gen as gen_tool

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT_MS = 3000
ECHO = "EchoService.Echo"
FAMILY = ("nova_pbrpc", "public_pbrpc", "ubrpc")
PUBLIC = ("PublicRequestHead", "PublicRequestBody", "PublicPbrpcRequest",
          "PublicResponseHead", "PublicResponseBody", "PublicPbrpcResponse")

# -- codecs ------------------------------------------------------------------


def _scalar(rng, kind):
    if kind == wire.STRING:
        return ["", "x", "EchoService", "é" * 3][int(rng.integers(4))]
    if kind == wire.BYTES:
        return rng.integers(0, 256, int(rng.integers(0, 5)),
                            dtype=np.uint8).tobytes()
    if kind == wire.BOOL:
        return bool(rng.integers(2))
    if kind == wire.UINT32:
        return [0, 1, (1 << 32) - 1, 300][int(rng.integers(4))]
    if kind == wire.UINT64:
        return [0, 1, (1 << 64) - 1, 1 << 40][int(rng.integers(4))]
    return [0, 1, -1, (1 << 31) - 1, -(1 << 31)][int(rng.integers(5))]


def _fill(rng, a, b, depth=0):
    """The same seeded fields, sub-messages and repeated ones included,
    set on a port message and a protobuf one."""
    for _, name, kind, sub in type(a).FIELDS:
        if rng.random() < 0.4:
            continue
        if kind == wire.MESSAGE:
            if depth < 2:
                _fill(rng, getattr(a, name), getattr(b, name), depth + 1)
        elif kind == wire.REPEATED_MESSAGE:
            for _ in range(int(rng.integers(0, 3))):
                _fill(rng, getattr(a, name).add(), getattr(b, name).add(),
                      depth + 1)
        else:
            v = _scalar(rng, kind)
            setattr(a, name, v)
            setattr(b, name, v)


@pytest.mark.parametrize("name", PUBLIC)
def test_public_metas_are_protobufs(name):
    ours, ref = getattr(legacy_meta, name), getattr(legacy_meta_pb2, name)
    rng = np.random.default_rng(21)
    refused = 0
    for _ in range(120):
        a, b = ours(), ref()
        _fill(rng, a, b)
        try:
            want = b.SerializeToString()
        except Exception as e:
            refused += 1
            with pytest.raises(wire.EncodeError) as got:
                a.SerializeToString()
            assert str(got.value) == str(e)
            continue
        assert a.SerializeToString() == want
        c = ours()
        c.ParseFromString(want)
        assert c.SerializeToString() == want
    assert (refused > 0) == (name not in ("PublicRequestHead",))


def _cntls(method=ECHO, **kw):
    ours, ref = rpc.Controller(), RefController()
    for c in (ours, ref):
        c._method_full_name = method
        c.log_id = 77
        c._current_sock = SimpleNamespace()
        for k, v in kw.items():
            setattr(c, k, v)
    return ours, ref


@pytest.mark.parametrize("protocol,kw", [
    ("nova_pbrpc", {}), ("nova_pbrpc", {"compress_type": 3}),
    ("nova_pbrpc", {"nova_method_index": 2}), ("public_pbrpc", {}),
    ("ubrpc", {})], ids=["nova", "nova-snappy", "nova-index", "public",
                         "ubrpc"])
def test_request_frames_are_the_references(protocol, kw):
    stem = protocol.split("_")[0]
    ours, ref = _cntls(**kw)
    req = wire.EchoRequest(message="frame", code=3)
    ref_req = echo_pb2.EchoRequest(message="frame", code=3)
    if stem == "ubrpc":
        payload = family._ubrpc_serialize_request(req, ours)
        ref_payload = ref_family._ubrpc_serialize_request(ref_req, ref)
    else:
        payload, ref_payload = (req.SerializeToString(),
                                ref_req.SerializeToString())
    got = getattr(family, f"_{stem}_pack_request")(payload, ours, 4099)
    want = getattr(ref_family, f"_{stem}_pack_request")(ref_payload, ref, 4099)
    assert bytes(got.to_bytes()) == bytes(want.to_bytes())


def _doc(rng, depth=0):
    out = {}
    for i in range(int(rng.integers(0, 6))):
        k = f"k{i}"
        pick = int(rng.integers(9 if depth < 2 else 7))
        out[k] = [lambda: float(rng.normal()), lambda: "s" * int(rng.integers(4)),
                  lambda: bool(rng.integers(2)), lambda: None,
                  lambda: int(rng.integers(-(1 << 31), 1 << 31)),
                  lambda: int(rng.integers(1 << 40, 1 << 62)),
                  lambda: rng.integers(0, 256, 3, dtype=np.uint8).tobytes(),
                  lambda: _doc(rng, depth + 1),
                  lambda: [_doc(rng, depth + 1), 5, "x"]][pick]()
    return out


def test_bson_is_the_references():
    rng = np.random.default_rng(8)
    for _ in range(200):
        doc = _doc(rng)
        data = mongo.bson_encode(doc)
        assert data == ref_mongo.bson_encode(doc)
        assert mongo.bson_decode(data) == ref_mongo.bson_decode(data)
        assert mongo.bson_decode(data)[0] == doc
    resp, ref_resp = mongo.MongoResponse(), ref_mongo.MongoResponse()
    for r in (resp, ref_resp):
        r.documents = [{"ok": 1.0}, {"n": 3}]
    assert resp.pack(5, 9) == ref_resp.pack(5, 9)
    assert mongo.MongoServiceAdaptor().serialize_error(4) == (
        ref_mongo.MongoServiceAdaptor().serialize_error(4))


def _map_pair(rng):
    a = mapdemo_pb2.MapDemo()
    for _ in range(int(rng.integers(0, 4))):
        a.counts[f"k{int(rng.integers(50))}"] = int(rng.integers(-9, 9))
    for i in range(int(rng.integers(0, 3))):
        k = int(rng.integers(-(1 << 40), 1 << 40))
        a.shards[k].label = f"l{i}"
        a.shards[k].rank = int(rng.integers(5))
    a.tags.extend(f"t{i}" for i in range(int(rng.integers(0, 3))))
    b = mapdemo.MapDemo()  # in the protobuf map's own order
    for k, v in a.counts.items():
        b.counts[k] = v
    for k, v in a.shards.items():
        b.shards[k].label, b.shards[k].rank = v.label, v.rank
    b.tags.extend(a.tags)
    return a, b


def _echo_pair(rng):
    kw = {"message": f"m{int(rng.integers(100))}",
          "code": int(rng.integers(-5, 5)), "sleep_us": int(rng.integers(3))}
    return echo_pb2.EchoRequest(**kw), wire.EchoRequest(**kw)


def _public_pair(rng):
    a, b = legacy_meta_pb2.PublicPbrpcRequest(), legacy_meta.PublicPbrpcRequest()
    if rng.random() < 0.6:
        for m in (a, b):
            m.requestHead.log_id = 7
            m.requestHead.connection = False
    for i in range(int(rng.integers(0, 3))):
        for m in (a, b):
            body = m.requestBody.add()
            body.service, body.method_id, body.id = "S", 0, 9 + i
            body.serialized_request = b"q"
    return a, b


@pytest.mark.parametrize("stem,pair", [
    ("echo_request", _echo_pair), ("map_demo", _map_pair),
    ("public_pbrpc_request", _public_pair)])
def test_generated_codec_is_the_references(stem, pair):
    ref_mod = ref_gen.compile_codec(ref_gen.generate_codec_source(
        [echo_pb2.EchoRequest, mapdemo_pb2.MapDemo,
         legacy_meta_pb2.PublicPbrpcRequest]), "ref_codec")
    mod = mcpack2pb_gen.compile_codec(mcpack2pb_gen.generate_codec_source(
        [wire.EchoRequest, mapdemo.MapDemo, legacy_meta.PublicPbrpcRequest]),
        "port_codec")
    rng = np.random.default_rng(5)
    for _ in range(40):
        a, b = pair(rng)
        want = getattr(ref_mod, f"serialize_{stem}")(a)
        assert getattr(mod, f"serialize_{stem}")(b) == want
        assert getattr(mod, f"parse_{stem}")(want) == b


# -- live --------------------------------------------------------------------

def _reverse_echo(pkg, req, resp):
    class EchoService(pkg.Service):
        calls = 0

        @pkg.rpc_method(req, resp)
        def Echo(self, cntl, request, response, done):
            type(self).calls += 1
            response.message = request.message[::-1]
            done()

    return EchoService()


def _ping_adaptor(mod):
    class PingAdaptor(mod.MongoServiceAdaptor):
        def process_mongo_request(self, cntl, request, response, done):
            q = request.query or {}
            response.documents = [{"ok": 1.0} if "ping" in q
                                  else {"you_said": request.collection}]
            done()

    return PingAdaptor()


PORT = SimpleNamespace(rpc=rpc, family=family, Req=wire.EchoRequest,
                       Resp=wire.EchoResponse, mongo=mongo,
                       esp=esp_protocol, nshead=nshead, mcpack=mcpack2pb)
REF = SimpleNamespace(rpc=ref_rpc, family=ref_family, Req=echo_pb2.EchoRequest,
                      Resp=echo_pb2.EchoResponse, mongo=ref_mongo,
                      esp=ref_esp, nshead=ref_nshead, mcpack=ref_mcpack)
ADAPTORS = {"nova_pbrpc": "NovaServiceAdaptor",
            "public_pbrpc": "PublicPbrpcServiceAdaptor",
            "ubrpc": "UbrpcServiceAdaptor"}


def _server(pkg, protocol):
    echo = _reverse_echo(pkg.rpc, pkg.Req, pkg.Resp)
    kw = {"device": "cpu"} if pkg is PORT else {"has_builtin_services": False}
    if protocol == "nova_pbrpc":
        kw.update(mongo_service_adaptor=_ping_adaptor(pkg.mongo),
                  esp_service=pkg.esp.EspService())
    srv = pkg.rpc.Server(pkg.rpc.ServerOptions(
        num_threads=2,
        nshead_service=getattr(pkg.family, ADAPTORS[protocol])(echo), **kw))
    srv.add_service(echo)
    assert srv.start("127.0.0.1:0") == 0
    return srv


@pytest.fixture(scope="module")
def servers():
    ref_get_task_control()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BRPC_TPU_FABRIC", "0")
        mp.setattr(ref_native_vars, "native_status_lines", lambda: [])
        mp.setattr(ref_native, "available", lambda: False)
        # and the port's pages show no native section, whether or not
        # an earlier test of this process loaded the port's library
        mp.setattr(port_native, "is_loaded", lambda: False)
        out = {(side, p): _server(pkg, p) for side, pkg in
               (("port", PORT), ("ref", REF)) for p in FAMILY}
        yield out
        for srv in out.values():
            srv.stop()


DIRECTIONS = [("port", "ref"), ("ref", "port"), ("port", "port")]


def _channel(pkg, protocol, target, **kw):
    ch = pkg.rpc.Channel(pkg.rpc.ChannelOptions(
        protocol=protocol, timeout_ms=WAIT_MS, **kw))
    assert ch.init(str(target)) == 0
    return ch


@pytest.mark.parametrize("protocol", FAMILY)
@pytest.mark.parametrize("client,server", DIRECTIONS)
def test_family_calls_both_ways(servers, protocol, client, server):
    pkg = PORT if client == "port" else REF
    ch = _channel(pkg, protocol, servers[(server, protocol)].listen_endpoint)
    try:
        for i, ctype in enumerate((0, 3, 0)):
            if ctype and protocol != "nova_pbrpc":
                continue
            msg = f"{protocol}-{i}" * (40 if ctype else 1)
            cntl, resp = ch.call(ECHO, pkg.Req(message=msg), pkg.Resp,
                                 compress_type=ctype)
            assert not cntl.failed(), cntl.error_text
            assert resp.message == msg[::-1]
        cntl, _ = ch.call("EchoService.Nope", pkg.Req(message="x"), pkg.Resp)
        assert cntl.error_code == errors.ENOMETHOD, cntl.error_text
    finally:
        ch.close()


@pytest.mark.parametrize("protocol", FAMILY)
def test_family_calls_from_threads_on_one_connection(servers, protocol):
    """The port queues nova and ubrpc calls first in, first out on a shared
    connection (ROADMAP queue C #30); public's carry their ids."""
    ch = _channel(PORT, protocol,
                  servers[("port", protocol)].listen_endpoint)
    got, socks = {}, set()

    def worker(t):
        for j in range(8):
            msg = f"{t}-{j}" * (1 + j % 3)
            cntl, resp = ch.call(ECHO, wire.EchoRequest(message=msg),
                                 wire.EchoResponse)
            got[msg] = (cntl.error_code, resp.message)
            socks.add(cntl._current_sock.socket_id)

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(8)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(20)
        assert not any(t.is_alive() for t in threads)
        assert len(got) == 64 and all(
            v == (0, k[::-1]) for k, v in got.items())
        assert len(socks) == 1
    finally:
        ch.close()


def _mongo_query(port, collection, doc, request_id=7):
    body = struct.pack("<i", 0) + collection.encode() + b"\x00"
    body += struct.pack("<ii", 0, 1) + mongo.bson_encode(doc)
    head = mongo.MongoHead(mongo.HEAD_SIZE + len(body), request_id, 0,
                           mongo.OP_QUERY)
    with pysocket.create_connection(("127.0.0.1", port), timeout=5) as s:
        s.sendall(head.pack() + body)
        raw = b""
        while len(raw) < mongo.HEAD_SIZE or len(raw) < struct.unpack_from(
                "<i", raw)[0]:
            chunk = s.recv(4096)
            assert chunk, "the server closed"
            raw += chunk
    return raw


def test_mongo_ping_both_packages(servers):
    replies = {}
    for side in ("port", "ref"):
        srv = servers[(side, "nova_pbrpc")]
        replies[side] = (_mongo_query(srv.listen_endpoint.port, "admin.$cmd",
                                      {"ping": 1}),
                         _mongo_query(srv.listen_endpoint.port, "db.c",
                                      {"find": "c"}, request_id=9))
    assert replies["port"] == replies["ref"]
    ping, find = replies["port"]
    head = mongo.MongoHead.unpack(ping)
    assert (head.op_code, head.response_to) == (mongo.OP_REPLY, 7)
    assert mongo.bson_decode(ping, mongo.HEAD_SIZE + 20)[0] == {"ok": 1.0}
    assert mongo.bson_decode(find, mongo.HEAD_SIZE + 20)[0] == {
        "you_said": "db.c"}


@pytest.mark.parametrize("client,server", DIRECTIONS)
def test_esp_round_trip(servers, client, server):
    pkg = PORT if client == "port" else REF
    ch = _channel(pkg, "esp", servers[(server, "nova_pbrpc")].listen_endpoint)
    try:
        for i in range(3):
            req = pkg.esp.EspMessage(b"esp payload %d" % i, to_addr=9, msg=3,
                                     msg_id=77 + i)
            cntl, resp = ch.call("esp.msg", req, pkg.esp.EspMessage)
            assert not cntl.failed(), cntl.error_text
            assert (resp.body, resp.msg, resp.msg_id) == (
                b"esp payload %d" % i, 3, 77 + i)
    finally:
        ch.close()


class GenEcho(rpc.Service):
    SERVICE_NAME = "EchoService"

    @rpc.rpc_method(wire.EchoRequest, wire.EchoResponse)
    def Echo(self, cntl, request, response, done):
        response.message = request.message.upper()
        done()


def test_generated_adaptor_serves_both_packages():
    src = mcpack2pb_gen.generate_nshead_adaptor_source(GenEcho)
    adaptor = mcpack2pb_gen.compile_codec(src, "gen").GenEchoNsheadAdaptor
    srv = rpc.Server(rpc.ServerOptions(num_threads=2, device="cpu",
                                       has_builtin_services=False,
                                       nshead_service=adaptor(GenEcho())))
    assert srv.start("127.0.0.1:0") == 0
    try:
        for pkg in (PORT, REF):
            ch = _channel(pkg, "nshead", srv.listen_endpoint)
            try:
                body = pkg.mcpack.enc_object("", [
                    pkg.mcpack.enc_str("method", "Echo"),
                    pkg.mcpack.enc_str("message", "gen")])
                cntl, resp = ch.call("nshead", pkg.nshead.NsheadMessage(body),
                                     pkg.nshead.NsheadMessage)
                assert not cntl.failed(), cntl.error_text
                assert pkg.mcpack.loads(resp.body)["message"] in ("GEN", b"GEN")
            finally:
                ch.close()
    finally:
        srv.stop()


def test_generator_cli_output_imports_standalone(tmp_path):
    out = tmp_path / "echo_mcpack.py"
    assert gen_tool.main(["brpc_tpu_torch.rpc.proto.wire:EchoRequest",
                          "brpc_tpu_torch.rpc.proto.mapdemo:MapDemo",
                          "-o", str(out)]) == 0
    script = (
        "import sys, echo_mcpack as m\n"
        "from brpc_tpu_torch.rpc.proto import wire\n"
        "data = m.serialize_echo_request(wire.EchoRequest(message='x'))\n"
        "assert m.parse_echo_request(data).message == 'x'\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('brpc_tpu', 'jax') or n.startswith('google.protobuf'))\n"
        "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=f"{tmp_path}{os.pathsep}{REPO}")
    proc = subprocess.run([sys.executable, "-c", script], cwd=tmp_path,
                          env=env, capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_nshead_extension_prints_the_references_line(servers):
    buf = io.StringIO()
    code = 0
    with contextlib.redirect_stdout(buf), pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", ["examples/nshead_extension.py"])
        mp.chdir(REPO)
        try:
            runpy.run_path(os.path.join(REPO, "examples",
                                        "nshead_extension.py"),
                           run_name="__main__")
        except SystemExit as e:
            code = e.code or 0
    ours = io.StringIO()
    with contextlib.redirect_stdout(ours):
        our_code = nshead_extension.main(["--device", "cpu"])
    assert code == our_code == 0
    assert ours.getvalue() == buf.getvalue() == (
        "nshead-mcpack reply: 'hELLO nshead'\n")
