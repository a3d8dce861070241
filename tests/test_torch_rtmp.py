"""The port's RTMP family held against brpc_tpu's, on the CPU.

* Codecs, byte for byte: every AMF0 type; 500 seeded garbage inputs give
  the same value or the same ``AmfError``; FLV tags, the writer and
  ``probe``; ``TsMuxer`` output for seeded frames that cross the 184-byte
  payload and wrap the continuity counter, ``demux``, the PCR and the
  truncated-PES contract; the digest handshake's primitives across the
  packages.
* The chunk layer: the reference's split, reparse and abort case at
  every split point, on both packages' sessions.
* Live, on one port and one reference server (module fixture), each a
  relay: a reference publisher through a port server to a reference and
  a port player; the port's ``RtmpClient`` (digest) against the
  reference server; ``pull_into_service`` of each package from the
  other's origin; command replies and relayed frames on one player's
  connection from two writers, every message whole.
* One port: tpu_std and HTTP answer beside RTMP sessions; a C0C1 whose
  first 32 bytes arrive one at a time reaches RTMP on a port that also
  serves redis, memcache, thrift, mongo and nshead; a server without an
  rtmp service closes the connection (both packages); what a handshake
  gets from a server with both an esp and an rtmp service (both
  packages, ROADMAP queue C #31).
* Shedding, both packages: a player that stops reading is shed once its
  backlog passes 8 MiB, the other player gets every frame.
* Kept mismatches, pinned on both packages: a session that hangs up
  leaves the relay in the port only, and ``rtmp_sessions`` counts live
  sessions (#32); a dead edge pull frees its name in the port only
  (#33).
* One two-process relay (a spawned port origin) and the ``rtmp_relay``
  example against the reference's script.

Threads only, but for the one spawned origin; every wait has a deadline.
"""
import contextlib
import io
import os
import random
import re
import runpy
import socket as pysocket
import struct
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from brpc_tpu import native as ref_native
from brpc_tpu import rpc as ref_rpc
from brpc_tpu.bthread import get_task_control as ref_get_task_control
from brpc_tpu.bvar import native_vars as ref_native_vars
from brpc_tpu.rpc import amf as ref_amf
from brpc_tpu.rpc import esp_protocol as ref_esp
from brpc_tpu.rpc import flv as ref_flv
from brpc_tpu.rpc import mpegts as ref_mpegts
from brpc_tpu.rpc import rtmp_client as ref_rc
from brpc_tpu.rpc import rtmp_protocol as ref_rp
from brpc_tpu.rpc.proto import echo_pb2
from brpc_tpu_torch import native as port_native
from brpc_tpu_torch import rpc
from brpc_tpu_torch.examples import rtmp_relay
from brpc_tpu_torch.rpc import amf, esp_protocol, flv, memcache, mongo, mpegts
from brpc_tpu_torch.rpc import nshead_protocol as nshead
from brpc_tpu_torch.rpc import redis, thrift
from brpc_tpu_torch.rpc import rtmp_client as rc
from brpc_tpu_torch.rpc import rtmp_protocol as rp
from brpc_tpu_torch.rpc.proto import wire

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT_S = 5.0
PORT = SimpleNamespace(name="port", amf=amf, flv=flv, ts=mpegts, rp=rp,
                       rc=rc, rpc=rpc)
REF = SimpleNamespace(name="ref", amf=ref_amf, flv=ref_flv, ts=ref_mpegts,
                      rp=ref_rp, rc=ref_rc, rpc=ref_rpc)
PKGS = [PORT, REF]


def _ids(pkg):
    return pkg.name


def _wait_for(cond, what: str, timeout: float = WAIT_S):
    end = time.monotonic() + timeout
    while not (got := cond()):
        assert time.monotonic() < end, f"waited {timeout} s for {what}"
        time.sleep(0.002)
    return got


# -- AMF0, FLV, MPEG-TS ------------------------------------------------------

AMF_VALUES = [0.0, -1.5, 2.0 ** 60, True, False, "", "connect", "é" * 5,
              "x" * 70000, {}, {"app": "live", "n": {"a": 2.5, "b": True}},
              None, [], [1.0, "two", False, None, {"k": [3.0]}]]


def test_amf0_every_type_same_bytes():
    for v in AMF_VALUES:
        blob = amf.encode(v)
        assert blob == ref_amf.encode(v), v
        assert amf.decode(blob) == ref_amf.decode(blob)
        assert amf.decode(blob)[0] == v
    many = amf.encode_many(*AMF_VALUES)
    assert many == ref_amf.encode_many(*AMF_VALUES)
    assert amf.decode_all(many) == AMF_VALUES
    # the ECMA array and undefined decode, as the reference's do
    ecma = (bytes([amf.AMF0_ECMA_ARRAY]) + struct.pack(">I", 1)
            + struct.pack(">H", 3) + b"key" + amf.encode(5.0)
            + struct.pack(">H", 0) + bytes([amf.AMF0_OBJECT_END])
            + bytes([amf.AMF0_UNDEFINED]))
    assert amf.decode_all(ecma) == ref_amf.decode_all(ecma) == [{"key": 5.0},
                                                               None]
    for mod in (amf, ref_amf):
        with pytest.raises(mod.AmfError, match="unencodable"):
            mod.encode(object())


def _amf_outcome(mod, blob):
    try:
        return "value", repr(mod.decode_all(blob))
    except mod.AmfError as e:
        return "AmfError", str(e)


def test_amf0_garbage_same_as_reference():
    rng = random.Random(11)
    errors_seen = 0
    for _ in range(500):
        blob = bytes(rng.randrange(256) for _ in range(rng.randrange(48)))
        if rng.random() < 0.5 and blob:  # start on a real marker
            blob = bytes([rng.choice([0, 1, 2, 3, 5, 6, 8, 10, 12])]) + blob
        ours = _amf_outcome(amf, blob)
        assert ours == _amf_outcome(ref_amf, blob), blob
        errors_seen += ours[0] == "AmfError"
    assert 0 < errors_seen < 500


def test_flv_same_bytes():
    outs = []
    for mod in (flv, ref_flv):
        buf = io.BytesIO()
        w = mod.FlvWriter(buf, has_audio=True, has_video=True)
        w.write_metadata(0, amf.encode_many("onMetaData", {"fps": 30.0}))
        w.write_video(10, b"\x17\x00cfg")
        w.write_audio(12, b"\xaf\x00cfg")
        w.write_video((1 << 24) + 40, b"\x27\x01frame" * 300)
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    data = outs[0]
    assert list(flv.read_tags(data)) == list(ref_flv.read_tags(data))
    assert list(flv.read_tags(data))[3][1] == (1 << 24) + 40
    assert list(flv.read_tags(data[:-20])) == list(ref_flv.read_tags(
        data[:-20]))  # a truncated tail ends the tags
    for header in (flv.file_header(False, True), data, b"FLX" + data[3:],
                   data[:12]):
        assert flv.probe(header) == ref_flv.probe(header)
    assert flv.encode_tag(9, 0xFFFFFFFF, b"p") == ref_flv.encode_tag(
        9, 0xFFFFFFFF, b"p")
    with pytest.raises(ValueError):
        list(flv.read_tags(b"NOTFLV"))


def _ts_frames(seed: int):
    """Seeded access units: sizes around the 184-byte payload of a
    packet and past it, enough packets to wrap each continuity counter."""
    rng = np.random.default_rng(seed)
    sizes = [1, 160, 169, 170, 171, 183, 184, 185, 400, 3000, 7000]
    out = []
    for i, n in enumerate(sizes * 2):
        kind = "audio" if i % 3 == 2 else "video"
        out.append((kind, i * 33, rng.integers(0, 256, n, dtype=np.uint8)
                    .tobytes(), i % 7 == 0))
    return out


@pytest.mark.parametrize("has_audio", [True, False])
def test_mpegts_same_bytes(has_audio):
    segs = []
    for mod in (mpegts, ref_mpegts):
        mux = mod.TsMuxer(has_audio=has_audio)
        for kind, pts, es, key in _ts_frames(5):
            if kind == "video":
                mux.write_video(pts, es, keyframe=key)
            elif has_audio:
                mux.write_audio(pts, es)
        mux.write_psi()
        segs.append(mux.packets())
    assert segs[0] == segs[1]
    seg = segs[0]
    assert len(seg) // mpegts.TS_PACKET > 2 * 16  # the counters wrapped
    got = list(mpegts.demux(seg))
    assert got == list(ref_mpegts.demux(seg))
    # a PES is yielded when the next one of its PID starts, so compare
    # each PID's access units in order
    for pid, kind in ((mpegts.PID_VIDEO, "video"), (mpegts.PID_AUDIO, "audio")):
        assert [(pts, es) for p, pts, es in got if p == pid] == [
            (pts, es) for k, pts, es, _ in _ts_frames(5)
            if k == kind and (has_audio or kind == "video")]
    assert mpegts._pat_table() == ref_mpegts._pat_table()
    assert mpegts._pmt_table(has_audio) == ref_mpegts._pmt_table(has_audio)
    crc_in = bytes(range(256)) * 3
    assert mpegts._crc32_mpeg(crc_in) == ref_mpegts._crc32_mpeg(crc_in)


@pytest.mark.parametrize("pkg", PKGS, ids=_ids)
def test_mpegts_contract(pkg):
    """tests/test_rtmp.py's contract: a PCR without keyframe flags, the
    PAT's program entry, refused oversized audio, ValueError on a
    truncated stream, a truncated PES or a sync loss."""
    ts = pkg.ts
    mux = ts.TsMuxer(has_audio=False)
    mux.write_video(0, b"frame-a")
    mux.write_video(33, b"frame-b")
    data = mux.packets()
    assert any((data[o + 3] >> 4) & 0x2 and data[o + 4] > 0
               and data[o + 5] & 0x10
               for o in range(0, len(data), ts.TS_PACKET))
    with pytest.raises(ValueError, match="truncated"):
        ts._finish_pes(ts.PID_VIDEO, b"\x00\x00\x01\xe0\x00\x00\x80\x80\x05")
    assert ts._pat_table()[8:12] == bytes([0, 1, 0xF0, 0x00])
    mux = ts.TsMuxer()
    with pytest.raises(ValueError, match="audio"):
        mux.write_audio(0, b"a" * 70000)
    mux.write_video(0, b"v" * 70000)
    data = mux.packets()
    with pytest.raises(ValueError, match="truncated"):
        list(ts.demux(data[:-7]))
    with pytest.raises(ValueError, match="sync"):
        list(ts.demux(b"\x00" * ts.TS_PACKET))


def test_mpegts_garbage_same_as_reference():
    rng = random.Random(13)
    for _ in range(100):
        n = rng.randrange(1, 5)
        blob = bytearray(rng.randrange(256) for _ in range(n * 188))
        for i in range(n):
            if rng.random() < 0.8:
                blob[i * 188] = 0x47
        outs = []
        for mod in (mpegts, ref_mpegts):
            try:
                outs.append(list(mod.demux(bytes(blob))))
            except ValueError as e:
                outs.append(str(e))
        assert outs[0] == outs[1]


def test_digest_handshake_across_packages():
    for a, b in ((rc, ref_rc), (ref_rc, rc)):
        c1, dig = a.make_digest_c1()
        assert b.find_digest(c1, b.FP_KEY) == (0, dig)
        assert b.find_digest(c1, b.FMS_KEY) is None
        for scheme in (0, 1):
            s1, s1_dig = a.make_digest_s1(scheme)
            assert b.find_digest(s1, b.FMS_KEY) == (scheme, s1_dig)
        s2 = a.make_chained_reply(dig, a.FMS_KEY_FULL)
        assert b.verify_chained_reply(s2, dig, b.FMS_KEY_FULL)
        assert not b.verify_chained_reply(s2, s1_dig, b.FMS_KEY_FULL)
    assert (rc.FP_KEY_FULL, rc.FMS_KEY_FULL) == (ref_rc.FP_KEY_FULL,
                                                 ref_rc.FMS_KEY_FULL)


# -- the chunk layer ---------------------------------------------------------

class _Sink:
    def write(self, buf, id_wait=None):
        return 0

    def failed(self):
        return False


def _collecting_session(pkg, got):
    class Collect(pkg.rp.RtmpSession):
        def _on_message(self, t, sid, ts, payload):
            if t in (pkg.rp.MSG_AUDIO, pkg.rp.MSG_VIDEO,
                     pkg.rp.MSG_DATA_AMF0):
                got.append((t, ts, payload))
            else:  # control messages (Abort) keep their meaning
                super()._on_message(t, sid, ts, payload)

    sess = Collect(_Sink(), pkg.rp.RtmpService())
    sess.state = sess.ST_ESTABLISHED
    return sess


def _chunk_stream() -> bytes:
    """tests/test_rtmp.py's case, plus an extended timestamp whose fmt-3
    continuation carries it again."""
    m0 = (bytes([3]) + (1000).to_bytes(3, "big") + (4).to_bytes(3, "big")
          + bytes([9]) + (1).to_bytes(4, "little") + b"AAAA")
    m1 = (bytes([(1 << 6) | 3]) + (33).to_bytes(3, "big")
          + (4).to_bytes(3, "big") + bytes([9]) + b"BBBB")
    part = (bytes([3]) + (10).to_bytes(3, "big") + (300).to_bytes(3, "big")
            + bytes([9]) + (1).to_bytes(4, "little") + b"x" * 128)
    abort = (bytes([2]) + (0).to_bytes(3, "big") + (4).to_bytes(3, "big")
             + bytes([2]) + (0).to_bytes(4, "little")
             + (3).to_bytes(4, "big"))
    fresh = (bytes([3]) + (2000).to_bytes(3, "big") + (2).to_bytes(3, "big")
             + bytes([9]) + (1).to_bytes(4, "little") + b"ZZ")
    ext = (bytes([4]) + b"\xff\xff\xff" + (200).to_bytes(3, "big")
           + bytes([8]) + (1).to_bytes(4, "little")
           + (1 << 25).to_bytes(4, "big") + b"e" * 128
           + bytes([(3 << 6) | 4]) + (1 << 25).to_bytes(4, "big")
           + b"f" * 72)
    return m0 + m1 + part + abort + fresh + ext


CHUNK_WANT = [(9, 1000, b"AAAA"), (9, 1033, b"BBBB"), (9, 2000, b"ZZ"),
              (8, 1 << 25, b"e" * 128 + b"f" * 72)]


@pytest.mark.parametrize("pkg", PKGS, ids=_ids)
def test_chunk_split_reparse_and_abort_at_every_split(pkg):
    stream = _chunk_stream()
    for cut in range(1, len(stream)):
        got = []
        sess = _collecting_session(pkg, got)
        sess.feed_bytes(stream[:cut])
        sess.feed_bytes(stream[cut:])
        assert got == CHUNK_WANT, cut
        assert not sess.pending


# -- live --------------------------------------------------------------------

class PortEcho(rpc.Service):
    SERVICE_NAME = "EchoService"

    @rpc.rpc_method(wire.EchoRequest, wire.EchoResponse)
    def Echo(self, cntl, request, response, done):
        response.message = request.message
        done()


class _PingAdaptor(mongo.MongoServiceAdaptor):
    def process_mongo_request(self, cntl, request, response, done):
        response.documents = [{"ok": 1.0}]
        done()


def _port_server(**kw):
    srv = rpc.Server(rpc.ServerOptions(num_threads=4, device="cpu", **kw))
    srv.add_service(PortEcho())
    assert srv.start("127.0.0.1:0") == 0
    return srv


def _ref_server(**kw):
    srv = ref_rpc.Server(ref_rpc.ServerOptions(
        num_threads=4, has_builtin_services=False, **kw))
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
        port_svc, ref_svc = rp.RtmpService(), ref_rp.RtmpService()
        thrift_svc = thrift.ThriftService()
        thrift_svc.add_method("Echo", lambda body: {0: body.get(1)})
        port = _port_server(
            rtmp_service=port_svc, redis_service=redis.DictRedisService(),
            memcache_service=memcache.MemcacheService(),
            thrift_service=thrift_svc, mongo_service_adaptor=_PingAdaptor(),
            nshead_service=nshead.NsheadPbServiceAdaptor.for_method(
                "EchoService.Echo"))
        ref = _ref_server(rtmp_service=ref_svc)
        yield {"port": port, "ref": ref, "port_svc": port_svc,
               "ref_svc": ref_svc}
        ref.stop()
        port.stop()


class _Player:
    """An RtmpClient of either package playing ``name``; keeps every
    media message it reads."""

    def __init__(self, pkg, port: int, name: str):
        self.got = []
        self.client = pkg.rc.RtmpClient("127.0.0.1", port).connect()
        self.client.start_reader()
        self.client.create_stream().play(
            name, lambda t, ts, p: self.got.append((t, ts, p)))

    def wait(self, n: int, what: str):
        _wait_for(lambda: len(self.got) >= n, what)
        return self.got


def _frames(seed: int, n: int):
    rng = np.random.default_rng(seed)
    return [(rp.MSG_VIDEO if i % 2 == 0 else rp.MSG_AUDIO, 40 + i * 33,
             bytes([0x27 if i % 2 == 0 else 0xAF, 1]) + rng.integers(
                 0, 256, int(rng.integers(1, 9000)), dtype=np.uint8)
             .tobytes()) for i in range(n)]


def test_reference_publisher_through_port_server(servers):
    port = servers["port"].listen_endpoint.port
    pconn, pub = ref_rp.rtmp_client_connect("127.0.0.1", port)
    try:
        pub.send_command("createStream", 2.0, None)
        pub.send_command("publish", 3.0, None, "interop1", "live",
                         stream_id=1)
        assert pub.pump_until(lambda s: any(
            c[0] == "onStatus" and c[3]["code"] == "NetStream.Publish.Start"
            for c in s.commands()))
        meta = ref_amf.encode_many("onMetaData", {"width": 64.0})
        avc = b"\x17\x00\x00\x00\x00cfg"
        pub.send_message(ref_rp.MSG_DATA_AMF0, 0, meta, stream_id=1)
        pub.send_message(ref_rp.MSG_VIDEO, 0, avc, stream_id=1)
        _wait_for(lambda: servers["port_svc"]._streams["interop1"]
                  .avc_seq_header is not None, "the cached header")
        players = [_Player(REF, port, "interop1"),
                   _Player(PORT, port, "interop1")]
        frames = _frames(1, 12)
        for t, ts, payload in frames:
            pub.send_message(t, ts, payload, stream_id=1)
        for p in players:
            got = p.wait(2 + len(frames), "the relayed frames")
            assert got == [(18, 0, meta), (9, 0, avc)] + frames
            p.client.close()
    finally:
        pconn.close()


def test_port_client_against_reference_server(servers):
    port = servers["ref"].listen_endpoint.port
    pub = rc.RtmpClient("127.0.0.1", port).connect()
    try:
        assert pub.digest_mode
        stream = pub.create_stream().publish("interop2")
        assert "interop2" in servers["ref_svc"].stream_names()
        stream.send_metadata({"fps": 30.0})
        stream.send_video(b"\x17\x00SEQ", 0)
        player = _Player(PORT, port, "interop2")
        player.wait(2, "the priming messages")
        frames = _frames(2, 10)
        for t, ts, payload in frames:
            (stream.send_video if t == rp.MSG_VIDEO
             else stream.send_audio)(payload, ts)
        assert player.wait(12, "the relayed frames")[2:] == frames
        player.client.close()
    finally:
        pub.close()


@pytest.mark.parametrize("edge_pkg,origin", [(PORT, "ref"), (REF, "port")],
                         ids=["port_pulls_ref", "ref_pulls_port"])
def test_pull_into_service_across_packages(servers, edge_pkg, origin):
    name = f"pull_{edge_pkg.name}"
    origin_port = servers[origin].listen_endpoint.port
    pub = rc.RtmpClient("127.0.0.1", origin_port).connect()
    edge_svc = edge_pkg.rp.RtmpService()
    edge = (_port_server(rtmp_service=edge_svc) if edge_pkg is PORT
            else _ref_server(rtmp_service=edge_svc))
    puller = player = None
    try:
        stream = pub.create_stream().publish(name)
        stream.send_video(b"\x17\x00SEQ", 0)
        puller = edge_pkg.rc.pull_into_service(edge_svc, name, "127.0.0.1",
                                               origin_port)
        assert puller.digest_mode
        player = _Player(PORT, edge.listen_endpoint.port, name)
        player.wait(1, "the sequence header through the edge")
        frames = _frames(3, 6)
        for t, ts, payload in frames:
            (stream.send_video if t == rp.MSG_VIDEO
             else stream.send_audio)(payload, ts)
        assert player.wait(7, "the pulled frames")[1:] == frames
    finally:
        for c in (player.client if player else None, puller, pub):
            if c is not None:
                c.close()
        edge.stop()


def test_replies_and_relayed_frames_stay_whole(servers):
    """A player's reading task writes pongs while the publisher's task
    writes frames to the same socket: every message arrives whole."""
    port = servers["port"].listen_endpoint.port
    pub = rc.RtmpClient("127.0.0.1", port).connect()
    conn, ply = rp.rtmp_client_connect("127.0.0.1", port)
    try:
        stream = pub.create_stream().publish("whole")
        ply.send_command("createStream", 2.0, None)
        ply.send_command("play", 4.0, None, "whole", stream_id=1)
        assert ply.pump_until(lambda s: any(
            c[0] == "onStatus" and c[3]["code"] == "NetStream.Play.Start"
            for c in s.commands()))
        ply.inbox.clear()
        frames = _frames(4, 60)

        def pings():
            for i in range(200):
                ply._send_control(rp.MSG_USER_CONTROL,
                                  struct.pack(">HI", rp.UC_PING, i))

        t = threading.Thread(target=pings)
        t.start()
        for kind, ts, payload in frames:
            (stream.send_video if kind == rp.MSG_VIDEO
             else stream.send_audio)(payload, ts)
        t.join(WAIT_S)
        assert ply.pump_until(lambda s: len(s.inbox) >= 260, timeout=WAIT_S)
        media = [m for m in ply.inbox if m[0] != rp.MSG_USER_CONTROL]
        pongs = [struct.unpack(">HI", p) for t_, _, p in ply.inbox
                 if t_ == rp.MSG_USER_CONTROL]
        assert media == frames
        assert pongs == [(rp.UC_PONG, i) for i in range(200)]
    finally:
        conn.close()
        pub.close()


def test_port_answers_beside_rtmp(servers):
    srv = servers["port"]
    port = srv.listen_endpoint.port
    pconn, pub = rp.rtmp_client_connect("127.0.0.1", port)
    try:
        pub.send_command("createStream", 2.0, None)
        pub.send_command("publish", 3.0, None, "beside", "live", stream_id=1)
        assert pub.pump_until(lambda s: any(c[0] == "onStatus"
                                            for c in s.commands()))
        ch = rpc.Channel(rpc.ChannelOptions(timeout_ms=WAIT_S * 1000))
        assert ch.init(str(srv.listen_endpoint)) == 0
        cntl, resp = rpc.Controller(), wire.EchoResponse()
        ch.call_method("EchoService.Echo", cntl,
                       wire.EchoRequest(message="beside-rtmp"), resp)
        assert not cntl.failed() and resp.message == "beside-rtmp"
        ch.close()
        import http.client

        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=WAIT_S)
        conn.request("POST", "/EchoService/Echo",
                     body=b'{"message": "http-beside-rtmp"}',
                     headers={"Content-Type": "application/json"})
        assert b"http-beside-rtmp" in conn.getresponse().read()
        conn.close()
        assert "beside" in servers["port_svc"].stream_names()
    finally:
        pconn.close()


@pytest.mark.parametrize("digest", [True, False], ids=["digest", "simple"])
def test_c0c1_one_byte_at_a_time_reaches_rtmp(servers, digest):
    """The port server also serves redis, memcache, thrift, mongo and
    nshead, whose weak magic holds a short first read."""
    srv = servers["port"]
    c1 = (rc.make_digest_c1()[0] if digest
          else bytes(8) + os.urandom(rp.HANDSHAKE_SIZE - 8))
    c0c1 = bytes([3]) + c1
    with pysocket.create_connection(srv.listen_endpoint.as_sockaddr(),
                                    timeout=WAIT_S) as s:
        s.setsockopt(pysocket.IPPROTO_TCP, pysocket.TCP_NODELAY, 1)
        mine = s.getsockname()[1]
        conn = _wait_for(lambda: next(
            (c for c in srv.list_connections()
             if c.remote_side is not None and c.remote_side.port == mine),
            None), "the server's end of the connection")

        def held():
            sess = getattr(conn, "rtmp_session", None)
            return len(conn.read_portal) + (len(sess.pending) if sess else 0)

        for i in range(32):
            s.sendall(c0c1[i:i + 1])
            _wait_for(lambda: held() == i + 1, f"byte {i} read")
        s.sendall(c0c1[32:])
        reply = b""
        while len(reply) < 1 + 2 * rp.HANDSHAKE_SIZE:
            chunk = s.recv(65536)
            assert chunk, "closed in the handshake"
            reply += chunk
    assert reply[0] == 3
    s1, s2 = reply[1:1 + rp.HANDSHAKE_SIZE], reply[1 + rp.HANDSHAKE_SIZE:]
    if digest:
        assert rc.find_digest(s1, rc.FMS_KEY) is not None
    else:
        assert s2 == c1


def _closed_or_answer(port: int, data: bytes) -> bytes:
    """What the server sends back before it closes (b"" when it closes
    without a byte); fails when it neither answers nor closes."""
    with pysocket.create_connection(("127.0.0.1", port), timeout=3) as s:
        s.sendall(data)
        got = b""
        while True:
            chunk = s.recv(65536)  # a timeout fails the test
            if not chunk:
                return got
            got += chunk


@pytest.mark.parametrize("pkg", PKGS, ids=_ids)
def test_no_rtmp_service_closes_the_connection(pkg):
    srv = (_port_server() if pkg is PORT else _ref_server())
    try:
        assert _closed_or_answer(srv.listen_endpoint.port, bytes([3]) + bytes(
            rp.HANDSHAKE_SIZE)) == b""
    finally:
        srv.stop()


@pytest.mark.parametrize("pkg", PKGS, ids=_ids)
def test_esp_takes_the_handshake_before_rtmp(pkg):
    """ROADMAP queue C #31: esp has no magic and is tried before RTMP, in
    both packages, so on a server with both services esp reads a C0C1 as
    esp frames: a 32-byte head whose length field (C1 bytes 27-30) is
    out of range closes the connection; a zero length is answered with
    an esp echo per 32 bytes; RTMP never sees the bytes."""
    esp = esp_protocol if pkg is PORT else ref_esp
    kw = dict(rtmp_service=pkg.rp.RtmpService(), esp_service=esp.EspService())
    srv = _port_server(**kw) if pkg is PORT else _ref_server(**kw)
    try:
        port = srv.listen_endpoint.port
        c1 = bytearray(rp.HANDSHAKE_SIZE)
        c1[27:31] = struct.pack("<i", -1)
        assert _closed_or_answer(port, bytes([3]) + bytes(c1)) == b""
        # 1537 bytes of zero length heads: 48 whole heads, the rest held;
        # the connection is closed here after the echoes arrive
        with pysocket.create_connection(("127.0.0.1", port),
                                        timeout=3) as s:
            s.sendall(bytes([3]) + bytes(rp.HANDSHAKE_SIZE))
            got = b""
            while len(got) < 48 * 32:
                chunk = s.recv(65536)
                assert chunk
                got += chunk
        # esp heads (body length 0) came back, not S0 S1 S2
        assert len(got) == 48 * 32
        assert all(struct.unpack_from("<i", got, i + 28) == (0,)
                   for i in range(0, len(got), 32))
    finally:
        srv.stop()


# -- shedding ----------------------------------------------------------------

@pytest.mark.parametrize("pkg", PKGS, ids=_ids)
def test_stalled_player_is_shed(pkg):
    svc = pkg.rp.RtmpService()
    srv = (_port_server(rtmp_service=svc) if pkg is PORT
           else _ref_server(rtmp_service=svc))
    pub = rc.RtmpClient("127.0.0.1", srv.listen_endpoint.port).connect()
    conn, stalled = rp.rtmp_client_connect("127.0.0.1",
                                           srv.listen_endpoint.port)
    good = None
    try:
        stream = pub.create_stream().publish("shed")
        stalled.send_command("createStream", 2.0, None)
        stalled.send_command("play", 4.0, None, "shed", stream_id=1)
        assert stalled.pump_until(lambda s: any(
            c[0] == "onStatus" and c[3]["code"] == "NetStream.Play.Start"
            for c in s.commands()))
        good = _Player(PORT, srv.listen_endpoint.port, "shed")
        # the stalled player reads nothing more: 64 keyframes of 256 KiB
        frame = b"\x17\x01" + bytes(256 * 1024 - 2)
        for i in range(64):
            stream.send_video(frame, i * 33)
        assert good.wait(64, "every frame at the good player") == [
            (rp.MSG_VIDEO, i * 33, frame) for i in range(64)]
        _wait_for(lambda: len(svc._streams["shed"].players) == 1,
                  "the stalled player shed")
        conn.settimeout(WAIT_S)
        read = 0
        while chunk := conn.recv(1 << 20):  # drains to the server's close
            read += len(chunk)
        assert read < 64 * len(frame) - svc.MAX_PLAYER_BACKLOG
    finally:
        conn.close()
        for c in (good.client if good else None, pub):
            if c is not None:
                c.close()
        srv.stop()


# -- kept mismatches ---------------------------------------------------------

@pytest.mark.parametrize("pkg", PKGS, ids=_ids)
def test_sessions_that_hang_up(pkg):
    """ROADMAP queue C #32: clients close without deleteStream. The port
    drops their sessions (the name is reaped, ``rtmp_sessions`` back);
    the reference keeps the name and counts every session ever made."""
    svc = pkg.rp.RtmpService()
    srv = (_port_server(rtmp_service=svc) if pkg is PORT
           else _ref_server(rtmp_service=svc))
    try:
        before = pkg.rp._rtmp_sessions.get_value()
        port = srv.listen_endpoint.port
        pub = rc.RtmpClient("127.0.0.1", port).connect()
        pub.create_stream().publish("hangup")
        player = _Player(PORT, port, "hangup")
        assert svc.stream_names() == ["hangup"]
        mid = pkg.rp._rtmp_sessions.get_value()
        assert mid >= before + 2 or pkg is PORT
        pub.close()
        player.client.close()
        if pkg is PORT:
            # other tests' sessions may still be ending: count down from
            # the value with this test's two sessions alive
            _wait_for(lambda: not svc.stream_names(), "the name reaped")
            _wait_for(lambda: pkg.rp._rtmp_sessions.get_value() <= mid - 2,
                      "rtmp_sessions back")
        else:
            time.sleep(0.3)  # the reference never reaps: nothing to wait for
            assert svc.stream_names() == ["hangup"]
            assert pkg.rp._rtmp_sessions.get_value() >= before + 2
    finally:
        srv.stop()


@pytest.mark.parametrize("pkg", PKGS, ids=_ids)
def test_dead_edge_pull_and_its_name(pkg):
    """ROADMAP queue C #33: the origin of an edge pull stops. The port's
    edge frees the name once the pull's reader ended; the reference's
    stand-in publisher never reports failure, so the name stays claimed
    until the process ends."""
    origin = _port_server(rtmp_service=rp.RtmpService())
    edge_svc = pkg.rp.RtmpService()
    pub = rc.RtmpClient("127.0.0.1", origin.listen_endpoint.port).connect()
    pub.create_stream().publish("edge")
    puller = pkg.rc.pull_into_service(edge_svc, "edge", "127.0.0.1",
                                      origin.listen_endpoint.port)
    try:
        origin.stop()
        puller._reader.join(WAIT_S)
        assert not puller._reader.is_alive()
        newcomer = SimpleNamespace(sock=_Sink())
        if pkg is PORT:
            _wait_for(lambda: not edge_svc.stream_names(), "the name freed")
            assert edge_svc.on_publish("edge", newcomer)
        else:
            assert edge_svc.stream_names() == ["edge"]
            assert not edge_svc.on_publish("edge", newcomer)
    finally:
        puller.close()
        pub.close()


# -- two processes, the example ----------------------------------------------

ORIGIN = """
import sys
sys.path.insert(0, sys.argv[1])
from brpc_tpu_torch import rpc
from brpc_tpu_torch.rpc import rtmp_protocol as rp
srv = rpc.Server(rpc.ServerOptions(num_threads=4, device="cpu",
                                   rtmp_service=rp.RtmpService()))
assert srv.start("127.0.0.1:0") == 0
print(srv.listen_endpoint.port, flush=True)
sys.stdin.readline()
srv.stop()
"""


def test_two_process_relay():
    """A spawned port origin; this process publishes into it, an edge
    here pulls from it and a player reads the edge."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.Popen([sys.executable, "-c", ORIGIN, REPO],
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            text=True, env=env)
    edge = None
    clients = []
    try:
        import select

        ready, _, _ = select.select([proc.stdout], [], [], 30)
        assert ready, "the origin printed no port"
        origin_port = int(proc.stdout.readline())
        pub = rc.RtmpClient("127.0.0.1", origin_port).connect()
        clients.append(pub)
        stream = pub.create_stream().publish("two")
        stream.send_metadata({"relay": 1.0})
        edge_svc = rp.RtmpService()
        edge = _port_server(rtmp_service=edge_svc)
        clients.append(rc.pull_into_service(edge_svc, "two", "127.0.0.1",
                                            origin_port))
        player = _Player(PORT, edge.listen_endpoint.port, "two")
        clients.append(player.client)
        player.wait(1, "the metadata through the edge")
        frames = _frames(6, 8)
        for t, ts, payload in frames:
            (stream.send_video if t == rp.MSG_VIDEO
             else stream.send_audio)(payload, ts)
        assert player.wait(9, "the frames of the other process")[1:] == \
            frames
    finally:
        for c in clients:
            c.close()
        if edge is not None:
            edge.stop()
        proc.stdin.close()
        proc.wait(timeout=10)


def test_example_prints_the_references_lines(servers):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), \
            pytest.MonkeyPatch.context() as mp:
        mp.setenv("BRPC_TPU_FABRIC", "0")
        mp.setattr(ref_native, "available", lambda: False)
        # and the port's pages show no native section, whether or not
        # an earlier test of this process loaded the port's library
        mp.setattr(port_native, "is_loaded", lambda: False)
        mp.setattr(sys, "argv", ["examples/rtmp_relay.py"])
        mp.chdir(REPO)
        try:
            runpy.run_path(os.path.join(REPO, "examples", "rtmp_relay.py"),
                           run_name="__main__")
            ref_code = 0
        except SystemExit as e:
            ref_code = e.code or 0
    ref_out = buf.getvalue()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = rtmp_relay.main(["--device", "cpu"])

    def mask(text):
        text = re.sub(r"127\.0\.0\.1:\d+", "127.0.0.1:N", text)
        return re.sub(r"relayed \d+ frames pulled", "relayed N frames pulled",
                      text)

    assert ref_code == code == 0, (ref_out, buf.getvalue())
    assert mask(buf.getvalue()) == mask(ref_out)
