"""The port's gRPC over HTTP/2 held against brpc_tpu's, on the CPU.

* HPACK, over seeded header lists (static hits, names of the static
  table with other values, literal names, values past each integer
  prefix width, with and without Huffman): the port's encoder gives the
  reference's bytes, each decoder decodes the other's blocks, the
  dynamic table indexes, evicts and resizes the same way, and both
  refuse a truncated string and bad Huffman padding.
* The frame and gRPC codecs, the status maps both ways and
  ``grpc-timeout``, case by case against the reference.
* Live, on one port server (a module fixture) that answers tpu_std, HTTP
  and h2 on its one port: unary calls, 16 concurrent streams on one
  connection, an error carried in the trailers, an unknown method and
  service, a deadline, messages of 200,000 B and 4 MiB, a preface split
  across reads, and the TensorStore service called over gRPC (pinned in
  both packages: a push fails, a pull finds its tensor and carries none).
* A client whose window stays small (ROADMAP queue C #22): the port
  holds the trailers behind the response's queued DATA; the reference
  sends them at once and drops the rest.
* Against a scripted h2 peer, both packages' clients: the preface is
  the first thing on every connection, also when 8 calls start at once;
  RST_STREAM fails the attempt and the retry opens a new stream; GOAWAY
  refuses the streams past its last id, marks the connection lame duck
  and the retry opens a new connection; a request goes whole past the
  window the peer gave (queue C #24).
* Interop four ways: a reference ``h2:grpc`` channel to the port server,
  a port channel to a reference server, a ``grpcio`` stub to the port
  server, a port channel to a ``grpcio`` server.

Threads only, no spawned process; every wait has a deadline.
"""
import http.client
import socket as pysocket
import struct
import threading
import time

import numpy as np
import pytest

from brpc_tpu import rpc as ref_rpc
from brpc_tpu.bthread import get_task_control as ref_get_task_control
from brpc_tpu.rpc import errors as ref_errors
from brpc_tpu.rpc import h2_protocol as ref_h2
from brpc_tpu.rpc import hpack as ref_hpack
from brpc_tpu.rpc.proto import echo_pb2, tensor_service_pb2
from brpc_tpu.rpc.tensor_service import TensorStoreService as RefStore
from brpc_tpu_torch import rpc
from brpc_tpu_torch.rpc import errors
from brpc_tpu_torch.rpc import h2_protocol as h2
from brpc_tpu_torch.rpc import hpack
from brpc_tpu_torch.rpc.proto import wire
from brpc_tpu_torch.rpc.socket import Socket
from brpc_tpu_torch.rpc.tensor_service import TensorStoreService

grpc = pytest.importorskip("grpc")

WAIT_S = 3.0
PREFACE = h2.PREFACE

# -- HPACK -------------------------------------------------------------------

_NAMES = ["x-trace", "grpc-timeout", "te", "user-agent-x", "x-é", "k"]


def _header_list(seed: int):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(int(rng.integers(4, 14))):
        kind = int(rng.integers(0, 4))
        if kind == 0:  # an exact static entry
            out.append(hpack.STATIC_TABLE[int(rng.integers(0, 61))])
            continue
        n = int(rng.choice([0, 1, 14, 126, 127, 128, 300, 16500]))
        value = "".join(chr(int(c)) for c in rng.integers(32, 127, n))
        if kind == 1:  # a static name with another value
            name = hpack.STATIC_TABLE[int(rng.integers(0, 61))][0]
        else:
            name = _NAMES[int(rng.integers(0, len(_NAMES)))]
        out.append((name, value))
    return out


@pytest.mark.parametrize("seed", range(8))
def test_hpack_blocks_are_the_references(seed):
    headers = _header_list(seed)
    block = hpack.HpackEncoder().encode(headers)
    ref_block = ref_hpack.HpackEncoder().encode(headers)
    assert block == ref_block
    assert hpack.HpackDecoder().decode(ref_block) == headers
    assert ref_hpack.HpackDecoder().decode(block) == headers
    for name, value in headers:
        # Huffman in Python is bit by bit: the long values go without it
        for huff in (False, True) if len(value) <= 300 else (False,):
            s = hpack.encode_str(value, huff)
            assert s == ref_hpack.encode_str(value, huff)
            assert hpack.decode_str(s, 0) == ref_hpack.decode_str(s, 0)
        raw = value.encode()[:300]
        assert hpack.huffman_encode(raw) == ref_hpack.huffman_encode(raw)
        assert (hpack.huffman_decode(hpack.huffman_encode(raw))
                == ref_hpack.huffman_decode(ref_hpack.huffman_encode(raw))
                == raw)


@pytest.mark.parametrize("prefix", range(1, 9))
def test_hpack_integers_across_the_prefix(prefix):
    limit = (1 << prefix) - 1
    values = [0, 1, limit - 1, limit, limit + 1, limit + 127, limit + 128,
              16383, 16384, 1 << 21, (1 << 28) + 5]
    for v in [x for x in values if x >= 0]:
        for first in (0x00, 0x80 & ~limit & 0xFF):
            enc = hpack.encode_int(v, prefix, first)
            assert enc == ref_hpack.encode_int(v, prefix, first)
            assert (hpack.decode_int(enc, 0, prefix)
                    == ref_hpack.decode_int(enc, 0, prefix) == (v, len(enc)))


def _dynamic_blocks(seed: int):
    """Blocks that index (0x40), reference the dynamic table, shrink it by
    a size update (0x20) and grow it back."""
    rng = np.random.default_rng(seed)
    blocks = []
    for _ in range(6):
        blk = b""
        for _ in range(int(rng.integers(1, 5))):
            n = int(rng.integers(1, 120))
            value = "v" * n
            if rng.random() < 0.5:  # a static name, indexed
                blk += hpack.encode_int(int(rng.integers(1, 62)), 6, 0x40)
            else:
                blk += b"\x40" + hpack.encode_str(f"n{n}", rng.random() < 0.5)
            blk += hpack.encode_str(value, rng.random() < 0.5)
        blk += hpack.encode_int(62, 7, 0x80)  # the newest dynamic entry
        if rng.random() < 0.4:
            blk = hpack.encode_int(int(rng.integers(0, 400)), 5, 0x20) + blk
        blocks.append(blk)
    blocks.append(hpack.encode_int(4096, 5, 0x20) + b"\x82")
    return blocks


@pytest.mark.parametrize("seed", range(4))
def test_hpack_dynamic_table_evicts_and_resizes_alike(seed):
    dec, ref_dec = hpack.HpackDecoder(), ref_hpack.HpackDecoder()
    for blk in _dynamic_blocks(seed):
        outs = []
        for d in (dec, ref_dec):
            try:
                outs.append(d.decode(blk))
            except ValueError as e:
                outs.append(f"ValueError: {e}")
        assert outs[0] == outs[1]
        assert (dec._dynamic, dec._size, dec._max_size) == (
            ref_dec._dynamic, ref_dec._size, ref_dec._max_size)


@pytest.mark.parametrize("mod", [hpack, ref_hpack], ids=["port", "ref"])
def test_hpack_refuses_truncated_strings_and_bad_padding(mod):
    with pytest.raises(ValueError):
        mod.decode_str(mod.encode_int(10, 7, 0x00) + b"abc", 0)
    good = mod.huffman_encode(b"www.example.com")
    assert mod.huffman_decode(good) == b"www.example.com"
    with pytest.raises(ValueError):
        mod.huffman_decode(bytes([0b00011_000]))  # 'a', zero padding
    with pytest.raises(ValueError):
        mod.huffman_decode(b"\xff\xff")  # padding longer than 7 bits
    with pytest.raises(ValueError):
        mod.HpackDecoder().decode(mod.encode_int(70, 7, 0x80))


# -- codecs ------------------------------------------------------------------

def test_frame_and_grpc_codecs_are_the_references():
    rng = np.random.default_rng(5)
    for _ in range(32):
        ftype, flags = int(rng.integers(0, 10)), int(rng.integers(0, 256))
        sid = int(rng.integers(0, 1 << 32))
        payload = rng.bytes(int(rng.choice([0, 1, 9, 16384, 70000])))
        assert (h2.pack_frame(ftype, flags, sid, payload)
                == ref_h2.pack_frame(ftype, flags, sid, payload))
        assert h2.grpc_wrap(payload) == ref_h2.grpc_wrap(payload)
        wrapped = h2.grpc_wrap(payload)
        for cut in (0, 3, 5, len(wrapped) - 1, len(wrapped)):
            assert (h2.grpc_unwrap(wrapped[:cut])
                    == ref_h2.grpc_unwrap(wrapped[:cut]))
    assert h2.PREFACE == ref_h2.PREFACE
    assert (h2.H2Connection(True).initial_frames()
            == ref_h2.H2Connection(True).initial_frames())
    assert (h2.H2Connection(False).initial_frames()
            == ref_h2.H2Connection(False).initial_frames())


def test_status_maps_and_timeouts_are_the_references():
    codes = sorted({v for k, v in vars(ref_errors).items()
                    if k.isupper() and isinstance(v, int)} | {0, 12345})
    for code in codes:
        assert h2.error_to_grpc_status(code) == ref_h2.error_to_grpc_status(code)
    for status in range(-1, 20):
        assert (h2.grpc_status_to_error(status)
                == ref_h2.grpc_status_to_error(status))
    for text in ("100m", "2S", "1M", "1H", "250u", "7n", "3x", "0m"):
        assert (h2._parse_grpc_timeout(text)
                == ref_h2._parse_grpc_timeout(text))


# -- live ----------------------------------------------------------------------

class PortEcho(rpc.Service):
    SERVICE_NAME = "EchoService"

    @rpc.rpc_method(wire.EchoRequest, wire.EchoResponse)
    def Echo(self, cntl, request, response, done):
        if request.code:
            cntl.set_failed(request.code, "requested failure")
            done()
            return
        if request.sleep_us:
            time.sleep(request.sleep_us / 1e6)
        response.message = request.message
        done()


class RefEcho(ref_rpc.Service):
    SERVICE_NAME = "EchoService"

    @ref_rpc.rpc_method(echo_pb2.EchoRequest, echo_pb2.EchoResponse)
    def Echo(self, cntl, request, response, done):
        if request.code:
            cntl.set_failed(request.code, "requested failure")
            done()
            return
        response.message = request.message
        done()


@pytest.fixture(scope="module")
def servers():
    ref_get_task_control()  # the reference's bthread pool, sized first
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BRPC_TPU_FABRIC", "0")
        port = rpc.Server(rpc.ServerOptions(num_threads=4, device="cpu"))
        port.add_service(PortEcho())
        port.add_service(TensorStoreService())
        assert port.start("127.0.0.1:0") == 0
        ref = ref_rpc.Server(ref_rpc.ServerOptions(
            num_threads=4, has_builtin_services=False))
        ref.add_service(RefEcho())
        ref.add_service(RefStore())
        assert ref.start("127.0.0.1:0") == 0
        yield {"port": port, "ref": ref}
        ref.stop()
        port.stop()


def _port_channel(target, **opts):
    ch = rpc.Channel(rpc.ChannelOptions(protocol="h2:grpc", timeout_ms=5000,
                                        **opts))
    assert ch.init(str(target)) == 0
    return ch


def _ref_channel(target, **opts):
    ch = ref_rpc.Channel(ref_rpc.ChannelOptions(protocol="h2:grpc",
                                                timeout_ms=5000, **opts))
    assert ch.init(str(target)) == 0
    return ch


@pytest.fixture(scope="module")
def port_channel(servers):
    ch = _port_channel(servers["port"].listen_endpoint)
    yield ch
    ch.close()


def _conn(ch) -> "h2.H2Connection":
    return Socket.address(ch._single_sid).h2_conn


def test_unary_calls_on_one_connection(port_channel):
    for i in range(20):
        cntl, resp = port_channel.call("EchoService.Echo",
                                       wire.EchoRequest(message=f"s{i}"),
                                       wire.EchoResponse)
        assert not cntl.failed(), cntl.error_text
        assert resp.message == f"s{i}"
    conn = _conn(port_channel)
    assert conn.is_client and not conn.streams


def test_sixteen_concurrent_streams_on_one_connection(port_channel):
    port_channel.call("EchoService.Echo", wire.EchoRequest(message="w"),
                      wire.EchoResponse)
    conn = _conn(port_channel)
    first = conn.next_stream_id
    got = {}

    def one(i):
        cntl, resp = port_channel.call(
            "EchoService.Echo", wire.EchoRequest(message=f"c{i}"),
            wire.EchoResponse)
        got[i] = (cntl.error_code, resp.message)

    threads = [threading.Thread(target=one, args=(i,)) for i in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(WAIT_S * 3)
    assert got == {i: (0, f"c{i}") for i in range(16)}
    assert _conn(port_channel) is conn
    assert conn.next_stream_id == first + 32 and not conn.streams


def test_errors_travel_in_trailers(port_channel, servers):
    cntl, _ = port_channel.call(
        "EchoService.Echo", wire.EchoRequest(message="x", code=errors.ELIMIT),
        wire.EchoResponse)
    assert (cntl.error_code, cntl.error_text) == (errors.ELIMIT,
                                                  "requested failure")
    cntl, _ = port_channel.call("EchoService.Nope",
                                wire.EchoRequest(message="x"),
                                wire.EchoResponse)
    assert cntl.error_code == errors.ENOMETHOD
    cntl, _ = port_channel.call("NoService.Echo",
                                wire.EchoRequest(message="x"),
                                wire.EchoResponse)
    assert cntl.error_code == errors.ENOSERVICE
    t0 = time.monotonic()
    cntl, _ = port_channel.call(
        "EchoService.Echo", wire.EchoRequest(message="slow", sleep_us=300_000),
        wire.EchoResponse, timeout_ms=80)
    assert cntl.error_code == errors.ERPCTIMEDOUT
    assert time.monotonic() - t0 < 0.3
    # the late answer finds its call ended; the next call is answered
    cntl, resp = port_channel.call("EchoService.Echo",
                                   wire.EchoRequest(message="after"),
                                   wire.EchoResponse)
    assert not cntl.failed() and resp.message == "after"


@pytest.mark.parametrize("n", [200_000, 4 << 20])
def test_large_messages_cross_both_windows(port_channel, n):
    rng = np.random.default_rng(n)
    text = "".join(chr(c) for c in rng.integers(32, 127, 64)) * (n // 64)
    conn = _conn(port_channel)
    data0 = conn.frames_in.get(h2.F_DATA, 0)
    cntl, resp = port_channel.call("EchoService.Echo",
                                   wire.EchoRequest(message=text),
                                   wire.EchoResponse, timeout_ms=20000)
    assert not cntl.failed(), cntl.error_text
    assert resp.message == text
    frames = -(-(len(wire.EchoResponse(message=text).SerializeToString()) + 5)
               // h2.MAX_FRAME)
    assert conn.frames_in[h2.F_DATA] - data0 == frames
    assert not conn.streams


def _frames(data: bytes):
    out, pos = [], 0
    while pos + 9 <= len(data):
        n = int.from_bytes(data[pos:pos + 3], "big")
        if pos + 9 + n > len(data):
            break
        out.append((data[pos + 3], data[pos + 4],
                    int.from_bytes(data[pos + 5:pos + 9], "big") & 0x7FFFFFFF,
                    data[pos + 9:pos + 9 + n]))
        pos += 9 + n
    return out, data[pos:]


def _read_for(sk, seconds: float) -> bytes:
    sk.settimeout(0.05)
    buf = b""
    end = time.monotonic() + seconds
    while time.monotonic() < end:
        try:
            d = sk.recv(1 << 20)
        except pysocket.timeout:
            continue
        if not d:
            break
        buf += d
    return buf


def _raw_request(message: str, sid: int = 1) -> bytes:
    blk = hpack.HpackEncoder().encode([
        (":method", "POST"), (":scheme", "http"),
        (":path", "/EchoService/Echo"), ("content-type", "application/grpc")])
    body = h2.grpc_wrap(wire.EchoRequest(message=message).SerializeToString())
    out = h2.pack_frame(h2.F_HEADERS, h2.FLAG_END_HEADERS, sid, blk)
    for pos in range(0, len(body), h2.MAX_FRAME):
        end = pos + h2.MAX_FRAME >= len(body)
        out += h2.pack_frame(h2.F_DATA, h2.FLAG_END_STREAM if end else 0, sid,
                             body[pos:pos + h2.MAX_FRAME])
    return out


@pytest.mark.parametrize("step", [1, 3, 5])
def test_preface_split_across_reads(servers, step):
    sk = pysocket.create_connection(
        ("127.0.0.1", servers["port"].listen_endpoint.port), timeout=WAIT_S)
    sk.setsockopt(pysocket.IPPROTO_TCP, pysocket.TCP_NODELAY, 1)
    try:
        for pos in range(0, len(PREFACE), step):
            sk.sendall(PREFACE[pos:pos + step])
            time.sleep(0.01)  # each piece its own read
        sk.sendall(h2.pack_frame(h2.F_SETTINGS, 0, 0, b"")
                   + _raw_request(f"split{step}"))
        buf = b""
        end = time.monotonic() + WAIT_S
        while time.monotonic() < end:
            buf += _read_for(sk, 0.1)
            frames, _ = _frames(buf)
            if any(t == h2.F_HEADERS and f & h2.FLAG_END_STREAM
                   for t, f, s, p in frames):
                break
        data = b"".join(p for t, f, s, p in frames
                        if t == h2.F_DATA and s == 1)
        msg = wire.EchoResponse()
        msg.ParseFromString(h2.grpc_unwrap(data))
        assert msg.message == f"split{step}"
        assert frames[0][0] == h2.F_SETTINGS  # the server's, sent first
    finally:
        sk.close()


def test_tpu_std_http_and_h2_on_one_port(servers, port_channel):
    srv = servers["port"]
    status = srv.method_statuses()["EchoService.Echo"].latency_recorder
    n0 = status.count()
    for i in range(3):
        cntl, resp = port_channel.call("EchoService.Echo",
                                       wire.EchoRequest(message=f"g{i}"),
                                       wire.EchoResponse)
        assert resp.message == f"g{i}"
    std = rpc.Channel(rpc.ChannelOptions(device="cpu"))
    assert std.init(str(srv.listen_endpoint)) == 0
    cntl, resp = std.call("EchoService.Echo", wire.EchoRequest(message="std"),
                          wire.EchoResponse)
    std.close()
    assert not cntl.failed() and resp.message == "std"
    # the method's status counts the gRPC calls with the tpu_std one
    assert status.count() - n0 == 4
    c = http.client.HTTPConnection("127.0.0.1", srv.listen_endpoint.port,
                                   timeout=WAIT_S)
    c.request("GET", "/status")
    page = c.getresponse().read().decode()
    c.close()
    assert "EchoService.Echo" in page


def _store_over_grpc(channel, req_mod):
    """(push code, push text, pull code, found) of TensorStore over gRPC."""
    push = channel.call("TensorStore.Push",
                        req_mod.TensorPushRequest(name="t"),
                        req_mod.TensorPushResponse)[0]
    pcntl, pulled = channel.call("TensorStore.Pull",
                                 req_mod.TensorPullRequest(name="held"),
                                 req_mod.TensorPullResponse)
    return push.error_code, push.error_text, pcntl.error_code, pulled.found


def test_tensor_store_over_grpc_in_both_packages(servers):
    """A push over gRPC carries no tensors: 1003 on the server, which has
    no gRPC status of its own, so it goes as INTERNAL and comes back as
    EINVAL. A pull finds its tensor and carries none. Both packages."""
    import torch

    servers["port"].find_service("TensorStore")._store["held"] = [
        torch.ones(4)]
    servers["ref"].find_service("TensorStore")._store["held"] = [
        np.ones(4, np.float32)]
    assert h2.error_to_grpc_status(errors.EREQUEST) == h2.GRPC_INTERNAL
    got = {}
    for name, ch in (
            ("port", _port_channel(servers["port"].listen_endpoint)),
            ("ref", _ref_channel(servers["ref"].listen_endpoint))):
        got[name] = _store_over_grpc(
            ch, wire if name == "port" else tensor_service_pb2)
        ch.close()
    assert got["port"] == got["ref"] == (
        errors.EINVAL, "no tensors in request", 0, True)


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_small_client_window(servers, pkg):
    """ROADMAP queue C #22: a client that opens no window. The port
    sends 3 DATA frames (49,152 B), holds the trailers, and sends the
    rest and then the trailers once the window opens; the reference sends
    the trailers at once and never the rest."""
    sk = pysocket.create_connection(
        ("127.0.0.1", servers[pkg].listen_endpoint.port), timeout=WAIT_S)
    try:
        text = "z" * 200_000
        sk.sendall(PREFACE + h2.pack_frame(h2.F_SETTINGS, 0, 0, b"")
                   + _raw_request(text))
        before, rest = _frames(_read_for(sk, 0.5))
        sk.sendall(h2.pack_frame(h2.F_WINDOW_UPDATE, 0, 0,
                                 struct.pack(">I", 1 << 20))
                   + h2.pack_frame(h2.F_WINDOW_UPDATE, 0, 1,
                                   struct.pack(">I", 1 << 20)))
        after, _ = _frames(rest + _read_for(sk, 0.5))
    finally:
        sk.close()

    def stream(frames):
        data = sum(len(p) for t, f, s, p in frames
                   if t == h2.F_DATA and s == 1)
        ended = any(t == h2.F_HEADERS and f & h2.FLAG_END_STREAM and s == 1
                    for t, f, s, p in frames)
        return data, ended

    body = len(h2.grpc_wrap(
        wire.EchoResponse(message=text).SerializeToString()))
    if pkg == "port":
        assert stream(before) == (3 * h2.MAX_FRAME, False)
        assert stream(after) == (body - 3 * h2.MAX_FRAME, True)
    else:
        assert stream(before) == (3 * h2.MAX_FRAME, True)
        assert stream(after) == (0, False)


# -- a scripted h2 peer ------------------------------------------------------

class ScriptedPeer:
    """An h2 server on a raw socket: it speaks first (SETTINGS with
    ``settings``), records each connection's first bytes and each
    request's stream id and body size, and per request answers an echo,
    an RST_STREAM or a GOAWAY, as ``script`` (a list of actions, one per
    request, then echoes) says. It never sends a WINDOW_UPDATE."""

    def __init__(self, script, settings: bytes = b""):
        self.script = list(script)
        self.settings = settings
        self.lock = threading.Lock()
        self.heads = []  # the first 24 bytes of each connection
        self.requests = []  # (connection index, stream id)
        self.bodies = []  # the DATA bytes of each request
        self.lsock = pysocket.socket()
        self.lsock.bind(("127.0.0.1", 0))
        self.lsock.listen(16)
        self.port = self.lsock.getsockname()[1]
        self.stopped = False
        threading.Thread(target=self._accept, daemon=True).start()

    def _accept(self):
        while not self.stopped:
            try:
                sk, _ = self.lsock.accept()
            except OSError:
                return
            with self.lock:
                idx = len(self.heads)
                self.heads.append(None)
            threading.Thread(target=self._serve, args=(sk, idx),
                             daemon=True).start()

    def _serve(self, sk, idx):
        enc, dec = hpack.HpackEncoder(), hpack.HpackDecoder()
        sk.sendall(h2.pack_frame(h2.F_SETTINGS, 0, 0, self.settings))
        buf, data = b"", {}
        sk.settimeout(10)
        try:
            while True:
                d = sk.recv(1 << 16)
                if not d:
                    return
                buf += d
                if self.heads[idx] is None:
                    if len(buf) < len(PREFACE):
                        continue
                    self.heads[idx] = buf[:len(PREFACE)]
                    buf = buf[len(PREFACE):]
                frames, buf = _frames(buf)
                for t, f, sid, p in frames:
                    if t == h2.F_HEADERS:
                        dec.decode(p)
                        data[sid] = b""
                    elif t == h2.F_DATA:
                        data[sid] += p
                    if t in (h2.F_HEADERS, h2.F_DATA) and f & h2.FLAG_END_STREAM:
                        self._answer(sk, enc, idx, sid, data.pop(sid))
        except OSError:
            return
        finally:
            sk.close()

    def _answer(self, sk, enc, idx, sid, body):
        with self.lock:
            self.requests.append((idx, sid))
            self.bodies.append(len(body))
            action = self.script.pop(0) if self.script else "echo"
        if action == "rst":
            sk.sendall(h2.pack_frame(h2.F_RST_STREAM, 0, sid,
                                     struct.pack(">I", 2)))
            return
        if action == "goaway":
            sk.sendall(h2.pack_frame(h2.F_GOAWAY, 0, 0,
                                     struct.pack(">II", 0, 0)))
            return
        out = h2.pack_frame(h2.F_HEADERS, h2.FLAG_END_HEADERS, sid, enc.encode(
            [(":status", "200"), ("content-type", "application/grpc")]))
        out += h2.pack_frame(h2.F_DATA, 0, sid, body)  # the request, echoed
        out += h2.pack_frame(h2.F_HEADERS, h2.FLAG_END_HEADERS
                             | h2.FLAG_END_STREAM, sid,
                             enc.encode([("grpc-status", "0")]))
        sk.sendall(out)

    def stop(self):
        self.stopped = True
        self.lsock.close()


def _call(pkg, ch, message, **kw):
    mod = wire if pkg == "port" else echo_pb2
    cntl, resp = ch.call("EchoService.Echo", mod.EchoRequest(message=message),
                         mod.EchoResponse, **kw)
    return cntl.error_code, cntl.error_text, resp.message


def _peer_channel(pkg, port, **opts):
    make = _port_channel if pkg == "port" else _ref_channel
    return make(f"127.0.0.1:{port}", **opts)


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_preface_first_when_calls_start_at_once(pkg, servers):
    peer = ScriptedPeer([])
    ch = _peer_channel(pkg, peer.port)
    got = {}

    def one(i):
        got[i] = _call(pkg, ch, f"m{i}")

    try:
        threads = [threading.Thread(target=one, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT_S * 2)
        assert got == {i: (0, "", f"m{i}") for i in range(8)}
        assert peer.heads == [PREFACE]
        assert sorted(s for _, s in peer.requests) == list(range(1, 17, 2))
    finally:
        ch.close()
        peer.stop()


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_reset_stream_fails_the_attempt_and_the_retry_opens_another(pkg,
                                                                     servers):
    peer = ScriptedPeer(["rst", "rst"])
    once = _peer_channel(pkg, peer.port, max_retry=0)
    retried = _peer_channel(pkg, peer.port, max_retry=2)
    try:
        code, text, _ = _call(pkg, once, "a")
        assert (code, text) == (errors.EFAILEDSOCKET, "h2 stream reset")
        assert _call(pkg, retried, "b") == (0, "", "b")
        # the channels share one connection; each attempt has a stream of
        # its own
        assert peer.requests == [(0, 1), (0, 3), (0, 5)]
    finally:
        once.close()
        retried.close()
        peer.stop()


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_goaway_refuses_and_the_retry_opens_a_new_connection(pkg, servers):
    peer = ScriptedPeer(["echo", "goaway"])
    try:
        ch = _peer_channel(pkg, peer.port, max_retry=1)
        assert _call(pkg, ch, "w") == (0, "", "w")
        first = Socket.address(ch._single_sid) if pkg == "port" else None
        assert _call(pkg, ch, "g") == (0, "", "g")
        # stream 3 was past GOAWAY's last id 0: refused, and retried on a
        # second connection, which begins with its own preface
        assert peer.requests == [(0, 1), (0, 3), (1, 1)]
        assert peer.heads == [PREFACE, PREFACE]
        if first is not None:
            assert first.lame_duck and not first.usable_for_new_calls()
            assert Socket.address(ch._single_sid) is not first
        ch.close()
    finally:
        peer.stop()


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_client_sends_a_request_past_the_peers_window(pkg, servers):
    """ROADMAP queue C #24 (both packages, kept): a client sends a
    request's DATA whole, whatever window the peer gave it; a peer that
    holds its windows to 1,024 B gets all 200,000 B at once."""
    peer = ScriptedPeer([], settings=struct.pack(
        ">HI", h2.SETTINGS_INITIAL_WINDOW_SIZE, 1024))
    ch = _peer_channel(pkg, peer.port)
    try:
        assert _call(pkg, ch, "w") == (0, "", "w")  # the SETTINGS are read
        text = "y" * 200_000
        assert _call(pkg, ch, text) == (0, "", text)
        assert peer.bodies[1] == len(h2.grpc_wrap(
            wire.EchoRequest(message=text).SerializeToString()))
    finally:
        ch.close()
        peer.stop()


# -- interop -----------------------------------------------------------------

def test_reference_channel_to_the_port_server(servers):
    ch = _ref_channel(servers["port"].listen_endpoint)
    try:
        for msg in ("ref->port", "r" * 200_000):
            cntl, resp = ch.call("EchoService.Echo",
                                 echo_pb2.EchoRequest(message=msg),
                                 echo_pb2.EchoResponse)
            assert not cntl.failed(), cntl.error_text
            assert resp.message == msg
        cntl, _ = ch.call("EchoService.Echo",
                          echo_pb2.EchoRequest(message="x",
                                               code=errors.ELIMIT),
                          echo_pb2.EchoResponse)
        assert cntl.error_code == errors.ELIMIT
    finally:
        ch.close()


def test_port_channel_to_the_reference_server(servers):
    ch = _port_channel(servers["ref"].listen_endpoint)
    try:
        for msg in ("port->ref", "p" * 200_000):
            cntl, resp = ch.call("EchoService.Echo",
                                 wire.EchoRequest(message=msg),
                                 wire.EchoResponse)
            assert not cntl.failed(), cntl.error_text
            assert resp.message == msg
        cntl, _ = ch.call("EchoService.Nope", wire.EchoRequest(message="x"),
                          wire.EchoResponse)
        assert cntl.error_code == errors.ENOMETHOD
    finally:
        ch.close()


def test_grpcio_stub_to_the_port_server(servers):
    target = f"127.0.0.1:{servers['port'].listen_endpoint.port}"
    with grpc.insecure_channel(target) as gch:
        stub = gch.unary_unary(
            "/EchoService/Echo",
            request_serializer=echo_pb2.EchoRequest.SerializeToString,
            response_deserializer=echo_pb2.EchoResponse.FromString)
        for msg in ("via grpcio", "q" * 200_000):
            assert stub(echo_pb2.EchoRequest(message=msg),
                        timeout=10).message == msg
        with pytest.raises(grpc.RpcError) as exc:
            stub(echo_pb2.EchoRequest(message="x", code=errors.ELIMIT),
                 timeout=10)
        assert exc.value.code() == grpc.StatusCode.RESOURCE_EXHAUSTED
        assert exc.value.details() == "requested failure"
        bad = gch.unary_unary(
            "/EchoService/Nope",
            request_serializer=echo_pb2.EchoRequest.SerializeToString,
            response_deserializer=echo_pb2.EchoResponse.FromString)
        with pytest.raises(grpc.RpcError) as exc:
            bad(echo_pb2.EchoRequest(message="x"), timeout=10)
        assert exc.value.code() == grpc.StatusCode.UNIMPLEMENTED


def test_port_channel_to_a_grpcio_server():
    from concurrent import futures

    class Handler(grpc.GenericRpcHandler):
        def service(self, details):
            if details.method != "/EchoService/Echo":
                return None

            def unary(request, context):
                return echo_pb2.EchoResponse(message=request.message[::-1])

            return grpc.unary_unary_rpc_method_handler(
                unary, request_deserializer=echo_pb2.EchoRequest.FromString,
                response_serializer=echo_pb2.EchoResponse.SerializeToString)

    gsrv = grpc.server(futures.ThreadPoolExecutor(max_workers=2))
    gsrv.add_generic_rpc_handlers((Handler(),))
    port = gsrv.add_insecure_port("127.0.0.1:0")
    gsrv.start()
    ch = _port_channel(f"127.0.0.1:{port}")
    try:
        for msg in ("ours->theirs", "ab" * 100_000):
            cntl, resp = ch.call("EchoService.Echo",
                                 wire.EchoRequest(message=msg),
                                 wire.EchoResponse)
            assert not cntl.failed(), cntl.error_text
            assert resp.message == msg[::-1]
        cntl, _ = ch.call("EchoService.Nope", wire.EchoRequest(message="x"),
                          wire.EchoResponse)
        assert cntl.error_code == errors.ENOMETHOD
    finally:
        ch.close()
        gsrv.stop(None)
