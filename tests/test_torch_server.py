"""The port's reference-grade server held against brpc_tpu's, on the CPU.

* Limiter twins: one script of on_requested / on_response calls on a fake
  clock gives the same decisions and max_concurrency in both packages
  (constant, auto, timeout, and the spec strings).
* bvar twins: Window over an Adder, a Maxer and an IntRecorder, PerSecond
  (on a fake clock) and LatencyRecorder, driven by force_tick_for_tests.
* Server twins: one Echo service on a reference server and on a port
  server, called by a port client, answers an unknown service, an
  unknown method, a garbage payload, an interceptor's refusal and the
  method's limit with the same codes; session data is lent and returned,
  and the method statuses count alike.
* The input messenger on raw bytes, both servers: several frames in one
  segment, a frame split across reads, a handshake and a request in one
  segment (the request runs after the connection holds its endpoint);
  unknown bytes close the port's connection.
* Options off by default, in both packages: ``enabled_protocols`` without
  the handshake closes a TDEV connection unanswered;
  ``graceful_quit_on_sigterm``'s handler stops the server, which fails
  its connections, and exits 0.
* No thread per connection: 64 connections to a port server add fewer
  than 8 threads to the process.
* A repaired fault of the port: a response meta carrying the SHUTDOWN
  bit marks its socket lame duck in both packages' ``parse``, and a
  balanced port channel then sends new calls to the other server.
* ROADMAP queue C #11 (both packages): a Pull that finds its window full
  holds its worker until the window's timeout, and the ACK that would
  open the window waits behind it.
* A DeviceEndpoint reached from many threads at once ends at rest.
* ``remove_service``, ``run_until_asked_to_quit`` and ``ClosureGuard``
  give the reference's outcomes.

Every server is stopped by its fixture or in ``finally``; every wait has a
deadline.
"""
import socket as pysocket
import struct
import sys
import threading
import time
import types

import pytest
import torch

from brpc_tpu import bvar as ref_bvar
from brpc_tpu import rpc as ref_rpc
from brpc_tpu.bthread import get_task_control as ref_get_task_control
from brpc_tpu.bthread import task_control as ref_tc
from brpc_tpu.butil.iobuf import IOBuf as RefIOBuf
from brpc_tpu.rpc import concurrency_limiter as ref_cl
from brpc_tpu.rpc import data_pools as ref_pools
from brpc_tpu.rpc import device_transport as ref_dt
from brpc_tpu.rpc import tensor_service as ref_ts
from brpc_tpu.rpc import tpu_std_protocol as ref_proto
from brpc_tpu.rpc.proto import echo_pb2
from brpc_tpu_torch import bvar, rpc
from brpc_tpu_torch.bthread import task_control as port_tc
from brpc_tpu_torch.butil.iobuf import IOBuf
from brpc_tpu_torch.rpc import concurrency_limiter as port_cl
from brpc_tpu_torch.rpc import data_pools as port_pools
from brpc_tpu_torch.rpc import device_transport as dt
from brpc_tpu_torch.rpc import errors
from brpc_tpu_torch.rpc import tensor_service as ts
from brpc_tpu_torch.rpc import tpu_std_protocol as proto
from brpc_tpu_torch.rpc.channel import call_on_socket, get_client_messenger
from brpc_tpu_torch.rpc.proto import wire
from brpc_tpu_torch.rpc.socket import Socket

CPU = "cpu"
WAIT_S = 5.0


class _Clock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def monotonic(self) -> float:
        return self.t


# -- limiter twins -----------------------------------------------------------

def _limiter_script(mod, clock):
    out = []
    c = mod.ConstantLimiter(2)
    out += [c.on_requested(k) for k in range(4)] + [c.max_concurrency()]
    a = mod.AutoLimiter()
    # one-second windows of answered calls: (calls, latency us); errors
    # never count; the twelfth window re-probes the no-load latency
    windows = [(50, 2000), (80, 1000), (120, 1500), (30, 800), (200, 5000),
               (90, 900), (60, 1200), (150, 700), (40, 3000), (100, 1000),
               (70, 600), (110, 2500)]
    for n, lat in windows:
        a.on_response(errors.EINVAL, 1.0)
        for _ in range(n):
            clock.t += 1.0 / n
            a.on_response(0, lat)
        out += [a.max_concurrency(), a.on_requested(a.max_concurrency() - 1),
                a.on_requested(a.max_concurrency())]
    t = mod.TimeoutLimiter(100)
    out.append(t.on_requested(1000))  # no sample yet: admit
    for lat in (20000, 40000, 10000):
        t.on_response(0, lat)
    t.on_response(errors.ELIMIT, 1e9)
    out += [t.on_requested(k) for k in (1, 4, 5, 6, 9)]
    for spec in ("constant:3", "auto", "timeout:200", 7, "constant"):
        lim = mod.create_concurrency_limiter(spec)
        out.append((type(lim).__name__, lim.max_concurrency()))
    with pytest.raises(ValueError):
        mod.create_concurrency_limiter("bogus:1")
    return out


def test_limiter_twins(monkeypatch):
    got = {}
    for name, mod in (("ref", ref_cl), ("port", port_cl)):
        clock = _Clock()
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(
            monotonic=clock.monotonic))
        got[name] = _limiter_script(mod, clock)
    assert got["port"] == got["ref"]
    assert got["port"][:5] == [True, True, False, False, 2]


# -- bvar twins --------------------------------------------------------------

def _window_script(bv):
    add, mx, rec = bv.Adder(), bv.Maxer(), bv.IntRecorder()
    w_add, w_max, w_rec = (bv.Window(add, 10), bv.Window(mx, 10),
                           bv.Window(rec, 10))
    lr = bv.LatencyRecorder(window_size=10)
    bv.force_tick_for_tests()  # the baseline before any update
    for v in (5, 3):
        add.update(v)
    for v in (7, 2):
        mx.update(v)
    for v in (10, 30):
        rec.update(v)
    for v in (100, 200, 300, 400):
        lr.update(v)
    bv.force_tick_for_tests()
    add.update(4)
    mx.update(1)
    rec.update(50)
    lr.update(1000)
    return [w_add.get_value(), w_max.get_value(), w_rec.get_value().average,
            w_rec.get_value().num, lr.count(), lr.latency(),
            lr.max_latency(),
            [lr.latency_percentile(r) for r in (0.5, 0.9, 0.99)]]


def test_window_and_latency_recorder_twins():
    got = _window_script(bvar)
    assert got == _window_script(ref_bvar)
    assert got[:5] == [12, 7, 30.0, 3, 5]


def _per_second_script(bv, clock):
    add = bv.Adder()
    ps = bv.PerSecond(add, 10)
    bv.force_tick_for_tests()
    clock.t += 1.0
    add.update(50)
    bv.force_tick_for_tests()
    clock.t += 1.0
    add.update(10)
    return len(ps._sampler._samples), ps.get_value(), ps.series()


def test_per_second_twin(monkeypatch):
    """On one fake clock; a real tick of the sampler thread between the
    forced ones adds a sample, and the script runs again."""
    for _ in range(5):
        got, base = [], time.monotonic()
        for bv in (bvar, ref_bvar):
            clock = _Clock(base)
            with monkeypatch.context() as m:
                m.setattr(time, "monotonic", clock.monotonic)
                got.append(_per_second_script(bv, clock))
        if got[0][0] == got[1][0] == 2:
            break
    assert got[0] == got[1]
    assert got[0][1] == pytest.approx(30.0)


# -- server twins --------------------------------------------------------------

def _echo_service(mod, msgs):
    class Echo(mod.Service):
        SERVICE_NAME = "EchoService"

        def __init__(self):
            self.sessions = []
            self.had_endpoint = []
            self.gate = threading.Event()  # a "hold" call waits for it

        @mod.rpc_method(msgs.EchoRequest, msgs.EchoResponse)
        def Echo(self, cntl, request, response, done):
            self.sessions.append(cntl.session_local_data)
            if request.message == "hold":
                self.gate.wait(WAIT_S)
            response.message = request.message
            done()

        @mod.rpc_method(msgs.EchoRequest, msgs.EchoResponse)
        def Tell(self, cntl, request, response, done):
            """Echo without a limit, noting the connection's endpoint."""
            self.had_endpoint.append(cntl._server_socket.app_state is not None)
            response.message = request.message
            done()

    return Echo


def _refuse_log_id_7(cntl):
    if cntl.log_id == 7:
        return False, errors.EPERM, "log id 7 refused"
    return True, 0, ""


PKGS = {
    "ref": (ref_rpc, echo_pb2, ref_pools, lambda **kw: ref_rpc.ServerOptions(
        num_threads=2, has_builtin_services=False, **kw)),
    "port": (rpc, wire, port_pools,
             lambda **kw: rpc.ServerOptions(device=CPU, **kw)),
}


@pytest.fixture(scope="module")
def servers():
    """One Echo server per package: the interceptor refuses log id 7, the
    method admits one call at a time, and a session pool lends dicts."""
    ref_get_task_control()  # the bthread pool's first sizing sticks
    out = {}
    try:
        for pkg, (mod, msgs, pools, opts) in PKGS.items():
            svc = _echo_service(mod, msgs)()
            srv = mod.Server(opts(
                interceptor=_refuse_log_id_7,
                method_max_concurrency={"EchoService.Echo": 1},
                session_local_data_factory=pools.DataFactory(dict)))
            assert srv.add_service(svc) == 0
            assert srv.start("127.0.0.1:0") == 0
            out[pkg] = (srv, svc)
        yield out
    finally:
        for srv, _ in out.values():
            srv.stop()


class _Garbage:
    """A request whose bytes do not parse: field 1 claims 5 bytes, has 2."""

    def SerializeToString(self):
        return b"\x0a\x05ab"


def _call(ch, method, request, **cntl_kw):
    cntl, resp = ch.call(method, request, wire.EchoResponse, timeout_ms=3000,
                         **cntl_kw)
    return cntl.error_code, resp.message


def _codes_against(srv, svc):
    ch = rpc.Channel(rpc.ChannelOptions(max_retry=0))
    assert ch.init(str(srv.listen_endpoint)) == 0
    try:
        out = [
            _call(ch, "EchoService.Echo", wire.EchoRequest(message="a")),
            _call(ch, "NoSuch.Echo", wire.EchoRequest(message="b")),
            _call(ch, "EchoService.Nope", wire.EchoRequest(message="c")),
            _call(ch, "EchoService.Echo", _Garbage())[0],
            _call(ch, "EchoService.Echo", wire.EchoRequest(message="d"),
                  log_id=7),
        ]
        # the method's one slot held by a call: a second is refused
        svc.gate.clear()
        held = rpc.Controller()
        held.timeout_ms = 3000
        ended = threading.Event()
        ch.call_method("EchoService.Echo", held,
                       wire.EchoRequest(message="hold"),
                       wire.EchoResponse(), done=lambda c: ended.set())
        status = srv.method_statuses()["EchoService.Echo"]
        deadline = time.monotonic() + WAIT_S
        while status.concurrency < 1 and time.monotonic() < deadline:
            time.sleep(0.002)
        # on another connection: the held call runs in the reading task of
        # its own, so a request behind it there is read only after it
        short = rpc.Channel(rpc.ChannelOptions(max_retry=0,
                                               connection_type="short"))
        assert short.init(str(srv.listen_endpoint)) == 0
        out.append(_call(short, "EchoService.Echo",
                         wire.EchoRequest(message="e")))
        short.close()
        svc.gate.set()
        assert ended.wait(WAIT_S)
        out.append(held.error_code)
        out.append(_call(ch, "EchoService.Echo", wire.EchoRequest(message="f")))
        return out
    finally:
        ch.close()


def test_server_answers_like_the_reference(servers):
    got = {pkg: _codes_against(srv, svc)
           for pkg, (srv, svc) in servers.items()}
    assert got["port"] == got["ref"]
    assert got["port"] == [
        (0, "a"), (errors.ENOSERVICE, ""), (errors.ENOMETHOD, ""),
        errors.EREQUEST, (errors.EPERM, ""), (errors.ELIMIT, ""), 0, (0, "f")]
    stats = {}
    for pkg, (srv, svc) in servers.items():
        st = srv.method_statuses()["EchoService.Echo"]
        # the same dict lent to every call, and back in the pool
        stats[pkg] = (st.concurrency, st.rejected_count,
                      st.latency_recorder.count(), srv.session_pool.created_count,
                      srv.session_pool.free_count,
                      len({id(s) for s in svc.sessions}),
                      all(isinstance(s, dict) for s in svc.sessions),
                      srv.service_count)
    assert stats["port"] == stats["ref"] == (0, 1, 4, 1, 1, 1, True, 1)



# -- the input messenger on raw bytes ----------------------------------------

def _frame(cid: int, message: str, method="Tell") -> bytes:
    meta = wire.RpcMeta()
    meta.request.service_name = "EchoService"
    meta.request.method_name = method
    meta.correlation_id = cid
    return proto.pack_frame(meta, wire.EchoRequest(message=message)
                            .SerializeToString(), IOBuf()).to_bytes()


def _handshake() -> bytes:
    info = b'{"device_count": 0, "process": "raw", "host": "raw"}'
    return b"TDEV" + struct.pack(">I", len(info)) + info


class _Stub:
    """What parse needs of a socket."""

    def __init__(self):
        self.lame = False

    def mark_lame_duck(self):
        self.lame = True


def _read_replies(conn, n_frames: int):
    """(handshake replies, {correlation id: echoed message}) once n_frames
    responses arrived, or what came before the peer closed."""
    portal, got, handshakes = IOBuf(), {}, 0
    conn.settimeout(WAIT_S)
    while len(got) < n_frames:
        data = conn.recv(65536)
        if not data:
            break
        portal.append(data)
        while len(portal) >= 8:
            head = portal.copy_to_bytes(8)
            if head[:4] == b"TDEV":
                (length,) = struct.unpack(">I", head[4:8])
                if len(portal) < 8 + length:
                    break
                portal.pop_front(8 + length)
                handshakes += 1
                continue
            r = proto.parse(portal, _Stub(), False, None)
            if r.status != r.OK:
                break
            resp = wire.EchoResponse()
            resp.ParseFromString(bytes(r.message.payload))
            got[r.message.meta.correlation_id] = resp.message
    return handshakes, got


def _raw_session(srv, *segments, n_frames: int, pause_s: float = 0.05):
    with pysocket.create_connection(
            (srv.listen_endpoint.ip, srv.listen_endpoint.port), 2) as conn:
        for i, seg in enumerate(segments):
            if i:
                time.sleep(pause_s)  # a read in between
            conn.sendall(seg)
        return _read_replies(conn, n_frames)


def test_messenger_cuts_like_the_reference(servers, monkeypatch):
    monkeypatch.setenv("BRPC_TPU_FABRIC", "0")  # no native fabric build
    three = _frame(1, "x") + _frame(2, "y") + _frame(3, "z")
    split = _frame(9, "split")
    got = {}
    for pkg, (srv, svc) in servers.items():
        svc.had_endpoint.clear()
        got[pkg] = [
            _raw_session(srv, three, n_frames=3),
            _raw_session(srv, split[:7], split[7:], n_frames=1),
            _raw_session(srv, _handshake() + _frame(5, "after"), n_frames=1),
            list(svc.had_endpoint),
        ]
    assert got["port"] == got["ref"]
    assert got["port"] == [(0, {1: "x", 2: "y", 3: "z"}), (0, {9: "split"}),
                           (1, {5: "after"}), [False, False, False, False,
                                               True]]


def test_unknown_bytes_close_the_connection(servers):
    srv = servers["port"][0]
    before = srv.connection_count()
    with pysocket.create_connection(
            (srv.listen_endpoint.ip, srv.listen_endpoint.port), 2) as conn:
        conn.sendall(b"\x00\x01\x02\x03" * 16)
        conn.settimeout(WAIT_S)
        assert conn.recv(16) == b""  # closed by the server
    deadline = time.monotonic() + WAIT_S
    while srv.connection_count() > before and time.monotonic() < deadline:
        time.sleep(0.005)
    assert srv.connection_count() <= before  # the closed one is not counted


# -- options off by default ----------------------------------------------------

def test_enabled_protocols_leave_the_handshake_out(monkeypatch):
    """enabled_protocols=("tpu_std",): a request is answered; a TDEV
    handshake is then unknown bytes and closes its connection unanswered.
    The same in both packages."""
    monkeypatch.setenv("BRPC_TPU_FABRIC", "0")  # no native fabric build
    got = {}
    for pkg, (mod, msgs, _pools, opts) in PKGS.items():
        srv = mod.Server(opts(enabled_protocols=("tpu_std",)))
        try:
            assert srv.add_service(_echo_service(mod, msgs)()) == 0
            assert srv.start("127.0.0.1:0") == 0
            got[pkg] = [
                _raw_session(srv, _frame(4, "std"), n_frames=1),
                _raw_session(srv, _handshake() + _frame(5, "after"),
                             n_frames=1),
            ]
        finally:
            srv.stop()
    assert got["port"] == got["ref"] == [(0, {4: "std"}), (0, {})]


def test_sigterm_stops_the_server_and_exits_zero():
    """graceful_quit_on_sigterm: the SIGTERM handler that start installs
    stops the server, which fails its connections, and exits with code 0.
    The same in both packages."""
    import signal

    assert threading.current_thread() is threading.main_thread()
    prev = signal.getsignal(signal.SIGTERM)
    got = {}
    for pkg, (mod, msgs, _pools, opts) in PKGS.items():
        srv = mod.Server(opts(graceful_quit_on_sigterm=True))
        try:
            assert srv.add_service(_echo_service(mod, msgs)()) == 0
            assert srv.start("127.0.0.1:0") == 0
            handler = signal.getsignal(signal.SIGTERM)
            ep = srv.listen_endpoint
            with pysocket.create_connection((ep.ip, ep.port), 2) as conn:
                conn.sendall(_frame(6, "before"))
                answered = _read_replies(conn, 1)
                with pytest.raises(SystemExit) as ended:
                    handler(signal.SIGTERM, None)
                conn.settimeout(WAIT_S)
                got[pkg] = (handler is not prev, answered, ended.value.code,
                            srv.is_running, conn.recv(16))
        finally:
            srv.stop()
            signal.signal(signal.SIGTERM, prev)
    assert got["port"] == got["ref"] == (True, (0, {6: "before"}), 0, False,
                                         b"")


# -- no thread per connection --------------------------------------------------

def test_many_connections_add_no_threads(servers):
    srv = servers["port"][0]
    ep = srv.listen_endpoint
    messenger = get_client_messenger()
    socks = []

    def connect_and_call():
        sid = Socket.create(remote_side=ep,
                            on_edge_triggered_events=messenger.on_new_messages)
        sock = Socket.address(sid)
        socks.append(sock)
        assert sock.connect(2.0) == 0
        cntl = rpc.Controller()
        cntl.timeout_ms = 3000
        resp = wire.EchoResponse()
        call_on_socket(sock, "EchoService.Echo", cntl,
                       wire.EchoRequest(message="n"), resp)
        assert not cntl.failed(), cntl.error_text
        assert resp.message == "n"

    connect_and_call()  # the dispatcher and the workers are up
    before = threading.active_count()
    try:
        for _ in range(64):
            connect_and_call()
        added = threading.active_count() - before
        # the acceptor notes a connection before it can be read
        assert srv.connection_count() >= 65
        assert added < 8, f"{added} threads for 64 connections"
    finally:
        for sock in socks:
            sock.recycle()


# -- the SHUTDOWN bit ---------------------------------------------------------

def _shutdown_frame(cid: int) -> bytes:
    meta = wire.RpcMeta()
    meta.correlation_id = cid
    meta.response.error_code = 0
    meta_bytes = meta.SerializeToString() + b"\x40\x01"  # field 8, varint 1
    return (b"TRPC" + struct.pack(">II", len(meta_bytes), len(meta_bytes))
            + meta_bytes)


def test_shutdown_bit_marks_lame_duck_in_both():
    frame = _shutdown_frame(77)
    port_stub, ref_stub = _Stub(), _Stub()
    r = proto.parse(IOBuf(frame), port_stub, False, None)
    ref_portal = RefIOBuf()
    ref_portal.append(frame)
    rr = ref_proto.parse(ref_portal, ref_stub, False, None)
    assert port_stub.lame and ref_stub.lame
    assert r.status == r.OK and r.message.meta.correlation_id == 77
    assert rr.message.meta.correlation_id == 77
    plain = _frame(1, "no bit", "Echo")
    plain_stub = _Stub()
    proto.parse(IOBuf(plain), plain_stub, False, None)
    assert not plain_stub.lame


def test_balanced_channel_leaves_a_lame_duck():
    class Tagged(rpc.Service):
        SERVICE_NAME = "EchoService"

        def __init__(self, name):
            self.name = name

        @rpc.rpc_method(wire.EchoRequest, wire.EchoResponse)
        def Echo(self, cntl, request, response, done):
            response.message = self.name
            done()

    pair = []
    ch = None
    try:
        for name in ("a", "b"):
            srv = rpc.Server(rpc.ServerOptions(device=CPU))
            assert srv.add_service(Tagged(name)) == 0
            assert srv.start("127.0.0.1:0") == 0
            pair.append(srv)
        ch = rpc.Channel()
        url = "list://" + ",".join(str(s.listen_endpoint) for s in pair)
        assert ch.init(url, "rr") == 0
        seen = {_call(ch, "EchoService.Echo", wire.EchoRequest())[1]
                for _ in range(4)}
        assert seen == {"a", "b"}
        port_a = pair[0].listen_endpoint.port
        (sock_a,) = [Socket.address(sid) for sid in ch._lb.server_ids()
                     if Socket.address(sid).remote_side.port == port_a]
        proto.parse(IOBuf(_shutdown_frame(0)), sock_a, False, None)
        assert sock_a.lame_duck and not sock_a.failed()
        assert [_call(ch, "EchoService.Echo", wire.EchoRequest())
                for _ in range(4)] == [(0, "b")] * 4
    finally:
        if ch is not None:
            ch.close()
        for srv in pair:
            srv.stop()


# -- queue C #11: a Pull waiting for its window holds its worker --------------

def _one_window_store(base):
    class OneWindow(base):
        """Each connection's window holds one tensor of the store."""

        def Pull(self, cntl, request, response, done):
            ep = cntl._server_socket.app_state
            ep.window_bytes = 4096
            super().Pull(cntl, request, response, done)

        Pull.__rpc_method__ = base.Pull.__rpc_method__

    return OneWindow


def _pull_then_ack_behind_a_waiting_pull(pkg, ch, srv):
    """Pull #1 without its ACK (the window is full); pull #2 waits in
    prepare_send on the server; then the ACK of #1. Returns pull #2's
    (code, tensors) and how long the ACK took."""
    mod, tsm = (ref_rpc, ref_ts) if pkg == "ref" else (rpc, ts)
    cntl = mod.Controller()
    cntl.timeout_ms = 5000
    ch.call_method("TensorStore.Pull", cntl,
                   tsm.ts_pb2.TensorPullRequest(name="x"),
                   tsm.ts_pb2.TensorPullResponse())
    assert not cntl.failed(), cntl.error_text
    _, seq = tsm.receive_tensors(cntl._response_rpc_meta,
                                 cntl.response_attachment)
    assert seq
    second = []
    t = threading.Thread(target=lambda: second.append(
        tsm.TensorClient(ch).pull("x", timeout_ms=5000)))
    t.start()
    status = srv.method_statuses()["TensorStore.Pull"]
    deadline = time.monotonic() + WAIT_S
    while status.concurrency < 1 and time.monotonic() < deadline:
        time.sleep(0.001)
    assert status.concurrency == 1  # pull #2 is in its handler
    ack = mod.Controller()
    ack.timeout_ms = 5000
    t0 = time.monotonic()
    args = ("TensorStore.Ack", ack, tsm.ts_pb2.TensorAckRequest(seq=seq),
            tsm.ts_pb2.TensorAckResponse())
    if pkg == "ref":
        ch.call_method(*args)
    else:
        call_on_socket(cntl._current_sock, *args)
    ack_s = time.monotonic() - t0
    t.join(WAIT_S)
    assert not t.is_alive() and not ack.failed()
    cntl2, arrays = second[0]
    return (cntl2.error_code, None if arrays is None else len(arrays)), ack_s


def test_pull_waiting_for_the_window_holds_its_worker(monkeypatch):
    """One worker, a window of one tensor: pull #1 fills it, pull #2 waits
    in prepare_send on the only worker, and the ACK of #1 sent then is not
    processed until the window's timeout (0.5 s here, 10 s by default)
    ends the wait; pull #2 comes back without its tensor. The reference
    does the same."""
    import jax.numpy as jnp

    got = {}
    for pkg, tc_mod, dt_mod in (("ref", ref_tc, ref_dt),
                                ("port", port_tc, dt)):
        monkeypatch.setenv("BRPC_TPU_FABRIC", "0")
        monkeypatch.setattr(dt_mod.DeviceEndpoint.prepare_send,
                            "__defaults__", (0.5,))
        one = tc_mod.TaskControl(1)
        monkeypatch.setattr(tc_mod, "_control", one)
        srv = ch = None
        try:
            if pkg == "ref":
                store = _one_window_store(ref_ts.TensorStoreService)()
                store._store["x"] = [jnp.ones((1024,), jnp.float32)]
                srv = ref_rpc.Server(ref_rpc.ServerOptions(
                    num_threads=1, has_builtin_services=False))
            else:
                store = _one_window_store(ts.TensorStoreService)()
                store._store["x"] = [torch.ones((1024,), dtype=torch.float32)]
                srv = rpc.Server(rpc.ServerOptions(num_threads=1, device=CPU))
            assert srv.add_service(store) == 0
            assert srv.start("127.0.0.1:0") == 0
            if pkg == "ref":
                ch = ref_ts.make_device_channel(str(srv.listen_endpoint))
            else:
                ch = ts.make_device_channel(str(srv.listen_endpoint),
                                            rpc.ChannelOptions(device=CPU))
            got[pkg] = _pull_then_ack_behind_a_waiting_pull(pkg, ch, srv)
        finally:
            if ch is not None and hasattr(ch, "close"):
                ch.close()
            if srv is not None:
                srv.stop()
            monkeypatch.undo()
            one.stop_and_join()
    assert got["port"][0] == got["ref"][0] == (0, 0)
    assert got["port"][1] >= 0.25 and got["ref"][1] >= 0.25


# -- the service table's rest and ClosureGuard ---------------------------------

def test_remove_service_and_closure_guard_like_the_reference():
    """remove_service before start, twice, after start;
    run_until_asked_to_quit returns once the server stops; ClosureGuard
    run on exit, released, and dropped: the same outcomes in both
    packages."""
    ref_get_task_control()
    got = {}
    for pkg, (mod, msgs, _pools, opts) in PKGS.items():
        svc = _echo_service(mod, msgs)()
        srv = mod.Server(opts())
        out = [srv.add_service(svc), srv.remove_service(svc),
               srv.remove_service(svc), srv.find_service("EchoService"),
               sorted(srv.method_statuses()), srv.add_service(svc)]
        assert srv.start("127.0.0.1:0") == 0
        serving = threading.Thread(target=srv.run_until_asked_to_quit)
        serving.start()
        try:
            out.append(srv.remove_service(svc))
            out.append(srv.find_service("EchoService") is svc)
        finally:
            srv.stop()
        serving.join(WAIT_S)
        out.append(serving.is_alive())
        calls = []
        with mod.ClosureGuard(lambda: calls.append("exit")):
            pass
        guard = mod.ClosureGuard(lambda: calls.append("released"))
        out.append(guard.release() is not None)
        del guard
        guard = mod.ClosureGuard(lambda: calls.append("dropped"))
        del guard
        got[pkg] = out + [calls]
    assert got["port"] == got["ref"] == [
        0, 0, -1, None, [], 0, -1, True, False, True, ["exit", "dropped"]]


# -- the endpoint reached from many workers -------------------------------------

def test_endpoint_from_many_threads_ends_at_rest():
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    ep = dt.DeviceEndpoint(window_bytes=64 << 10, device=CPU)
    errs = []

    def work(k):
        try:
            for i in range(50):
                x = torch.full((1024,), float(k * 100 + i))
                meta, att = wire.RpcMeta(), IOBuf()
                seq = ep.prepare_send([x], meta, att, timeout_s=WAIT_S)
                assert seq and len(att) == 4096
                ep.on_ack(seq)
        except Exception as e:  # reported below
            errs.append(e)

    threads = [threading.Thread(target=work, args=(k,)) for k in range(8)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT_S * 4)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert not errs
    assert ep.retained_count == 0 and ep.inflight_bytes == 0
