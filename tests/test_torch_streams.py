"""The port's streams held against brpc_tpu's, on the CPU, with threads.

* ExecutionQueue twins: one script on a scheduler the test runs by hand
  gives the same batches in both packages (batch_size, high-priority
  tasks, stop with tasks queued, a negative return, a stop when idle);
  the port's queue on its task control keeps one consumer at a time.
* The TSTR codec: DATA, FEEDBACK and CLOSE frames byte-equal, and the
  same ``parse`` result in both packages on every cut of a run of frames
  and on bad headers.
* Streams in three pairings (port client -> port server, port client ->
  reference server, reference client -> port server): setup and echo; a
  1 MiB tensor written by each side (a torch tensor by the port, a jax
  array by the reference) received byte-identical; a DATA frame sent
  from ``stream_accept`` before the response that binds the client's
  stream; close propagating to the peer's ``on_closed``; EEOF after
  close; no accept without a request stream; EOVERCROWDED at
  ``timeout_s=0.05`` and the write larger than the window, which waits
  even on an empty window (ROADMAP queue C, both packages); the windows
  and ``stream_count`` back at rest.
* ``write_tensor`` sends the bytes the tensor held at the call: an
  in-place write right after it does not reach the receiver.
* On a backed-up call the stream binds once, to the connection whose
  response won.

The servers are module-scoped; every wait, join and write has a deadline
of at most WAIT_S.
"""
import struct
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brpc_tpu import rpc as ref_rpc
from brpc_tpu.bthread import execution_queue as ref_eq
from brpc_tpu.bthread import get_task_control as ref_get_task_control
from brpc_tpu.butil.iobuf import IOBuf as RefIOBuf
from brpc_tpu.rpc import stream as ref_stream
from brpc_tpu.rpc import streaming_protocol as ref_sp
from brpc_tpu.rpc.proto import echo_pb2
from brpc_tpu_torch import rpc
from brpc_tpu_torch.bthread import execution_queue as port_eq
from brpc_tpu_torch.butil.iobuf import IOBuf
from brpc_tpu_torch.rpc import errors
from brpc_tpu_torch.rpc import stream as port_stream
from brpc_tpu_torch.rpc import streaming_protocol as port_sp
from brpc_tpu_torch.rpc.proto import wire

WAIT_S = 3.0
FAST_S = 0.05  # the write timeout of the window cases
SLOW_S = 0.3  # the losing attempt's answer, against a 50 ms backup request


def _wait(cond, what: str):
    deadline = time.monotonic() + WAIT_S
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"not within {WAIT_S} s: {what}")
        time.sleep(0.002)


# -- execution queue twins ---------------------------------------------------

def _queue_script(mod):
    pending = []
    log = []

    def run():
        while pending:
            pending.pop(0)()

    def consume(it):
        batch = list(it)
        log.append((batch, it.is_queue_stopped()))
        return -1 if "neg" in batch else 0

    out = []
    q = mod.ExecutionQueue(consume, scheduler=pending.append, batch_size=3)
    out += [q.execute(k) for k in range(5)]
    out.append(q.execute("hi", high_priority=True))
    out.append(len(pending))  # one consumer scheduled, not six
    run()
    out.append(q.execute(5))
    run()
    # a stop with tasks queued: they are drained, then the stopped batch
    out += [q.execute(6), q.execute(7, high_priority=True)]
    q.stop()
    out += [q.execute(8), q.join(0)]
    run()
    out.append(q.join(0))
    # a negative return stops the queue; what it held is not run
    q = mod.ExecutionQueue(consume, scheduler=pending.append, batch_size=2)
    out += [q.execute(1), q.execute("neg"), q.execute(3)]
    run()
    out += [q.execute(4), q.join(0)]
    # a stop on an idle queue: one empty, stopped batch
    q = mod.execution_queue_start(consume, scheduler=pending.append)
    q.stop()
    run()
    out.append(q.join(0))
    return out, log


def test_execution_queue_twins():
    assert _queue_script(port_eq) == _queue_script(ref_eq)
    out, log = _queue_script(port_eq)
    assert log[:3] == [(["hi", 0, 1], False), ([2, 3, 4], False),
                       ([5], False)]
    assert log[3:5] == [([7, 6], False), ([], True)]


def test_execution_queue_one_consumer_on_the_task_control():
    """Four producers on the port's default scheduler: every task runs
    once, each producer's in order, never two batches at once."""
    running, seen, overlap = [0], [], []
    lock = threading.Lock()
    closed = threading.Event()

    def consume(it):
        with lock:
            running[0] += 1
            overlap.append(running[0])
        seen.extend(it)
        time.sleep(0.0005)
        with lock:
            running[0] -= 1
        if it.is_queue_stopped():
            closed.set()
        return 0

    q = port_eq.ExecutionQueue(consume, batch_size=8)

    def produce(p):
        for k in range(50):
            assert q.execute((p, k))

    threads = [threading.Thread(target=produce, args=(p,)) for p in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(WAIT_S)
        assert not t.is_alive()
    q.stop()
    assert q.join(WAIT_S) and closed.is_set()
    assert max(overlap) == 1
    assert sorted(seen) == [(p, k) for p in range(4) for k in range(50)]
    for p in range(4):
        assert [k for q_, k in seen if q_ == p] == list(range(50))


# -- the TSTR codec ----------------------------------------------------------

def _frames(sp, buf_cls, payload: bytes):
    return [sp.pack_data_frame(7, buf_cls(payload)).to_bytes(),
            sp.pack_data_frame(1 << 40, buf_cls(b"")).to_bytes(),
            sp.pack_feedback_frame(3, 123456789).to_bytes(),
            sp.pack_close_frame(2).to_bytes()]


def _parse_all(sp, buf_cls, data: bytes):
    """Each cut of ``data``: the parse results until it stops."""
    out = []
    for cut in range(len(data) + 1):
        portal = buf_cls(data[:cut]) if cut else buf_cls()
        got = []
        while len(portal):
            r = sp.parse(portal, None, False, None)
            status = int(getattr(r, "status", getattr(r, "error", -1)))
            if status != 0:
                got.append((status, len(portal)))
                break
            m = r.message
            got.append((m.dest_id, m.ftype, m.payload.to_bytes(), len(portal)))
        out.append(got)
    return out


def test_tstr_frames_and_parse_twins():
    payload = np.random.default_rng(5).integers(0, 256, 40, np.uint8).tobytes()
    port = _frames(port_sp, IOBuf, payload)
    assert port == _frames(ref_sp, RefIOBuf, payload)
    assert port[0] == (b"TSTR" + struct.pack(">I", 49)
                       + struct.pack(">QB", 7, 0) + payload)
    run = b"".join(port)
    assert _parse_all(port_sp, IOBuf, run) == _parse_all(ref_sp, RefIOBuf, run)
    bad = [b"T", b"TS", b"TSX", b"HTTP/1.1", b"TSTR" + struct.pack(">I", 8),
           b"TSTR" + struct.pack(">I", (1 << 31) + 1) + b"x" * 9,
           b"TSTR" + struct.pack(">I", 9) + b"\0" * 8]
    for data in bad:
        assert (_parse_all(port_sp, IOBuf, data)[-1]
                == _parse_all(ref_sp, RefIOBuf, data)[-1]), data
    assert [_parse_all(port_sp, IOBuf, d)[-1][0][0] for d in bad] == [
        1, 1, 2, 2, 3, 3, 1]


# -- streams in three pairings -----------------------------------------------

class Collector:
    """A stream handler for either package: keeps what arrives, echoes it
    when asked, and waits at ``gate`` first when given one."""

    def __init__(self, echo: bool = False, gate: threading.Event = None):
        self.echo = echo
        self.gate = gate
        self.got = []
        self.lock = threading.Lock()
        self.closed = threading.Event()
        self.echo_rcs = []

    def on_received_messages(self, stream, messages):
        if self.gate is not None:
            self.gate.wait(WAIT_S)
        data = [m.to_bytes() for m in messages]
        with self.lock:
            self.got.extend(data)
        if self.echo:
            for d in data:
                self.echo_rcs.append(stream.write(d, timeout_s=WAIT_S))

    def on_closed(self, stream):
        self.closed.set()

    def wait_for(self, n: int):
        _wait(lambda: len(self.got) >= n, f"{n} messages")
        return self.got


def _stream_service(mod, msgs):
    class StreamEcho(mod.Service):
        SERVICE_NAME = "StreamEcho"

        def __init__(self, slow_first: threading.Event = None):
            self.streams = {}  # our stream id -> (stream, handler)
            self.gate = threading.Event()
            # set by the first Open of every service sharing it, which
            # then answers SLOW_S late
            self.slow_first = slow_first

        @mod.rpc_method(msgs.EchoRequest, msgs.EchoResponse)
        def Open(self, cntl, request, response, done):
            if self.slow_first is not None and not self.slow_first.is_set():
                self.slow_first.set()
                time.sleep(SLOW_S)
            mode = request.message
            handler = Collector(echo=mode == "echo",
                                gate=self.gate if mode == "gate" else None)
            s = mod.stream_accept(cntl, mod.StreamOptions(handler=handler))
            if s is None:
                cntl.set_failed(errors.EINVAL, "no stream in request")
            else:
                self.streams[s.stream_id] = (s, handler)
                if mode == "hello":
                    # before the response that binds the client's stream
                    s.write(b"hello", timeout_s=WAIT_S)
            response.message = mode
            done()

    return StreamEcho


PKGS = {"port": (rpc, wire, port_stream),
        "ref": (ref_rpc, echo_pb2, ref_stream)}
PAIRINGS = [("port", "port"), ("port", "ref"), ("ref", "port")]
PAIR_IDS = [f"{c}-client-{s}-server" for c, s in PAIRINGS]


@pytest.fixture(scope="module")
def streams_env():
    """A stream server per package and a channel per pairing."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BRPC_TPU_FABRIC", "0")  # no native fabric build
        ref_get_task_control()  # the bthread pool's first sizing sticks
        servers, channels = {}, {}
        try:
            for pkg, (mod, msgs, _) in PKGS.items():
                svc = _stream_service(mod, msgs)()
                opts = (mod.ServerOptions(device="cpu") if pkg == "port" else
                        mod.ServerOptions(num_threads=2,
                                          has_builtin_services=False))
                srv = mod.Server(opts)
                assert srv.add_service(svc) == 0
                assert srv.start("127.0.0.1:0") == 0
                servers[pkg] = (srv, svc)
            for client, server in PAIRINGS:
                ch = PKGS[client][0].Channel()
                assert ch.init(str(servers[server][0].listen_endpoint)) == 0
                channels[client, server] = ch
            yield servers, channels
        finally:
            for ch in channels.values():
                ch.close()
            for srv, _ in servers.values():
                srv.stop()


class Pair:
    """One pairing: its channel, the server's service, both packages."""

    def __init__(self, env, client: str, server: str):
        servers, channels = env
        self.client, self.server = client, server
        self.ch = channels[client, server]
        self.svc = servers[server][1]
        self.cmod, self.cmsgs, self.cstream = PKGS[client]
        self.smod, _, self.sstream = PKGS[server]
        self.opened = []  # (client stream, server stream)

    def call_open(self, mode: str, stream_opts=None):
        """Open's controller; with ``stream_opts``, a stream rides it."""
        cntl = self.cmod.Controller()
        cntl.timeout_ms = WAIT_S * 1000
        stream = None
        if stream_opts is not None:
            stream = self.cmod.stream_create(
                cntl, self.cmod.StreamOptions(**stream_opts))
        self.ch.call_method("StreamEcho.Open", cntl,
                            self.cmsgs.EchoRequest(message=mode),
                            self.cmsgs.EchoResponse())
        return cntl, stream

    def open(self, mode: str, **opts):
        """(client stream, its handler, server stream, its handler)."""
        handler = Collector()
        cntl, stream = self.call_open(mode, dict(handler=handler, **opts))
        assert not cntl.failed(), cntl.error_text
        assert stream.wait_connected(WAIT_S)
        peer, peer_handler = self.svc.streams[stream.peer_id]
        assert peer.peer_id == stream.stream_id
        self.opened.append((stream, peer))
        return stream, handler, peer, peer_handler

    def counts(self):
        return (port_stream._stream_count.get_value(),
                ref_stream._stream_count.get_value())

    def settle(self):
        """Close what the test opened and wait until both ends closed and
        each package's stream_count again counts its registry, so the
        next test starts from rest."""
        for stream, _ in self.opened:
            stream.close()
        _wait(lambda: all(peer.closed for _, peer in self.opened),
              "the server streams closed")
        _wait(lambda: all(
            m._stream_count.get_value() == len(m.Stream._registry)
            for m in (port_stream, ref_stream)), "stream_count settled")


@pytest.fixture(params=PAIRINGS, ids=PAIR_IDS)
def pair(request, streams_env):
    p = Pair(streams_env, *request.param)
    yield p
    p.settle()


def _chunks(seed: int, n: int, size: int):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size, np.uint8).tobytes() for _ in range(n)]


def test_stream_setup_and_echo(pair):
    s, h, peer, ph = pair.open("echo")
    try:
        chunks = _chunks(1, 10, 3000)
        for c in chunks:
            assert s.write(c, timeout_s=WAIT_S) == 0
        assert h.wait_for(10) == chunks  # in order, both ways
        # the peer's handler appends a write's code after the write, so
        # the last echo can arrive here before its code is appended
        _wait(lambda: len(ph.echo_rcs) >= 10, "the peer's echo codes")
        assert ph.got == chunks and ph.echo_rcs == [0] * 10
    finally:
        s.close()


def _array_of(pkg: str, a: np.ndarray):
    return torch.from_numpy(a.copy()) if pkg == "port" else jnp.asarray(a)


def test_tensor_crosses_byte_identical(pair):
    a, b = np.random.default_rng(2).standard_normal((2, 256, 1024),
                                                    np.float32)
    s, h, peer, ph = pair.open("collect")
    try:
        assert s.write_tensor(_array_of(pair.client, a)) == 0
        assert ph.wait_for(1) == [a.tobytes()]
        assert peer.write_tensor(_array_of(pair.server, b)) == 0
        assert h.wait_for(1) == [b.tobytes()]
    finally:
        s.close()


def test_data_frame_before_bind_is_kept(pair, monkeypatch):
    """The server writes from stream_accept, before its response: the
    client's stream takes the frame before the response binds it, and
    the feedback it owes goes out with the bind."""
    bound_at_data = []
    on_data = pair.cstream.Stream._on_data

    def spy(self, payload):
        bound_at_data.append(self.connected)
        on_data(self, payload)

    monkeypatch.setattr(pair.cstream.Stream, "_on_data", spy)
    s, h, peer, _ = pair.open("hello")
    try:
        assert h.wait_for(1) == [b"hello"]
        assert bound_at_data == [False]
        _wait(lambda: peer.unconsumed_bytes == 0, "the server's window")
    finally:
        s.close()


def test_close_propagates(pair):
    s, h, peer, ph = pair.open("echo")
    assert s.write(b"last", timeout_s=WAIT_S) == 0
    assert h.wait_for(1) == [b"last"]
    s.close()
    assert s.closed and h.closed.wait(WAIT_S)
    _wait(lambda: peer.closed, "the peer closed")
    assert ph.closed.wait(WAIT_S) and ph.got == [b"last"]
    # and from the server's side
    s, h, peer, ph = pair.open("echo")
    peer.close()
    _wait(lambda: s.closed, "the client closed")
    assert h.closed.wait(WAIT_S) and ph.closed.wait(WAIT_S)


def test_write_after_close_is_eeof(pair):
    s, _, peer, _ = pair.open("collect")
    s.close()
    assert s.write(b"x", timeout_s=FAST_S) == errors.EEOF
    _wait(lambda: peer.closed, "the peer closed")
    assert peer.write(b"x", timeout_s=FAST_S) == errors.EEOF


def test_no_accept_without_a_request_stream(pair):
    count0 = pair.counts()
    cntl, _ = pair.call_open("echo")
    assert cntl.error_code == errors.EINVAL
    assert "no stream in request" in cntl.error_text
    assert pair.counts() == count0


def test_window_overcrowded_and_larger_than_window(pair):
    """A window of 64 KiB and a handler held at a gate: a full window
    refuses a write after timeout_s; once fed back, a write of 64 KiB + 1
    is refused even by the empty window (both packages), and 1 B passes."""
    window = 64 << 10
    pair.svc.gate.clear()
    s, _, peer, ph = pair.open("gate", max_buf_size=window)
    try:
        assert s.write(b"a" * window, timeout_s=FAST_S) == 0
        t0 = time.monotonic()
        assert s.write(b"b", timeout_s=FAST_S) == errors.EOVERCROWDED
        assert time.monotonic() - t0 >= FAST_S
        pair.svc.gate.set()
        _wait(lambda: s.unconsumed_bytes == 0, "the feedback")
        t0 = time.monotonic()
        assert s.write(b"c" * (window + 1),
                       timeout_s=FAST_S) == errors.EOVERCROWDED
        assert time.monotonic() - t0 >= FAST_S
        assert s.unconsumed_bytes == 0
        assert s.write(b"d", timeout_s=FAST_S) == 0
        assert ph.wait_for(2) == [b"a" * window, b"d"]
    finally:
        pair.svc.gate.set()
        s.close()


def test_windows_and_stream_count_at_rest(pair):
    count0 = pair.counts()
    s, h, peer, ph = pair.open("echo")
    assert pair.counts() != count0
    chunks = _chunks(3, 8, 32 << 10)
    for c in chunks:
        assert s.write(c, timeout_s=WAIT_S) == 0
    assert h.wait_for(8) == chunks
    _wait(lambda: s.unconsumed_bytes == 0 and peer.unconsumed_bytes == 0,
          "both windows at rest")
    s.close()
    _wait(lambda: peer.closed and pair.counts() == count0,
          "stream_count back")
    assert h.closed.wait(WAIT_S) and ph.closed.wait(WAIT_S)


@pytest.mark.parametrize("pair", PAIRINGS[:2], ids=PAIR_IDS[:2],
                         indirect=True)
def test_write_tensor_sends_the_bytes_at_the_call(pair):
    a = np.random.default_rng(4).standard_normal((256, 1024), np.float32)
    t = torch.from_numpy(a.copy())
    s, _, _, ph = pair.open("collect")
    try:
        assert s.write_tensor(t) == 0
        t.view(torch.int32).bitwise_not_()  # in place, right after the call
        assert s.write_tensor(t[:, ::2]) == 0  # a strided view: its values
        got = ph.wait_for(2)
        assert got[0] == a.tobytes()
        flipped = np.bitwise_not(a.view(np.int32)).view(np.float32)
        assert got[1] == np.ascontiguousarray(flipped[:, ::2]).tobytes()
    finally:
        s.close()


def test_stream_binds_to_the_winning_attempt(monkeypatch):
    """A backup request: the stream's id rides both attempts, and the
    stream binds once, to the connection whose response won; the losing
    attempt's late response binds nothing."""
    binds = []
    bind = port_stream.Stream.bind

    def spy(self, sock):
        binds.append((self.stream_id, sock))
        bind(self, sock)

    monkeypatch.setattr(port_stream.Stream, "bind", spy)
    slow_first = threading.Event()
    svcs, srvs = [], []
    ch = s = None
    try:
        for _ in range(2):
            svcs.append(_stream_service(rpc, wire)(slow_first))
            srvs.append(rpc.Server(rpc.ServerOptions(device="cpu")))
            assert srvs[-1].add_service(svcs[-1]) == 0
            assert srvs[-1].start("127.0.0.1:0") == 0
        ch = rpc.Channel(rpc.ChannelOptions(backup_request_ms=50))
        assert ch.init("list://" + ",".join(
            str(srv.listen_endpoint) for srv in srvs), "rr") == 0
        handler = Collector()
        cntl = rpc.Controller()
        cntl.timeout_ms = WAIT_S * 1000
        s = rpc.stream_create(cntl, rpc.StreamOptions(handler=handler))
        ch.call_method("StreamEcho.Open", cntl,
                       wire.EchoRequest(message="echo"), wire.EchoResponse())
        assert not cntl.failed(), cntl.error_text
        assert cntl.has_backup_request and s.wait_connected(WAIT_S)
        (winner,) = [v for v in svcs if s.peer_id in v.streams]
        (loser,) = [v for v in svcs if v is not winner]
        # the loser accepts too, SLOW_S late; its response is then dropped
        _wait(lambda: loser.streams, "the losing attempt's accept")
        time.sleep(0.1)
        mine = [sock for sid, sock in binds if sid == s.stream_id]
        assert mine == [cntl._current_sock]
        assert s.write(b"to the winner", timeout_s=WAIT_S) == 0
        assert handler.wait_for(1) == [b"to the winner"]
        assert winner.streams[s.peer_id][1].got == [b"to the winner"]
        assert [h.got for _, h in loser.streams.values()] == [[]]
    finally:
        if s is not None:
            s.close()
        for v in svcs:
            for peer, _ in v.streams.values():
                peer.close()
        if ch is not None:
            ch.close()
        for srv in srvs:
            srv.stop()
