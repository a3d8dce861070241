"""The port's reference-grade client held against brpc_tpu on the CPU.

* Twins, pure Python in both packages: the load balancers pick the same
  socket ids on the same nodes (rr, wrr, c_murmurhash, c_md5, random and
  wr under one random.seed, la and _dynpart on one feedback stream); the
  naming services parse the same list:// and file:// texts into the same
  nodes and reject the same garbage; the circuit breaker and the cluster
  recover policy decide alike on one stream of calls, on a fake clock.
* The port's channel against port servers in this process: rr spreads,
  failover under max_retry, a backup request answered by the fast server,
  ERPCTIMEDOUT with the late response dropped, pooled and short
  connections, two channels on one socket, health-check revival, a file://
  update for a live channel.
* The tensor lane behind a balancer: interop over list:// with rr both
  ways; ROADMAP queue C #8 (the reference sends a pull's ACK wherever the
  balancer points), #9 (the reference keeps the send of an abandoned
  attempt and of a failed connection retained) and #10 (a retry's frame
  carries every earlier attempt's wire bytes too), each pinned on the
  reference and repaired on the port.

Every server is stopped in ``finally`` or by its fixture; every wait has
its own deadline.
"""
import random
import threading
import time
import types

import numpy as np
import pytest
import torch

from brpc_tpu import rpc as ref_rpc
from brpc_tpu.bthread import get_task_control
from brpc_tpu.rpc import circuit_breaker as ref_cb
from brpc_tpu.rpc import cluster_recover as ref_cr
from brpc_tpu.rpc import errors as ref_errors
from brpc_tpu.rpc import load_balancer as ref_lb
from brpc_tpu.rpc import naming_service as ref_ns
from brpc_tpu.rpc import tensor_service as ref_ts
from brpc_tpu.rpc import tpu_std_protocol as ref_proto
from brpc_tpu.rpc.controller import Controller as RefController
from brpc_tpu.rpc.socket import Socket as RefSocket
from brpc_tpu_torch import bvar, rpc
from brpc_tpu_torch.rpc import circuit_breaker as port_cb
from brpc_tpu_torch.rpc import cluster_recover as port_cr
from brpc_tpu_torch.rpc import errors
from brpc_tpu_torch.rpc import load_balancer as port_lb
from brpc_tpu_torch.rpc import naming_service as port_ns
from brpc_tpu_torch.rpc import tensor_service as ts
from brpc_tpu_torch.rpc import tpu_std_protocol as proto
from brpc_tpu_torch.rpc.proto import wire
from brpc_tpu_torch.rpc.socket import Socket

CPU = "cpu"
SIDS = [101, 202, 303, 404, 505]


@pytest.fixture(autouse=True)
def _keep_random_state():
    """The twins seed the global random module; the tests that run after
    these in the same process get the state they would have had."""
    state = random.getstate()
    yield
    random.setstate(state)


def _wait_for(cond, deadline_s: float, what: str):
    end = time.monotonic() + deadline_s
    while not cond():
        if time.monotonic() > end:
            raise AssertionError(f"timed out after {deadline_s} s: {what}")
        time.sleep(0.01)


# -- load balancer twins -----------------------------------------------------

@pytest.fixture
def dead(monkeypatch):
    """Liveness of the twins' literal socket ids: alive unless listed."""
    down = set()
    for mod in (ref_lb, port_lb):
        monkeypatch.setattr(mod, "_alive", lambda sid: sid not in down)
    return down


def _pair(name, weights=None):
    out = []
    for mod in (ref_lb, port_lb):
        lb = mod.create_load_balancer(name)
        for i, sid in enumerate(SIDS):
            lb.add_server(sid, (weights or {}).get(sid, i + 1))
        out.append(lb)
    return out


@pytest.mark.parametrize("name", ["rr", "wrr"])
def test_round_robin_twins(dead, name):
    def picks(lb):
        out = [lb.select_server() for _ in range(100)]
        out += [lb.select_server(exclude={202}) for _ in range(100)]
        dead.add(303)
        out += [lb.select_server(exclude={101}) for _ in range(100)]
        dead.discard(303)
        lb.remove_server(404)
        out += [lb.select_server() for _ in range(20)]
        return out

    ref, port = _pair(name)
    want = picks(ref)
    got = picks(port)
    assert got == want
    assert set(want[:100]) == set(SIDS)
    assert 202 not in want[100:200] and 303 not in want[200:300]


@pytest.mark.parametrize("name", ["c_murmurhash", "c_md5"])
def test_consistent_hash_twins(dead, name):
    def picks(lb):
        out = [lb.select_server(request_code=c) for c in range(1000)]
        dead.add(505)
        out += [lb.select_server(request_code=c, exclude={101})
                for c in range(0, 1000, 7)]
        dead.discard(505)
        return out

    ref, port = _pair(name)
    want = picks(ref)
    assert picks(port) == want
    assert len(set(want[:1000])) == len(SIDS)


@pytest.mark.parametrize("name", ["random", "wr"])
def test_random_twins(dead, name):
    def picks(lb):
        random.seed(7)
        out = [lb.select_server() for _ in range(300)]
        out += [lb.select_server(exclude={101, 202}) for _ in range(100)]
        return out

    ref, port = _pair(name)
    assert picks(port) == picks(ref)


def test_locality_aware_twins(dead):
    latency = {101: 900.0, 202: 3000.0, 303: 12000.0, 404: 500.0,
               505: 40000.0}

    def picks(lb):
        random.seed(11)
        out = []
        for i in range(400):
            sid = lb.select_server()
            out.append(sid)
            if i % 3:  # some calls still in flight while others select
                lb.feedback(sid, errors.EFAILEDSOCKET if i % 17 == 0 else 0,
                            latency[sid] * (1 + (i % 5) / 10))
        return out

    ref, port = _pair("la")
    want = picks(ref)
    assert picks(port) == want
    assert want[200:].count(404) > want[200:].count(505)


def test_dynpart_twins():
    caps = {1: 3, 2: 1, 4: 0}

    def picks(lb):
        random.seed(5)
        lb.set_capacity_fn(lambda sid: caps[sid])
        for sid in caps:
            lb.add_server(sid)
        out = [lb.select_server() for _ in range(300)]
        out += [lb.select_server(exclude={1}) for _ in range(50)]
        return out

    want = picks(ref_lb.create_load_balancer("_dynpart"))
    assert picks(port_lb.create_load_balancer("_dynpart")) == want
    assert 4 not in want


def test_balancer_names_and_recover_params():
    for name in ("rr", "wrr", "random", "wr", "c_murmurhash", "c_md5", "la",
                 "_dynpart", "rr:min_working_instances=2 hold_seconds=3",
                 "nope", "rr:bogus", "la:min_working_instances=x hold_seconds=1",
                 "rr:hold_seconds=3"):
        ref = ref_lb.create_load_balancer(name)
        port = port_lb.create_load_balancer(name)
        assert (ref is None) == (port is None), name
        if ref is not None:
            assert ref.name == port.name
            assert ((ref.cluster_recover_policy is None)
                    == (port.cluster_recover_policy is None))


# -- naming service twins ----------------------------------------------------

LISTS = [
    "127.0.0.1:8000",
    "127.0.0.1:8000,10.0.0.2:9 3, 10.0.0.3:7 0/2,,",
    "localhost:80 tag,[::1]:81 2",
    "1.2.3.4:5/tpu:0.1.2.3 1/4",
]
GARBAGE = ["1.2.3.4", "1.2.3.4:x", "1.2.3.4:70000", ":80", "a:b:c",
           "1.2.3.4:80/gpu:0", "1.2.3.4:80,nohost"]
SERVER_FILE = """# servers
127.0.0.1:8000
10.0.0.2:9 3   # weight
10.0.0.3:7 0/2
not-an-endpoint
1.2.3.4:99999

[::1]:81 x
"""


def _nodes(ns, path):
    try:
        return [(ep.ip, ep.port, str(ep.device), w, tag)
                for ep, w, tag in ns.get_servers(path)]
    except ValueError as e:
        return type(e)


@pytest.mark.parametrize("text", LISTS + GARBAGE)
def test_list_naming_twins(text):
    want = _nodes(ref_ns.ListNamingService(), text)
    assert _nodes(port_ns.ListNamingService(), text) == want
    assert (want is ValueError) == (text in GARBAGE)


def test_file_naming_twins(tmp_path):
    path = tmp_path / "servers"
    path.write_text(SERVER_FILE)
    want = _nodes(ref_ns.FileNamingService(), str(path))
    assert _nodes(port_ns.FileNamingService(), str(path)) == want
    assert len(want) == 4
    assert _nodes(port_ns.FileNamingService(), str(tmp_path / "nope")) == []


def test_channel_init_rejects_garbage():
    """The port returns EINVAL where the reference's init raises (a list
    it cannot parse) or returns EINVAL (unknown scheme or balancer)."""
    with pytest.raises(ValueError):
        ref_rpc.Channel().init("list://1.2.3.4", "rr")
    assert rpc.Channel().init("list://1.2.3.4", "rr") == errors.EINVAL
    for url, lb in (("nope://1.2.3.4:80", "rr"), ("list://1.2.3.4:80", "xx"),
                    ("list://1.2.3.4:80", "rr:bogus")):
        assert ref_rpc.Channel().init(url, lb) == ref_errors.EINVAL
        assert rpc.Channel().init(url, lb) == errors.EINVAL
    assert rpc.Channel().init("1.2.3.4") == errors.EINVAL
    # a protocol the port does not speak (yet) is refused; mongo is a
    # server's protocol only, and the stream frames and the device
    # handshake pack no request
    for protocol in ("rtmp", "mongo", "streaming"):
        assert (rpc.Channel(rpc.ChannelOptions(protocol=protocol)).init(
            "1.2.3.4:80") == errors.EPROTONOTSUP)


# -- circuit breaker and cluster recover twins --------------------------------

class _Clock:
    def __init__(self):
        self.t = 1000.0

    def monotonic(self):
        return self.t


@pytest.fixture
def clock(monkeypatch):
    c = _Clock()
    fake = types.SimpleNamespace(monotonic=c.monotonic)
    for mod in (ref_cb, port_cb, ref_cr, port_cr):
        monkeypatch.setattr(mod, "time", fake)
    return c


def test_circuit_breaker_twins(clock):
    def decisions(mod):
        clock.t = 1000.0
        cb = mod.CircuitBreaker()
        out = []
        for i in range(1500):
            clock.t += 0.01
            bad = i % 23 == 0 or 300 <= i < 330 or 900 <= i < 960
            ok = cb.on_call_end(errors.EFAILEDSOCKET if bad else 0, 1000 + i)
            out.append((ok, cb.is_broken(), cb.isolation_duration_ms(),
                        round(cb.remaining_isolation_s(), 6)))
            if cb.is_broken() and i % 50 == 0:
                cb.reset()  # a revival
        return out

    want = decisions(ref_cb)
    assert decisions(port_cb) == want
    assert any(not ok for ok, *_ in want) and any(ok for ok, *_ in want)


def test_cluster_recover_twins(clock):
    def decisions(mod, socket_cls):
        clock.t = 1000.0
        random.seed(3)
        policy = mod.recover_policy_from_params(
            "min_working_instances=4 hold_seconds=0.2")
        sids = [socket_cls.create(remote_side=None) for _ in range(8)]
        for sid in sids[:4]:
            socket_cls.address(sid).set_failed(errors.EFAILEDSOCKET, "down")
        out = [policy.do_reject(sids[:4])]
        policy.start_recover()
        for step in range(400):
            clock.t += 0.005
            ids = sids[:4] + sids[4:4 + min(4, step // 100 * 2)]
            recovering = policy.stop_recover_if_necessary()
            out.append((recovering, recovering and policy.do_reject(ids)))
        for sid in sids:
            socket_cls.address(sid).recycle()
        return out

    want = decisions(ref_cr, RefSocket)
    assert decisions(port_cr, Socket) == want
    rejects = [r for _, r in want[1:101]]
    assert all(rejects)  # nothing usable: everything rejected
    assert not want[-1][0]  # recovery ended once 4 held for 0.2 s


# -- the channel against port servers ----------------------------------------

class TaggedEcho(rpc.Service):
    """Answers with its name. ``delay_s`` slows one server down;
    ``drop`` closes the connection instead of answering."""

    SERVICE_NAME = "EchoService"

    def __init__(self, name):
        self.name = name
        self.delay_s = 0.0
        self.drop = False
        self.peers = []  # remote port of every call

    @rpc.rpc_method(wire.EchoRequest, wire.EchoResponse)
    def Echo(self, cntl, request, response, done):
        self.peers.append(cntl.remote_side.port)
        if self.drop:
            cntl._server_socket.close()
            return
        if self.delay_s:
            time.sleep(self.delay_s)
        if request.sleep_us:
            time.sleep(request.sleep_us / 1e6)
        response.message = f"{self.name}:{request.message}"
        done()


def _serve(name, address="127.0.0.1:0", extra=()):
    svc = TaggedEcho(name)
    srv = rpc.Server(rpc.ServerOptions(device=CPU))
    assert srv.add_service(svc) == 0
    for s in extra:
        assert srv.add_service(s) == 0
    assert srv.start(address) == 0
    return srv, svc


@pytest.fixture
def trio():
    started = [_serve(f"n{i}") for i in range(3)]
    yield started
    for srv, _ in started:
        srv.stop()


def _list(servers):
    return "list://" + ",".join(str(s.listen_endpoint) for s, _ in servers)


def _echo(ch, msg="x", timeout_ms=2000, **kw):
    return ch.call("EchoService.Echo", wire.EchoRequest(message=msg, **kw),
                   wire.EchoResponse, timeout_ms=timeout_ms)


def test_rr_spreads_calls(trio):
    ch = rpc.Channel()
    assert ch.init(_list(trio), "rr") == 0
    try:
        got = [_echo(ch) for _ in range(9)]
        assert all(not c.failed() for c, _ in got)
        names = [r.message.split(":")[0] for _, r in got]
        assert sorted(names) == ["n0"] * 3 + ["n1"] * 3 + ["n2"] * 3
        assert names[:3] != names[3:6] or len(set(names[:3])) == 3
    finally:
        ch.close()


def test_failover_under_max_retry(trio):
    trio[1][1].drop = True  # rr's first pick closes the connection
    retries0 = bvar.find_exposed("rpc_retries").get_value()
    ch = rpc.Channel(rpc.ChannelOptions(max_retry=2))
    nore = rpc.Channel(rpc.ChannelOptions(max_retry=0))
    try:
        assert ch.init(_list(trio), "rr") == 0
        got = [_echo(ch) for _ in range(6)]
        assert all(not c.failed() for c, _ in got), [c.error_text for c, _ in got]
        assert all(not r.message.startswith("n1") for _, r in got)
        assert any(c.retried_count == 1 for c, _ in got)
        assert bvar.find_exposed("rpc_retries").get_value() > retries0
        trio[2][0].stop()  # a server stops: its socket fails, rr skips it
        got = [_echo(ch) for _ in range(4)]
        assert [r.message for _, r in got] == ["n0:x"] * 4
        assert nore.init(str(trio[1][0].listen_endpoint)) == 0
        c, _ = _echo(nore)
        assert c.error_code == errors.ECLOSE and c.retried_count == 0
    finally:
        ch.close()
        nore.close()


def test_backup_request_answered_by_fast_server(trio):
    trio[0][1].delay_s = 0.5  # rr's third pick
    backups0 = bvar.find_exposed("rpc_backup_requests").get_value()
    ch = rpc.Channel(rpc.ChannelOptions(backup_request_ms=30))
    try:
        assert ch.init(_list(trio), "rr") == 0
        fast = []
        for _ in range(3):
            t0 = time.monotonic()
            c, r = _echo(ch)
            took = time.monotonic() - t0
            assert not c.failed(), c.error_text
            if c.has_backup_request:
                # answered well before the slow server could
                assert not r.message.startswith("n0") and took < 0.4
                fast.append(took)
        assert len(fast) == 1  # one of three rr picks is the slow server
        assert bvar.find_exposed("rpc_backup_requests").get_value() == backups0 + 1
    finally:
        ch.close()


def test_timeout_with_late_response_dropped():
    srv, svc = _serve("slow")
    svc.delay_s = 0.4
    ch = rpc.Channel()
    try:
        assert ch.init(str(srv.listen_endpoint)) == 0
        t0 = time.monotonic()
        c, r = _echo(ch, "late", timeout_ms=40)
        assert c.error_code == errors.ERPCTIMEDOUT
        assert time.monotonic() - t0 < 0.3  # well before the answer
        svc.delay_s = 0.0
        # the next call waits behind the late answer on the connection,
        # which reaches no controller: the id of its RPC is stale
        c2, r2 = _echo(ch, "next")
        assert not c2.failed() and r2.message == "slow:next"
        assert r.message == "" and len(c.response_attachment) == 0
        assert c._response_rpc_meta is None
    finally:
        ch.close()
        srv.stop()


def test_async_done_and_cancel():
    srv, svc = _serve("a")
    ch = rpc.Channel()
    try:
        assert ch.init(str(srv.listen_endpoint)) == 0
        ended = threading.Event()
        seen = []
        cntl = rpc.Controller()
        resp = wire.EchoResponse()
        ch.call_method("EchoService.Echo", cntl,
                       wire.EchoRequest(message="m"), resp,
                       lambda c: (seen.append(c.error_code), ended.set()))
        assert ended.wait(5) and seen == [0] and resp.message == "a:m"
        svc.delay_s = 0.2
        cntl = rpc.Controller()
        ch.call_method("EchoService.Echo", cntl, wire.EchoRequest(), None,
                       lambda c: None)
        cntl.cancel()
        assert cntl.join(2) and cntl.error_code == errors.ECANCELED
    finally:
        ch.close()
        srv.stop()


def test_pooled_and_short_connections():
    srv, svc = _serve("p")
    pooled = rpc.Channel(rpc.ChannelOptions(connection_type="pooled"))
    short = rpc.Channel(rpc.ChannelOptions(connection_type="short"))
    try:
        for ch in (pooled, short):
            assert ch.init(str(srv.listen_endpoint)) == 0
        for _ in range(3):
            assert not _echo(pooled)[0].failed()
        assert len(set(svc.peers)) == 1  # one pooled connection, reused
        threads = [threading.Thread(target=_echo, args=(pooled, "c"),
                                    kwargs={"sleep_us": 50000})
                   for _ in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(5)
        assert len(set(svc.peers)) >= 2  # concurrent calls opened more
        del svc.peers[:]
        for _ in range(3):
            c, _ = _echo(short)
            assert not c.failed() and c._current_sock.failed()
        assert len(set(svc.peers)) == 3  # a connection per call
        # a device channel keeps "single", as the reference does: a pull's
        # ACK must reach the endpoint that retains it
        for mod in (rpc, ref_rpc):
            for kind in ("short", "pooled"):
                ch = mod.Channel(mod.ChannelOptions(
                    use_device_transport=True, connection_type=kind))
                assert ch.options.connection_type == "single"
    finally:
        pooled.close()
        short.close()
        srv.stop()


def test_two_channels_share_one_socket():
    srv, svc = _serve("s")
    chans = [rpc.Channel() for _ in range(2)]
    devs = [ts.make_device_channel(str(srv.listen_endpoint),
                                   rpc.ChannelOptions(device=CPU))
            for _ in range(2)]
    try:
        for ch in chans:
            assert ch.init(str(srv.listen_endpoint)) == 0
        for ch in chans + devs:
            assert not _echo(ch)[0].failed()
        assert chans[0]._single_sid == chans[1]._single_sid
        assert devs[0]._single_sid == devs[1]._single_sid
        assert devs[0]._single_sid != chans[0]._single_sid
        assert len(set(svc.peers)) == 2  # one plain, one device connection
        sock = Socket.address(devs[0]._single_sid)
        assert sock.app_state.state == 2  # one handshake, ESTABLISHED
        chans[0].close()
        assert not Socket.address(chans[1]._single_sid).failed()
        chans[1].close()
        assert Socket.address(chans[1]._single_sid) is None  # recycled
    finally:
        for ch in chans + devs:
            ch.close()
        srv.stop()


def test_health_check_revives_after_restart():
    srv, _ = _serve("r1")
    port = srv.listen_endpoint.port
    ch = rpc.Channel(rpc.ChannelOptions(health_check_interval_s=0.05,
                                        max_retry=0))
    try:
        assert ch.init(f"list://127.0.0.1:{port}", "rr") == 0
        assert _echo(ch)[1].message == "r1:x"
        (sid,) = ch._lb.server_ids()
        srv.stop()
        _wait_for(lambda: Socket.address(sid).failed(), 5, "socket failed")
        assert _echo(ch)[0].error_code == errors.EFAILEDSOCKET
        srv, _ = _serve("r2", f"127.0.0.1:{port}")
        _wait_for(lambda: not Socket.address(sid).failed(), 5, "revival")
        c, r = _echo(ch)
        assert not c.failed() and r.message == "r2:x"
        assert ch._lb.server_ids() == [sid]  # the same socket, revived
    finally:
        ch.close()
        srv.stop()


def test_file_naming_update_for_live_channel(tmp_path, monkeypatch, trio):
    monkeypatch.setattr(port_ns.FileNamingService, "refresh_interval_s", 0.05)
    path = tmp_path / "servers"
    path.write_text(f"{trio[0][0].listen_endpoint}\n")
    ch = rpc.Channel()
    try:
        assert ch.init(f"file://{path}", "rr") == 0
        assert _echo(ch)[1].message == "n0:x"
        (old,) = ch._lb.server_ids()
        path.write_text(f"{trio[1][0].listen_endpoint}\n"
                        f"{trio[2][0].listen_endpoint} 2\n")
        _wait_for(lambda: old not in ch._lb.server_ids(), 3, "ns update")
        assert Socket.address(old) is None  # the removed node's socket
        names = {_echo(ch)[1].message for _ in range(4)}
        assert names == {"n1:x", "n2:x"}
    finally:
        ch.close()


# -- the tensor lane behind a balancer ---------------------------------------

def _x(seed=0, n=64 << 10):
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=n).astype(np.float32))


def _u8(t) -> bytes:
    if isinstance(t, torch.Tensor):
        return t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(t).tobytes()


class _Store:
    """Records the endpoint of every connection that served a Pull."""

    def __init__(self, base):
        store = self

        class Svc(base):
            def __init__(self):
                super().__init__()
                self.endpoints = []
                self.push_delay_s = 0.0
                self.drop_push = False

            def Push(self, cntl, request, response, done):
                if self.drop_push:
                    self.drop_push = False
                    sock = cntl._server_socket
                    (sock.close() if hasattr(sock, "close")
                     else sock.set_failed(ref_errors.ECLOSE, "dropped"))
                    return
                if self.push_delay_s:
                    time.sleep(self.push_delay_s)
                super().Push(cntl, request, response, done)

            def Pull(self, cntl, request, response, done):
                ep = cntl._server_socket.app_state
                if ep not in self.endpoints:
                    self.endpoints.append(ep)
                super().Pull(cntl, request, response, done)

        for name in ("Push", "Pull"):  # keep the registration's handlers
            getattr(Svc, name).__rpc_method__ = getattr(base, name).__rpc_method__
        store.cls = Svc


_PortStore = _Store(ts.TensorStoreService).cls
_RefStore = _Store(ref_ts.TensorStoreService).cls


@pytest.fixture
def ref_env(monkeypatch):
    # the reference server would arm its native descriptor-ring fabric;
    # the first sizing of the process-wide bthread pool sticks: take the
    # default, as test_torch_interop does
    monkeypatch.setenv("BRPC_TPU_FABRIC", "0")
    get_task_control()


def _port_stores(n):
    out = []
    for _ in range(n):
        svc = _PortStore()
        srv = rpc.Server(rpc.ServerOptions(device=CPU))
        assert srv.add_service(svc) == 0
        assert srv.start("127.0.0.1:0") == 0
        out.append((srv, svc))
    return out


def _ref_stores(n):
    out = []
    for _ in range(n):
        svc = _RefStore()
        srv = ref_rpc.Server(ref_rpc.ServerOptions(num_threads=2))
        assert srv.add_service(svc) == 0
        assert srv.start("127.0.0.1:0") == 0
        out.append((srv, svc))
    return out


def _stop(servers):
    for srv, _ in servers:
        srv.stop()


def _port_device_channel(target, lb="rr", **kw):
    ch = rpc.Channel(rpc.ChannelOptions(use_device_transport=True,
                                        device=CPU, **kw))
    assert ch.init(target, lb) == 0
    return ch


def _ref_device_channel(target, lb="rr", **kw):
    ch = ref_rpc.Channel(ref_rpc.ChannelOptions(use_device_transport=True,
                                                **kw))
    assert ch.init(target, lb) == 0
    return ch


def _push_pull(client, to_host, n_push=2, n_pull=4):
    """One tensor pushed under one name n_push times (rr: once to each
    server), then pulled n_pull times, byte for byte."""
    x = _x(1)
    for _ in range(n_push):
        cntl, resp = client.push("t", [to_host(x)])
        assert not cntl.failed() and resp.ok, cntl.error_text
    for _ in range(n_pull):
        cntl, got = client.pull("t")
        assert not cntl.failed(), cntl.error_text
        assert _u8(got[0]) == _u8(x)


def test_interop_reference_client_rr_to_port_servers(monkeypatch):
    # both packages without the ring lane: a port server would advertise
    # its fabric, and the reference would try to build its library to push
    monkeypatch.setenv("BRPC_TPU_FABRIC", "0")
    servers = _port_stores(2)
    ch = _ref_device_channel(_list(servers))
    try:
        _push_pull(ref_ts.TensorClient(ch), lambda x: x.numpy())
        # rr sent one push to each port server
        assert all(len(svc._store) == 1 for _, svc in servers)
        assert all(_u8(t) == _u8(_x(1)) for _, svc in servers
                   for v in svc._store.values() for t in v)
    finally:
        ch.close()
        _stop(servers)


def test_interop_port_client_rr_to_reference_servers(ref_env):
    servers = _ref_stores(2)
    ch = _port_device_channel(_list(servers))
    try:
        client = ts.TensorClient(ch)
        _push_pull(client, lambda x: x)
        assert all(len(svc._store) == 1 for _, svc in servers)
        assert all(np.asarray(t).tobytes() == _u8(_x(1))
                   for _, svc in servers for v in svc._store.values()
                   for t in v)
        # every pull's ACK reached the reference server that served it
        assert all(ep.retained_count == 0 and ep.inflight_bytes == 0
                   for _, svc in servers for ep in svc.endpoints)
    finally:
        ch.close()
        _stop(servers)


def test_pull_ack_goes_to_the_serving_server(ref_env):
    """ROADMAP queue C #8. Two servers, rr, 2 pushes then 4 pulls of
    256 KiB float32: the reference sends each pull's ACK through the
    balancer, which alternates, so every pull comes from one server and
    every ACK goes to the other, whose endpoint has nothing to release.
    The port sends the ACK on the connection that served the pull."""
    ref_servers = _ref_stores(2)
    ref_ch = _ref_device_channel(_list(ref_servers))
    try:
        _push_pull(ref_ts.TensorClient(ref_ch), lambda x: x.numpy())
        served = [svc for _, svc in ref_servers if svc.endpoints]
        assert len(served) == 1  # rr: every pull went to one server
        (ep,) = served[0].endpoints
        assert ep.retained_count == 4 and ep.inflight_bytes == 4 * (256 << 10)
    finally:
        ref_ch.close()
        _stop(ref_servers)
    servers = _port_stores(2)
    ch = _port_device_channel(_list(servers))
    try:
        _push_pull(ts.TensorClient(ch), lambda x: x)
        eps = [ep for _, svc in servers for ep in svc.endpoints]
        assert len(eps) == 2  # the pulls alternate, and so do their ACKs
        assert all(ep.retained_count == 0 and ep.inflight_bytes == 0
                   for ep in eps)
        for sid in ch._lb.server_ids():
            cep = Socket.address(sid).app_state
            assert cep.retained_count == 0 and cep.inflight_bytes == 0
    finally:
        ch.close()
        _stop(servers)


def _client_endpoints(mod_socket, ch):
    return [mod_socket.address(sid).app_state for sid in ch._lb.server_ids()]


def test_backup_push_releases_the_losing_send(ref_env):
    """ROADMAP queue C #9, a backup request: the first attempt's send,
    packed on the slow server's connection, is never ACKed (only the
    winner's ack_seq comes back). The reference keeps it retained for
    good; the port releases it when the late response arrives."""
    for pkg in ("ref", "port"):
        servers = _ref_stores(2) if pkg == "ref" else _port_stores(2)
        servers[1][1].push_delay_s = 0.5  # rr's first pick
        mk = _ref_device_channel if pkg == "ref" else _port_device_channel
        ch = mk(_list(servers), backup_request_ms=30)
        client = (ref_ts if pkg == "ref" else ts).TensorClient(ch)
        x = _x(3)
        try:
            t0 = time.monotonic()
            cntl, resp = client.push("b", [x.numpy() if pkg == "ref" else x])
            assert not cntl.failed() and resp.ok, cntl.error_text
            assert cntl.has_backup_request and time.monotonic() - t0 < 0.4
            sock_cls = RefSocket if pkg == "ref" else Socket
            fast, slow = _client_endpoints(sock_cls, ch)
            assert fast.retained_count == 0
            # the slow server answers late; its response reaches no RPC
            _wait_for(lambda: "b" in servers[1][1]._store, 3, "late push")
            time.sleep(0.05)
            if pkg == "ref":
                assert slow.retained_count == 1  # kept for good
                assert slow.inflight_bytes == 256 << 10
            else:
                _wait_for(lambda: slow.retained_count == 0, 3, "release")
                assert slow.inflight_bytes == 0
        finally:
            ch.close()
            _stop(servers)


def test_retried_push_releases_the_failed_connection(ref_env):
    """ROADMAP queue C #9, a retry: the first server closes the connection
    without answering; the push succeeds on the other server. The
    reference keeps the failed connection's send retained; the port
    releases it when the connection fails."""
    for pkg in ("ref", "port"):
        servers = _ref_stores(2) if pkg == "ref" else _port_stores(2)
        servers[1][1].drop_push = True  # rr's first pick
        mk = _ref_device_channel if pkg == "ref" else _port_device_channel
        ch = mk(_list(servers))
        client = (ref_ts if pkg == "ref" else ts).TensorClient(ch)
        x = _x(4)
        try:
            cntl, resp = client.push("f", [x.numpy() if pkg == "ref" else x])
            assert not cntl.failed() and resp.ok, cntl.error_text
            # the reference may take the one failure twice (its socket's
            # sweep and its write path), which costs it a second retry
            assert (cntl.retried_count >= 1 if pkg == "ref"
                    else cntl.retried_count == 1)
            sock_cls = RefSocket if pkg == "ref" else Socket
            served, dropped = _client_endpoints(sock_cls, ch)
            if pkg == "ref":
                # kept for good (and a failure taken twice leaves the
                # served connection one more unACKed send)
                assert (dropped.retained_count, dropped.inflight_bytes) == (
                    1, 256 << 10)
            else:
                for ep in (served, dropped):
                    assert (ep.retained_count, ep.inflight_bytes) == (0, 0)
        finally:
            ch.close()
            _stop(servers)


def test_closed_connection_releases_an_unacked_pull(ref_env):
    """A pull whose ACK never comes (its client goes away): the reference
    server's endpoint keeps the send; the port server releases it, and
    its arena span, when the connection closes."""
    for pkg in ("ref", "port"):
        servers = _ref_stores(1) if pkg == "ref" else _port_stores(1)
        mk = _ref_device_channel if pkg == "ref" else _port_device_channel
        ch = mk(_list(servers))
        mod = ref_ts if pkg == "ref" else ts
        try:
            x = _x(5)
            cntl, _ = mod.TensorClient(ch).push(
                "p", [x.numpy() if pkg == "ref" else x])
            assert not cntl.failed(), cntl.error_text
            # the pull without its ACK
            cntl, resp = ch.call("TensorStore.Pull", mod.ts_pb2.TensorPullRequest(
                name="p"), mod.ts_pb2.TensorPullResponse, timeout_ms=2000)
            assert not cntl.failed() and resp.found
            (ep,) = servers[0][1].endpoints
            assert ep.retained_count == 1
            cntl._current_sock.set_failed(errors.ECLOSE, "client gone")
            if pkg == "ref":
                time.sleep(0.1)
                assert ep.retained_count == 1
            else:
                _wait_for(lambda: ep.retained_count == 0, 3, "release")
                assert ep.inflight_bytes == 0
        finally:
            ch.close()
            _stop(servers)


def test_each_attempt_packs_its_own_attachment():
    """ROADMAP queue C #10: the reference packs every attempt's wire-lane
    tensors into the one request attachment, so attempt 2's frame carries
    attempt 1's bytes too (the server reads the first copy, so only the
    size is wrong); the port packs each attempt into a copy."""
    x = _x(6, 1024)
    sizes = {}
    for name, mod, cntl, t in (
            ("ref", ref_proto, RefController(), x.numpy()),
            ("port", proto, rpc.Controller(), x)):
        cntl._method_full_name = "TensorStore.Push"
        cntl._outbound_tensors = [t]
        sizes[name] = [len(mod.pack_request(b"", cntl, cid).to_bytes())
                       for cid in (5, 6)]
        sizes[name].append(len(cntl.request_attachment))
    assert sizes["ref"][1] == sizes["ref"][0] + 4096 and sizes["ref"][2] == 8192
    assert sizes["port"] == [sizes["ref"][0], sizes["ref"][0], 0]
