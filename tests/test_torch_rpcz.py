"""The port's rpcz held against brpc_tpu's, on the CPU, with threads.

* The reference's cascade (tests/test_rpcz.py): a client calls Front,
  whose handler calls Back. Both packages collect the same four spans
  with the same parent edges, under one trace id.
* A trace crosses the packages both ways: a reference client through a
  port cascade, and a port client through a reference cascade.
* ``/rpcz`` (a trace, the newest spans, a bad and an unknown trace id)
  gives the reference's page line for line, with ids, times and ports
  masked.
* ``enable_rpcz`` off collects nothing; ``rpcz_sample_every`` keeps one
  span in N; the flags are restored in ``finally``.
* The SpanDB: the same spans give byte-equal files in both packages,
  rotated in two generations; ``find_trace`` finds on disk the spans
  that left the bounded memory.

Servers are module-scoped; every wait has a deadline of WAIT_S.
"""
import http.client
import re

import pytest

from brpc_tpu import native as ref_native
from brpc_tpu import rpc as ref_rpc
from brpc_tpu import rpcz as ref_rpcz
from brpc_tpu.bthread import get_task_control as ref_get_task_control
from brpc_tpu.butil import flags as ref_flags
from brpc_tpu.bvar import native_vars as ref_native_vars
from brpc_tpu.rpc.proto import echo_pb2
from brpc_tpu_torch import native as port_native
from brpc_tpu_torch import rpc, rpcz
from brpc_tpu_torch.butil import flags
from brpc_tpu_torch.rpc.proto import wire

WAIT_S = 10.0  # a deadline under load, never a sleep
PKGS = {"port": (rpc, wire, rpcz, flags),
        "ref": (ref_rpc, echo_pb2, ref_rpcz, ref_flags)}


def _services(mod, msgs):
    class Back(mod.Service):
        @mod.rpc_method(msgs.EchoRequest, msgs.EchoResponse)
        def Back(self, cntl, request, response, done):
            response.message = f"back({request.message})"
            done()

    class Front(mod.Service):
        backend = None

        @mod.rpc_method(msgs.EchoRequest, msgs.EchoResponse)
        def Front(self, cntl, request, response, done):
            _, back = self.backend.call(
                "Back.Back", msgs.EchoRequest(message=request.message),
                msgs.EchoResponse, timeout_ms=WAIT_S * 1000)
            response.message = f"front({back.message})"
            done()

    return Front(), Back()


@pytest.fixture(scope="module")
def cascades():
    """Per package: a Back server and a Front server (with the console)
    whose handler calls Back."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BRPC_TPU_FABRIC", "0")  # no native fabric build
        # the reference's native pieces would build its native runtime
        mp.setattr(ref_native_vars, "native_status_lines", lambda: [])
        mp.setattr(ref_native, "available", lambda: False)
        # and the port's pages show no native section, whether or not
        # an earlier test of this process loaded the port's library
        mp.setattr(port_native, "is_loaded", lambda: False)
        ref_get_task_control()  # the bthread pool's first sizing sticks
        servers, channels = [], []
        out = {}
        try:
            for pkg, (mod, msgs, _, _) in PKGS.items():
                front, back = _services(mod, msgs)
                kw = {"device": "cpu"} if pkg == "port" else {"num_threads": 4}
                for svc in (back, front):
                    srv = mod.Server(mod.ServerOptions(**kw))
                    servers.append(srv)
                    assert srv.add_service(svc) == 0
                    assert srv.start("127.0.0.1:0") == 0
                    if svc is back:
                        front.backend = mod.Channel()
                        channels.append(front.backend)
                        assert front.backend.init(
                            str(srv.listen_endpoint)) == 0
                out[pkg] = srv  # the Front server
            yield out
        finally:
            for ch in channels:
                ch.close()
            for srv in servers:
                srv.stop()


def _call_front(client: str, server):
    mod, msgs, _, _ = PKGS[client]
    ch = mod.Channel()
    assert ch.init(str(server.listen_endpoint)) == 0
    try:
        cntl, resp = ch.call("Front.Front", msgs.EchoRequest(message="t"),
                             msgs.EchoResponse, timeout_ms=WAIT_S * 1000)
    finally:
        ch.close()
    assert not cntl.failed(), cntl.error_text
    assert resp.message == "front(back(t))"
    return cntl.trace_id


def _chain(trace_id: int, client: str, server: str):
    """The trace's four spans in call order: the client's from the
    client's package, the rest from the server's."""
    spans = PKGS[client][2].find_trace(trace_id)
    if client != server:
        spans += PKGS[server][2].find_trace(trace_id)
    order = [("client", "Front.Front"), ("server", "Front.Front"),
             ("client", "Back.Back"), ("server", "Back.Back")]
    by_key = {(s.kind, s.full_method): s for s in spans}
    assert sorted(by_key) == sorted(order) and len(spans) == 4, [
        (s.kind, s.full_method) for s in spans]
    return [by_key[k] for k in order]


def _edges(chain):
    """The parent of each span as the index of the span before it."""
    ids = [s.span_id for s in chain]
    return [ids.index(s.parent_span_id) if s.parent_span_id in ids else None
            for s in chain]


def test_cascade_spans_like_the_reference(cascades):
    edges = {}
    for pkg in PKGS:
        PKGS[pkg][2].clear_for_tests()
        trace = _call_front(pkg, cascades[pkg])
        chain = _chain(trace, pkg, pkg)
        assert {s.trace_id for s in chain} == {trace}
        assert all(s.error_code == 0 and s.end_time >= s.start_time
                   for s in chain)
        assert len(PKGS[pkg][2].recent_spans()) == 4
        edges[pkg] = _edges(chain)
    assert edges["port"] == edges["ref"] == [None, 0, 1, 2]


CROSS = [("ref", "port"), ("port", "ref")]


@pytest.mark.parametrize("client,server", CROSS,
                         ids=[f"{c}-client-{s}-cascade" for c, s in CROSS])
def test_trace_crosses_the_packages(cascades, client, server):
    trace = _call_front(client, cascades[server])
    chain = _chain(trace, client, server)
    assert {s.trace_id for s in chain} == {trace}
    assert _edges(chain) == [None, 0, 1, 2]


_HEX = re.compile(rb"[0-9a-f]{16}")


def _mask(body: bytes) -> bytes:
    return re.sub(rb"\d+", b"N", _HEX.sub(b"H", body))


def _get(srv, path):
    conn = http.client.HTTPConnection("127.0.0.1", srv.listen_endpoint.port,
                                      timeout=WAIT_S)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        return r.status, r.getheader("content-type"), r.read()
    finally:
        conn.close()


PAGES = ["/rpcz?trace_id={trace:x}", "/rpcz", "/rpcz?limit=2",
         "/rpcz?trace_id=zz", "/rpcz?trace_id=1"]


@pytest.mark.parametrize("path", PAGES)
def test_rpcz_page_like_the_reference(cascades, path):
    got = {}
    for pkg in PKGS:
        PKGS[pkg][2].clear_for_tests()
        trace = _call_front(pkg, cascades[pkg])
        got[pkg] = _get(cascades[pkg], path.format(trace=trace))
    assert got["port"][:2] == got["ref"][:2] == (200, "text/plain")
    assert (_mask(got["port"][2]).split(b"\n")
            == _mask(got["ref"][2]).split(b"\n"))
    if path.startswith("/rpcz?trace_id={"):
        assert got["port"][2].count(b"\n") == 4


@pytest.mark.parametrize("pkg", PKGS)
def test_enable_and_sample_flags(cascades, pkg):
    _, _, mod_rpcz, fl = PKGS[pkg]
    try:
        mod_rpcz.clear_for_tests()
        assert fl.set_flag("enable_rpcz", False)
        _call_front(pkg, cascades[pkg])
        assert mod_rpcz.recent_spans() == []
        assert fl.set_flag("enable_rpcz", True)
        assert fl.set_flag("rpcz_sample_every", 2)
        for _ in range(3):
            _call_front(pkg, cascades[pkg])
        assert len(mod_rpcz.recent_spans()) == 6  # 12 spans, one in two
    finally:
        fl.set_flag("enable_rpcz", True)
        fl.set_flag("rpcz_sample_every", 1)
        mod_rpcz.clear_for_tests()


def _span_pair(i: int, trace_id: int):
    """The same span in both packages."""
    out = []
    for mod in (rpcz, ref_rpcz):
        s = mod.Span("server", f"Svc.M{i % 3}", trace_id=trace_id,
                     parent_span_id=i + 1, log_id=i)
        s.span_id = 1000 + i
        s.remote_side = f"127.0.0.1:{2000 + i}"
        s.start_time, s.end_time = 1.7e9 + i, 1.7e9 + i + 0.25
        s.request_size, s.response_size = 10 * i, 7
        s.annotations = [(1.7e9 + i + 0.125, f"step {i}")]
        out.append(s)
    return out


def test_spandb_files_and_rotation_like_the_reference(tmp_path):
    dbs = {"port": rpcz.SpanDB(str(tmp_path / "port"), 1000),
           "ref": ref_rpcz.SpanDB(str(tmp_path / "ref"), 1000)}
    try:
        for i in range(1200):  # rotates at 500 and 1000
            ours, theirs = _span_pair(i, 77 if i % 2 else 78)
            dbs["port"].append(ours)
            dbs["ref"].append(theirs)
        found = {pkg: db.find_trace(77) for pkg, db in dbs.items()}
    finally:
        for db in dbs.values():
            db.close()
    for gen in (0, 1):
        name = f"rpcz.{gen}.recordio"
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "ref" / name).read_bytes())
    # generation 1 holds spans 500-999, generation 0 spans 1000-1199
    assert [s.span_id for s in found["port"]] == [
        1000 + i for i in range(501, 1200, 2)]
    assert ([s.describe() for s in found["port"]]
            == [s.describe() for s in found["ref"]])


@pytest.mark.parametrize("pkg", PKGS)
def test_find_trace_from_disk(tmp_path, pkg):
    mod_rpcz, fl = PKGS[pkg][2], PKGS[pkg][3]
    mod_rpcz.clear_for_tests()
    try:
        assert fl.set_flag("rpcz_database_dir", str(tmp_path))
        assert fl.set_flag("rpcz_max_spans", 16)
        spans = [_span_pair(i, 55)[0 if pkg == "port" else 1]
                 for i in range(40)]
        for s in spans:
            s.end(0)
        assert len(mod_rpcz.recent_spans(100)) == 16
        found = mod_rpcz.find_trace(55)
        assert sorted(s.span_id for s in found) == [1000 + i
                                                    for i in range(40)]
    finally:
        fl.set_flag("rpcz_database_dir", "")
        fl.set_flag("rpcz_max_spans", 4096)
        mod_rpcz.find_trace(55)  # closes the SpanDB, as the flag is cleared
        mod_rpcz.clear_for_tests()
    assert mod_rpcz._span_db is None
