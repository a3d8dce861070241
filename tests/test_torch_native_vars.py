"""The port's native observability held against brpc_tpu's, on the CPU.

The binder's A12b calls against the reference's (names and
``inspect.signature``); the native section of ``/status`` and the native
``/connections`` table on seeded rows (both packages' code in this
process, their binders' reads replaced by the rows); the ``nat_*``
counters of a native server of each package moved by a seeded list of
Echo calls, on ``/vars`` and ``/brpc_metrics`` too; native spans under
``trace_scope`` from a native client of one package chained under the
caller's span in the other package's ``/rpcz``; the headers of
``/hotspots/native``, ``/heap/native``, ``/growth/native`` and
``/hotspots/contention``; and queue C #38, a page in a process without
a loaded library compiling nothing where the reference's builds.

Native servers and clients run in child processes (one native runtime
per process; the reference's library, built as in
``tests/test_torch_native.py``, only in children): a ``Child`` child
runs the snippets this file sends it, with its package's ``native``,
``rpc`` and a server of Echo and Sleep. Children are module-scoped and
started together; every wait has a deadline.
"""
import inspect
import itertools
import json
import os
import re
import subprocess
import sys
import threading
import time
import urllib.request

import pytest

from brpc_tpu import native as ref_native
from brpc_tpu.builtin import console as ref_console
from brpc_tpu.bvar import native_vars as ref_nv
from brpc_tpu_torch import native as port_native
from brpc_tpu_torch import rpc
from brpc_tpu_torch.builtin import console as port_console
from brpc_tpu_torch.bvar import native_vars as port_nv
from brpc_tpu_torch.rpc.controller import Controller
from brpc_tpu_torch.rpc.proto import wire
from test_torch_native import REPO, child_env

CALL_S = 20

# the reference binder's calls that the port binds (ROADMAP A12b and
# rpc_client_bench, brought forward from A12d)
A12B = """
stats_counter_names stats_counters stats_counter_bump stats_lane_names
stats_hist stats_quantile stats_now_ns stats_drain_spans stats_reset
stats_snapshot method_stats method_quantile method_hist conn_snapshot
dispatcher_count dispatcher_stats ring_counters res_names
res_accounted_bytes res_prof_start res_prof_stop res_prof_running
res_prof_samples res_prof_reset res_heap_report res_growth_baseline
res_growth_report prof_start prof_stop prof_running prof_samples
prof_reset prof_report mu_prof_start mu_prof_stop mu_prof_running
mu_prof_samples mu_prof_reset mu_prof_reset_samples mu_prof_report
mu_rank_stats mu_rank_name trace_set trace_scope dump_start dump_stop
dump_running dump_status replay_run channel_open channel_close
channel_open_http channel_open_grpc channel_call channel_acall http_call
grpc_call channel_set_breaker channel_breaker_state channel_retry_budget
rpc_server_add_port rpc_server_remove_port rpc_server_limiter
rpc_server_limit rpc_server_inflight rpc_server_queue_deadline_ms
server_draining rpc_set_dispatchers rpc_server_requests take_request
sock_graceful_close fault_configure fault_enabled fault_injected
rpc_client_bench res_stats
""".split()
# left for the native tools (ROADMAP A12d), listed in the binder's docstring
A12D = """
sched_start sched_stop bench_spawn_join bench_ping_pong echo_server_start
echo_server_stop echo_server_requests echo_client_bench redis_client_bench
grpc_client_bench http_client_bench grpc_channel_bench http_channel_bench
shm_push_bench shm_worker_drain_bench refguard_enabled refguard_ops
refguard_selftest res_selftest mu_contend_selftest
""".split()


# -- the children ---------------------------------------------------------------

# argv: package. Each stdin line is a snippet run in one namespace that
# lasts; its ``out`` comes back as one JSON line after REPLY (bytes as
# {"hex": ...}), or its traceback as {"error": ...}. Other lines (what the
# snippet prints) are skipped.
CHILD = r"""
import base64, json, os, sys, threading, time, traceback
sys.path.insert(0, os.environ["REPO"])
pkg = sys.argv[1]
if pkg == "port":
    from brpc_tpu_torch import native, rpc, rpcz
    from brpc_tpu_torch.rpc.proto import wire as msgs
    base = dict(device="cpu")
else:
    from brpc_tpu import native, rpc, rpcz
    from brpc_tpu.rpc.proto import echo_pb2 as msgs
    from brpc_tpu.bthread import get_task_control
    get_task_control()
    base = {}

class EchoService(rpc.Service):
    @rpc.rpc_method(msgs.EchoRequest, msgs.EchoResponse)
    def Echo(self, cntl, request, response, done):
        response.message = request.message
        done()

    @rpc.rpc_method(msgs.EchoRequest, msgs.EchoResponse)
    def Sleep(self, cntl, request, response, done):
        sleeping.append(1)
        time.sleep(float(request.message or 0.3))
        sleeping.pop()
        response.message = request.message
        done()

sleeping = []  # Sleep calls in their handler now

def serve(store=False, **opts):
    srv = rpc.Server(rpc.ServerOptions(**base, **{"num_threads": 2, **opts}))
    assert srv.add_service(EchoService()) == 0
    if store:  # a TensorStore (the fabric stays off: BRPC_TPU_FABRIC=0)
        ts = __import__(rpc.__name__ + ".tensor_service", fromlist=["x"])
        assert srv.add_service(ts.TensorStoreService()) == 0
    assert srv.start("127.0.0.1:0") == 0
    return srv

def enc(x):
    if isinstance(x, (bytes, bytearray, memoryview)):
        return {"hex": bytes(x).hex()}
    if isinstance(x, (list, tuple)):
        return [enc(v) for v in x]
    if isinstance(x, dict):
        return {str(k): enc(v) for k, v in x.items()}
    return x

ns = dict(globals())
for line in sys.stdin:
    ns["out"] = None
    try:
        exec(json.loads(line), ns)
        reply = {"out": enc(ns["out"])}
    except BaseException:
        reply = {"error": traceback.format_exc()[-3000:]}
    print("@@reply " + json.dumps(reply), flush=True)
"""
REPLY = "@@reply "


def dec(x):
    if isinstance(x, dict):
        if set(x) == {"hex"}:
            return bytes.fromhex(x["hex"])
        return {k: dec(v) for k, v in x.items()}
    if isinstance(x, list):
        return [dec(v) for v in x]
    return x


class Child:
    """A CHILD child of one package; ``run(code)`` is the snippet's
    ``out``. The reference's children load its library through
    ``BRPC_TPU_NATIVE_SO``."""

    def __init__(self, pkg: str, **env):
        self.pkg = pkg
        self.proc = subprocess.Popen(
            [sys.executable, "-c", CHILD, pkg], stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, text=True, cwd=str(REPO),
            env=child_env(ref_native=pkg == "ref", BRPC_TPU_FABRIC="0",
                          **env))

    def run(self, code: str, timeout_s: float = CALL_S):
        self.proc.stdin.write(json.dumps(code) + "\n")
        self.proc.stdin.flush()
        got = []

        def read():
            for line in self.proc.stdout:
                if line.startswith(REPLY):
                    got.append(line[len(REPLY):])
                    return

        t = threading.Thread(target=read, daemon=True)
        t.start()
        t.join(timeout_s)
        assert got, f"{self.pkg} child: no answer to {code!r}"
        reply = json.loads(got[0])
        assert "error" not in reply, reply["error"]
        return dec(reply["out"])

    def close(self) -> int:
        try:
            self.proc.stdin.close()
        except OSError:
            pass
        try:
            return self.proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            return self.proc.wait()


def start_children(names, store=False):
    """{name: Child} for names like "port_srv" (package before "_"),
    each given ``srv`` on a native runtime when its name ends "srv" (with
    a TensorStore when ``store``)."""
    children = {n: Child(n.split("_")[0]) for n in names}
    try:
        for n, d in children.items():
            if n.endswith("srv"):
                d.run(f"srv = serve(store={store}, use_native_runtime=True, "
                      f"native_builtin_echo=True)", timeout_s=90)
                d.port = d.run("out = srv.listen_endpoint.port")
            else:
                d.run("native.load()", timeout_s=90)
    except BaseException:
        for d in children.values():
            d.close()
        raise
    return children


def http_get(port: int, path: str):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=CALL_S) as r:
        return r.status, r.read().decode()


@pytest.fixture(scope="module")
def servers():
    children = start_children(["port_srv", "ref_srv", "port_cli", "ref_cli"])
    yield children
    for d in children.values():
        d.run("srv.stop()" if hasattr(d, "port") else "pass")
        assert d.close() == 0


# -- the binder -------------------------------------------------------------------

def test_binder_names_and_signatures():
    for name in A12B:
        want, got = getattr(ref_native, name), getattr(port_native, name)
        if inspect.isfunction(want):
            assert inspect.signature(got) == inspect.signature(want), name
    ref_names = {n for n, o in vars(ref_native).items()
                 if inspect.isfunction(o) and not n.startswith("_")
                 and o.__module__ == ref_native.__name__}
    missing = {n for n in ref_names if not hasattr(port_native, n)}
    assert missing == set(A12D)
    for name in A12D:  # each named where the binder says what is left
        assert f"``{name}``" in port_native.__doc__
    # importing the variables' module loaded no library
    assert "register_native_bvars" in dir(port_nv)


# -- the pages on seeded rows -------------------------------------------------------

LANES = ["echo", "http", "redis", "grpc", "client", "shm"]
SNAP = {"nat_socket_read_bytes": 81920, "nat_socket_write_bytes": 40960,
        "nat_connections_accepted": 7, "nat_py_queue_depth": 2,
        "nat_tpu_std_msgs_in": 300, "nat_tpu_std_responses_out": 299,
        "nat_tpu_std_errors": 4, "nat_http_msgs_in": 12,
        "nat_http_responses_out": 12, "nat_http_errors": 0,
        "nat_grpc_msgs_in": 0, "nat_client_calls": 41,
        "nat_client_responses": 40, "nat_client_errors": 1,
        "nat_elimit_rejects": 3, "nat_faults_injected": 0}
RES = [{"subsystem": s, "live_bytes": b, "live_objects": o, "cum_allocs": o + 3,
        "cum_frees": 3, "cum_alloc_bytes": b + 99, "hwm_bytes": b + 512}
       for s, b, o in (("iobuf.block", 65536, 8), ("sock.slab", 4096, 2),
                       ("prof.cells", 1 << 20, 1), ("shm.span", 0, 0))]
METHODS = [{"lane": "echo", "method": "EchoService.Echo", "count": 300,
            "errors": 4, "concurrency": 1, "max_concurrency": 9},
           {"lane": "http", "method": "/status", "count": 12, "errors": 0,
            "concurrency": 0, "max_concurrency": 1},
           {"lane": "grpc", "method": "(other)", "count": 0, "errors": 0,
            "concurrency": 0, "max_concurrency": 0}]
CONNS = [{"sock_id": 4294967301 + i, "in_bytes": 100 * i + 7,
          "out_bytes": 50 * i, "in_msgs": i, "out_msgs": i, "read_calls": 3,
          "write_calls": 2, "unwritten_bytes": 0, "mem_bytes": 4096 * i,
          "fd": 10 + i, "disp_idx": i % 2, "server_side": i % 2 == 0,
          "protocol": ("tpu_std", "http", "h2")[i % 3],
          "remote": f"127.0.0.1:{40000 + i}"} for i in range(3)]


def _seed(mp, mod, nv):
    """Replace the binder's reads by the seeded rows (no library)."""
    hist = {0: [0, 5, 9, 2], 1: [0, 1], 3: [0, 0, 0]}
    fns = dict(
        available=lambda: True, is_loaded=lambda: True,
        stats_counters=lambda: dict(SNAP),
        stats_lane_names=lambda: list(LANES),
        res_stats=lambda: [dict(r) for r in RES],
        res_accounted_bytes=lambda: sum(r["live_bytes"] for r in RES),
        rss_at_load=lambda: 50 << 20, _read_rss=lambda: 53 << 20,
        method_stats=lambda: [dict(r) for r in METHODS],
        method_quantile=lambda lane, m, q: 1000.0 * lane + 2e4 * q,
        stats_hist=lambda lane: hist.get(lane, [0]),
        stats_quantile=lambda lane, q: 500.0 * (lane + 1) + 1e5 * q,
        conn_snapshot=lambda: [dict(r) for r in CONNS])
    for name, fn in fns.items():
        mp.setattr(mod, name, fn, raising=False)
    nv.settle_for_tests()


# fields that read a clock: the rates of the PerSecond windows
CLOCK_FIELDS = {"qps": r"qps=[0-9.]+", "per-second": r"\([0-9,.]+/s\)"}


def _mask(text: str) -> str:
    for name, pat in CLOCK_FIELDS.items():
        text = re.sub(pat, f"<{name}>", text)
    return text


def test_native_status_section_and_connections_on_seeded_rows(monkeypatch):
    class NoConnections:
        def list_connections(self):
            return []

    got = {}
    for pkg, mod, nv, console in (("ref", ref_native, ref_nv, ref_console),
                                  ("port", port_native, port_nv,
                                   port_console)):
        with monkeypatch.context() as mp:
            _seed(mp, mod, nv)
            status = "\n".join(nv.native_status_lines(dict(SNAP)))
            code, _, conns = console._connections_handler(NoConnections(),
                                                          None)
            got[pkg] = (_mask(status), code, _mask(conns))
            # the rate windows' sampler would read the real binder later
            nv._method_rates.clear()
            nv._conn_rates.clear()
            nv.settle_for_tests()
    assert got["port"] == got["ref"]
    status, _, conns = got["port"]
    assert "tpu_std: in=300 out=299 errors=4" in status
    assert "method EchoService.Echo [echo]: count=300 <qps>" in status
    assert "(other)" not in status  # a row never used
    assert "overload/faults: faults_injected=0 elimit_rejects=3" in status
    assert conns.count("127.0.0.1:400") == 3
    assert "native socket buffered memory: 12288 bytes across 3" in conns


# -- the counters against the traffic -------------------------------------------------

N_ECHO = 37


def _port_echo(port: int, n: int):
    ch = rpc.Channel()
    assert ch.init(f"127.0.0.1:{port}") == 0
    try:
        for i in range(n):
            cntl = Controller()
            cntl.timeout_ms = CALL_S * 1000
            resp = wire.EchoResponse()
            ch.call_method("EchoService.Echo", cntl,
                           wire.EchoRequest(message=f"m{i}"), resp)
            assert not cntl.failed() and resp.message == f"m{i}"
    finally:
        ch.close()


# a tpu_std call parsed and answered natively (the builtin echo)
COUNT_KEYS = ("nat_tpu_std_msgs_in", "nat_tpu_std_responses_out")
ECHO_ROW = 'nat_method_count{lane="echo",method="EchoService.Echo"}'


def _echo_count(rows) -> int:
    return sum(r["count"] for r in rows
               if (r["lane"], r["method"]) == ("echo", "EchoService.Echo"))


def test_counters_move_by_the_calls(servers):
    for pkg in ("port", "ref"):
        srv = servers[f"{pkg}_srv"]
        get = "out = [native.stats_counters(), native.method_stats()]"
        before, rows0 = srv.run(get)
        _port_echo(srv.port, N_ECHO)
        after, rows1 = srv.run(get)
        for key in COUNT_KEYS:
            assert after[key] - before[key] == N_ECHO, (pkg, key)
        assert _echo_count(rows1) - _echo_count(rows0) == N_ECHO, pkg
        # the same counters on the console, through the native HTTP lane
        # (the pages read snapshots kept 0.25 s)
        _page_shows(srv.port, "/vars/nat_tpu_std_msgs_in",
                    r"^nat_tpu_std_msgs_in : (\d+)$",
                    after["nat_tpu_std_msgs_in"], srv)
        _page_shows(srv.port, "/brpc_metrics",
                    r"^" + re.escape(ECHO_ROW) + r" (\d+)$",
                    _echo_count(rows1), srv)
        _page_shows(srv.port, "/status",
                    r"^  method EchoService\.Echo \[echo\]: count=(\d+) ",
                    _echo_count(rows1), srv)
        code, body = http_get(srv.port, "/status")
        assert "native runtime:" in body and "tpu_std: in=" in body, pkg


def _page_shows(port: int, path: str, pattern: str, at_least: int, srv):
    """The page reaches ``at_least``: its snapshot is kept 0.25 s, so the
    first read may predate the calls (a page takes seconds on a loaded
    host: at least three reads)."""
    deadline = time.monotonic() + CALL_S
    for attempt in itertools.count(1):
        code, body = http_get(port, path)
        m = re.search(pattern, body, re.M)
        if code == 200 and m and int(m[1]) >= at_least:
            return
        if attempt >= 3 and time.monotonic() > deadline:
            # what the server's process reads now, beside the page
            now = srv.run("out = [native.stats_counters(), os.getpid(), "
                          "srv.listen_endpoint.port]")
            raise AssertionError((port, path, at_least, body[-2000:], now))
        time.sleep(0.1)


# -- native spans under trace_scope ----------------------------------------------------

def test_native_client_spans_chain_under_the_caller(servers):
    """caller's span s -> the native client's span (in the client's
    /rpcz) -> the native server span (in the server's /rpcz), with its
    parse, dispatch and write annotations."""
    for cli, srv in (("port_cli", "ref_srv"), ("ref_cli", "port_srv")):
        trace, parent = {"port_cli": (0x5eed01, 0x77),
                         "ref_cli": (0x5eed02, 0x78)}[cli]
        code, out = servers[cli].run(
            f"native.stats_enable_spans(1)\n"
            f"ch = native.channel_open('127.0.0.1', {servers[srv].port}, "
            f"connect_timeout_ms=5000)\n"
            f"with native.trace_scope({trace}, {parent}):\n"
            f"    r = native.channel_call(ch, 'EchoService', 'Echo', "
            f"b'traced', timeout_ms=5000)\n"
            f"native.channel_close(ch)\n"
            f"out = [r[0], [(s.kind, s.span_id, s.parent_span_id) "
            f"for s in rpcz.find_trace({trace})]]")
        assert code == 0 and len(out) == 1, (cli, out)
        kind, client_span, client_parent = out[0]
        assert (kind, client_parent) == ("client", parent), out
        code, body = http_get(servers[srv].port, f"/rpcz?trace_id={trace:x}")
        assert code == 200 and "EchoService.Echo" in body, (srv, body)
        spans = servers[srv].run(
            f"out = [(s.kind, s.full_method, s.parent_span_id, "
            f"[a for _, a in s.annotations]) for s in rpcz.find_trace({trace})]")
        assert spans == [["server", "EchoService.Echo", client_span,
                          ["native parse done", "native usercode done",
                           "native response queued"]]], (cli, srv, spans)


# -- the native profiles' headers --------------------------------------------------------

PROFILE_PAGES = ["/hotspots/native?seconds=0.2", "/heap/native?seconds=0.2",
                 "/growth/native?seconds=0.2",
                 "/hotspots/contention?seconds=0.2"]


def _headers(body: str) -> list:
    """A profile's comment lines, numbers masked."""
    return [re.sub(r"\d+", "N", ln) for ln in body.splitlines()
            if ln.startswith("# ") and "rank" not in ln]


@pytest.mark.parametrize("path", PROFILE_PAGES)
def test_native_profile_headers(servers, path):
    got = {}
    for pkg in ("port", "ref"):
        code, body = http_get(servers[f"{pkg}_srv"].port, path)
        assert code == 200 and "native runtime unavailable" not in body, body
        got[pkg] = _headers(body)
    assert got["port"] == got["ref"]
    if "contention" in path:
        assert got["port"][0].startswith("# native lock contention")
        assert "# python wait-frame profile" in got["port"]


# -- queue C #38: a page never builds the library -------------------------------------

NO_BUILD = r"""
import json, os, sys, urllib.request
sys.path.insert(0, os.environ["REPO"])
from brpc_tpu_torch import native, rpc, rpcz
from brpc_tpu_torch.bvar import register_native_bvars
from brpc_tpu import native as ref_native
from brpc_tpu.builtin import console as ref_console
pages = ["/status", "/connections", "/rpc_dump", "/rpc_dump?seconds=0.1",
         "/hotspots/native?seconds=0.1", "/heap/native", "/growth/native",
         "/hotspots/contention?seconds=0.1", "/rpcz", "/vars", "/brpc_metrics"]
srv = rpc.Server(rpc.ServerOptions(device="cpu"))
assert srv.start("127.0.0.1:0") == 0
out = {"bvars": register_native_bvars(), "drained": rpcz.drain_native_spans(),
       "spans": len(rpcz.find_trace(1))}
for p in pages:
    url = f"http://127.0.0.1:{srv.listen_endpoint.port}{p}"
    with urllib.request.urlopen(url, timeout=20) as r:
        out[p] = [r.status, r.read().decode()]
srv.stop()
out["loaded"] = native.is_loaded()
out["compiles"] = len(open(os.environ["COMPILES"]).readlines()) if os.path.exists(
    os.environ["COMPILES"]) else 0
class NoConnections:
    def list_connections(self):
        return []
ref_console._connections_handler(NoConnections(), None)
out["ref_makes"] = len(open(os.environ["MAKES"]).readlines()) if os.path.exists(
    os.environ["MAKES"]) else 0
print(json.dumps(out))
"""


def test_a_page_never_builds_the_library(tmp_path):
    """Queue C #38, kept: the port's pages, bvar registry and /rpcz read
    only a library the process has loaded; the reference's /connections
    builds its library (``make``) to answer."""
    tools = tmp_path / "bin"
    tools.mkdir()
    for name, log in (("g++", "compiles"), ("make", "makes")):
        (tools / name).write_text(
            f'#!/bin/sh\necho "$@" >> "{tmp_path / log}"\nexit 1\n')
        (tools / name).chmod(0o755)
    env = child_env(CXX=str(tools / "g++"), COMPILES=str(tmp_path / "compiles"),
                    MAKES=str(tmp_path / "makes"),
                    PATH=f"{tools}:{os.environ['PATH']}")
    r = subprocess.run([sys.executable, "-c", NO_BUILD], capture_output=True,
                       text=True, env=env, cwd=str(REPO), timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert (out["compiles"], out["loaded"]) == (0, False), out
    assert out["ref_makes"] >= 1  # the reference's page ran its build
    assert out["bvars"] is False and out["drained"] == out["spans"] == 0
    for page in ("/rpc_dump?seconds=0.1", "/hotspots/native?seconds=0.1",
                 "/heap/native", "/growth/native"):
        assert out[page] == [200, "native runtime unavailable\n"], page
    assert "native recorder: unavailable" in out["/rpc_dump"][1]
    assert "native runtime:" not in out["/status"][1]
    assert "native sockets" not in out["/connections"][1]
    assert out["/hotspots/contention?seconds=0.1"][1].startswith(
        "# python wait-frame profile")
    assert "nat_" not in out["/vars"][1] + out["/brpc_metrics"][1]
