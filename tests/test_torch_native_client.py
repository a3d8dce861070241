"""The port's native client lanes and server calls held against
brpc_tpu's, on the CPU.

Native clients of each package call the other package's native server
(``use_native_runtime`` with the native builtin Echo, and Sleep on its
Python lane) on one seeded
list: Echo, an unknown service, an unknown method, a deadline, HTTP GET
and POST, and gRPC; bodies and codes are equal. Under one failure
sequence the breaker's and the retry budget's states are equal. A
capture by either package's server (``dump_start``) is replayed by the
other package's ``replay_run`` with equal counts (a captured push fails,
queue C #40), and by ``rpc_replay --native``. The limiter, the queue deadline,
``rpc_server_add_port``/``remove_port``, one seeded fault spec and
``server_draining`` give the same codes and counts in both packages. The
four native examples print the reference's lines (ports, pids, times
and rates masked), ``device_performance``'s native bulk line takes the
reference's format, and queue C #39 is pinned: where the library does
not build, the port's examples raise and the reference's print that
there is nothing to demo.

Children as in ``tests/test_torch_native_vars.py`` (one native runtime
per process): two servers and two clients, module-scoped, and the
examples, started in the background at the first test.
"""
import json
import re
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from brpc_tpu_torch import rpc
from brpc_tpu_torch.rpc.tensor_service import TensorClient
from test_torch_native import REPO, child_env
from test_torch_native_vars import start_children

EXAMPLES = {"native_client": [], "native_protocol_clients": ["--device", "cpu"],
            "usercode_workers": ["--device", "cpu"],
            "io_uring_echo": ["--seconds", "0.3"]}
EXAMPLE_S = 120

# helpers in every client child
CLIENT = r'''
def open_all(port):
    return (native.channel_open("127.0.0.1", port, connect_timeout_ms=5000),
            native.channel_open_http("127.0.0.1", port,
                                     connect_timeout_ms=5000),
            native.channel_open_grpc("127.0.0.1", port,
                                     connect_timeout_ms=5000))

def close_all(chans):
    for c in chans:
        native.channel_close(c)

def req(msg):
    return msgs.EchoRequest(message=msg).SerializeToString()

def acalls(port, calls, timeout_ms=5000, gap_s=0.0):
    """Each (method, message) as an async call on a connection of its own
    (a connection's requests reach the Python lane together); the codes
    in order."""
    chans = [native.channel_open("127.0.0.1", port, connect_timeout_ms=5000)
             for _ in calls]
    codes, ev, lock = {}, threading.Event(), threading.Lock()
    def make(i):
        def done(code, resp):
            with lock:
                codes[i] = code
                if len(codes) == len(calls):
                    ev.set()
        return done
    for i, (m, msg) in enumerate(calls):
        assert native.channel_acall(chans[i], "EchoService", m, req(msg),
                                    make(i), timeout_ms=timeout_ms) == 0
        time.sleep(gap_s)
    assert ev.wait(20)
    close_all(chans)
    return [codes[i] for i in range(len(calls))]

def traffic(port, n):
    """n rounds of a tpu_std, an HTTP and a gRPC Echo: the codes."""
    chans = open_all(port)
    ch, h, g = chans
    out = []
    for i in range(n):
        out.append(native.channel_call(ch, "EchoService", "Echo",
                                       req(f"d{i}"), timeout_ms=5000)[0])
        out.append(native.http_call(
            h, "POST", "/EchoService/Echo",
            body=('{"message": "h%d"}' % i).encode(),
            headers="Content-Type: application/json\r\n",
            timeout_ms=5000)[0])
        out.append(native.grpc_call(g, "/EchoService/Echo", req(f"g{i}"),
                                    timeout_ms=5000)[0])
    close_all(chans)
    return out
'''

PAIRS = (("port_cli", "ref_srv"), ("ref_cli", "port_srv"))


@pytest.fixture(scope="module")
def peers():
    children = start_children(["port_srv", "ref_srv", "port_cli", "ref_cli"],
                            store=True)
    for n, d in children.items():
        if n.endswith("cli"):
            d.run(CLIENT)
    yield children
    for n, d in children.items():
        if n.endswith("srv"):
            d.run("srv.stop()")
        assert d.close() == 0


def _both(peers, code_fn):
    """{client package: code_fn(client, server)} over the two pairs."""
    return {cli.split("_")[0]: code_fn(peers[cli], peers[srv])
            for cli, srv in PAIRS}


# -- the examples, started at the first test ---------------------------------------

def _example_proc(pkg: str, name: str):
    if pkg == "port":
        cmd = [sys.executable, "-m", f"brpc_tpu_torch.examples.{name}",
               *EXAMPLES[name]]
        env = child_env(BRPC_TPU_FABRIC="0")
    else:
        cmd = [sys.executable, f"examples/{name}.py",
               *(EXAMPLES[name] if name == "io_uring_echo" else [])]
        env = child_env(ref_native=True, BRPC_TPU_FABRIC="0")
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env, cwd=str(REPO))


@pytest.fixture(scope="module", autouse=True)
def examples():
    procs = {(pkg, name): _example_proc(pkg, name)
             for name in EXAMPLES for pkg in ("port", "ref")}
    outs = {}

    def collect():
        for key, p in procs.items():
            try:
                out, err = p.communicate(timeout=EXAMPLE_S)
            except subprocess.TimeoutExpired:
                p.kill()
                out, err = p.communicate()
            outs[key] = (p.returncode, out, err)

    t = threading.Thread(target=collect, daemon=True)
    t.start()
    yield lambda: (t.join(EXAMPLE_S + 10), outs)[1]
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.wait()


# -- the client lanes on a seeded list ------------------------------------------------

def _seeded_calls(seed: int = 16):
    rng = np.random.default_rng(seed)
    msgs = ["".join(chr(97 + int(c)) for c in rng.integers(0, 26, int(n)))
            for n in rng.integers(1, 300, 6)]
    calls = [("echo", m) for m in msgs]
    calls += [("unknown_service", msgs[0]), ("unknown_method", msgs[1]),
              ("deadline", "0.5"), ("http_get", "/health"),
              ("http_post", msgs[2]), ("grpc", msgs[3]),
              ("grpc_unknown", msgs[4])]
    return calls


RUN_CALLS = r'''
chans = open_all({port})
ch, h, g = chans
out = []
for kind, m in {calls!r}:
    if kind == "echo":
        out.append(native.channel_call(ch, "EchoService", "Echo", req(m),
                                       timeout_ms=5000)[:2])
    elif kind == "unknown_service":
        out.append(native.channel_call(ch, "NoSuch", "Echo", req(m),
                                       timeout_ms=5000)[:2])
    elif kind == "unknown_method":
        out.append(native.channel_call(ch, "EchoService", "Nope", req(m),
                                       timeout_ms=5000)[:2])
    elif kind == "deadline":
        out.append(native.channel_call(ch, "EchoService", "Sleep", req(m),
                                       timeout_ms=150)[:2])
    elif kind == "http_get":
        out.append(native.http_call(h, "GET", m, timeout_ms=5000))
    elif kind == "http_post":
        out.append(native.http_call(
            h, "POST", "/EchoService/Echo",
            body=json.dumps({{"message": m}}).encode(),
            headers="Content-Type: application/json\r\n", timeout_ms=5000))
    elif kind == "grpc":
        out.append(native.grpc_call(g, "/EchoService/Echo", req(m),
                                    timeout_ms=5000)[:2])
    else:
        out.append(native.grpc_call(g, "/EchoService/Nope", req(m),
                                    timeout_ms=5000)[:2])
close_all(chans)
'''


def test_client_lanes_across_packages(peers):
    calls = _seeded_calls()
    got = _both(peers, lambda c, s: c.run(RUN_CALLS.format(port=s.port,
                                                           calls=calls)))
    assert got["port"] == got["ref"]
    out = dict(zip([k for k, _ in calls], got["port"]))
    assert out["echo"][0] == 0 and out["unknown_service"][0] == 1001
    assert out["unknown_method"][0] == 1002 and out["deadline"][0] == 1008
    assert out["http_get"] == [200, b"OK\n"]
    assert out["http_post"][0] == 200 and calls[-3][1].encode() in out[
        "http_post"][1]
    assert out["grpc"][0] == 0 and out["grpc_unknown"][0] != 0


BREAKER = r'''
ch = native.channel_open("127.0.0.1", {port}, connect_timeout_ms=5000,
                         health_check_ms=50)
native.channel_set_breaker(ch, True)
out = []
for i in range(12):
    r = native.channel_call(ch, "NoSuch" if i % 3 != 2 else "EchoService",
                            "Echo", req("b"), timeout_ms=2000, max_retry=1)
    out.append((r[0], native.channel_breaker_state(ch),
                native.channel_retry_budget(ch)))
native.channel_close(ch)
'''


def test_breaker_and_retry_budget(peers):
    got = _both(peers, lambda c, s: c.run(BREAKER.format(port=s.port)))
    assert got["port"] == got["ref"]
    states = [state for _, state, _ in got["port"]]
    assert states[0] == 0 and states[-1] == 1  # the errors tripped it


ACALLS = r"""
got = {{}}
ev = threading.Event()
def done(name, raise_):
    def fn(code, resp):
        got[name] = [code, resp]
        if len(got) == 2:
            ev.set()
        if raise_:
            raise ValueError("done raised")
    return fn
ch = native.channel_open("127.0.0.1", {port})
for name in ("x", "y"):
    assert native.channel_acall(ch, "EchoService", "Echo", req(name),
                                done(name, name == "x"), timeout_ms=5000) == 0
assert ev.wait(10)
native.channel_close(ch)
deadline = time.monotonic() + 5
while native._acall_live and time.monotonic() < deadline:
    time.sleep(0.01)
out = [got, len(native._acall_live)]
"""


def test_async_done_callbacks_and_one_that_raises(peers):
    """Each done runs once, its callback object held until then; one that
    raises is logged and the process goes on."""
    got, live = peers["port_cli"].run(ACALLS.format(port=peers["ref_srv"].port))
    assert got == {"x": [0, bytes.fromhex("0a0178")],
                   "y": [0, bytes.fromhex("0a0179")]}
    assert live == 0
    assert peers["port_cli"].run("out = 1") == 1  # still serving


# -- capture and replay --------------------------------------------------------------

def _push_by_wire(port: int, n: int):
    """n TensorStore pushes of a small tensor by the wire lane, from this
    process's Python client."""
    ch = rpc.Channel()
    assert ch.init(f"127.0.0.1:{port}") == 0
    try:
        client = TensorClient(ch)
        for i in range(n):
            cntl, resp = client.push(f"cap{i}", [torch.arange(64)])
            assert not cntl.failed() and resp.ok, cntl.error_text
    finally:
        ch.close()


def test_capture_replayed_by_the_other_package(peers, tmp_path):
    """Queue C #40, kept in both packages: the recorder keeps a tpu_std
    request's payload only, so a captured push replays with no tensors
    and fails."""
    counts = {}
    for cli, srv in PAIRS:
        other = peers["ref_cli" if cli == "port_cli" else "port_cli"]
        d = str(tmp_path / srv)
        assert peers[srv].run(f"out = native.dump_start({d!r})") == 0
        codes = peers[cli].run(f"out = traffic({peers[srv].port}, 3)")
        assert codes == [0, 200, 0] * 3
        _push_by_wire(peers[srv].port, 2)
        st = peers[srv].run("native.dump_stop()\nout = native.dump_status()")
        assert (st["samples"], st["written"], st["drops"]) == (11, 11, 0), st
        res = other.run(f"out = native.replay_run('127.0.0.1', "
                        f"{peers[srv].port}, {d!r})")
        counts[srv] = {k: res[k] for k in ("loaded", "sent", "ok", "failed",
                                           "skipped")}
        if other.pkg == "port":  # and the port's tool over the same files
            rc = other.run(
                "from brpc_tpu_torch.tools import rpc_replay\n"
                f"out = rpc_replay.main(['--dir', {d!r}, '--server', "
                f"'127.0.0.1:{peers[srv].port}', '--native', "
                f"'--concurrency', '2'])")
            assert rc == 1  # the two pushes
    assert counts["port_srv"] == counts["ref_srv"] == {
        "loaded": 11, "sent": 11, "ok": 9, "failed": 2, "skipped": 0}


def test_rpc_replay_native_exits_0(peers, tmp_path):
    d = str(tmp_path / "calls")
    srv = peers["ref_srv"]
    assert srv.run(f"out = native.dump_start({d!r})") == 0
    assert peers["ref_cli"].run(f"out = traffic({srv.port}, 2)") == [
        0, 200, 0] * 2
    srv.run("native.dump_stop()")
    rc = peers["port_cli"].run(
        "from brpc_tpu_torch.tools import rpc_replay\n"
        f"out = rpc_replay.main(['--dir', {d!r}, '--server', "
        f"'127.0.0.1:{srv.port}', '--native', '--qps', '200', "
        f"'--qps-to', '400'])")
    assert rc == 0


# -- the server's calls -------------------------------------------------------------

def _server_calls(cli, srv):
    out = {"limit": srv.run("native.rpc_server_limiter('constant:2')\n"
                            "out = native.rpc_server_limit()")}
    out["limited"] = sorted(cli.run(
        f"out = acalls({srv.port}, [('Sleep', '0.3')] * 6)"))
    out["limit_off"] = srv.run("native.rpc_server_limiter('')\n"
                               "out = [native.rpc_server_limit(), "
                               "native.rpc_server_inflight()]")
    srv.run("native.rpc_server_queue_deadline_ms(50)")
    # each Python-lane thread (2) busy with a Sleep of its own; three
    # more calls to the lane (Echo is the native builtin's) then wait
    # past the deadline
    out["queue_deadline"] = cli.run(
        f"out = acalls({srv.port}, [('Sleep', '0.5')] * 2 + "
        f"[('Sleep', '0')] * 3, gap_s=0.05)")
    srv.run("native.rpc_server_queue_deadline_ms(0)")
    p2 = srv.run("out = native.rpc_server_add_port()")
    out["ports"] = cli.run(
        f"ch2 = native.channel_open('127.0.0.1', {p2}, connect_timeout_ms=2000)\n"
        f"out = [native.channel_call(ch2, 'EchoService', 'Echo', req('a'), "
        f"timeout_ms=2000)[0]]")
    out["ports"].append(srv.run(f"out = native.rpc_server_remove_port({p2})"))
    out["ports"] += cli.run(
        f"out = [native.channel_call(ch2, 'EchoService', 'Echo', req('a'), "
        f"timeout_ms=2000)[0]]\n"
        f"try:\n"
        f"    ch3 = native.channel_open('127.0.0.1', {p2}, "
        f"connect_timeout_ms=1000)\n"
        f"    r = native.channel_call(ch3, 'EchoService', 'Echo', req('a'), "
        f"timeout_ms=1000)[0]\n"
        f"    native.channel_close(ch3)\n"
        f"    out.append('served' if r == 0 else 'refused')\n"
        f"except RuntimeError:\n"
        f"    out.append('refused')\n"
        f"native.channel_close(ch2)")
    # the client's writes fail by a seeded schedule: as many failed calls
    # as faults injected, the same in both packages
    out["faults"] = cli.run(
        "b = native.fault_injected()\n"
        "assert native.fault_configure('seed=7;write:err=EPIPE:p=0.25') == 0\n"
        f"ch = native.channel_open('127.0.0.1', {srv.port}, "
        f"connect_timeout_ms=5000)\n"
        "codes = [native.channel_call(ch, 'EchoService', 'Echo', req('f'), "
        "timeout_ms=2000)[0] for _ in range(40)]\n"
        "native.fault_configure('')\n"
        "native.channel_close(ch)\n"
        "out = [codes, native.fault_injected() - b]")
    return out


def test_server_calls_in_both_packages(peers):
    got = _both(peers, _server_calls)
    assert got["port"] == got["ref"]
    out = got["port"]
    assert out["limit"] == 2 and out["limit_off"] == [0, 0]
    assert out["limited"] == [0, 0, 2004, 2004, 2004, 2004]
    assert out["queue_deadline"] == [0, 0, 2004, 2004, 2004]
    assert out["ports"] == [0, 0, 0, "refused"]
    codes, injected = out["faults"]
    failed = sum(1 for c in codes if c != 0)
    assert injected == failed > 0


DRAIN = r'''
seen = []
t = threading.Thread(target=lambda: seen.append(native.server_quiesce(3000)))
before = native.server_draining()
deadline = time.monotonic() + 5  # the client's Sleep in its handler first
while not sleeping and time.monotonic() < deadline:
    time.sleep(0.005)
t.start()
deadline = time.monotonic() + 5
while not native.server_draining() and time.monotonic() < deadline:
    time.sleep(0.005)
during = native.server_draining()
t.join(10)
srv.stop()
out = [before, during, seen]
'''


def test_server_draining_during_the_stop(peers):
    """Last in this file: it stops both servers."""
    got = {}
    for cli, srv in PAIRS:
        codes = []
        th = threading.Thread(target=lambda c=cli, s=srv: codes.append(
            peers[c].run(f"out = acalls({peers[s].port}, [('Sleep', '0.4')])")))
        th.start()
        got[srv] = peers[srv].run(DRAIN)
        th.join(20)
        got[srv].append(codes)
    assert got["port_srv"] == got["ref_srv"] == [False, True, [0], [[0]]]


# -- the examples --------------------------------------------------------------------

MASKS = [(r"127\.0\.0\.1:\d+", "127.0.0.1:<port>"),
         (r"after \d+ms", "after <ms>ms"), (r"pid \d+", "pid <pid>"),
         (r"\['\d+'(, '\d+')*\]", "[<pids>]"), (r"[\d.]+ qps", "<qps> qps"),
         (r"\(\d+ requests\)", "(<n> requests)"),
         (r"\d+ provided-buffer receives, \d+ fixed-buffer sends",
          "<n> provided-buffer receives, <n> fixed-buffer sends")]


def _masked(text: str) -> list:
    for pat, rep in MASKS:
        text = re.sub(pat, rep, text)
    return text.splitlines()


def test_examples_print_the_references_lines(examples):
    outs = examples()
    for name in EXAMPLES:
        lines = {}
        for pkg in ("port", "ref"):
            code, out, err = outs[(pkg, name)]
            assert code == 0, (pkg, name, err[-2000:])
            lines[pkg] = _masked(out)
        assert lines["port"] == lines["ref"], name
    assert "revived: revived" in outs[("port", "native_client")][1]
    assert "worker processes served calls: [<pids>]" in _masked(
        outs[("port", "usercode_workers")][1])


def test_device_performance_native_bulk_line(peers):
    out = peers["port_cli"].run(
        "import contextlib, io\n"
        "from brpc_tpu_torch.examples import device_performance\n"
        "buf = io.StringIO()\n"
        "with contextlib.redirect_stdout(buf):\n"
        "    res = device_performance.native_bulk(1, seconds=0.2)\n"
        "out = [buf.getvalue(), res['bytes']]")
    line, moved = out
    assert moved > 0
    assert re.fullmatch(r"native_bulk=\d+\.\d\d GB/s \(\d+ MB echoed, "
                        r"1MB attachments\)\n", line), line


# -- queue C #39: the examples raise ------------------------------------------------------

NO_LIBRARY = r"""
import contextlib, io, json, os, runpy, sys
sys.path.insert(0, os.environ["REPO"])
from brpc_tpu_torch import native
out = {}
for name, argv in json.loads(sys.argv[1]).items():
    mod = __import__(f"brpc_tpu_torch.examples.{name}", fromlist=["main"])
    try:
        mod.main(argv)
        out[name] = "returned"
    except native.NativeUnavailable as e:
        out[name] = "raised: " + str(e)[:60]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        sys.argv = [f"examples/{name}.py"]
        try:
            runpy.run_path(f"examples/{name}.py", run_name="__main__")
        except SystemExit:
            pass
    out["ref/" + name] = buf.getvalue()
print(json.dumps(out))
"""


def test_examples_raise_without_the_library():
    """Queue C #39, kept: the port's native examples raise
    NativeUnavailable with the compiler's errors; the reference's say
    there is nothing to demo and exit 0."""
    env = child_env(CXX="/nonexistent/g++",
                    BRPC_TPU_NATIVE_SO="/nonexistent.so")
    r = subprocess.run([sys.executable, "-c", NO_LIBRARY, json.dumps(EXAMPLES)],
                       capture_output=True, text=True, env=env, cwd=str(REPO),
                       timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    for name in EXAMPLES:
        assert out[name].startswith("raised: native build failed"), out
        assert out["ref/" + name] == "native toolchain unavailable; " \
                                     "nothing to demo\n", out
