"""The port's native runtime held against brpc_tpu's, on the CPU.

The port's library builds from ``brpc_tpu_torch/native/src`` alone and
exports the same ``nat_*`` symbols as the reference's library built from
the reference's own sources (``native/src``, with the two flags its
headers need here) into ``brpc_tpu_torch/build/ref_native/<digest>/``.
The reference's native half runs only in child processes, with
``BRPC_TPU_NATIVE_SO`` pointing at that build in their environment: this
process's ``brpc_tpu.native`` is never pointed at it. Servers run in
child processes too (one native server per process), each stopped by its
test or fixture; every wait has a deadline.

Covered: the build and its symbols; a broken compiler raising from a
TensorStore server's start unless ``BRPC_TPU_FABRIC=0``, other servers
starting without the library and arming no fabric (queue C #37), and
``use_native_runtime`` returning -1, never serving from a Python
listener instead; a port ``use_native_runtime`` server giving the
reference native server's response bytes on a seeded list of raw
tpu_std calls (Echo, unknown service, unknown method, TensorStore Push,
Pull and Ack) and of redis commands to ``native_redis_store``;
TensorStore from a port device client (the ring lane) and from a
reference client; HTTP, gRPC and tensor records through ``py_workers``
with one worker killed and replaced; a graceful stop under load; the
native cluster, ``native=True`` combo channels and the host axis against
the reference's native cluster and the Python channels.
"""
import json
import os
import re
import socket
import struct
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from brpc_tpu import rpc as ref_rpc
from brpc_tpu.bthread import get_task_control
from brpc_tpu.rpc import tensor_service as ref_ts
from brpc_tpu_torch import rpc
from brpc_tpu_torch.native import build
from brpc_tpu_torch.rpc import tensor_service as ts
from brpc_tpu_torch.rpc.controller import Controller
from brpc_tpu_torch.rpc.proto import wire

REPO = Path(__file__).resolve().parent.parent
REF_SRC = REPO / "native" / "src"
# the reference's sources build here with these two flags: this host's
# <linux/io_uring.h> has the pbuf-ring structs but not the macro the
# reference probes (queue C #34), and libstdc++ does not pull <vector>
# into iobuf.cpp (queue C #35)
REF_FLAGS = ["-DIORING_OFF_PBUF_RING=0x80000000ULL", "-include", "vector"]
# the three files the port changes, each change commented in place
CHANGED = {"ring_listener.h", "ring_listener.cpp", "iobuf.cpp",
           "nat_shm_lane.cpp"}
READY_S = 60
CALL_S = 20


def makefile_list(var: str):
    mk = (REPO / "native" / "Makefile").read_text()
    return [p.split("/")[-1] for p in
            re.search(rf"^{var} = (.*)$", mk, re.M).group(1).split()]


def ref_library() -> Path:
    return build.build_library(REF_SRC, makefile_list("SRCS"),
                               build.BUILD_ROOT / "ref_native", REF_FLAGS,
                               "libbrpc_tpu_native.so")


def exported_nat_symbols(lib: Path) -> set:
    out = subprocess.run(["nm", "-D", "--defined-only", str(lib)],
                         capture_output=True, text=True, check=True).stdout
    return {line.split()[-1] for line in out.splitlines()
            if line.split() and line.split()[-1].startswith("nat_")}


# -- children -------------------------------------------------------------------

# A server of either package: TensorStore, an Echo and a Control service
# whose JSON ops read and change the process. argv: package, options.
PEER = r"""
import gc, json, os, signal, sys, threading, time
sys.path.insert(0, os.environ["REPO"])
pkg, opts = sys.argv[1], json.loads(sys.argv[2])
if pkg == "port":
    from brpc_tpu_torch import native, rpc
    from brpc_tpu_torch.rpc import device_transport as dt, tensor_service as ts
    from brpc_tpu_torch.rpc.proto import wire as msgs
    base = dict(device="cpu")
else:
    from brpc_tpu import native, rpc
    from brpc_tpu.rpc import device_transport as dt, tensor_service as ts
    from brpc_tpu.rpc.proto import echo_pb2 as msgs
    base = dict(num_threads=4)
    from brpc_tpu.bthread import get_task_control
    get_task_control()
if opts.pop("redis", False):
    base["redis_service"] = __import__(
        rpc.__name__ + ".redis", fromlist=["x"]).DictRedisService()

class Echo(rpc.Service):
    SERVICE_NAME = "EchoService"
    @rpc.rpc_method(msgs.EchoRequest, msgs.EchoResponse)
    def Echo(self, cntl, request, response, done):
        response.message = request.message
        done()

store = ts.TensorStoreService()
srv = rpc.Server(rpc.ServerOptions(**base, **opts))

class Control(rpc.Service):
    SERVICE_NAME = "Control"
    @rpc.rpc_method(msgs.EchoRequest, msgs.EchoResponse)
    def Op(self, cntl, request, response, done):
        op = json.loads(request.message)
        out = {}
        if op["op"] == "state":
            gc.collect()
            out["lanes"] = dt.lane_counters()
            if pkg == "port":
                out["fabric"] = dt.fabric_state()
                if native.available():
                    out["spans"] = native.res_live_bytes("shm.span")
            mount = getattr(srv, "_native_mount", None)
            out["workers"] = (mount.shm_worker_pids()
                              if hasattr(mount, "shm_worker_pids") else [])
        elif op["op"] == "drop":
            store._store.clear()
            gc.collect()
        elif op["op"] == "push_workers":
            rng = __import__("numpy").random.default_rng(op["seed"])
            for i, n in enumerate(op["sizes"]):
                data = rng.integers(0, 256, n, dtype="uint8").tobytes()
                assert native.shm_push_tensor(data, op["tag"] + i) == 0
        elif op["op"] == "kill_worker":
            os.kill(op["pid"], signal.SIGKILL)
            srv._native_mount._shm_workers[0].wait(10)
        elif op["op"] == "replace_workers":
            out["replaced"] = srv._native_mount.replace_dead_workers()
        elif op["op"] == "stop":
            threading.Thread(target=srv.stop, daemon=True).start()
        response.message = json.dumps(out)
        done()

for svc in (store, Echo(), Control()):
    assert srv.add_service(svc) == 0
if srv.start("127.0.0.1:0") != 0:
    print("start failed", flush=True)
    sys.exit(3)
print("ready", srv.listen_endpoint.port, flush=True)
quit_ = threading.Event()
threading.Thread(target=lambda: (sys.stdin.readline(), quit_.set()),
                 daemon=True).start()
while srv.is_running and not quit_.wait(0.05):
    pass
srv.stop()
print("stopped", flush=True)
"""


def child_env(ref_native: bool = False, **extra) -> dict:
    env = dict(os.environ, REPO=str(REPO), JAX_PLATFORMS="cpu",
               PYTHONPATH=str(REPO))
    env.pop("BRPC_TPU_NATIVE_SO", None)
    if ref_native:
        env["BRPC_TPU_NATIVE_SO"] = str(ref_library())
    env.update(extra)
    return env


class Peer:
    """A PEER child: ``port`` when it is serving; ``close`` stops it and
    returns its exit code."""

    def __init__(self, pkg: str, env: dict, **opts):
        self.proc = subprocess.Popen(
            [sys.executable, "-c", PEER, pkg, json.dumps(opts)],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
            env=env, cwd=str(REPO))
        line = _readline(self.proc, READY_S)
        if not line.startswith("ready "):
            self.close()
            raise RuntimeError(f"{pkg} peer did not start: {line!r}")
        self.port = int(line.split()[1])
        self.endpoint = f"127.0.0.1:{self.port}"

    def control(self, op: str, **kw) -> dict:
        ch = rpc.Channel()
        assert ch.init(self.endpoint) == 0
        try:
            cntl = Controller()
            cntl.timeout_ms = CALL_S * 1000
            resp = wire.EchoResponse()
            ch.call_method("Control.Op", cntl,
                           wire.EchoRequest(message=json.dumps(
                               {"op": op, **kw})), resp)
            assert not cntl.failed(), cntl.error_text
            return json.loads(resp.message)
        finally:
            ch.close()

    def close(self) -> int:
        try:
            self.proc.stdin.close()
        except OSError:
            pass
        try:
            code = self.proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            code = self.proc.wait()
        # the reference never unlinks its fabric's segment (the port does
        # at exit): remove what this child left
        for name in os.listdir("/dev/shm"):
            if name.startswith(f"brpc_tpu_lane_{self.proc.pid}_"):
                os.unlink(os.path.join("/dev/shm", name))
        return code


def _readline(proc, timeout_s: float) -> str:
    out = []
    t = threading.Thread(target=lambda: out.append(proc.stdout.readline()),
                         daemon=True)
    t.start()
    t.join(timeout_s)
    return out[0] if out else ""


def run_child(script: str, env: dict, *args, timeout_s: float = 120) -> dict:
    """Run a script in a child; its last stdout line is a JSON object."""
    r = subprocess.run([sys.executable, "-c", script, *args],
                       capture_output=True,
                       text=True, env=env, cwd=str(REPO), timeout=timeout_s)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


# -- the build ------------------------------------------------------------------

def test_library_builds_from_the_ports_sources_alone():
    lib = build.build_library()
    assert lib.parent.parent == build.BUILD_ROOT / "native"
    port = sorted(p.name for p in build.SOURCE_DIR.glob("*.cpp"))
    headers = sorted(p.name for p in build.SOURCE_DIR.glob("*.h"))
    assert port == sorted(makefile_list("SRCS"))
    assert headers == sorted(makefile_list("HDRS"))
    assert (len(port), len(headers)) == (30, 19)
    # the sources are the reference's, but for the three commented changes
    differ = {n for n in port + headers
              if (build.SOURCE_DIR / n).read_bytes()
              != (REF_SRC / n).read_bytes()}
    assert differ == CHANGED
    assert "/brpc_tpu_torch_lane_" in (
        build.SOURCE_DIR / "nat_shm_lane.cpp").read_text()


def test_exported_symbols_equal_the_references():
    port = exported_nat_symbols(build.build_library())
    ref = exported_nat_symbols(ref_library())
    assert len(port) > 150
    assert port == ref


BROKEN = r"""
import json, os, socket, sys
sys.path.insert(0, os.environ["REPO"])
from brpc_tpu.rpc import device_transport as ref_dt
from brpc_tpu_torch import native, rpc
from brpc_tpu_torch.rpc import device_transport as dt, tensor_service as ts
# the reference, its library missing: it advertises no fabric, quietly
out = {"ref_fabric": ref_dt._fabric_arm_receiver()}
try:
    info = dt.local_device_info("cpu", arm_fabric=True)
    out["fabric"] = info["fabric"]
except native.NativeUnavailable as e:
    out["raised"] = "native build failed" in str(e)

def start(services, **opts):
    # (start's result, whether anything listens on the port)
    srv = rpc.Server(rpc.ServerOptions(device="cpu", **opts))
    for svc in services:
        assert srv.add_service(svc) == 0
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    try:
        rc = srv.start(f"127.0.0.1:{port}")
    except native.NativeUnavailable:
        rc = "raised"
    try:
        socket.create_connection(("127.0.0.1", port), timeout=2).close()
        listening = True
    except OSError:
        listening = False
    srv.stop()
    return [rc, listening]

out["store"] = start([ts.TensorStoreService()])
out["plain"] = start([])
out["native"] = start([], use_native_runtime=True)
print(json.dumps(out))
"""


@pytest.mark.parametrize("fabric", ["1", "0"])
def test_a_broken_compiler_raises_unless_the_fabric_is_off(fabric):
    out = run_child(BROKEN, child_env(CXX="/nonexistent/g++",
                                      BRPC_TPU_FABRIC=fabric,
                                      BRPC_TPU_NATIVE_SO="/nonexistent.so"))
    assert out["ref_fabric"] == ""
    if fabric == "1":
        # queue C #36, kept: the handshake's identity and a TensorStore
        # server's start raise where the reference advertises no fabric
        assert out.get("raised") is True and out["store"] == ["raised", False], out
    else:
        assert out.get("fabric") == "" and out["store"] == [0, True], out
    # a server without a TensorStore needs no native library
    assert out["plain"] == [0, True], out
    # the native runtime's mount fails: -1, and no Python listener serves
    # in its place
    assert out["native"] == [-1, False], out


# argv: package. A device channel's handshake with a server without and
# then with a TensorStore service: the fabric each advertised.
ARMS = r"""
import json, os, sys
sys.path.insert(0, os.environ["REPO"])
if sys.argv[1] == "port":
    from brpc_tpu_torch import native, rpc
    from brpc_tpu_torch.rpc import tensor_service as ts
    from brpc_tpu_torch.rpc.socket import Socket
    opts = dict(device="cpu")
else:
    from brpc_tpu import native, rpc
    from brpc_tpu.bthread import get_task_control
    from brpc_tpu.rpc import tensor_service as ts
    from brpc_tpu.rpc.socket import Socket
    get_task_control()
    opts = {}
out = {}
for name, services in (("plain", []), ("store", [ts.TensorStoreService()])):
    srv = rpc.Server(rpc.ServerOptions(**opts))
    for svc in services:
        assert srv.add_service(svc) == 0
    assert srv.start("127.0.0.1:0") == 0
    ch = ts.make_device_channel(str(srv.listen_endpoint),
                                rpc.ChannelOptions(**opts))
    ts.TensorClient(ch).pull("none")  # the handshake, then any answer
    info = Socket.address(ch._single_sid).app_state.peer_info
    out[name] = {"fabric": bool(info["fabric"]),
                 "loaded": native._lib is not None}
    ch.close()
    srv.stop()
out["pid"] = os.getpid()
print(json.dumps(out))
"""


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_only_a_tensor_store_server_arms_the_fabric(pkg):
    """Queue C #37: the reference arms the fabric in every server's
    handshake; the port only on a server with a TensorStore service, and
    another server loads no native library."""
    out = run_child(ARMS, child_env(ref_native=pkg == "ref"), pkg)
    # the reference never unlinks its fabric's segment
    for name in os.listdir("/dev/shm"):
        if name.startswith(f"brpc_tpu_lane_{out['pid']}_"):
            os.unlink(os.path.join("/dev/shm", name))
    assert out["store"] == {"fabric": True, "loaded": True}, out
    if pkg == "port":
        assert out["plain"] == {"fabric": False, "loaded": False}, out
    else:
        assert out["plain"] == {"fabric": True, "loaded": True}, out


def _syntax_check(src: Path, *flags) -> subprocess.CompletedProcess:
    return subprocess.run([build.compiler(), *build.CXXFLAGS, *flags,
                           "-fsyntax-only", str(src)],
                          capture_output=True, text=True, timeout=120)


def _header_has_pbuf_structs_without_the_probe() -> bool:
    h = Path("/usr/include/linux/io_uring.h")
    text = h.read_text() if h.exists() else ""
    return "struct io_uring_buf {" in text and "IORING_OFF_PBUF_RING" not in text


@pytest.mark.parametrize("fault", ["34-pbuf-ring", "35-vector"])
def test_reference_build_faults_the_port_does_not_copy(fault):
    """Queue C #34 and #35: the reference's file fails here as it is, the
    port's copy compiles. Where the host's headers or compiler do not show
    the fault, the reference's file compiles too."""
    name = "ring_listener.cpp" if fault.startswith("34") else "iobuf.cpp"
    ref = _syntax_check(REF_SRC / name)
    port = _syntax_check(build.SOURCE_DIR / name)
    assert port.returncode == 0, port.stderr[-2000:]
    if fault.startswith("34"):
        if _header_has_pbuf_structs_without_the_probe():
            assert ref.returncode != 0
            assert "redefinition of 'struct io_uring_buf'" in ref.stderr \
                or "redefinition of \u2018struct io_uring_buf\u2019" in ref.stderr
    elif ref.returncode != 0:
        assert "vector" in ref.stderr
    fixed = _syntax_check(REF_SRC / name, *REF_FLAGS)
    assert fixed.returncode == 0, fixed.stderr[-2000:]


# -- the native server against the reference's -----------------------------------

@pytest.fixture(scope="module")
def native_pair():
    """A port and a reference use_native_runtime server, each in a child."""
    get_task_control()
    peers = {}
    try:
        peers["port"] = Peer("port", child_env(), use_native_runtime=True,
                             redis=True, native_redis_store=True)
        peers["ref"] = Peer("ref", child_env(ref_native=True,
                                             BRPC_TPU_FABRIC="0"),
                            use_native_runtime=True, redis=True,
                            native_redis_store=True)
        yield peers
    finally:
        codes = [p.close() for p in peers.values()]
        assert codes == [0] * len(peers)


def _frame(service: str, method: str, cid: int, payload: bytes,
           tensors=(), attachment: bytes = b"") -> bytes:
    meta = wire.RpcMeta()
    meta.request.service_name = service
    meta.request.method_name = method
    meta.correlation_id = cid
    for dtype, shape, spec in tensors:
        t = meta.tensors.add()
        t.dtype = dtype
        t.shape.extend(shape)
        t.nbytes = len(attachment)
        t.sharding_spec = spec
    meta.attachment_size = len(attachment)
    mb = meta.SerializeToString()
    return (b"TRPC" + struct.pack(">II", len(mb) + len(payload)
                                  + len(attachment), len(mb))
            + mb + payload + attachment)


def _read_frame(s: socket.socket) -> bytes:
    def exact(n):
        buf = b""
        while len(buf) < n:
            chunk = s.recv(n - len(buf))
            assert chunk, "the server closed the connection"
            buf += chunk
        return buf

    head = exact(12)
    assert head[:4] == b"TRPC", head
    return head + exact(struct.unpack(">I", head[4:8])[0])


def _seeded_calls(seed: int):
    rng = np.random.default_rng(seed)
    calls = []
    for i in range(6):
        text = "".join(chr(c) for c in rng.integers(97, 123, int(
            rng.integers(0, 40))))
        calls.append(("EchoService", "Echo",
                      wire.EchoRequest(message=text).SerializeToString(),
                      (), b""))
    calls.append(("NoSuchService", "Echo", b"", (), b""))
    calls.append(("EchoService", "NoSuchMethod", b"", (), b""))
    x = rng.standard_normal(256).astype(np.float32)
    calls.append(("TensorStore", "Push",
                  wire.TensorPushRequest(name="t").SerializeToString(),
                  (("float32", [16, 16], "wire::7"),), x.tobytes()))
    calls.append(("TensorStore", "Pull",
                  wire.TensorPullRequest(name="t").SerializeToString(),
                  (), b""))
    calls.append(("TensorStore", "Pull",
                  wire.TensorPullRequest(name="none").SerializeToString(),
                  (), b""))
    calls.append(("TensorStore", "Ack",
                  wire.TensorAckRequest(seq=1).SerializeToString(), (), b""))
    return calls


def test_response_bytes_equal_the_reference_native_servers(native_pair):
    answers = {}
    for pkg, peer in native_pair.items():
        got = []
        with socket.create_connection(("127.0.0.1", peer.port),
                                      timeout=CALL_S) as s:
            for cid, (svc, m, payload, tensors, att) in enumerate(
                    _seeded_calls(15), start=1):
                s.sendall(_frame(svc, m, cid, payload, tensors, att))
                got.append(_read_frame(s))
        answers[pkg] = got
    assert len(answers["port"]) == len(_seeded_calls(15))
    for i, (p, r) in enumerate(zip(answers["port"], answers["ref"])):
        assert p == r, (i, p[:200], r[:200])
    meta = wire.RpcMeta()
    body = answers["port"][6][12:]
    meta.ParseFromString(body[:struct.unpack(">I", answers["port"][6][8:12])[0]])
    assert meta.response.error_code != 0  # the unknown service was refused


def _resp_command(*args) -> bytes:
    out = b"*%d\r\n" % len(args)
    for a in args:
        a = a.encode() if isinstance(a, str) else a
        out += b"$%d\r\n%s\r\n" % (len(a), a)
    return out


def _read_resp(f) -> bytes:
    """One RESP reply off a socket file, as its raw bytes."""
    line = f.readline()
    assert line.endswith(b"\r\n"), line
    if line[:1] == b"$" and int(line[1:]) >= 0:
        return line + f.read(int(line[1:]) + 2)
    if line[:1] == b"*":
        return line + b"".join(_read_resp(f) for _ in range(int(line[1:])))
    return line


def _seeded_redis(seed: int):
    """The native store's command family (GET/SET, counters, MGET/MSET,
    APPEND, STRLEN, DBSIZE, any case), its errors, and commands it hands
    to the Python RedisService (SET with options, an unknown command)."""
    rng = np.random.default_rng(seed)
    val = lambda: "".join(chr(c) for c in rng.integers(97, 123, int(
        rng.integers(1, 30))))
    keys = [f"k{i}" for i in range(4)]
    calls = [("PING",), ("ECHO", val()), ("SELECT", "0")]
    for k in keys:
        calls += [("SET", k, val()), ("get", k)]
    calls += [("GET", "missing"), ("GET",), ("INCR", "n"), ("incr", "n"),
              ("INCRBY", "n", str(int(rng.integers(1, 100)))),
              ("DECR", "n"), ("DECRBY", "n", "3"), ("INCR", keys[0]),
              ("INCRBY", "n", "x"), ("APPEND", keys[1], val()),
              ("STRLEN", keys[1]), ("MSET", "a", val(), "b", val()),
              ("MGET", "a", "missing", "b", keys[2]),
              ("EXISTS", "a", "b", "missing"), ("DEL", "a", "missing"),
              ("UNLINK", "b"), ("DBSIZE",), ("sEt", keys[3], val()),
              ("GeT", keys[3]), ("SET", "opt", val(), "EX", "10"),
              ("HSET", "h", "f", val()), ("FLUSHDB",), ("DBSIZE",)]
    return calls


def test_native_redis_store_replies_equal_the_reference(native_pair):
    calls = _seeded_redis(15)
    answers = {}
    for pkg, peer in native_pair.items():
        with socket.create_connection(("127.0.0.1", peer.port),
                                      timeout=CALL_S) as s:
            f = s.makefile("rb")
            got = []
            for args in calls:
                s.sendall(_resp_command(*args))
                got.append(_read_resp(f))
        answers[pkg] = got
    for args, p, r in zip(calls, answers["port"], answers["ref"]):
        assert p == r, (args, p, r)
    by_command = dict(zip((c[0] for c in calls), answers["port"]))
    # the native store served: the Python DictRedisService has no
    # DBSIZE, MGET or STRLEN
    assert by_command["DBSIZE"] == b":0\r\n"
    assert by_command["MGET"].startswith(b"*4\r\n")
    assert by_command["STRLEN"].startswith(b":")
    # and the Python lane answered what the store hands over
    assert by_command["HSET"].startswith(b"-ERR unknown command")


RING_PUSH = r"""
import json, os, sys, torch
sys.path.insert(0, os.environ["REPO"])
from brpc_tpu_torch import rpc
from brpc_tpu_torch.rpc import device_transport as dt, tensor_service as ts
x = torch.arange(4096, dtype=torch.float32).reshape(64, 64)
ch = ts.make_device_channel(sys.argv[1], rpc.ChannelOptions(device="cpu"))
client = ts.TensorClient(ch)
cntl, resp = client.push("p", [x])
pc, got = client.pull("p")
print(json.dumps({"ok": not cntl.failed() and resp.ok and not pc.failed()
                  and torch.equal(got[0], x),
                  "attachment": len(cntl.request_attachment),
                  "lanes": dt.lane_counters()}))
"""


def test_tensor_store_from_port_and_reference_clients(native_pair):
    peer = native_pair["port"]
    x = torch.arange(4096, dtype=torch.float32).reshape(64, 64)
    # a port device channel in a process of its own (a process pushes by
    # ring to one segment): the ring lane into the native server's arena
    out = run_child(RING_PUSH, child_env(), peer.endpoint)
    assert out["ok"] and out["attachment"] == 0, out
    assert out["lanes"]["ring"] == 1, out
    assert out["lanes"]["wire"] == 0 and out["lanes"]["shm"] == 0, out
    # a reference client over a plain channel: the wire lane
    rch = ref_rpc.Channel()
    assert rch.init(peer.endpoint) == 0
    try:
        rclient = ref_ts.TensorClient(rch)
        cntl, resp = rclient.push("r", [x.numpy()])
        assert not cntl.failed() and resp.ok, cntl.error_text
        pc, got = rclient.pull("r")
        assert not pc.failed() and np.array_equal(got[0], x.numpy())
        pc, got = rclient.pull("p")  # what the port pushed by ring
        assert not pc.failed() and np.array_equal(got[0], x.numpy())
    finally:
        rch.close()
    peer.control("drop")
    state = peer.control("state")
    assert state["fabric"]["held_records"] == 0, state
    assert state["fabric"]["live_leases"] == 0, state
    assert state["spans"] == 0, state


# -- usercode workers -------------------------------------------------------------

def _grpc(endpoint: str, method: str, message: str):
    ch = rpc.Channel(rpc.ChannelOptions(protocol="h2:grpc"))
    assert ch.init(endpoint) == 0
    try:
        cntl = Controller()
        cntl.timeout_ms = CALL_S * 1000
        resp = wire.EchoResponse()
        ch.call_method(method, cntl, wire.EchoRequest(message=message), resp)
        return cntl, resp
    finally:
        ch.close()


def _worker_states(endpoint: str, pids, tries: int = 40) -> dict:
    """WorkerSink.State of every worker in ``pids`` (calls land on some
    worker each, so ask until each answered)."""
    out = {}
    for _ in range(tries):
        cntl, resp = _grpc(endpoint, "WorkerSink.State", "")
        if not cntl.failed():
            st = json.loads(resp.message)
            out[st["pid"]] = st
        if set(pids) <= set(out):
            break
    return out


def test_py_workers_land_tensor_records_and_survive_a_kill():
    peer = Peer("port", child_env(), use_native_runtime=True, py_workers=2,
                py_worker_factory="brpc_tpu_torch.rpc.shm_worker:"
                                  "cpu_landing_services")
    try:
        pids = peer.control("state")["workers"]
        assert len(pids) == 2 and peer.proc.pid not in pids
        # HTTP and gRPC run in the workers
        body = urllib.request.urlopen(urllib.request.Request(
            f"http://{peer.endpoint}/EchoService/Echo",
            data=b'{"message": "h"}',
            headers={"Content-Type": "application/json"}),
            timeout=CALL_S).read()
        assert json.loads(body)["message"].split("@")[1] in map(str, pids)
        cntl, resp = _grpc(peer.endpoint, "EchoService.Echo", "g")
        assert not cntl.failed(), cntl.error_text
        assert int(resp.message.split("@")[1]) in pids
        # kind-8 records land in the workers' sinks, checksums equal
        sizes = [8 << 10, 1 << 20, 3]
        peer.control("push_workers", seed=5, sizes=sizes, tag=100)
        rng = np.random.default_rng(5)
        want = {}
        for i, n in enumerate(sizes):
            data = torch.from_numpy(rng.integers(0, 256, n, dtype=np.uint8))
            from brpc_tpu_torch.rpc.shm_worker import checksum

            want[str(100 + i)] = [n, "cpu"] + checksum(data)
        deadline = time.monotonic() + CALL_S
        while True:
            states = _worker_states(peer.endpoint, pids)
            landed = {}
            for st in states.values():
                landed.update(st["landed"])
                assert st["drops"] == 0
            if landed == want or time.monotonic() > deadline:
                break
            time.sleep(0.1)
        assert landed == want
        # one worker killed, the lane recovers, a replacement attaches
        peer.control("kill_worker", pid=pids[0])
        assert peer.control("replace_workers")["replaced"] == 1
        now = peer.control("state")["workers"]
        assert len(now) == 2 and pids[0] not in now
        ok = 0
        for _ in range(20):
            cntl, resp = _grpc(peer.endpoint, "EchoService.Echo", "after")
            ok += (not cntl.failed()) and resp.message.startswith("after@")
        assert ok >= 18
        assert set(_worker_states(peer.endpoint, now)) == set(now)
    finally:
        assert peer.close() == 0
    left = [n for n in os.listdir("/dev/shm")
            if n.startswith(f"brpc_tpu_torch_lane_{peer.proc.pid}_")]
    assert left == []


# -- a graceful stop under load ---------------------------------------------------

def test_graceful_stop_under_load():
    peer = Peer("port", child_env(), use_native_runtime=True,
                graceful_shutdown_timeout_ms=3000)
    x = torch.arange(1 << 16, dtype=torch.float32)
    codes = []
    go = threading.Event()

    def pusher(k):
        ch = rpc.Channel()
        assert ch.init(peer.endpoint) == 0
        client = ts.TensorClient(ch)
        go.wait(10)
        try:
            for _ in range(10000):
                cntl, _ = client.push(f"k{k}", [x], timeout_ms=5000)
                codes.append(cntl.error_code)
                if cntl.failed():
                    break
        finally:
            ch.close()

    threads = [threading.Thread(target=pusher, args=(k,)) for k in range(16)]
    for t in threads:
        t.start()
    try:
        go.set()
        end = time.monotonic() + 30
        while codes.count(0) < 32 and time.monotonic() < end:
            time.sleep(0.01)  # the pushers under way before the stop
        peer.control("stop")
        for t in threads:
            t.join(30)
        assert not any(t.is_alive() for t in threads)
    finally:
        code = peer.close()
    assert code == 0
    assert codes.count(0) >= 32
    # every call answered OK, or refused the way the reference refuses:
    # ELIMIT while draining, a closed or failed connection after
    allowed = {0, 2004, 1009, 2005, 104, 32, 111}
    assert set(codes) <= allowed, set(codes)
    assert [n for n in os.listdir("/dev/shm")
            if n.startswith(f"brpc_tpu_torch_lane_{peer.proc.pid}_")] == []


# -- the native cluster, combo native=True and the host axis ------------------------

REF_CLUSTER = r"""
import json, os, sys
sys.path.insert(0, os.environ["REPO"])
from brpc_tpu.rpc.native_cluster import NativeCluster
from brpc_tpu.rpc.proto import echo_pb2
nodes, n = json.loads(sys.argv[1]), {}
payload = echo_pb2.EchoRequest(message="fan").SerializeToString()
with NativeCluster(lb="rr", connect_timeout_ms=2000) as c:
    c.update([tuple(x) for x in nodes])
    out = {"count": c.backend_count()}
    out["parallel"] = [x.hex() if isinstance(x, bytes) else x
                       for x in c.parallel_call("EchoService.Echo", payload,
                                                timeout_ms=5000)]
    out["partition"] = [x.hex() if isinstance(x, bytes) else x
                        for x in c.partition_call("EchoService.Echo", payload,
                                                  timeout_ms=5000,
                                                  partitions=2)]
    out["select"] = sorted(c.call("EchoService.Echo", payload,
                                  timeout_ms=5000)[1].hex()
                           for _ in range(4))
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def tagged_servers():
    """Two port servers (Python listeners) whose Echo answers its name."""
    from brpc_tpu_torch.rpc.service import Service, rpc_method

    def echo(name):
        class Tagged(Service):
            SERVICE_NAME = "EchoService"

            @rpc_method(wire.EchoRequest, wire.EchoResponse)
            def Echo(self, cntl, request, response, done):
                response.message = f"{request.message}:{name}"
                done()

        return Tagged()

    out = []
    try:
        for i in range(2):
            srv = rpc.Server(rpc.ServerOptions(device="cpu"))
            assert srv.add_service(echo(f"n{i}")) == 0
            assert srv.start("127.0.0.1:0") == 0
            out.append(srv)
        yield out
    finally:
        for srv in out:
            srv.stop()


def test_native_cluster_combo_and_host_axis_equal_the_references(tagged_servers):
    from brpc_tpu_torch.parallel.mesh_channel import MeshChannel
    from brpc_tpu_torch.rpc.native_cluster import NativeCluster

    nodes = [(str(s.listen_endpoint), 1, f"{i}/2")
             for i, s in enumerate(tagged_servers)]
    url = "list://" + ",".join(f"{ep} {tag}" for ep, _, tag in nodes)
    req = wire.EchoRequest(message="fan")
    ref = run_child(REF_CLUSTER, child_env(ref_native=True),
                    json.dumps(nodes), timeout_s=60)
    assert ref["count"] == 2
    with NativeCluster(lb="rr", connect_timeout_ms=2000) as c:
        c.update(nodes)
        mine = {"count": c.backend_count()}
        mine["parallel"] = [x.hex() if isinstance(x, bytes) else x for x in
                            c.parallel_call("EchoService.Echo",
                                            req.SerializeToString(),
                                            timeout_ms=5000)]
        mine["partition"] = [x.hex() if isinstance(x, bytes) else x for x in
                             c.partition_call("EchoService.Echo",
                                              req.SerializeToString(),
                                              timeout_ms=5000, partitions=2)]
        mine["select"] = sorted(c.call("EchoService.Echo",
                                       req.SerializeToString(),
                                       timeout_ms=5000)[1].hex()
                                for _ in range(4))
    assert mine == ref
    # the combo channels: native=True parses the reference's merged body;
    # the Python path's sub-responses, in channel order, are that body
    for cls, verb, native_init, python_init in (
            # the native cluster keeps its backends in endpoint order
            (rpc.ParallelChannel, "parallel", lambda ch: ch.init(url, "rr"),
             lambda ch, mergers: [ch.add_channel(_plain(s), None, m)
                                  for s, m in zip(sorted(
                                      tagged_servers,
                                      key=lambda s: str(s.listen_endpoint)),
                                      mergers)]),
            (rpc.PartitionChannel, "partition",
             lambda ch: ch.init(2, url, "rr"),
             lambda ch, mergers: ch.init(2, url, "rr"))):
        body = ref[verb][1]
        expect = wire.EchoResponse()
        expect.ParseFromString(bytes.fromhex(body))
        ch = cls(native=True)
        native_init(ch)
        try:
            cntl, resp = ch.call("EchoService.Echo", req, wire.EchoResponse,
                                 timeout_ms=5000)
            assert not cntl.failed(), cntl.error_text
            assert resp.SerializeToString() == expect.SerializeToString()
        finally:
            ch.stop()
        mergers = [_Keep(), _Keep()]
        ch = cls()
        python_init(ch, mergers)
        if cls is rpc.PartitionChannel:  # its sub-channels, in partition order
            ch._subs = [(c, None, m) for (c, _, _), m in zip(ch._subs, mergers)]
        try:
            cntl, resp = ch.call("EchoService.Echo", req, wire.EchoResponse,
                                 timeout_ms=5000)
            assert not cntl.failed(), cntl.error_text
            assert b"".join(m.body for m in mergers).hex() == body
        finally:
            ch.stop()
    # the host axis of a world-1 mesh
    import torch.distributed as dist

    from brpc_tpu_torch.parallel.world import RankMesh
    from brpc_tpu_torch.tensor.config import MeshSpec

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        free = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{free}",
                            world_size=1, rank=0)
    try:
        with NativeCluster(lb="rr", connect_timeout_ms=2000) as c:
            c.update(nodes)
            mc = MeshChannel(RankMesh(MeshSpec()), "dp").attach_host_cluster(c)
            rc, body, err, failed = mc.host_parallel_call(
                "EchoService.Echo", req.SerializeToString(), timeout_ms=5000)
        assert (rc, failed) == (0, 0) and body.hex() == ref["parallel"][1]
    finally:
        dist.destroy_process_group()


class _Keep(rpc.ResponseMerger):
    """Keeps its sub-channel's response bytes."""

    body = b""

    def merge(self, main_response, sub_response) -> int:
        self.body = sub_response.SerializeToString()
        return super().merge(main_response, sub_response)


def _plain(srv) -> rpc.Channel:
    ch = rpc.Channel()
    assert ch.init(str(srv.listen_endpoint)) == 0
    return ch
