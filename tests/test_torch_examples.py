"""The port's examples held against the reference's, on the CPU.

Host examples: each of the reference's scripts (``examples/<name>.py``)
runs in this process through ``runpy`` with ``sys.argv`` set and its
output captured, then the port's twin (``brpc_tpu_torch.examples.<name>``)
with the same arguments and ``--device cpu``; both exit 0 and print the
same lines once numbers, span ids and the package's name are masked.
Where the reference picks at random or threads race (the partition hits,
the order of two "stream closed" lines, the spans), sets are compared.

Device examples: the reference's ``tensor_transport.py`` and
``device_performance.py`` are not run here (their jax and native halves
would start the native build); the port's twins are held to the
reference's line formats, read from its print calls' f-strings, and to
the bytes and lanes they move. Their mesh halves run in one 2-rank gloo
world, started when the module starts, against the reference's
``MeshChannel.parallel_call`` and ``ici_bandwidth_probe`` on a 2-device
mesh. One server subprocess (tensor_transport's cross-process half).
"""
import ast
import contextlib
import io
import os
import re
import runpy
import sys
import threading

import numpy as np
import pytest
import torch

from brpc_tpu import native as ref_native
from brpc_tpu import parallel as ref_parallel
from brpc_tpu.bthread import get_task_control
from brpc_tpu.bvar import native_vars as ref_native_vars
from brpc_tpu.rpc.proto import echo_pb2
from brpc_tpu import rpc as ref_rpc
from brpc_tpu_torch import native as port_native
from brpc_tpu_torch import parallel, rpc
from brpc_tpu_torch.examples import (
    device_performance,
    parallel_echo,
    tensor_transport,
)
from brpc_tpu_torch.rpc import device_transport as dt
from brpc_tpu_torch.rpc.proto import wire
from brpc_tpu_torch.rpc.tensor_service import TensorStoreService
import torch_spmd_ranks  # tests/ is on sys.path (rootdir insertion)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD_DEADLINE_S = 120.0


@pytest.fixture(scope="module", autouse=True)
def reference_without_native():
    """The reference's servers in this process: no native fabric, no
    native /status sections (they would build the native runtime)."""
    get_task_control()  # the bthread pool's first sizing sticks
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BRPC_TPU_FABRIC", "0")
        mp.setattr(ref_native_vars, "native_status_lines", lambda: [])
        mp.setattr(ref_native, "available", lambda: False)
        # and the port's pages show no native section, whether or not
        # an earlier test of this process loaded the port's library
        mp.setattr(port_native, "is_loaded", lambda: False)
        mp.chdir(REPO)  # the reference's scripts put "." on sys.path
        yield


@pytest.fixture(scope="module")
def mesh_world():
    """The mesh halves' one 2-rank world, run in a thread from the first
    test that asks, while the host examples run."""
    out = {}

    def run():
        try:
            out["ranks"] = parallel.run_ranks(
                torch_spmd_ranks.example_mesh_halves, 2, device="cpu",
                deadline_s=WORLD_DEADLINE_S)
        except Exception as e:  # raised by the tests that read it
            out["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()

    def result():
        t.join(WORLD_DEADLINE_S + 10)
        assert not t.is_alive(), "the mesh world did not end"
        if "error" in out:
            raise out["error"]
        return out["ranks"]

    return result


def _run_reference(name, args):
    buf = io.StringIO()
    code = 0
    with contextlib.redirect_stdout(buf), \
            pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", [f"examples/{name}.py", *args])
        try:
            runpy.run_path(os.path.join(REPO, "examples", f"{name}.py"),
                           run_name="__main__")
        except SystemExit as e:
            code = e.code or 0
    return code, buf.getvalue()


def _run_port(module, args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = module.main([*args, "--device", "cpu"])
    return code, buf.getvalue()


def _mask(text: str) -> str:
    text = text.replace("brpc_tpu_torch", "brpc_tpu")
    text = re.sub(r"\b[0-9a-f]{16}\b", "H", text)
    return re.sub(r"\d+(\.\d+)?", "N", text)


def _sorted_parts(line: str) -> str:
    """'hit: part2,part0,part1,' -> 'hit: part0,part1,part2,'."""
    head, sep, parts = line.rpartition(": ")
    return head + sep + ",".join(sorted(parts.strip(",").split(","))) + ","


def _lines(name: str, out: str):
    lines = out.splitlines()
    if name == "partition_echo":
        lines = [_sorted_parts(l) if "hit:" in l else l for l in lines]
    if name == "http_server":
        lines = lines[:-1]  # the /status page is cut at 400 characters
    if name == "backup_request":
        # which call is backed up: the rr phase differs between the
        # packages (ROADMAP queue C #19), and a loaded host adds backups
        lines = [re.sub(r"backup=\w+", "backup=?", l) for l in lines]
    lines = [_mask(l) for l in lines]
    if name in ("streaming_echo", "cascade_echo", "partition_echo"):
        # thread order: the two "closed" lines, spans, random picks
        return sorted(lines)
    return lines


HOST_EXAMPLES = [
    ("echo", ["demo"]),
    ("asynchronous_echo", []),
    ("multi_threaded_echo", ["--threads", "2", "--seconds", "0.1"]),
    ("streaming_echo", []),
    ("http_server", []),
    ("session_data", []),
    ("backup_request", []),
    ("auto_concurrency_limiter", []),
    ("cascade_echo", []),
    ("partition_echo", []),
    ("selective_echo", []),
    ("dynamic_partition_echo", []),
    ("grpc_echo", []),
]


@pytest.mark.parametrize("name,args", HOST_EXAMPLES,
                         ids=[n for n, _ in HOST_EXAMPLES])
def test_host_example_prints_the_references_lines(name, args, mesh_world):
    import importlib

    module = importlib.import_module(f"brpc_tpu_torch.examples.{name}")
    # one retry, as tests/test_examples.py gives the reference's: the
    # examples carry real deadlines (200-2000 ms), which a loaded host
    # can miss
    for attempt in (1, 2):
        ref_code, ref_out = _run_reference(name, args)
        code, out = _run_port(module, args)
        same = _lines(name, out) == _lines(name, ref_out)
        if ref_code == 0 and code == 0 and same:
            return
    assert ref_code == 0 and code == 0, (ref_out, out)
    assert same, (ref_out, out)


def test_backup_request_excludes_the_first_server():
    """ROADMAP queue C #19: the port's backup attempt excludes the server
    the first attempt waits on (brpc's accessed set); the reference's does
    not. Two servers that answer in 150 ms behind c_murmurhash (request
    code 0, so every pick without exclusion is the same server) and a
    20 ms backup: the reference sends both attempts to one server, the
    port one to each. Counted as the handlers start, whatever the load."""
    import time

    def service(mod, msgs, hits, i):
        class SlowEcho(mod.Service):
            SERVICE_NAME = "EchoService"

            @mod.rpc_method(msgs.EchoRequest, msgs.EchoResponse)
            def Echo(self, cntl, request, response, done):
                hits[i] += 1
                time.sleep(0.15)
                response.message = "slow"
                done()

        return SlowEcho()

    got = {}
    for key, mod, msgs, opts in (
            ("ref", ref_rpc, echo_pb2, ref_rpc.ServerOptions),
            ("port", rpc, wire, lambda: rpc.ServerOptions(device="cpu"))):
        hits, servers = [0, 0], []
        for i in range(2):
            srv = mod.Server(opts())
            assert srv.add_service(service(mod, msgs, hits, i)) == 0
            assert srv.start("127.0.0.1:0") == 0
            servers.append(srv)
        ch = mod.Channel(mod.ChannelOptions(backup_request_ms=20,
                                            max_retry=2))
        try:
            url = "list://" + ",".join(str(s.listen_endpoint) for s in servers)
            assert ch.init(url, "c_murmurhash") == 0
            cntl, resp = ch.call("EchoService.Echo",
                                 msgs.EchoRequest(message="x"),
                                 msgs.EchoResponse, timeout_ms=5000)
            assert not cntl.failed() and resp.message == "slow"
            assert cntl.has_backup_request
            end = time.monotonic() + 10  # both attempts' handlers started
            while sum(hits) < 2 and time.monotonic() < end:
                time.sleep(0.01)
            got[key] = sorted(hits)
        finally:
            ch.close()
            for srv in servers:
                srv.stop()
    assert got == {"ref": [0, 2], "port": [1, 1]}


def _reference_formats(name: str):
    """One regex per print call of examples/<name>.py, in source order:
    its literal text escaped, each replacement field any text."""
    tree = ast.parse(open(os.path.join(REPO, "examples", f"{name}.py")).read())
    out = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and getattr(node.func, "id", None) == "print"):
            continue
        parts = []
        for arg in node.args:
            if isinstance(arg, ast.Constant):
                parts.append(re.escape(str(arg.value)))
            elif isinstance(arg, ast.JoinedStr):
                parts.append("".join(
                    re.escape(v.value) if isinstance(v, ast.Constant)
                    else "(.+?)" for v in arg.values))
            else:
                parts.append("(.+?)")
        out.append((node.lineno, re.compile(" ".join(parts))))
    return [p for _, p in sorted(out, key=lambda x: x[0])]


def _hold_to_formats(name: str, out: str):
    """Every line the port printed matches the reference's print calls,
    in their order; returns the lines' fields."""
    formats = _reference_formats(name)
    fields, at = [], 0
    for line in out.splitlines():
        for i in range(at, len(formats)):
            m = formats[i].fullmatch(line)
            if m:
                fields.append(m.groups())
                at = i + 1
                break
        else:
            raise AssertionError(f"{name}: {line!r} matches none of the "
                                 f"reference's formats after #{at}")
    return fields


def _fake_run_ranks(ranks, n_want):
    by_fn = {"mesh_probe_rank": [r["probe"] for r in ranks],
             "mesh_fanout_rank": [r["merged"] for r in ranks]}

    def run_ranks(fn, n, args=(), device=None, deadline_s=None):
        assert n == n_want and str(device) == "cpu"
        return by_fn[fn.__name__]

    return run_ranks


def test_tensor_transport_twin(mesh_world, monkeypatch):
    """The reference's five lines, in order; the in-process lane and the
    shm lane across processes named as lane_counters() moved them; the
    tensor pulled back from the other process bit-equal."""
    pulled = {}
    across = tensor_transport.across_processes

    def across_and_pull(client, arr, mb, iters):
        arr = torch.from_numpy(np.random.default_rng(7).integers(
            0, 255, arr.numel() * 4, dtype=np.uint8)).view(torch.float32)
        run = across(client, arr, mb, iters)
        cntl, got = client.pull("x0")
        pulled["equal"] = got is not None and torch.equal(
            got[0].view(torch.uint8), arr.view(torch.uint8))
        return run

    monkeypatch.setattr(tensor_transport, "across_processes", across_and_pull)
    monkeypatch.setattr(parallel, "run_ranks", _fake_run_ranks(mesh_world(), 2))
    lanes0 = dt.lane_counters()
    code, out = _run_port(tensor_transport,
                          ["--mb", "1", "--iters", "2", "--ranks", "2"])
    lanes1 = dt.lane_counters()
    assert code == 0
    fields = _hold_to_formats("tensor_transport", out)
    assert len(fields) == 5, out
    assert fields[0] == ("2", "True")  # ESTABLISHED, same process
    assert fields[3][4:] == ("shm", "True", "False")
    assert fields[4][0] == "2"
    moved = {k: lanes1[k] - lanes0[k] for k in lanes1}
    # warm + 2 pushes each way (the pulls go back from the servers)
    assert moved == {"inproc": 4, "ring": 0, "shm": 3, "wire": 0, "xfer": 0}
    assert pulled["equal"]


def test_device_performance_twin(monkeypatch):
    """The reference's lines with its native half refused; the lane
    named is the one that moved; the pushers store the reference's bytes
    bit for bit. The native half runs in tests/test_torch_native_client.py
    (a native server per process); here it is refused."""
    def refuse(*args, **kw):
        raise port_native.NativeUnavailable("refused by the test")

    monkeypatch.setattr(port_native, "rpc_server_start", refuse)
    code, out = _run_port(device_performance,
                          ["--threads", "2", "--mb", "1", "--iters", "3"])
    assert code == 0
    fields = _hold_to_formats("device_performance", out)
    assert [f[:3] for f in fields[:1]] == [("inproc", "6", "0")]
    assert out.splitlines()[-1] == ("native bulk lane unavailable: refused "
                                    "by the test")
    want = np.random.default_rng(0).standard_normal(
        (1024 * 1024) // 8).astype(np.float64)
    payload = device_performance.make_payload(1)
    assert payload.numpy().tobytes() == want.tobytes()

    store = TensorStoreService()
    srv = rpc.Server(rpc.ServerOptions(device="cpu"))
    assert srv.add_service(store) == 0
    assert srv.start("127.0.0.1:0") == 0
    try:
        from brpc_tpu_torch import bvar

        rec, moved, errs = bvar.LatencyRecorder(), bvar.Adder(), bvar.Adder()
        device_performance.run_pushers(str(srv.listen_endpoint), payload,
                                       2, 2, "cpu", rec, moved, errs)
        assert (rec.count(), errs.get_value()) == (4, 0)
        assert moved.get_value() == 4 * want.nbytes
        for name in ("t0.0", "t0.1", "t1.0", "t1.1"):
            got = store.get(name)[0]
            assert got.numpy().tobytes() == want.tobytes()
    finally:
        srv.stop()


def test_mesh_halves_against_the_reference(mesh_world, monkeypatch):
    """2 ranks against a 2-device mesh: the same fan-out value and the
    same reduced value (the GB/s are not the same quantity, queue C #7);
    parallel_echo prints the reference's mesh line."""
    import jax.numpy as jnp

    ranks = mesh_world()
    mesh = ref_parallel.make_mesh({"x": 2})
    want_merged = float(ref_parallel.MeshChannel(mesh, "x").parallel_call(
        lambda s: s * 2.0, jnp.arange(2.0).reshape(2, 1),
        merger="add").ravel()[0])
    want_probe = ref_parallel.ici_bandwidth_probe(mesh, "x",
                                                  nbytes=1 << 16, iters=2)
    x = jnp.ones((1 << 14,), jnp.float32)
    want_reduced = float(ref_parallel.collectives._allreduce_fn(
        mesh, "x", x.shape, "float32", "add")(x))
    for r in ranks:
        assert r["merged"] == want_merged == 2.0
        assert r["reduced"] == want_reduced == 2.0
        assert set(r["probe"]) == set(want_probe)
        for key in ("axis_size", "payload_bytes", "iters"):
            assert r["probe"][key] == want_probe[key]

    monkeypatch.setattr(parallel, "run_ranks", _fake_run_ranks(ranks, 2))
    code, out = _run_port(parallel_echo, ["--ranks", "2"])
    assert code == 0
    fields = _hold_to_formats("parallel_echo", out)
    assert len(fields) == 2, out
    assert sorted(fields[0][0].split(";")) == [
        "", "node0:fanout", "node1:fanout", "node2:fanout"]
    assert fields[1] == ("2", "2.0")
