"""The port's builtin console held against brpc_tpu's, on the CPU.

One Echo server per package, both with their builtin services (a module
fixture); pages are read with ``http.client`` and compared after masking
what differs by nature (the version, the uptime, ports and latencies):

* ``/health``, ``/version``, ``/index``, ``/protobufs``, ``/list``;
* ``/flags`` with a live edit and refused edits, for a flag defined in
  both packages;
* ``/vars/<name>``, ``/vars/<name>?chart=1`` and ``/brpc_metrics`` for an
  Adder and a labelled variable defined in both packages;
* ``/status`` after the same calls;
* the profilers: ``_ProfWindow``'s 503 with ``Retry-After``,
  ``/hotspots/contention`` busy, ``/hotspots/cpu`` naming a busy
  thread's function, ``/hotspots/tpu`` through a stub of
  ``profilers.cuda_trace`` (the card trace itself is tested in
  tests/test_torch_profilers.py), ``/hotspots/native``, ``/heap`` and
  ``/growth`` (tracemalloc stopped after);
* every other page answers with the reference's status and type;
* the device variables: one transfer over each lane moves the same
  variables by the same deltas in both packages.

The reference's ``/status``, ``/connections`` and native profiles would
load its native runtime, which does not build here: the fixture replaces
``brpc_tpu.bvar.native_vars.native_status_lines`` and
``brpc_tpu.native.available`` for the module's duration. Threads only;
every wait has a deadline; profiler windows at the 0.1 s clamp.
"""
import http.client
import re
import threading
import time
import tracemalloc

import jax
import numpy as np
import pytest
import torch

from brpc_tpu import bvar as ref_bvar
from brpc_tpu import native as ref_native
from brpc_tpu import rpc as ref_rpc
from brpc_tpu.bthread import get_task_control as ref_get_task_control
from brpc_tpu.builtin import hotspots as ref_hotspots
from brpc_tpu.builtin import profilers as ref_profilers
from brpc_tpu.butil import flags as ref_flags
from brpc_tpu.butil.iobuf import IOBuf as RefIOBuf
from brpc_tpu.bvar import native_vars as ref_native_vars
from brpc_tpu.bvar import variable as ref_variable
from brpc_tpu.rpc import device_transport as ref_dt
from brpc_tpu.rpc.fake_transfer import FakeTransferServer as RefFake
from brpc_tpu.rpc.proto import echo_pb2, rpc_meta_pb2
from brpc_tpu_torch import native as port_native
from brpc_tpu_torch import bvar, rpc
from brpc_tpu_torch.builtin import hotspots, profilers
from brpc_tpu_torch.butil import flags
from brpc_tpu_torch.butil.iobuf import IOBuf
from brpc_tpu_torch.bvar import variable
from brpc_tpu_torch.rpc import device_transport as dt
from brpc_tpu_torch.rpc.fake_transfer import FakeTransferServer
from brpc_tpu_torch.rpc.proto import wire

WAIT_S = 3.0
PROBE_FLAG = "console_probe_ms"  # reloadable, in both packages
FIXED_FLAG = "console_fixed"  # not reloadable


def _echo_service(mod, msgs):
    class Echo(mod.Service):
        SERVICE_NAME = "EchoService"

        @mod.rpc_method(msgs.EchoRequest, msgs.EchoResponse)
        def Echo(self, cntl, request, response, done):
            response.message = request.message
            done()

    return Echo()


PKGS = {"ref": (ref_rpc, echo_pb2, ref_flags), "port": (rpc, wire, flags)}


@pytest.fixture(scope="module")
def servers():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BRPC_TPU_FABRIC", "0")  # no native fabric build
        # the reference's native sections would build its native runtime
        mp.setattr(ref_native_vars, "native_status_lines", lambda: [])
        mp.setattr(ref_native, "available", lambda: False)
        # and the port's pages show no native section, whether or not
        # an earlier test of this process loaded the port's library
        mp.setattr(port_native, "is_loaded", lambda: False)
        ref_get_task_control()  # the bthread pool's first sizing sticks
        out = {}
        try:
            for pkg, (mod, msgs, fl) in PKGS.items():
                if PROBE_FLAG not in fl.all_flags():
                    fl.define_int(PROBE_FLAG, 5, "a probe's period",
                                  validator=lambda v: v > 0)
                    fl.define_string(FIXED_FLAG, "a", "fixed",
                                     reloadable=False)
                kw = {"device": "cpu"} if pkg == "port" else {"num_threads": 4}
                srv = mod.Server(mod.ServerOptions(**kw))
                assert srv.add_service(_echo_service(mod, msgs)) == 0
                assert srv.start("127.0.0.1:0") == 0
                out[pkg] = srv
            yield out
        finally:
            for srv in out.values():
                srv.stop()


def _get(srv, path, method="GET"):
    conn = http.client.HTTPConnection("127.0.0.1", srv.listen_endpoint.port,
                                      timeout=WAIT_S)
    try:
        conn.request(method, path)
        r = conn.getresponse()
        return r.status, dict(r.getheaders()), r.read()
    finally:
        conn.close()


def _both(servers, path):
    return {pkg: _get(srv, path) for pkg, srv in servers.items()}


_VERSION = re.compile(rb"brpc_tpu(_torch)?/[0-9.]+")


def _mask(body: bytes) -> bytes:
    return re.sub(rb"\d+(\.\d+)?", b"N", _VERSION.sub(b"VERSION", body))


def test_health_and_version(servers):
    got = _both(servers, "/health")
    assert got["port"] == got["ref"] and got["port"][2] == b"OK\n"
    got = _both(servers, "/version")
    assert _VERSION.sub(b"V", got["port"][2]) == b"V\n"
    assert _VERSION.sub(b"V", got["ref"][2]) == b"V\n"
    assert got["port"][2] == b"brpc_tpu_torch/0.1.0\n"


def test_index_protobufs_and_list(servers):
    got = _both(servers, "/index")
    ref_only = {b"  /fleet"}  # not ported yet
    ref_lines = [ln for ln in got["ref"][2].split(b"\n") if ln not in ref_only]
    assert got["port"][2].split(b"\n") == ref_lines
    for path in ("/protobufs", "/list"):
        got = _both(servers, path)
        assert got["port"] == got["ref"]
    assert got["port"][1]["content-type"] == "application/json"


def test_flags_page_and_live_edit(servers):
    for path, status in ((f"/flags/{PROBE_FLAG}", 200),
                         (f"/flags/{PROBE_FLAG}?setvalue=7", 200),
                         (f"/flags/{PROBE_FLAG}", 200),
                         (f"/flags/{PROBE_FLAG}?setvalue=-1", 403),
                         (f"/flags/{PROBE_FLAG}?setvalue=abc", 403),
                         (f"/flags/{FIXED_FLAG}?setvalue=b", 403),
                         ("/flags/no_such_flag", 404)):
        got = _both(servers, path)
        assert got["port"][0] == status
        assert got["port"][2] == got["ref"][2]
    assert flags.get_flag(PROBE_FLAG) == ref_flags.get_flag(PROBE_FLAG) == 7
    listing = {pkg: [ln for ln in v[2].split(b"\n")
                     if ln.startswith(b"console_")]
               for pkg, v in _both(servers, "/flags").items()}
    assert listing["port"] == listing["ref"] and len(listing["port"]) == 2
    # every flag is a variable too
    assert bvar.find_exposed(f"flag_{PROBE_FLAG}").get_value() == 7
    flags.set_flag(PROBE_FLAG, 5)
    ref_flags.set_flag(PROBE_FLAG, 5)


@pytest.fixture
def twin_vars():
    """An Adder and a labelled variable of the same names in both."""
    made = []
    for mod, var_mod in ((bvar, variable), (ref_bvar, ref_variable)):
        adder = mod.Adder("console_twin_adder")
        adder.update(42)
        labelled = var_mod.PassiveStatus(
            lambda: {(("method", 'Svc."M"\\x'), ("code", "0")): 3,
                     (("method", "line\nbreak"),): 1.5},
            "console_twin_labelled")
        made += [adder, labelled]
    yield
    for v in made:
        v.hide()


def test_vars_and_metrics_of_twin_variables(servers, twin_vars):
    for path in ("/vars/console_twin", "/vars/console_twin_adder?chart=1",
                 "/vars/no_such_var?chart=1"):
        got = _both(servers, path)
        assert got["port"] == got["ref"], path
    assert got["port"][0] == 404
    assert _get(servers["port"], "/vars/console_twin")[2] == (
        b"console_twin_adder : 42\nconsole_twin_labelled : "
        + repr({(("method", 'Svc."M"\\x'), ("code", "0")): 3,
                (("method", "line\nbreak"),): 1.5}).encode() + b"\n")
    metrics = {}
    for pkg, (status, headers, body) in _both(servers,
                                              "/brpc_metrics").items():
        assert status == 200
        metrics[pkg] = [ln for ln in body.split(b"\n") if b"console_twin" in ln]
        metrics[pkg].append(headers["content-type"].encode())
    assert metrics["port"] == metrics["ref"]
    assert metrics["port"][:2] == [b"# TYPE console_twin_adder gauge",
                                   b"console_twin_adder 42"]
    assert (b'console_twin_labelled{method="Svc.\\"M\\"\\\\x",code="0"} 3'
            in metrics["port"])


def test_status_lists_the_methods(servers):
    for pkg, srv in servers.items():
        mod, msgs, _ = PKGS[pkg]
        ch = mod.Channel(mod.ChannelOptions(protocol="http"))
        assert ch.init(str(srv.listen_endpoint)) == 0
        for i in range(3):
            cntl, resp = ch.call("EchoService.Echo",
                                 msgs.EchoRequest(message=str(i)),
                                 msgs.EchoResponse, timeout_ms=WAIT_S * 1000)
            assert not cntl.failed() and resp.message == str(i)
        ch.close()
    got = _both(servers, "/status")
    assert _mask(got["port"][2]) == _mask(got["ref"][2])
    counts = {pkg: re.search(rb"EchoService.Echo: .* count=(\d+)", v[2])[1]
              for pkg, v in got.items()}
    assert counts["port"] == counts["ref"]


def test_prof_window_busy_answers_503_with_retry_after():
    got = []
    for mod in (ref_hotspots, hotspots):
        window = mod._ProfWindow(10.0, "busy: another window is running\n")
        inside, release = threading.Event(), threading.Event()
        first = []
        t = threading.Thread(target=lambda: first.append(window.run(
            2.5, lambda s: (inside.set(), release.wait(WAIT_S), f"{s}")[2])))
        t.start()
        assert inside.wait(WAIT_S)
        second = window.run(0.1, lambda s: "never")
        release.set()
        t.join(WAIT_S)
        got.append((second, first[0]))
    assert got[0] == got[1]
    assert got[1][0] == (503, "text/plain", "busy: another window is "
                         "running\n", {"Retry-After": "3"})
    assert got[1][1] == (200, "text/plain", "2.5")


def test_contention_window_busy_over_http(servers):
    srv = servers["port"]
    first = []
    t = threading.Thread(target=lambda: first.append(
        _get(srv, "/hotspots/contention?seconds=0.3")))
    t.start()
    deadline = time.monotonic() + WAIT_S
    while (not hotspots._contention_prof_window._lock.locked()
           and time.monotonic() < deadline):
        time.sleep(0.002)
    status, headers, body = _get(srv, "/hotspots/contention?seconds=0.1")
    t.join(WAIT_S)
    assert (status, headers["retry-after"]) == (503, "1")
    assert body == ref_hotspots._contention_prof_window._busy_text.encode()
    assert first[0][0] == 200
    assert first[0][2].startswith(b"# python wait-frame profile\n"
                                  b"# contention profile: ")


def _console_busy_loop(stop):
    while not stop.wait(0.001):
        sum(range(200))


def test_hotspots_cpu_names_a_busy_thread(servers):
    stop = threading.Event()
    t = threading.Thread(target=_console_busy_loop, args=(stop,))
    t.start()
    try:
        got = _both(servers, "/hotspots/cpu?seconds=0.1")
    finally:
        stop.set()
        t.join(WAIT_S)
    for status, headers, body in got.values():
        assert status == 200
        assert body.startswith(b"# cpu profile: ")
        assert b"_console_busy_loop (test_torch_console.py:" in body


def test_hotspots_tpu_serves_the_card_trace(servers, monkeypatch):
    calls = []

    def fake_trace(seconds, device=None):
        calls.append((seconds, device))
        return "application/zip", b"PK\x05\x06" + bytes(18)

    monkeypatch.setattr(profilers, "cuda_trace", fake_trace)
    status, headers, body = _get(servers["port"], "/hotspots/tpu?seconds=0.5")
    assert (status, headers["content-type"], body) == (
        200, "application/zip", b"PK\x05\x06" + bytes(18))
    assert calls == [(0.5, "cpu")]  # the server's device
    got = _both(servers, "/hotspots/native")
    assert got["port"][2] == got["ref"][2] == b"native runtime unavailable\n"
    got = _both(servers, "/hotspots/nope")
    assert got["port"] == got["ref"] and got["port"][0] == 404


@pytest.fixture
def tracemalloc_stopped_after():
    was = tracemalloc.is_tracing()
    yield
    if not was:
        tracemalloc.stop()
        profilers._growth_baseline = ref_profilers._growth_baseline = None


def test_heap_and_growth_pages(servers, tracemalloc_stopped_after):
    for path, head in (("/heap", b"# heap profile: "),
                       ("/growth", b"# growth profile: "),
                       ("/pprof/heap", b"# heap profile: "),
                       ("/heap/native", b"native runtime unavailable\n")):
        got = _both(servers, path)
        for status, headers, body in got.values():
            assert status == 200 and body.startswith(head), path


PAGES = ["/vars", "/flags", "/connections", "/bthreads", "/sockets", "/ids",
         "/ids?id=12", "/ids?id=x", "/vlog", "/threads", "/pprof/symbol",
         "/pprof/nope", "/brpc_metrics", "/dir/no/such/path", "/status"]


@pytest.mark.parametrize("path", PAGES)
def test_every_page_answers_like_the_reference(servers, path):
    got = _both(servers, path)
    assert got["port"][0] == got["ref"][0]
    assert (got["port"][1]["content-type"]
            == got["ref"][1]["content-type"])
    port_lines = got["port"][2].split(b"\n")
    ref_lines = got["ref"][2].split(b"\n")
    # the same first line, masked (each page's title or first entry)
    if path not in ("/vars", "/flags", "/brpc_metrics", "/threads"):
        assert _mask(port_lines[0]) == _mask(ref_lines[0])
    if path == "/connections":
        port = servers["port"].listen_endpoint.port
        assert any(b"|ok" in ln for ln in port_lines[1:]), port


# -- the device variables ------------------------------------------------------

_DEVICE_VARS = ["device_block_pool_acquired", "device_block_pool_released",
                "device_transport_ring_transfers",
                "device_transport_shm_transfers",
                "device_transport_wire_transfers",
                "device_transport_xfer_transfers",
                "device_transport_zero_copy_transfers"]


def _device_vars(mod):
    return {n: mod.find_exposed(n).get_value() for n in _DEVICE_VARS}


def _one_send_per_lane(mod, endpoint_of, meta_cls, buf_cls, payload, land):
    """One tensor over each lane (in-process, shm, xfer, wire), received
    onto ``land`` and ACKed."""
    for where, peer_xfer in (("same_process", False), ("same_host", False),
                             ("other_host", True), ("other_host", False)):
        ep = endpoint_of()
        ep.state = mod.ESTABLISHED
        ep.peer_info = {
            "process": mod._process_uuid if where == "same_process" else "p",
            "host": mod._boot_id if where != "other_host" else "other-host",
            "arena": "", "fabric": "", "xfer": peer_xfer, "device_count": 1}
        if peer_xfer:
            ep.resolve_xfer_addr("127.0.0.1")
        meta, att = meta_cls(), buf_cls()
        assert ep.prepare_send([payload], meta, att)
        kw = {"endpoint": ep} if mod is dt else {}
        _, seq = mod.receive_tensors(meta, att, land, **kw)
        ep.on_ack(seq)


def test_device_variables_move_like_the_reference():
    saved = (dt._xfer_server, ref_dt._xfer_server)
    fakes = dt._xfer_server, ref_dt._xfer_server = (FakeTransferServer(),
                                                    RefFake())
    try:
        before = {"port": _device_vars(bvar), "ref": _device_vars(ref_bvar)}
        _one_send_per_lane(dt, lambda: dt.DeviceEndpoint(device="cpu"),
                           wire.RpcMeta, IOBuf,
                           torch.arange(64, dtype=torch.int32), "cpu")
        _one_send_per_lane(ref_dt, ref_dt.DeviceEndpoint,
                           rpc_meta_pb2.RpcMeta, RefIOBuf,
                           np.arange(64, dtype=np.int32), jax.devices()[0])
        after = {"port": _device_vars(bvar), "ref": _device_vars(ref_bvar)}
    finally:
        for fake in fakes:
            fake.stop()
        dt._xfer_server, ref_dt._xfer_server = saved
    deltas = {pkg: {n: after[pkg][n] - before[pkg][n] for n in _DEVICE_VARS}
              for pkg in after}
    assert deltas["port"] == deltas["ref"]
    assert deltas["port"]["device_transport_ring_transfers"] == 0
    assert all(deltas["port"][f"device_transport_{lane}_transfers"] == 1
               for lane in ("zero_copy", "shm", "xfer", "wire"))
    lanes = dt.lane_counters()
    assert lanes["shm"] == bvar.find_exposed(
        "device_transport_shm_transfers").get_value()
