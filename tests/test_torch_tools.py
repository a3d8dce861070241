"""The port's tools held against the reference's, on the CPU.

Each tool of ``brpc_tpu_torch.tools`` runs against a port server and a
reference server in this process (one of each, with their consoles), and
where the reference's tool (``tools/<name>.py``, run through ``runpy``)
has a result to compare, it runs too: rpc_press's ``@file`` bodies reach
the server in cycle order, ``--qps 40 --duration 1`` makes 30-50 calls,
and ``--protocol http`` works; a dump recorded by each package replays
with the same ok/failed/skipped counts through either package's tool,
and ``--native`` with nothing to replay is refused with exit code 2
(``tests/test_torch_native_client.py`` replays through it); rpc_view prints the same
page as the reference's tool; parallel_http counts the same; a trackme
ping from each package is counted by the other's server. Threads only.
"""
import contextlib
import io
import json
import os
import re
import runpy
import sys

import pytest

from brpc_tpu import native as ref_native
from brpc_tpu import rpc as ref_rpc
from brpc_tpu.bthread import get_task_control
from brpc_tpu.butil import flags as ref_flags
from brpc_tpu.butil.recordio import RecordWriter
from brpc_tpu.bvar import native_vars as ref_native_vars
from brpc_tpu.rpc import rpc_dump as ref_rpc_dump
from brpc_tpu.rpc import trackme as ref_trackme
from brpc_tpu.rpc.proto import echo_pb2
import brpc_tpu_torch
from brpc_tpu_torch import native as port_native
from brpc_tpu_torch import rpc
from brpc_tpu_torch.butil import flags
from brpc_tpu_torch.rpc import rpc_dump, trackme
from brpc_tpu_torch.rpc.proto import wire
from brpc_tpu_torch.tools import (
    parallel_http,
    rpc_press,
    rpc_replay,
    rpc_view,
    trackme_server,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _echo_service(mod, msgs, seen):
    class EchoService(mod.Service):
        @mod.rpc_method(msgs.EchoRequest, msgs.EchoResponse)
        def Echo(self, cntl, request, response, done):
            seen.append(request.message)
            response.message = request.message
            done()

    return EchoService()


@pytest.fixture(scope="module")
def servers():
    """{"ref": (server, messages seen), "port": (...)}, consoles on."""
    get_task_control()  # the bthread pool's first sizing sticks
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BRPC_TPU_FABRIC", "0")
        # the reference's native /status sections would build its runtime
        mp.setattr(ref_native_vars, "native_status_lines", lambda: [])
        mp.setattr(ref_native, "available", lambda: False)
        # and the port's pages show no native section, whether or not
        # an earlier test of this process loaded the port's library
        mp.setattr(port_native, "is_loaded", lambda: False)
        try:
            for pkg, mod, msgs, opts in (
                    ("ref", ref_rpc, echo_pb2, ref_rpc.ServerOptions()),
                    ("port", rpc, wire, rpc.ServerOptions(device="cpu"))):
                seen = []
                srv = mod.Server(opts)
                assert srv.add_service(_echo_service(mod, msgs, seen)) == 0
                assert srv.start("127.0.0.1:0") == 0
                out[pkg] = (srv, seen)
            yield out
        finally:
            for srv, _ in out.values():
                srv.stop()


def _target(servers, pkg):
    return str(servers[pkg][0].listen_endpoint)


def _reference_tool(name, args):
    """(exit code, stdout) of tools/<name>.py run in this process."""
    buf = io.StringIO()
    code = 0
    with contextlib.redirect_stdout(buf), \
            pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", [f"tools/{name}.py", *args])
        mp.chdir(REPO)
        try:
            runpy.run_path(os.path.join(REPO, "tools", f"{name}.py"),
                           run_name="__main__")
        except SystemExit as e:
            code = e.code or 0
    return code, buf.getvalue()


def _quiet(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = fn(*args)
    return result, buf.getvalue()


def _press(servers, pkg, *args):
    """rpc_press at ``pkg``'s server: (totals, printed text, what the
    server saw). Each call may take up to 10 s on a loaded host."""
    del servers[pkg][1][:]
    res, out = _quiet(rpc_press.press, rpc_press.parse_args([
        "--server", _target(servers, pkg), "--method", "EchoService.Echo",
        "--timeout-ms", "10000", *args]))
    return res, out, list(servers[pkg][1])


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_rpc_press_sends_file_bodies_in_cycle_order(servers, pkg, tmp_path):
    """One thread, three @file bodies, unthrottled: the server sees them
    in cycle order; the closing line is the reference's."""
    bodies = tmp_path / "bodies.jsonl"
    bodies.write_text("".join(json.dumps({"message": m}) + "\n"
                              for m in ("a", "b", "c")))
    res, out, seen = _press(servers, pkg, "--input", f"@{bodies}",
                            "--duration", "0.1", "--threads", "1")
    assert len(seen) >= 3 and res["sent"] == len(seen) and res["errors"] == 0
    assert seen == [("a", "b", "c")[i % 3] for i in range(len(seen))]
    assert re.search(r"^total=\d+ qps=\d+\.\d errors=0 avg=\d+us p50=\d+us "
                     r"p90=\d+us p99=\d+us$", out, re.M)


def test_rpc_press_holds_the_throttled_rate(servers):
    """--qps 40 --duration 1 (two threads, each firing every 50 ms), at
    both servers at once: 30-50 calls each, no error."""
    import threading

    got = {}

    def run(pkg):
        del servers[pkg][1][:]
        got[pkg] = rpc_press.press(rpc_press.parse_args([
            "--server", _target(servers, pkg), "--method", "EchoService.Echo",
            "--timeout-ms", "10000", "--input", '{"message": "q"}',
            "--qps", "40", "--duration", "1"]))

    threads = [threading.Thread(target=run, args=(p,)) for p in servers]
    with contextlib.redirect_stdout(io.StringIO()):  # one redirect: threads
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
    assert set(got) == {"ref", "port"}
    for pkg, res in got.items():
        seen = servers[pkg][1]
        assert 30 <= len(seen) <= 50 and res["sent"] == len(seen), (pkg, res)
        assert res["errors"] == 0


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_rpc_press_over_http(servers, pkg):
    res, out, seen = _press(servers, pkg, "--input", '{"message": "h"}',
                            "--duration", "0.1", "--protocol", "http")
    assert res["sent"] > 0 and res["errors"] == 0, out
    assert set(seen) == {"h"}


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_rpc_press_over_grpc(servers, pkg):
    """--protocol h2:grpc: the same press over gRPC, at both servers."""
    res, out, seen = _press(servers, pkg, "--input", '{"message": "g"}',
                            "--duration", "0.1", "--protocol", "h2:grpc")
    assert res["sent"] > 0 and res["errors"] == 0, out
    assert set(seen) == {"g"}


def _record(pkg, mod, msgs, dump_mod, flag_mod, target, directory):
    """Three echoes and one call to a missing method, recorded by
    ``pkg``'s rpc_dump into ``directory``; plus a file holding one record
    of another lane (a native capture's HTTP record), to be skipped."""
    dump_mod.reset_for_tests()
    old_dir = flag_mod.get_flag("rpc_dump_dir")
    assert flag_mod.set_flag("rpc_dump_dir", str(directory))
    assert flag_mod.set_flag("rpc_dump", True)
    ch = mod.Channel()
    try:
        assert ch.init(target) == 0
        for m in ("x", "y", "z"):
            cntl, _ = ch.call("EchoService.Echo", msgs.EchoRequest(message=m),
                              msgs.EchoResponse)
            assert not cntl.failed()
        cntl, _ = ch.call("EchoService.Nope", msgs.EchoRequest(message="n"),
                          msgs.EchoResponse)
        assert cntl.failed()
    finally:
        flag_mod.set_flag("rpc_dump", False)
        dump_mod.reset_for_tests()
        flag_mod.set_flag("rpc_dump_dir", old_dir)
        ch.close()
    with RecordWriter(str(directory / "zz_native.rio")) as w:
        w.write({"service": "EchoService", "method": "Echo", "lane": "http"},
                b"GET / HTTP/1.1\r\n\r\n")


def test_rpc_replay_same_counts_for_either_packages_dump_and_tool(
        servers, tmp_path):
    dumps = {}
    for pkg, mod, msgs, dump_mod, flag_mod in (
            ("ref", ref_rpc, echo_pb2, ref_rpc_dump, ref_flags),
            ("port", rpc, wire, rpc_dump, flags)):
        dumps[pkg] = tmp_path / pkg
        dumps[pkg].mkdir()
        _record(pkg, mod, msgs, dump_mod, flag_mod, _target(servers, pkg),
                dumps[pkg])
    counts = set()
    for dump_pkg, directory in dumps.items():
        for server_pkg in ("ref", "port"):
            args = ["--dir", str(directory), "--server",
                    _target(servers, server_pkg), "--timeout-ms", "10000"]
            code, out = _quiet(rpc_replay.main, args)
            ref_code, ref_out = _reference_tool("rpc_replay", args)
            assert code == ref_code == 1  # the missing method fails
            for text in (out, ref_out):
                counts.add(re.search(r"^replayed (ok=\d+ failed=\d+ "
                                     r"skipped=\d+) in ", text, re.M)[1])
    assert counts == {"ok=3 failed=1 skipped=1"}


def test_rpc_replay_native_is_refused(tmp_path, capsys):
    """``--native`` with a capture that holds nothing to replay is refused
    with exit code 2 and the reason."""
    code = rpc_replay.main(["--dir", str(tmp_path), "--server",
                            "127.0.0.1:1", "--native"])
    assert code == 2
    assert "no replayable records" in capsys.readouterr().err


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_rpc_view_prints_the_references_page(servers, pkg):
    for page in ("health", "version", "nope"):
        args = [_target(servers, pkg), page]
        code, out = _quiet(rpc_view.main, args)
        ref_code, ref_out = _reference_tool("rpc_view", args)
        assert code == ref_code == 0
        assert out == ref_out


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_parallel_http_counts_like_the_reference(servers, pkg):
    host = _target(servers, pkg)
    urls = [f"http://{host}/health"] * 6 + [f"http://{host}/nope"] * 2
    got, out = _quiet(parallel_http.fetch_all, urls, 4, 5)
    assert (got["fetched"], got["ok"], got["failed"]) == (8, 6, 2)
    args = ["--url", f"http://{host}/health", "-n", "6", "--concurrency", "4"]
    _, port_out = _quiet(parallel_http.main, args)
    _, ref_out = _reference_tool("parallel_http", args)
    for text in (port_out, ref_out):
        assert re.match(r"fetched=6 ok=6 failed=0 in \d+\.\ds ", text), text


def test_trackme_pings_are_counted_across_packages(monkeypatch):
    """The port's start_trackme pings the reference's trackme_server at
    once, on the bthread timer, and a reference ping reaches the port's
    server: each counted under the pinger's version. The notice in the
    reply is logged, not fatal."""
    import time

    started = []
    monkeypatch.setattr(ref_rpc.Server, "run_until_asked_to_quit",
                        lambda self: started.append(self))
    _reference_tool("trackme_server", ["--port", "0", "--notice", "hi"])
    ref_srv = started[0]
    (port_srv, counts), _ = _quiet(trackme_server.start, 0, "", "cpu")
    ref_target = str(ref_srv.listen_endpoint)
    want = json.dumps({brpc_tpu_torch.__version__: 1}, indent=1)
    try:
        assert flags.set_flag("trackme_server", ref_target)
        try:
            trackme.start_trackme()
            end = time.monotonic() + 10
            while (rpc_view.fetch(ref_target, "tallies") != want
                   and time.monotonic() < end):
                time.sleep(0.01)
        finally:
            flags.set_flag("trackme_server", "")  # later ticks ping no one
        assert rpc_view.fetch(ref_target, "tallies") == want
        assert ref_flags.set_flag("trackme_server",
                                  str(port_srv.listen_endpoint))
        try:
            assert ref_trackme._ping_once()
        finally:
            ref_flags.set_flag("trackme_server", "")
        assert counts == {"0.1.0": 1}
    finally:
        ref_srv.stop()
        port_srv.stop()
