"""The port's progressive attachments held against brpc_tpu's, on the CPU,
with threads (after tests/test_progressive_session.py).

* A download: the server answers at once, then writes five parts and
  closes; the client's reader gets them in order and ends. In three
  pairings: port to port, port server to reference client, and
  reference server to port client.
* The reader's callbacks: ``on_read_one_part`` once per part, in order,
  then ``on_end_of_message``.
* A handler asked for an attachment by a client without a reader gets
  None, in both packages.

Servers are module-scoped; every wait has a deadline of WAIT_S.
"""
import threading
import time

import pytest

from brpc_tpu import rpc as ref_rpc
from brpc_tpu.bthread import get_task_control as ref_get_task_control
from brpc_tpu.rpc import progressive as ref_progressive
from brpc_tpu.rpc.proto import echo_pb2
from brpc_tpu_torch import rpc
from brpc_tpu_torch.rpc import progressive
from brpc_tpu_torch.rpc.proto import wire

WAIT_S = 10.0  # a deadline under load, never a sleep
PARTS = [f"part-{i};".encode() for i in range(5)]
PKGS = {"port": (rpc, wire, progressive),
        "ref": (ref_rpc, echo_pb2, ref_progressive)}


def _push_service(mod, msgs, prog):
    class PushService(mod.Service):
        @mod.rpc_method(msgs.EchoRequest, msgs.EchoResponse)
        def Download(self, cntl, request, response, done):
            pa = prog.create_progressive_attachment(cntl)
            response.message = "headers-sent" if pa else "no-reader"
            done()  # answer first, then write the body
            if pa is None:
                return

            def pusher():
                for part in PARTS:
                    pa.write(part)
                    time.sleep(0.005)
                pa.close()

            threading.Thread(target=pusher, daemon=True).start()

    return PushService()


@pytest.fixture(scope="module")
def servers():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BRPC_TPU_FABRIC", "0")  # no native fabric build
        ref_get_task_control()  # the bthread pool's first sizing sticks
        out = {}
        try:
            for pkg, (mod, msgs, prog) in PKGS.items():
                opts = (mod.ServerOptions(device="cpu") if pkg == "port" else
                        mod.ServerOptions(num_threads=4,
                                          has_builtin_services=False))
                srv = mod.Server(opts)
                assert srv.add_service(_push_service(mod, msgs, prog)) == 0
                assert srv.start("127.0.0.1:0") == 0
                out[pkg] = srv
            yield out
        finally:
            for srv in out.values():
                srv.stop()


PAIRINGS = [("port", "port"), ("ref", "port"), ("port", "ref")]
IDS = [f"{c}-client-{s}-server" for c, s in PAIRINGS]


@pytest.fixture
def download(servers):
    """``download(client, server, reader)`` calls Download and returns the
    response's message; the channel stays open until the test ends (the
    body comes on its connection after the response)."""
    channels = []

    def call(client: str, server: str, reader):
        mod, msgs, prog = PKGS[client]
        ch = mod.Channel()
        channels.append(ch)
        assert ch.init(str(servers[server].listen_endpoint)) == 0
        cntl = mod.Controller()
        cntl.timeout_ms = WAIT_S * 1000
        if reader is not None:
            prog.attach_progressive_reader(cntl, reader)
        resp = msgs.EchoResponse()
        ch.call_method("PushService.Download", cntl,
                       msgs.EchoRequest(message="get"), resp)
        assert not cntl.failed(), cntl.error_text
        return resp.message

    yield call
    for ch in channels:
        ch.close()


@pytest.mark.parametrize("client,server", PAIRINGS, ids=IDS)
def test_progressive_download(download, client, server):
    reader = PKGS[client][2].ProgressiveReader()
    assert download(client, server, reader) == "headers-sent"
    assert reader.read_all(timeout=WAIT_S) == b"".join(PARTS)
    assert reader.ended


@pytest.mark.parametrize("client,server", PAIRINGS, ids=IDS)
def test_progressive_callbacks(download, client, server):
    events = []
    ended = threading.Event()

    class Reader(PKGS[client][2].ProgressiveReader):
        def on_read_one_part(self, data):
            events.append(data)

        def on_end_of_message(self):
            events.append("end")
            ended.set()

    assert download(client, server, Reader()) == "headers-sent"
    assert ended.wait(WAIT_S)
    assert events == PARTS + ["end"]


@pytest.mark.parametrize("pkg", PKGS)
def test_no_reader_no_attachment(download, pkg):
    assert download(pkg, pkg, None) == "no-reader"
