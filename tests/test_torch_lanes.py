"""The rest of the port's tensor lane, on the CPU: the shm send arena and the
xfer lane (through the TCP fake transfer server; its CUDA IPC backend runs
only on the card, tests/test_torch_real_transfer.py).

* twins of tests/test_device_lane.py: arena spans, the transfer-server
  plumbing, the two-process xfer push/pull;
* the shm send lane for every wire dtype;
* lane choice held against the reference for every peer locality, xfer
  advertisement and prefer-xfer flag;
* interop with the reference over the shm and the fake xfer lanes, both
  ways;
* the two window repairs (a lane that raises, a release that raises);
* malformed transfer replies refused with ValueError.
"""
import os
import socket
import subprocess
import sys
import threading

import ml_dtypes
import numpy as np
import pytest
import torch

from brpc_tpu import rpc as ref_rpc
from brpc_tpu.bthread import get_task_control
from brpc_tpu.butil import flags as ref_flags
from brpc_tpu.butil.iobuf import IOBuf as RefIOBuf
from brpc_tpu.rpc import device_transport as ref_dt
from brpc_tpu.rpc import tensor_service as ref_ts
from brpc_tpu.rpc.fake_transfer import FakeTransferServer as RefFake
from brpc_tpu.rpc.proto import rpc_meta_pb2
from brpc_tpu_torch import rpc
from brpc_tpu_torch.butil import flags
from brpc_tpu_torch.butil.iobuf import IOBuf
from brpc_tpu_torch.rpc import cuda_ipc_transfer as ipc
from brpc_tpu_torch.rpc import device_transport as dt
from brpc_tpu_torch.rpc import tensor_service as ts
from brpc_tpu_torch.rpc.fake_transfer import (
    FakeTransferConnection,
    FakeTransferServer,
)
from brpc_tpu_torch.rpc.proto import wire

CPU = "cpu"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PREFER = "device_transport_prefer_xfer"


def _bytes(t) -> bytes:
    if isinstance(t, torch.Tensor):
        return t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(np.asarray(t)).tobytes()


def _tensor(name: str, shape=(3, 5, 8), seed=7) -> torch.Tensor:
    dtype, itemsize = dt.DTYPES[name]
    g = torch.Generator().manual_seed(seed)
    n = int(np.prod(shape)) * itemsize
    raw = torch.randint(0, 256, (n,), dtype=torch.uint8, generator=g)
    if dtype == torch.bool:
        raw = raw % 2
    return raw.view(dtype).reshape(shape)


def _numpy_of(x: torch.Tensor) -> np.ndarray:
    name = dt.dtype_name(x.dtype)
    np_dtype = ml_dtypes.bfloat16 if name == "bfloat16" else np.dtype(name)
    return np.frombuffer(_bytes(x), dtype=np_dtype).reshape(tuple(x.shape))


@pytest.fixture
def fakes():
    """Fresh fake transfer servers installed in both packages, the
    prefer-xfer flag saved; everything restored afterwards."""
    saved = (dt._xfer_server, ref_dt._xfer_server, flags.get_flag(PREFER),
             ref_flags.get_flag(PREFER))
    port, ref = FakeTransferServer(), RefFake()
    dt._xfer_server, ref_dt._xfer_server = port, ref
    try:
        yield port, ref
    finally:
        port.stop()
        ref.stop()
        dt._xfer_server, ref_dt._xfer_server = saved[:2]
        flags.set_flag(PREFER, saved[2])
        ref_flags.set_flag(PREFER, saved[3])


def _prefer_xfer(on: bool):
    flags.set_flag(PREFER, on)
    ref_flags.set_flag(PREFER, on)


def test_host_arena_spans():
    arena = dt.HostArena(size=1 << 20)
    try:
        total = arena.free_bytes()
        a = arena.alloc(1000)
        b = arena.alloc(5000)
        assert a is not None and b is not None and a != b
        assert a % 64 == 0 and b % 64 == 0
        assert arena.free_bytes() < total
        assert arena.alloc(2 << 20) is None  # larger than the arena
        arena.free(a, 1000)
        arena.free(b, 5000)
        assert arena.free_bytes() == total  # spans coalesce back
        assert arena.alloc(total) == 0      # into one span again
    finally:
        arena.close()


def _same_host_endpoint(device=CPU) -> dt.DeviceEndpoint:
    ep = dt.DeviceEndpoint(device=device)
    ep.state = dt.ESTABLISHED
    ep.peer_info = {"process": "another-process", "host": dt._boot_id,
                    "xfer": False, "device_count": 1}
    return ep


@pytest.mark.parametrize("name", sorted(dt.DTYPES))
def test_shm_send_lane_every_dtype(name):
    """A same-host peer in another process: one copy into a span of the
    send arena, a descriptor on the wire, the span freed on ACK."""
    ep = _same_host_endpoint()
    arena = dt.default_send_arena()
    free0, shm0 = arena.free_bytes(), dt.lane_counters()["shm"]
    x = _tensor(name)
    meta, att = wire.RpcMeta(), IOBuf()
    assert ep.prepare_send([x, x[1:]], meta, att)
    spec = meta.tensors[0].sharding_spec
    assert spec.startswith(f"shm:{arena.name}:") and spec.endswith(":1")
    assert len(att) == 0  # no payload bytes on the RPC wire
    assert dt.lane_counters()["shm"] == shm0 + 1
    assert arena.free_bytes() < free0
    out, seq = dt.receive_tensors(meta, att)
    assert [o.dtype for o in out] == [x.dtype] * 2
    assert _bytes(out[0]) == _bytes(x) and _bytes(out[1]) == _bytes(x[1:])
    ep.on_ack(seq)
    assert arena.free_bytes() == free0
    assert ep.retained_count == 0 and ep.inflight_bytes == 0
    assert _bytes(out[0]) == _bytes(x)  # owned: the span's reuse is harmless


def test_full_arena_falls_through_to_the_wire():
    ep = _same_host_endpoint()
    arena = dt.default_send_arena()
    big = torch.zeros(arena.size + 64, dtype=torch.uint8)
    wire0 = dt.lane_counters()["wire"]
    meta, att = wire.RpcMeta(), IOBuf()
    ep.window_bytes = 2 * arena.size
    assert ep.prepare_send([big], meta, att)
    assert meta.tensors[0].sharding_spec == "wire::1"
    assert len(att) == big.numel()
    assert dt.lane_counters()["wire"] == wire0 + 1
    ep.on_ack(1)


def test_transfer_server_lane_plumbing(fakes):
    """Twin of test_device_lane.py::test_transfer_server_lane_plumbing on
    the port's fake: a cross-host peer with a transfer server selects the
    xfer lane; nothing rides the RPC wire; the pull lands on the device."""
    port, _ = fakes
    ep = dt.DeviceEndpoint(device=CPU)
    ep.state = dt.ESTABLISHED
    ep.peer_info = {"process": "other-proc", "host": "other-host",
                    "xfer": True, "device_count": 1}
    ep.resolve_xfer_addr("127.0.0.1")
    assert ep._my_xfer_addr == f"127.0.0.1:{port._port}"  # wildcard resolved

    xfer0 = dt.lane_counters()["xfer"]
    meta, att = wire.RpcMeta(), IOBuf()
    x = torch.arange(2048, dtype=torch.float32).reshape(32, 64) * 0.5
    assert ep.prepare_send([x], meta, att)
    spec = meta.tensors[0].sharding_spec
    assert spec == f"xfer|{ep._my_xfer_addr}|{ep._xfer_uuid_base + 1}|1"
    assert len(att) == 0
    assert dt.lane_counters()["xfer"] == xfer0 + 1

    out, seq = dt.receive_tensors(meta, att, endpoint=ep)
    assert torch.equal(out[0], x) and out[0].data_ptr() != x.data_ptr()
    assert port.published_count() == 0  # serving the pull released it
    ep.on_ack(seq)
    assert ep.retained_count == 0 and ep.inflight_bytes == 0


_LOCALITY = ("same_process", "same_host", "other_host")


@pytest.mark.parametrize("prefer", [False, True], ids=["flag_off", "flag_on"])
@pytest.mark.parametrize("peer_xfer", [False, True],
                         ids=["peer_no_xfer", "peer_xfer"])
@pytest.mark.parametrize("where", _LOCALITY)
def test_lane_choice_matches_reference(fakes, where, peer_xfer, prefer):
    _prefer_xfer(prefer)
    lanes = []
    for mod, endpoint, meta_cls, buf_cls, payload in (
            (dt, dt.DeviceEndpoint(device=CPU), wire.RpcMeta, IOBuf,
             torch.arange(64, dtype=torch.int32)),
            (ref_dt, ref_dt.DeviceEndpoint(), rpc_meta_pb2.RpcMeta, RefIOBuf,
             np.arange(64, dtype=np.int32))):
        endpoint.state = mod.ESTABLISHED
        endpoint.peer_info = {
            "process": mod._process_uuid if where == "same_process" else "p",
            "host": mod._boot_id if where != "other_host" else "other-host",
            "arena": "", "fabric": "", "xfer": peer_xfer, "device_count": 1}
        if peer_xfer:
            endpoint.resolve_xfer_addr("127.0.0.1")
        meta, att = meta_cls(), buf_cls()
        assert endpoint.prepare_send([payload], meta, att)
        spec = meta.tensors[0].sharding_spec
        lanes.append(spec.split("|")[0].split(":")[0])
        endpoint.on_ack(1)
    assert lanes[0] == lanes[1], lanes


_INTEROP_DTYPES = [n for n in sorted(dt.DTYPES) if "64" not in n]
# 64-bit dtypes are left out: the reference's xfer lane puts its arrays
# through jax.device_put, which (without x64) turns them into 32-bit ones


def _check_interop_round(client_push, client_pull, stored_of, lane, counters,
                         attach_len):
    for i, name in enumerate(_INTEROP_DTYPES):
        x = _tensor(name, shape=(4, 16), seed=i)
        key = f"{lane}-{name}"
        before = counters()[lane]
        cntl, resp = client_push(key, x)
        assert not cntl.failed(), cntl.error_text
        assert resp.ok
        assert counters()[lane] == before + 1
        assert attach_len(cntl.request_attachment) == 0
        stored = stored_of(key)
        assert _bytes(stored) == _bytes(x)
        cntl, pulled = client_pull(key)
        assert not cntl.failed(), cntl.error_text
        assert cntl._response_rpc_meta.tensors[0].sharding_spec.startswith(
            "xfer|" if lane == "xfer" else f"{lane}:")
        assert cntl._response_rpc_meta.attachment_size == 0
        assert _bytes(pulled[0]) == _bytes(x)


def test_interop_reference_client_port_server(fakes, monkeypatch):
    """The reference pushes to a port server and pulls back: shm with the
    flag off, then the fake xfer lane, where the port pulls from the
    reference's fake and the reference from the port's."""
    # both packages without the ring lane: a port server would advertise
    # its fabric, and the reference would try to build its library to push
    monkeypatch.setenv("BRPC_TPU_FABRIC", "0")
    port, ref = fakes
    svc = ts.TensorStoreService()
    srv = rpc.Server(rpc.ServerOptions(device=CPU))
    srv.add_service(svc)
    assert srv.start("127.0.0.1:0") == 0
    ch = ref_ts.make_device_channel(str(srv.listen_endpoint))
    try:
        client = ref_ts.TensorClient(ch)
        for lane in ("shm", "xfer"):
            _prefer_xfer(lane == "xfer")
            _check_interop_round(
                lambda k, x: client.push(k, [_numpy_of(x)]),
                client.pull, lambda k: svc.get(k)[0], lane,
                ref_dt.lane_counters, len)
        assert port.published_count() == 0 and ref.published_count() == 0
    finally:
        ch.close()
        srv.stop()


def test_interop_port_client_reference_server(fakes, monkeypatch):
    """The port pushes to a reference server and pulls back, over shm and
    over the fake xfer lane."""
    monkeypatch.setenv("BRPC_TPU_FABRIC", "0")  # no native fabric build
    get_task_control()
    port, ref = fakes
    svc = ref_ts.TensorStoreService()
    srv = ref_rpc.Server(ref_rpc.ServerOptions())
    srv.add_service(svc)
    assert srv.start("127.0.0.1:0") == 0
    ch = ts.make_device_channel(str(srv.listen_endpoint),
                                rpc.ChannelOptions(device=CPU))
    arena = dt.default_send_arena()
    free0 = arena.free_bytes()
    try:
        client = ts.TensorClient(ch)
        for lane in ("shm", "xfer"):
            _prefer_xfer(lane == "xfer")
            _check_interop_round(
                lambda k, x: client.push(k, [x]), client.pull,
                lambda k: np.asarray(svc.get(k)[0]), lane,
                dt.lane_counters, len)
        assert arena.free_bytes() == free0  # the reference's ACKs freed it
        assert port.published_count() == 0 and ref.published_count() == 0
    finally:
        ch.close()
        srv.stop()


XFER_SERVER_SCRIPT = r"""
import sys
sys.path.insert(0, ".")
from brpc_tpu_torch import rpc
from brpc_tpu_torch.rpc.tensor_service import TensorStoreService

srv = rpc.Server(rpc.ServerOptions(device="cpu"))
srv.add_service(TensorStoreService())
assert srv.start("127.0.0.1:0") == 0
print(srv.listen_endpoint.port, flush=True)
sys.stdin.readline()
srv.stop()
"""


def test_two_process_xfer_transfer(fakes, monkeypatch):
    """Twin of test_device_lane.py::test_two_process_xfer_transfer, port to
    port: the server process runs the fake with prefer-xfer set from its
    environment. Flag off here: the push rides the shm arena, the pull
    comes back by xfer. Flag on: both by xfer, the wildcard address
    resolved, nothing on the RPC wire, publications released by the
    pulls."""
    port, _ = fakes
    # no ring lane on either side: the push with the flag off is the shm
    # lane's, as between two reference processes with the fabric off
    monkeypatch.setenv("BRPC_TPU_FABRIC", "0")
    env = dict(os.environ, BRPC_TPU_FAKE_XFER="1",
               BRPC_TPU_DEVICE_TRANSPORT_PREFER_XFER="1")
    env.pop("PYTHONPATH", None)
    proc = subprocess.Popen([sys.executable, "-c", XFER_SERVER_SCRIPT],
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            text=True, cwd=REPO, env=env)
    ch = None
    try:
        server_port = int(proc.stdout.readline())
        ch = ts.make_device_channel(f"127.0.0.1:{server_port}",
                                    rpc.ChannelOptions(device=CPU))
        client = ts.TensorClient(ch)
        arena = dt.default_send_arena()
        free0 = arena.free_bytes()
        x = torch.arange(3000, dtype=torch.float32).reshape(60, 50) * 1.5
        for push_lane in ("shm", "xfer"):
            _prefer_xfer(push_lane == "xfer")
            before = dt.lane_counters()[push_lane]
            cntl, resp = client.push(f"xw-{push_lane}", [x])
            assert not cntl.failed(), cntl.error_text
            assert resp.ok
            ep = cntl._current_sock.app_state
            assert ep.state == dt.ESTABLISHED and not ep.same_process
            assert ep.peer_info["xfer"] is True
            assert ep._my_xfer_addr == f"127.0.0.1:{port._port}"
            assert dt.lane_counters()[push_lane] == before + 1
            assert len(cntl.request_attachment) == 0
            assert port.published_count() == 0
            assert ep.retained_count == 0 and ep.inflight_bytes == 0
            assert arena.free_bytes() == free0

            cntl, pulled = client.pull(f"xw-{push_lane}")
            assert not cntl.failed(), cntl.error_text
            assert cntl._response_rpc_meta.tensors[0].sharding_spec.startswith(
                "xfer|127.0.0.1:")
            assert torch.equal(pulled[0], x)
    finally:
        if ch is not None:
            ch.close()
        proc.stdin.close()
        proc.wait(timeout=10)


class _Publisher:
    """A transfer server stand-in whose publish or release raises."""

    same_host_only = False

    def __init__(self, publish_raises=False, cancel_raises=False):
        self.publish_raises = publish_raises
        self.cancel_raises = cancel_raises

    def address(self):
        return "0.0.0.0:1"

    def await_pull(self, uid, tensors):
        if self.publish_raises:
            raise RuntimeError("publish failed")

    def cancel(self, uid):
        if self.cancel_raises:
            raise RuntimeError("release failed")


def _xfer_endpoint(publisher) -> dt.DeviceEndpoint:
    dt._xfer_server = publisher
    ep = dt.DeviceEndpoint(device=CPU)
    ep.state = dt.ESTABLISHED
    ep.peer_info = {"process": "p", "host": "other-host", "xfer": True,
                    "device_count": 1}
    ep.resolve_xfer_addr("127.0.0.1")
    return ep


def test_failing_lane_reopens_the_window(fakes):
    ep = _xfer_endpoint(_Publisher(publish_raises=True))
    with pytest.raises(RuntimeError, match="publish failed"):
        ep.prepare_send([torch.ones(1024)], wire.RpcMeta(), IOBuf())
    assert ep.inflight_bytes == 0 and ep.retained_count == 0


def test_failing_release_still_opens_the_window(fakes):
    ep = _xfer_endpoint(_Publisher(cancel_raises=True))
    ep.window_bytes = 4096
    assert ep.prepare_send([torch.ones(1024)], wire.RpcMeta(), IOBuf())
    assert ep.inflight_bytes == 4096
    ep.on_ack(1)
    assert ep.inflight_bytes == 0 and ep.retained_count == 0
    # and the window really is open again
    assert ep.prepare_send([torch.ones(1024)], wire.RpcMeta(), IOBuf(),
                           timeout_s=0.1)


def _one_shot_server(reply: bytes, read: int):
    """A listener that reads ``read`` bytes from one peer, answers
    ``reply`` and hangs up."""
    lsock = socket.socket()
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(1)

    def serve():
        conn, _ = lsock.accept()
        with conn:
            got = b""
            while len(got) < read:
                chunk = conn.recv(read - len(got))
                if not chunk:
                    break
                got += chunk
            conn.sendall(reply)
        lsock.close()

    threading.Thread(target=serve, daemon=True).start()
    return f"127.0.0.1:{lsock.getsockname()[1]}"


_SPECS = [(torch.float32, (4, 4), 64)]
_IPC_ENTRY = ipc.ENTRY.pack(bytes(64), 0, 64, bytes(64))
_MALFORMED = {
    ("ipc", "count"): ipc.REPLY.pack(ipc.MAGIC, ipc.OK, 2) + _IPC_ENTRY * 2,
    ("ipc", "nbytes"): ipc.REPLY.pack(ipc.MAGIC, ipc.OK, 1)
    + ipc.ENTRY.pack(bytes(64), 0, 65, bytes(64)),
    ("ipc", "short"): ipc.REPLY.pack(ipc.MAGIC, ipc.OK, 1) + _IPC_ENTRY[:100],
    ("fake", "count"): (2).to_bytes(4, "big"),
    ("fake", "nbytes"): (1).to_bytes(4, "big") + (65).to_bytes(8, "big"),
    ("fake", "short"): (1).to_bytes(4, "big") + (64).to_bytes(8, "big")
    + bytes(10),
}


@pytest.mark.parametrize("kind,fault", sorted(_MALFORMED))
def test_malformed_transfer_reply_is_refused(kind, fault):
    conn_cls = (ipc.CudaIpcConnection if kind == "ipc"
                else FakeTransferConnection)
    addr = _one_shot_server(_MALFORMED[kind, fault],
                            ipc.REQUEST.size if kind == "ipc" else 8)
    with pytest.raises(ValueError, match="xfer lane"):
        conn_cls(addr).pull(5, _SPECS, CPU)


def test_pull_from_a_server_of_the_other_kind_fails_fast(fakes):
    """A CUDA IPC pull from the fake, and a fake pull from an IPC server,
    each fail with a ValueError naming the lane: the first at once, the
    second after the IPC server's one-second wait for a whole request."""
    port, _ = fakes
    port.await_pull(9, [torch.ones(16)])
    with pytest.raises(ValueError, match=r"xfer lane \(CUDA IPC\).*not a "
                                         r"CUDA IPC transfer server"):
        ipc.CudaIpcConnection(f"127.0.0.1:{port._port}").pull(9, _SPECS[:1],
                                                               CPU)
    server = ipc.CudaIpcTransferServer()
    try:
        with pytest.raises(ValueError, match=r"xfer lane \(fake transfer\)"):
            port.connect(server.address()).pull(9, _SPECS, CPU)
    finally:
        server.stop()
