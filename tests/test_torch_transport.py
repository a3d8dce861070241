"""Tensor-lane tests of the PyTorch port, on the CPU (``device="cpu"``).

Twins of tests/test_tensor_transport.py: handshake, pool accounting and
lifetime, wire prepare/receive and the send window, push/pull round trips
byte for byte in every wire dtype, the in-process zero-copy lane, and the
rule that nothing falls back to the CPU when the card was meant.
"""
import threading

import numpy as np
import pytest
import torch

from brpc_tpu_torch import rpc
from brpc_tpu_torch.butil.iobuf import IOBuf
from brpc_tpu_torch.entry import entry
from brpc_tpu_torch.rpc import device_transport as dt
from brpc_tpu_torch.rpc import errors
from brpc_tpu_torch.rpc.proto import wire
from brpc_tpu_torch.rpc.service import Service, rpc_method
from brpc_tpu_torch.rpc.tensor_service import (
    TensorClient,
    TensorStoreService,
    make_device_channel,
)
from brpc_tpu_torch.tensor import ModelConfig, init_params

CPU = "cpu"


class _SlowService(Service):
    SERVICE_NAME = "Slow"

    def __init__(self):
        self.release = threading.Event()

    @rpc_method(wire.TensorAckRequest, wire.TensorAckResponse)
    def Wait(self, cntl, request, response, done):
        self.release.wait(5.0)
        response.ok = True
        done()


@pytest.fixture(scope="module")
def store_server():
    svc = TensorStoreService()
    slow = _SlowService()
    srv = rpc.Server(rpc.ServerOptions(device=CPU))
    assert srv.add_service(svc) == 0
    assert srv.add_service(slow) == 0
    assert srv.start("127.0.0.1:0") == 0
    yield srv, svc, slow
    slow.release.set()
    srv.stop()


@pytest.fixture
def device_channel(store_server):
    ch = make_device_channel(str(store_server[0].listen_endpoint),
                             rpc.ChannelOptions(device=CPU))
    yield ch
    ch.close()


@pytest.fixture
def plain_channel(store_server):
    ch = rpc.Channel()
    assert ch.init(str(store_server[0].listen_endpoint)) == 0
    yield ch
    ch.close()


def _bytes(t: torch.Tensor) -> bytes:
    return t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def test_local_device_info():
    info = dt.local_device_info(CPU)
    assert info["device_count"] == 1 and info["platform"] == "cpu"
    # the send arena is advertised; the CPU has no transfer server unless
    # the fake is switched on
    assert info["arena"] == dt.default_send_arena().name
    assert (info["fabric"], info["xfer"]) == ("", False)
    assert list(info) == ["process", "host", "arena", "fabric", "xfer",
                          "platform", "device_count"]


def test_block_pool_acquire_release():
    pool = dt.DeviceBlockPool(blocks_per_class=2, device=CPU)
    assert all(v == 2 for v in pool.stats().values())
    got = pool.acquire(10_000)  # -> 64KB class
    assert got is not None
    size, entry_ = got
    assert size == 64 << 10 and entry_[0].numel() == size
    assert pool.stats()[size] == 1
    pool.release(size, entry_)
    assert pool.stats()[size] == 2
    assert pool.acquire(10 << 20) is None  # above the largest class


def test_block_pool_put_via_pool_roundtrip():
    pool = dt.DeviceBlockPool(blocks_per_class=2, device=CPU)
    src = torch.arange(640, dtype=torch.float32).reshape(16, 40)
    before, acquired = pool.stats(), pool.acquired
    out = pool.put_via_pool(src.reshape(-1).view(torch.uint8), torch.float32,
                            (16, 40))
    assert torch.equal(out, src)
    assert pool.stats() == before  # every block is back home
    assert pool.acquired == acquired + 1
    src8 = torch.arange(100, dtype=torch.uint8)
    assert torch.equal(pool.put_via_pool(src8.clone(), torch.uint8, (100,)),
                       src8)
    # oversized: a plain copy, no block taken
    big = torch.zeros(4 << 20, dtype=torch.uint8)
    out_big = pool.put_via_pool(big, torch.uint8, (4 << 20,))
    assert out_big.shape == (4 << 20,) and pool.acquired == acquired + 2
    assert out_big.data_ptr() != big.data_ptr()


def test_block_pool_result_does_not_alias_a_refilled_block():
    """A result must own its memory: refilling the same (only) block of its
    class afterwards leaves the first result unchanged."""
    pool = dt.DeviceBlockPool(blocks_per_class=1, device=CPU)
    first_src = torch.full((1024,), 7, dtype=torch.int32)  # 4 KB -> 8K class
    first = pool.put_via_pool(first_src.view(torch.uint8), torch.int32, (1024,))
    second_src = torch.full((2048,), -1, dtype=torch.int32)  # same class
    second = pool.put_via_pool(second_src.view(torch.uint8), torch.int32,
                               (2048,))
    assert pool.acquired == 2
    assert torch.equal(first, first_src)
    assert torch.equal(second, second_src)


def test_endpoint_prepare_and_receive_wire():
    ep = dt.DeviceEndpoint()
    ep.state = dt.FALLBACK_TCP
    meta = wire.RpcMeta()
    att = IOBuf()
    tensors = [torch.arange(12, dtype=torch.float32).reshape(3, 4),
               torch.ones((2, 2), dtype=torch.int32)]
    assert ep.prepare_send(tensors, meta, att)
    assert [t.dtype for t in meta.tensors] == ["float32", "int32"]
    assert meta.tensors[0].sharding_spec == "wire::1"
    assert ep.inflight_bytes == 48 + 16
    assert ep.retained_count == 1
    out, seq = dt.receive_tensors(meta, att)
    assert torch.equal(out[0], tensors[0]) and torch.equal(out[1], tensors[1])
    ep.on_ack(seq)
    assert ep.inflight_bytes == 0 and ep.retained_count == 0


def test_endpoint_window_blocks():
    ep = dt.DeviceEndpoint(window_bytes=100)
    ep.state = dt.FALLBACK_TCP
    big = torch.zeros(200, dtype=torch.uint8)
    assert not ep.prepare_send([big], wire.RpcMeta(), IOBuf(), timeout_s=0.05)


def test_receive_rejects_inconsistent_meta():
    meta = wire.RpcMeta()
    t = meta.tensors.add(dtype="float32", nbytes=12, sharding_spec="wire::1")
    t.shape.extend([2, 2])
    with pytest.raises(ValueError):
        dt.receive_tensors(meta, IOBuf(b"\0" * 12))
    t.nbytes = 16
    with pytest.raises(ValueError):  # attachment shorter than the tensors
        dt.receive_tensors(meta, IOBuf(b"\0" * 12))
    t.dtype = "complex64"
    with pytest.raises(ValueError):
        dt.receive_tensors(meta, IOBuf(b"\0" * 16))


def test_push_pull_roundtrip(store_server, device_channel):
    _, svc, _ = store_server
    client = TensorClient(device_channel)
    x = torch.from_numpy(
        np.random.default_rng(0).normal(size=(8, 16)).astype(np.float32))
    cntl, resp = client.push("w0", [x])
    assert not cntl.failed(), cntl.error_text
    assert resp.ok
    assert torch.equal(svc.get("w0")[0], x)
    cntl2, pulled = client.pull("w0")
    assert not cntl2.failed(), cntl2.error_text
    assert torch.equal(pulled[0], x)


def test_pull_missing(device_channel):
    cntl, tensors = TensorClient(device_channel).pull("no-such-tensor")
    assert not cntl.failed()
    assert tensors is None


def test_handshake_establishes(device_channel):
    cntl, _ = TensorClient(device_channel).push(
        "hs", [torch.ones(4, dtype=torch.float32)])
    assert not cntl.failed(), cntl.error_text
    ep = cntl._current_sock.app_state
    assert isinstance(ep, dt.DeviceEndpoint)
    assert ep.state == dt.ESTABLISHED
    assert ep.peer_info["device_count"] == 1
    assert ep.peer_info["platform"] == "cpu"


def test_same_process_zero_copy(store_server, device_channel):
    """In process the receiver gets the sender's tensor itself: same
    storage, no copy, both ways."""
    _, svc, _ = store_server
    client = TensorClient(device_channel)
    x = torch.arange(32, dtype=torch.float32)
    cntl, _ = client.push("zc", [x])
    assert not cntl.failed(), cntl.error_text
    assert svc.get("zc")[0].data_ptr() == x.data_ptr()
    cntl, pulled = client.pull("zc")
    assert not cntl.failed(), cntl.error_text
    assert pulled[0].data_ptr() == x.data_ptr()
    assert cntl._response_rpc_meta.tensors[0].sharding_spec.startswith("inproc:")


@pytest.mark.parametrize("name", sorted(dt.DTYPES))
def test_every_dtype_byte_identical_over_the_wire(plain_channel, name):
    """A plain channel (no handshake) takes the wire lane; a pull with
    device= lands the bytes through the block pool."""
    dtype, _ = dt.DTYPES[name]
    g = torch.Generator().manual_seed(7)
    raw = torch.randint(0, 256, (3 * 5 * 8 * 4,), dtype=torch.uint8,
                        generator=g)
    if dtype == torch.bool:
        raw = raw % 2
    x = raw.view(dtype).reshape(3, 5, -1)
    client = TensorClient(plain_channel)
    cntl, _ = client.push(f"dt-{name}", [x])
    assert not cntl.failed(), cntl.error_text
    pool = dt.default_block_pool(CPU)
    acquired = pool.acquired
    cntl, pulled = client.pull(f"dt-{name}", device=CPU)
    assert not cntl.failed(), cntl.error_text
    meta = cntl._response_rpc_meta.tensors[0]
    assert meta.dtype == name and meta.sharding_spec.startswith("wire::")
    assert pool.acquired == acquired + 1
    assert pulled[0].dtype == dtype and pulled[0].shape == x.shape
    assert _bytes(pulled[0]) == _bytes(x)


def test_call_times_out(store_server, plain_channel):
    cntl = rpc.Controller()
    cntl.timeout_ms = 50
    plain_channel.call_method("Slow.Wait", cntl, wire.TensorAckRequest(seq=1),
                              wire.TensorAckResponse())
    assert cntl.error_code == errors.ERPCTIMEDOUT
    store_server[2].release.set()


def test_unknown_method_fails(plain_channel):
    cntl = rpc.Controller()
    plain_channel.call_method("TensorStore.Nope", cntl,
                              wire.TensorAckRequest(), wire.TensorAckResponse())
    assert cntl.error_code == errors.ENOMETHOD


def test_iobuf_device_block_materializes_once():
    x = torch.arange(6, dtype=torch.bfloat16).reshape(2, 3)
    buf = IOBuf(b"head")
    buf.append_device_array(x)
    buf.append(b"tail")
    assert len(buf) == 4 + 12 + 4
    head = buf.cut(4)
    assert head.to_bytes() == b"head"
    assert bytes(buf.cutn_bytes(12)) == _bytes(x)
    assert buf.to_bytes() == b"tail"


def test_no_fallback_without_cuda():
    """Where CUDA is missing, entry points that default to the card raise
    instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("the card is present: its defaults are valid here")
    cfg = ModelConfig()
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA"):
        dt.DeviceBlockPool()
    with pytest.raises(RuntimeError, match="CUDA"):
        dt.local_device_info()
    with pytest.raises(RuntimeError, match="CUDA"):
        entry()
