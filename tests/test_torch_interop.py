"""Wire compatibility between brpc_tpu and its PyTorch port.

* The port's hand-written proto3 codec gives protobuf's bytes, both ways,
  on randomised metas and on the six Tensor* messages.
* ``pack_frame`` gives the reference's frame.
* Live round trips in each direction on the CPU: a reference device
  channel against a port server (the reference stages its push in its
  shared arena, so this drives the port's shm receive; the port stages
  its pull answers in its own arena, which the reference attaches), and a
  port device channel against a reference server (shm both ways, then the
  ACKs that free the spans).
* The port and chip_smoke.py import no jax, ml_dtypes, protobuf or
  brpc_tpu module; every module of the package is imported, the
  client's modules by name.
"""
import os
import subprocess
import sys

import ml_dtypes
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from brpc_tpu import rpc as ref_rpc
from brpc_tpu.bthread import get_task_control
from brpc_tpu.butil.iobuf import IOBuf as RefIOBuf
from brpc_tpu.rpc import device_transport as ref_dt
from brpc_tpu.rpc import tensor_service as ref_ts
from brpc_tpu.rpc import tpu_std_protocol as ref_proto
from brpc_tpu.rpc.proto import rpc_meta_pb2, tensor_service_pb2
from brpc_tpu_torch import rpc
from brpc_tpu_torch.butil.iobuf import IOBuf
from brpc_tpu_torch.rpc import device_transport as port_dt
from brpc_tpu_torch.rpc import tensor_service as ts
from brpc_tpu_torch.rpc import tpu_std_protocol as proto
from brpc_tpu_torch.rpc.proto import wire

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

i32 = st.integers(-(1 << 31), (1 << 31) - 1)
i64 = st.integers(-(1 << 63), (1 << 63) - 1)
text = st.text(max_size=12)

request_st = st.fixed_dictionaries({}, optional={
    "service_name": text, "method_name": text, "log_id": i64,
    "trace_id": i64, "span_id": i64, "parent_span_id": i64,
    "timeout_ms": i32, "request_id": text, "auth_data": text})
response_st = st.fixed_dictionaries({}, optional={
    "error_code": i32, "error_text": text})
tensor_st = st.fixed_dictionaries({}, optional={
    "dtype": text, "shape": st.lists(i64, max_size=4),
    "sharding_spec": text, "nbytes": i64})
meta_st = st.fixed_dictionaries({}, optional={
    "request": request_st, "response": response_st, "compress_type": i32,
    "correlation_id": i64, "attachment_size": i64,
    "tensors": st.lists(tensor_st, max_size=3), "stream_id": i32})

# field that marks an empty sub-message present when set to its default
_TOUCH = {"request": "log_id", "response": "error_code"}


def _fill(msg, spec):
    """Apply one spec to a protobuf message or a port message alike."""
    for k, v in spec.items():
        if k in _TOUCH:
            sub = getattr(msg, k)
            if not v:
                setattr(sub, _TOUCH[k], 0)
            _fill(sub, v)
        elif k == "tensors":
            for t in v:
                _fill(msg.tensors.add(), t)
        elif k == "shape":
            msg.shape.extend(v)
        else:
            setattr(msg, k, v)


@settings(max_examples=300, deadline=None)
@given(meta_st)
def test_rpc_meta_bytes_equal_protobuf(spec):
    ref, port = rpc_meta_pb2.RpcMeta(), wire.RpcMeta()
    _fill(ref, spec)
    _fill(port, spec)
    data = ref.SerializeToString()
    assert port.SerializeToString() == data
    back = wire.RpcMeta()
    back.ParseFromString(data)
    assert back.SerializeToString() == data
    assert back.HasField("request") == ref.HasField("request")
    assert back.HasField("response") == ref.HasField("response")
    again = rpc_meta_pb2.RpcMeta()
    again.ParseFromString(port.SerializeToString())
    assert again == ref


_SERVICE_MESSAGES = [
    ("TensorPushRequest", {"name": text}),
    ("TensorPushResponse", {"ok": st.booleans(), "ack_seq": i64}),
    ("TensorPullRequest", {"name": text}),
    ("TensorPullResponse", {"found": st.booleans()}),
    ("TensorAckRequest", {"seq": i64}),
    ("TensorAckResponse", {"ok": st.booleans()}),
]


@pytest.mark.parametrize("name,fields", _SERVICE_MESSAGES,
                         ids=[m[0] for m in _SERVICE_MESSAGES])
def test_service_message_bytes_equal_protobuf(name, fields):
    @settings(max_examples=50, deadline=None)
    @given(st.fixed_dictionaries({}, optional=fields))
    def check(spec):
        ref = getattr(tensor_service_pb2, name)(**spec)
        port = getattr(wire, name)(**spec)
        assert port.SerializeToString() == ref.SerializeToString()
        back = getattr(wire, name)()
        back.ParseFromString(ref.SerializeToString())
        assert back == port

    check()


def test_decoder_skips_unknown_fields():
    """A native server's lame-duck bit (RpcMeta varint field 8) and other
    unknown fields are skipped."""
    ref = rpc_meta_pb2.RpcMeta(correlation_id=9)
    ref.response.error_code = 0
    data = ref.SerializeToString() + bytes([8 << 3, 1]) + bytes(
        [(12 << 3) | 2, 2, 0xAA, 0xBB]) + bytes([(13 << 3) | 5, 1, 2, 3, 4])
    port = wire.RpcMeta()
    port.ParseFromString(data)
    assert port.correlation_id == 9 and port.HasField("response")
    with pytest.raises(wire.DecodeError):
        wire.RpcMeta().ParseFromString(data[:-2])


def test_pack_frame_equals_reference():
    frames = []
    for meta, buf_cls in ((rpc_meta_pb2.RpcMeta(), RefIOBuf),
                          (wire.RpcMeta(), IOBuf)):
        meta.request.service_name = "TensorStore"
        meta.request.method_name = "Push"
        meta.request.timeout_ms = 9999
        meta.correlation_id = 42
        t = meta.tensors.add()
        t.dtype = "bfloat16"
        t.shape.extend([4, 512])
        t.nbytes = 4096
        t.sharding_spec = "wire::3"
        att = buf_cls()
        att.append(b"\x01\x02" * 2048)
        frame = (ref_proto.pack_frame if buf_cls is RefIOBuf
                 else proto.pack_frame)(meta, b"\n\x02w0", att)
        frames.append(frame.to_bytes())
    assert frames[0] == frames[1]


def _payloads():
    rng = np.random.default_rng(11)
    return {
        "f32": rng.normal(size=(16, 33)).astype(np.float32),
        "bf16": rng.normal(size=(8, 64)).astype(ml_dtypes.bfloat16),
        "i32": rng.integers(-(1 << 31), 1 << 31, size=(4, 512),
                            dtype=np.int64).astype(np.int32),
    }


def _torch_of(a: np.ndarray) -> torch.Tensor:
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _raw(x) -> bytes:
    if isinstance(x, torch.Tensor):
        return x.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(x).tobytes()


def test_reference_client_against_port_server(monkeypatch):
    # both packages without the ring lane: a port server would advertise
    # its fabric, and the reference would try to build its library to push
    monkeypatch.setenv("BRPC_TPU_FABRIC", "0")
    svc = ts.TensorStoreService()
    srv = rpc.Server(rpc.ServerOptions(device="cpu"))
    srv.add_service(svc)
    assert srv.start("127.0.0.1:0") == 0
    ch = ref_ts.make_device_channel(str(srv.listen_endpoint))
    arena = port_dt.default_send_arena()
    free0 = arena.free_bytes()
    try:
        client = ref_ts.TensorClient(ch)
        for name, a in _payloads().items():
            shm0 = ref_dt.lane_counters()["shm"]
            cntl, resp = client.push(name, [a])
            assert not cntl.failed(), cntl.error_text
            assert resp.ok
            assert ref_dt.lane_counters()["shm"] == shm0 + 1  # the shm lane
            stored = svc.get(name)[0]
            assert str(stored.dtype) == f"torch.{a.dtype.name}"
            assert tuple(stored.shape) == a.shape
            assert _raw(stored) == _raw(a)
            cntl, pulled = client.pull(name)
            assert not cntl.failed(), cntl.error_text
            # the port stages a same-host pull in its send arena; the
            # reference client attaches it by name
            assert cntl._response_rpc_meta.tensors[0].sharding_spec.startswith(
                f"shm:{arena.name}:")
            assert pulled[0].dtype == a.dtype and _raw(pulled[0]) == _raw(a)
        # every pull was ACKed: the port freed its staged spans
        assert arena.free_bytes() == free0
    finally:
        ch.close()
        srv.stop()


def test_port_client_against_reference_server(monkeypatch):
    # the reference server would arm its native descriptor-ring fabric
    # (building the native library); the port never advertises that lane
    monkeypatch.setenv("BRPC_TPU_FABRIC", "0")
    # the first sizing of the process-wide bthread pool sticks: take the
    # default, so later tests in this process see what they would alone
    get_task_control()
    svc = ref_ts.TensorStoreService()
    srv = ref_rpc.Server(ref_rpc.ServerOptions())
    srv.add_service(svc)
    assert srv.start("127.0.0.1:0") == 0
    ch = ts.make_device_channel(str(srv.listen_endpoint),
                                rpc.ChannelOptions(device="cpu"))
    arena = ref_dt.default_send_arena()
    free0 = arena.free_bytes()
    try:
        client = ts.TensorClient(ch)
        for name, a in _payloads().items():
            x = _torch_of(a)
            cntl, resp = client.push(name, [x])
            assert not cntl.failed(), cntl.error_text
            assert resp.ok and resp.ack_seq > 0
            assert cntl._current_sock.app_state.state == 2  # ESTABLISHED
            stored = np.asarray(svc.get(name)[0])
            assert stored.dtype == a.dtype and _raw(stored) == _raw(a)
            cntl, pulled = client.pull(name)
            assert not cntl.failed(), cntl.error_text
            spec = cntl._response_rpc_meta.tensors[0].sharding_spec
            assert spec.startswith("shm:")
            assert pulled[0].dtype == x.dtype and _raw(pulled[0]) == _raw(a)
        # every pull was ACKed: the reference freed its staged spans
        assert arena.free_bytes() == free0
    finally:
        ch.close()
        srv.stop()


# the reference-grade client: each must be among the modules walked
CLIENT_MODULES = [f"brpc_tpu_torch.{m}" for m in (
    "butil.endpoint", "butil.flags", "butil.dbd", "bvar.variable",
    "bvar.reducer", "bthread.timer_thread", "bthread.id", "rpc.socket",
    "rpc.socket_map", "rpc.controller", "rpc.load_balancer",
    "rpc.naming_service", "rpc.circuit_breaker", "rpc.cluster_recover",
    "rpc.channel", "rpc.combo_channels", "rpc.tensor_service",
    "rpc.hpack", "rpc.h2_protocol", "butil.status", "butil.timeutil",
    "butil.containers", "butil.pools", "bvar.collector",
    "bvar.multi_dimension", "fleet", "fleet.hist", "fleet.slo",
    "rpc.proto.legacy_meta", "rpc.pb_dispatch", "rpc.hulu_protocol",
    "rpc.sofa_protocol", "rpc.redis", "rpc.redis_protocol", "rpc.memcache",
    "rpc.memcache_protocol", "rpc.thrift", "rpc.thrift_protocol",
    "mcpack2pb", "rpc.nshead_protocol", "rpc.authenticator",
    "rpc.legacy_nshead_family", "rpc.mongo", "rpc.mongo_protocol",
    "rpc.esp_protocol", "rpc.proto.mapdemo", "mcpack2pb_gen", "rpc.amf",
    "rpc.flv", "rpc.mpegts", "rpc.rtmp_protocol", "rpc.rtmp_client")]
# the examples' and the tools' twins, each a program a user starts
PROGRAM_MODULES = [f"brpc_tpu_torch.{m}" for m in (
    "examples.echo", "examples.asynchronous_echo",
    "examples.multi_threaded_echo", "examples.streaming_echo",
    "examples.http_server", "examples.session_data",
    "examples.backup_request", "examples.auto_concurrency_limiter",
    "examples.cascade_echo", "examples.partition_echo",
    "examples.selective_echo", "examples.dynamic_partition_echo",
    "examples.tensor_transport", "examples.device_performance",
    "examples.parallel_echo", "examples.grpc_echo", "examples.redis_kv",
    "examples.memcache_kv", "examples.thrift_echo",
    "examples.legacy_pbrpc_echo", "examples.nshead_extension",
    "examples.rtmp_relay",
    "tools.mcpack2pb_gen", "tools.rpc_press",
    "tools.rpc_replay", "tools.rpc_view", "tools.parallel_http", "tools.trackme_server",
    "rpc.trackme")]


def test_port_imports_no_jax_protobuf_or_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import brpc_tpu_torch\n"
        "for m in pkgutil.walk_packages(brpc_tpu_torch.__path__,"
        " 'brpc_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0].startswith("
        "('jax', 'ml_dtypes')) or m.split('.')[0] in ('brpc_tpu', 'grpc')"
        " or m.startswith('google.protobuf'))\n"
        f"missing = sorted(set({CLIENT_MODULES + PROGRAM_MODULES!r})"
        " - set(sys.modules))\n"
        "print(bad, missing)\n"
        "sys.exit(1 if bad or missing else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
