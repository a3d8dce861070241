"""The port's tpu_std compression and frame hooks held against brpc_tpu's,
on the CPU, with threads.

* gzip, zlib and snappy give the same bytes in both packages on seeded
  inputs (empty, 1 byte, 64 KiB random, 64 KiB repetitive), and each
  package decompresses the other's.
* A compressed call port -> reference and reference -> port with each
  codec: the answer is right, the response came compressed alike, and
  the server's span saw the compressed request's size.
* An unknown type: ``compress`` raises the same ValueError in both; a
  client fails the call with the same EREQUEST; a server answers a frame
  that asks for it with the same EREQUEST.
* A request frame carrying ``trace_id``, ``span_id`` and
  ``compress_type`` with fixed ids is byte-equal in both packages, and
  so are a frame's tensor meta and attachment (``attach_arrays``), which
  ``extract_arrays`` reads back across the packages.
* ``close_connection()`` in a handler: the response arrives, then the
  connection closes, in both packages.
* A tensor push with gzip: the port compresses the request message and
  lands the tensor bit-equal; the reference fails it with 1003, its
  meta saying 0 over a gzip payload (ROADMAP queue C #18).

Servers are module-scoped; every wait has a deadline of WAIT_S.
"""
import socket
import struct

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from brpc_tpu import native as ref_native
from brpc_tpu import rpc as ref_rpc
from brpc_tpu import rpcz as ref_rpcz
from brpc_tpu.bthread import get_task_control as ref_get_task_control
from brpc_tpu.butil.iobuf import IOBuf as RefIOBuf
from brpc_tpu.rpc import compress as ref_compress
from brpc_tpu.rpc import tensor_service as ref_ts
from brpc_tpu.rpc import tpu_std_protocol as ref_tpu_std
from brpc_tpu.rpc.proto import echo_pb2, rpc_meta_pb2
from brpc_tpu_torch import rpc, rpcz
from brpc_tpu_torch.butil.iobuf import IOBuf
from brpc_tpu_torch.rpc import compress, errors
from brpc_tpu_torch.rpc import tensor_service as port_ts
from brpc_tpu_torch.rpc import tpu_std_protocol as tpu_std
from brpc_tpu_torch.rpc.proto import wire

WAIT_S = 10.0  # a deadline under load, never a sleep
CODECS = {"gzip": compress.COMPRESS_GZIP, "zlib": compress.COMPRESS_ZLIB,
          "snappy": compress.COMPRESS_SNAPPY}


def _inputs():
    rng = np.random.default_rng(7)
    return {"empty": b"", "one_byte": b"\x9c",
            "random_64KiB": rng.integers(0, 256, 64 << 10, np.uint8).tobytes(),
            "repetitive_64KiB": (rng.integers(0, 256, 1000, np.uint8).tobytes()
                                 * 66)[:64 << 10]}


INPUTS = _inputs()


@pytest.mark.parametrize("data", INPUTS, ids=list(INPUTS))
@pytest.mark.parametrize("codec", CODECS)
def test_codecs_give_the_reference_bytes(codec, data):
    ctype, raw = CODECS[codec], INPUTS[data]
    assert ctype == getattr(ref_compress, f"COMPRESS_{codec.upper()}")
    ours = compress.compress(raw, ctype)
    theirs = ref_compress.compress(raw, ctype)
    assert ours == theirs
    assert compress.decompress(theirs, ctype) == raw
    assert ref_compress.decompress(ours, ctype) == raw
    if data == "repetitive_64KiB":
        assert len(ours) < len(raw) // 4


def test_unknown_type_is_refused_alike():
    for mod in (compress, ref_compress):
        for fn in (mod.compress, mod.decompress):
            with pytest.raises(ValueError, match="unknown compress type 9"):
                fn(b"x", 9)
            assert fn(b"", 9) == b""  # empty data passes, as in brpc_tpu


def test_corrupt_payload_is_a_value_error():
    bad = compress.compress(INPUTS["repetitive_64KiB"],
                            compress.COMPRESS_GZIP)[:100]
    for ctype in (compress.COMPRESS_GZIP, compress.COMPRESS_SNAPPY):
        with pytest.raises(ValueError):
            compress.decompress(bad, ctype)


# -- calls across the packages ------------------------------------------------

def _service(mod, msgs):
    class Codec(mod.Service):
        @mod.rpc_method(msgs.EchoRequest, msgs.EchoResponse)
        def Echo(self, cntl, request, response, done):
            response.message = request.message
            done()

        @mod.rpc_method(msgs.EchoRequest, msgs.EchoResponse)
        def Close(self, cntl, request, response, done):
            response.message = "bye"
            cntl.close_connection()
            done()

    return Codec()


PKGS = {"port": (rpc, wire, rpcz), "ref": (ref_rpc, echo_pb2, ref_rpcz)}
STORES = {"port": port_ts, "ref": ref_ts}


@pytest.fixture(scope="module")
def servers():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BRPC_TPU_FABRIC", "0")  # no native fabric build
        # the reference's rpcz drains native spans, which would build its
        # native runtime (seconds, then fail) at each find_trace
        mp.setattr(ref_native, "available", lambda: False)
        ref_get_task_control()  # the bthread pool's first sizing sticks
        out = {}
        try:
            for pkg, (mod, msgs, _) in PKGS.items():
                opts = (mod.ServerOptions(device="cpu") if pkg == "port" else
                        mod.ServerOptions(num_threads=2,
                                          has_builtin_services=False))
                srv = mod.Server(opts)
                srv.store = STORES[pkg].TensorStoreService()
                for svc in (_service(mod, msgs), srv.store):
                    assert srv.add_service(svc) == 0
                assert srv.start("127.0.0.1:0") == 0
                out[pkg] = srv
            yield out
        finally:
            for srv in out.values():
                srv.stop()


DIRECTIONS = [("port", "ref"), ("ref", "port")]


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("client,server", DIRECTIONS,
                         ids=[f"{c}-to-{s}" for c, s in DIRECTIONS])
def test_compressed_call_across_packages(servers, client, server, codec):
    cmod, cmsgs, _ = PKGS[client]
    smsgs, srpcz = PKGS[server][1], PKGS[server][2]
    text = "tensor lane " * 200
    ch = cmod.Channel()
    assert ch.init(str(servers[server].listen_endpoint)) == 0
    try:
        cntl = cmod.Controller()
        cntl.timeout_ms = WAIT_S * 1000
        cntl.compress_type = CODECS[codec]
        resp = cmsgs.EchoResponse()
        ch.call_method("Codec.Echo", cntl, cmsgs.EchoRequest(message=text),
                       resp)
        assert not cntl.failed(), cntl.error_text
        assert resp.message == text
        # the server answered compressed alike, and saw the compressed size
        assert cntl._response_rpc_meta.compress_type == CODECS[codec]
        sent = compress.compress(
            smsgs.EchoRequest(message=text).SerializeToString(),
            CODECS[codec])
        spans = [s for s in srpcz.find_trace(cntl.trace_id)
                 if s.kind == "server"]
        assert [s.request_size for s in spans] == [len(sent)]
        assert len(sent) < len(text) // 4
    finally:
        ch.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_client_refuses_an_unknown_type_alike(servers, pkg):
    mod, msgs, _ = PKGS[pkg]
    ch = mod.Channel()
    assert ch.init(str(servers[pkg].listen_endpoint)) == 0
    try:
        cntl, _ = ch.call("Codec.Echo", msgs.EchoRequest(message="x"),
                          msgs.EchoResponse, timeout_ms=WAIT_S * 1000,
                          compress_type=9)
        assert (cntl.error_code, cntl.error_text) == (
            errors.EREQUEST, "fail to pack request: unknown compress type 9")
    finally:
        ch.close()


def _raw_call(srv, method: str, payload: bytes, compress_type: int = 0,
              then_closed: bool = False):
    """One request frame on a new connection; (response meta, payload,
    and with ``then_closed`` whether the server then closed it)."""
    meta = wire.RpcMeta()
    service, _, name = method.rpartition(".")
    meta.request.service_name = service
    meta.request.method_name = name
    meta.correlation_id = 1
    meta.compress_type = compress_type
    frame = tpu_std.pack_frame(meta, payload, IOBuf()).to_bytes()
    with socket.create_connection(("127.0.0.1", srv.listen_endpoint.port),
                                  timeout=WAIT_S) as s:
        s.sendall(frame)
        data = b""
        while len(data) < 12 or len(data) < 12 + struct.unpack(
                ">I", data[4:8])[0]:
            chunk = s.recv(65536)
            assert chunk, "the connection closed before the response"
            data += chunk
        body, meta_size = struct.unpack(">II", data[4:12])
        got = wire.RpcMeta()
        got.ParseFromString(data[12:12 + meta_size])
        closed = then_closed and s.recv(1) == b""
    return got, data[12 + meta_size:12 + body], closed


@pytest.mark.parametrize("pkg", PKGS)
def test_server_refuses_an_unknown_type_alike(servers, pkg):
    payload = wire.EchoRequest(message="x").SerializeToString()
    got, _, _ = _raw_call(servers[pkg], "Codec.Echo", payload, 9)
    assert (got.response.error_code, got.response.error_text) == (
        errors.EREQUEST, "fail to parse request: unknown compress type 9")


@pytest.mark.parametrize("pkg", PKGS)
def test_close_connection_after_the_response(servers, pkg):
    payload = wire.EchoRequest(message="x").SerializeToString()
    got, body, closed = _raw_call(servers[pkg], "Codec.Close", payload,
                                  then_closed=True)
    assert got.response.error_code == 0
    resp = wire.EchoResponse()
    resp.ParseFromString(body)
    assert resp.message == "bye" and closed


# -- frames --------------------------------------------------------------------

def _request_frame(mod, cntl, payload: bytes) -> bytes:
    cntl._method_full_name = "Codec.Echo"
    cntl.log_id = 77
    cntl.trace_id = 0x1234_5678_9ABC_DEF0
    cntl.span_id = 0x0FED_CBA9_8765_4321
    cntl.compress_type = compress.COMPRESS_GZIP
    return mod.pack_request(payload, cntl, 4242).to_bytes()


def test_request_frame_with_ids_and_compression_is_byte_equal():
    payload = wire.EchoRequest(message="hello " * 50).SerializeToString()
    ours = _request_frame(tpu_std, rpc.Controller(), payload)
    theirs = _request_frame(ref_tpu_std, ref_rpc.Controller(), payload)
    assert ours == theirs
    meta = rpc_meta_pb2.RpcMeta()
    meta.ParseFromString(theirs[12:12 + struct.unpack(">I", theirs[8:12])[0]])
    assert (meta.request.trace_id, meta.request.span_id,
            meta.request.parent_span_id, meta.compress_type) == (
        0x1234_5678_9ABC_DEF0, 0x0FED_CBA9_8765_4321, 0,
        compress.COMPRESS_GZIP)


def test_tensor_meta_helpers_match_the_reference():
    rng = np.random.default_rng(3)
    arrays = [rng.standard_normal((4, 8), np.float32),
              rng.integers(-9, 9, (3,), np.int32),
              rng.standard_normal((2, 5)).astype(ml_dtypes.bfloat16)]
    torch_of = [torch.from_numpy(arrays[0]), torch.from_numpy(arrays[1]),
                torch.from_numpy(arrays[2].view(np.int16)).view(torch.bfloat16)]
    ours_meta, ours_att = wire.RpcMeta(), IOBuf()
    tpu_std.attach_arrays(ours_att, ours_meta, torch_of)
    ref_meta, ref_att = rpc_meta_pb2.RpcMeta(), RefIOBuf()
    ref_tpu_std.attach_arrays(ref_att, ref_meta,
                              [jnp.asarray(a) for a in arrays])
    assert ours_meta.SerializeToString() == ref_meta.SerializeToString()
    assert ours_att.to_bytes() == ref_att.to_bytes()
    # each package reads the other's frame
    back = tpu_std.extract_arrays(IOBuf(ref_att.to_bytes()), ours_meta)
    for got, want in zip(back, torch_of):
        assert got.dtype == want.dtype and torch.equal(got, want)
    theirs = ref_tpu_std.extract_arrays(RefIOBuf(ours_att.to_bytes()),
                                        ref_meta)
    for got, want in zip(theirs, arrays):
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("pkg", PKGS)
def test_gzip_push_lands_in_the_port_and_fails_in_the_reference(servers,
                                                                 pkg):
    mod, ts = PKGS[pkg][0], STORES[pkg]
    a = np.random.default_rng(4).standard_normal((256, 64), np.float32)
    ch = mod.Channel()
    assert ch.init(str(servers[pkg].listen_endpoint)) == 0
    try:
        cntl = mod.Controller()
        cntl.timeout_ms = WAIT_S * 1000
        cntl.compress_type = compress.COMPRESS_GZIP
        cntl._outbound_tensors = [torch.from_numpy(a) if pkg == "port"
                                  else jnp.asarray(a)]
        resp = ts.ts_pb2.TensorPushResponse()
        ch.call_method("TensorStore.Push", cntl,
                       ts.ts_pb2.TensorPushRequest(name="gz"), resp)
    finally:
        ch.close()
    if pkg == "ref":
        assert (cntl.error_code, cntl.error_text) == (
            errors.EREQUEST, "fail to parse request: Error parsing message "
            "with type 'brpc_tpu.TensorPushRequest'")
        assert servers[pkg].store.get("gz") is None
        return
    assert not cntl.failed() and resp.ok, cntl.error_text
    landed = servers[pkg].store.get("gz")[0]
    assert landed.numpy().tobytes() == a.tobytes()
