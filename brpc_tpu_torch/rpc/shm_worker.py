"""A usercode worker process of the shm lane.

Port of brpc_tpu/rpc/shm_worker.py. The parent's native runtime parses
HTTP and gRPC requests and spreads their dispatch over N of these
processes on the descriptor-ring transport: fixed 64-byte descriptors on
lock-free rings per worker, payload bytes written once into a shared blob
arena and read here in place (the one copy on this side is into Python
bytes). Python usercode so runs on N interpreters, each with its GIL.

The worker holds its slot's robust lifetime fence from attach to death: a
SIGKILL here surfaces as EOWNERDEAD at the parent's recovery probe, which
drains what this worker answered, reaps what it took, and frees the slot
for a replacement.

Started by the native-runtime mount (``ServerOptions.py_workers``), not
by hand::

    python -m brpc_tpu_torch.rpc.shm_worker <shm_name> <module:factory>

``factory()`` returns the Services to serve, rebuilt in this process.

Kind-8 records (the parent's ``native.shm_push_tensor``) go to the tensor
sink the factory registers with ``set_tensor_sink``, as leases read in
place; with no sink they are counted in
``shm_tensor_sink_unregistered_drops`` and released, never lost silently.
``card_landing_services`` and ``cpu_landing_services`` are factories
whose sink lands each record on the device and keeps its checksum.
"""
from __future__ import annotations

import json
import os
import sys
import threading

from brpc_tpu_torch import bvar

_tensor_sink = None
_sink_drops = bvar.Adder("shm_tensor_sink_unregistered_drops")


def set_tensor_sink(fn):
    """Register fn(lease) as this worker's consumer of kind-8 records
    (from the service factory, which runs in the worker). The sink owns
    the lease and must release it, in any order. None unregisters."""
    global _tensor_sink
    _tensor_sink = fn


def tensor_sink_drops() -> int:
    """Records released because no sink was registered."""
    return _sink_drops.get_value()


def dispatch_tensor_record(native_mod, h) -> bool:
    """Give one kind-8 handle to the registered sink as a lease. True when
    a sink took it (and owns the span now)."""
    lease = native_mod.FabricLease(h)
    sink = _tensor_sink
    if sink is None:
        _sink_drops.update(1)
        lease.release()
        return False
    try:
        sink(lease)
        return True
    except Exception:
        lease.release()  # a sink that released already: a no-op
        return False


def main(shm_name: str, factory_spec: str) -> int:
    import importlib

    from brpc_tpu_torch import native, rpc
    from brpc_tpu_torch.builtin import register_builtin_services
    from brpc_tpu_torch.rpc.native_runtime import NativeRuntimeMount

    lib = native.load()
    if lib.nat_shm_worker_attach(shm_name.encode()) != 0:
        print(f"shm_worker: cannot attach {shm_name}", file=sys.stderr)
        return 1

    # responses ride the lane's response ring; the parent's drainer puts
    # them through the connections' ordered emitters. This process owns
    # no socket.
    def http_respond(sock_id, seq, data, close_after=False):
        p, n = native._buf(data)
        return lib.nat_shm_respond(3, sock_id, seq, p, n, 0, None,
                                   1 if close_after else 0)

    def grpc_respond(sock_id, stream_id, payload=b"", grpc_status=0,
                     grpc_message=""):
        p, n = native._buf(payload)
        return lib.nat_shm_respond(4, sock_id, stream_id, p, n, grpc_status,
                                   grpc_message.encode() or None, 0)

    native.http_respond = http_respond
    native.grpc_respond = grpc_respond
    native.sock_write = lambda *a, **k: -1
    native.sock_set_failed = lambda *a, **k: -1

    mod_name, _, fn_name = factory_spec.partition(":")
    services = getattr(importlib.import_module(mod_name), fn_name)()
    server = rpc.Server(rpc.ServerOptions(device="cpu"))
    for svc in services:
        server.add_service(svc)
    register_builtin_services(server)
    mount = NativeRuntimeMount(server, num_threads=1)

    while True:
        h = lib.nat_shm_take_request(500)
        if not h:
            # PR_SET_PDEATHSIG is armed at attach; a worker reparented
            # before that must not poll a leaked segment forever
            if os.getppid() == 1:
                return 0
            continue
        kind = lib.nat_req_kind(h)
        if kind == 8:
            dispatch_tensor_record(native, h)
            continue
        sock_id = lib.nat_req_sock_id(h)
        seq = lib.nat_req_cid(h)
        verb, path = native._field(lib, h, 0), native._field(lib, h, 1)
        headers, payload = native._field(lib, h, 4), native._field(lib, h, 2)
        lib.nat_req_free(h)  # copied out: the arena span frees
        try:
            if kind == 3:
                mount._handle_http(verb, path, headers, payload, sock_id, seq)
            elif kind == 4:
                mount._handle_grpc(path, headers, payload, sock_id, seq)
        except Exception as e:  # answer rather than drop
            if kind == 3:
                body = f"{e}\n".encode()
                http_respond(sock_id, seq,
                             (f"HTTP/1.1 500 Internal Server Error\r\n"
                              f"Content-Length: {len(body)}\r\n\r\n").encode()
                             + body)
            else:
                grpc_respond(sock_id, seq, b"", 13, f"{e}")


# -- a landing factory ---------------------------------------------------------

def checksum(u8) -> list:
    """(sum of the bytes, sum of byte * (index mod 65521)) of a 1-D uint8
    tensor, computed where the tensor lies."""
    import torch

    v = u8.to(torch.int64)
    w = torch.arange(v.numel(), dtype=torch.int64, device=v.device) % 65521
    return [int(v.sum()), int((v * w).sum())]


def _landing_services(device: str):
    """An EchoService answering ``<message>@<pid>`` and a ``WorkerSink``
    service whose ``State`` answers this worker's landed records as JSON
    ({"pid", "device", "landed": {tag: [nbytes, checksum...]}, "drops"});
    the tensor sink copies each record to ``device`` and releases its
    lease once the copy is done."""
    import torch

    from brpc_tpu_torch.rpc.proto import wire
    from brpc_tpu_torch.rpc.service import Service, rpc_method

    landed = {}
    lock = threading.Lock()

    def sink(lease):
        try:
            src = torch.frombuffer(lease.view(), dtype=torch.uint8) \
                if lease.nbytes else torch.empty(0, dtype=torch.uint8)
            on_dev = src.to(device, copy=True)  # owns its bytes
            if on_dev.is_cuda:
                torch.cuda.synchronize(on_dev.device)
        finally:
            lease.release()
        with lock:
            landed[str(lease.tag)] = [lease.nbytes, on_dev.device.type] + \
                checksum(on_dev)

    set_tensor_sink(sink)

    class EchoService(Service):
        SERVICE_NAME = "EchoService"

        @rpc_method(wire.EchoRequest, wire.EchoResponse)
        def Echo(self, cntl, request, response, done):
            response.message = f"{request.message}@{os.getpid()}"
            done()

    class WorkerSink(Service):
        SERVICE_NAME = "WorkerSink"

        @rpc_method(wire.EchoRequest, wire.EchoResponse)
        def State(self, cntl, request, response, done):
            with lock:
                response.message = json.dumps({
                    "pid": os.getpid(), "device": device,
                    "landed": dict(landed), "drops": tensor_sink_drops()})
            done()

    return [EchoService(), WorkerSink()]


def card_landing_services():
    return _landing_services("cuda")


def cpu_landing_services():
    return _landing_services("cpu")


if __name__ == "__main__":
    # run as the package's module, the one a factory registers its sink on
    from brpc_tpu_torch.rpc import shm_worker

    sys.exit(shm_worker.main(sys.argv[1], sys.argv[2]) or 0)
