"""usercode_workers — HTTP and gRPC handlers run across worker processes
over the native runtime's shm lane, each answer naming the pid that ran
it: user code on N interpreters, without this process's GIL in the way.

Port of examples/usercode_workers.py:

  python -m brpc_tpu_torch.examples.usercode_workers [--device cpu]

Where the native library does not build this raises
``NativeUnavailable`` with the compiler's errors (queue C #39).
"""
import argparse
import os
import sys

from brpc_tpu_torch import native, rpc
from brpc_tpu_torch.rpc.proto import wire


def make_services():
    """The workers' factory: each worker process builds the services."""

    class PidEchoService(rpc.Service):
        @rpc.rpc_method(wire.EchoRequest, wire.EchoResponse)
        def Echo(self, cntl, request, response, done):
            response.message = f"{request.message}@{os.getpid()}"
            done()

    return [PidEchoService()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    native.load()  # raises NativeUnavailable with the compiler's errors
    srv = rpc.Server(rpc.ServerOptions(
        num_threads=2, device=args.device, use_native_runtime=True,
        py_workers=2,
        py_worker_factory="brpc_tpu_torch.examples.usercode_workers:"
                          "make_services"))
    for s in make_services():
        srv.add_service(s)  # the in-process fallback serves these too
    assert srv.start("127.0.0.1:0") == 0
    port = srv.listen_endpoint.port
    print(f"server on 127.0.0.1:{port}, usercode in 2 worker processes "
          f"(parent pid {os.getpid()})")
    try:
        g = native.channel_open_grpc("127.0.0.1", port)
        pids = set()
        for i in range(12):
            st, body, _ = native.grpc_call(
                g, "/PidEchoService/Echo",
                wire.EchoRequest(message=f"r{i}").SerializeToString(),
                timeout_ms=15000)
            assert st == 0
            reply = wire.EchoResponse()
            reply.ParseFromString(body)
            pids.add(reply.message.split("@")[1])
        print(f"12 calls served by pids: {sorted(pids)}")
        # the parent's pid shows when the in-process fallback answers (a
        # worker's heartbeat stalled on a loaded host), by design
        worker_pids = pids - {str(os.getpid())}
        if worker_pids:
            print(f"worker processes served calls: {sorted(worker_pids)}")
        else:
            print("note: loaded host — calls served by the in-process "
                  "fallback this run")
        native.channel_close(g)
    finally:
        srv.stop()
    print("ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
