"""session_data — example/session_data_and_thread_local counterpart:
session-local data borrowed from a SimpleDataPool per request and
returned afterwards, so expensive per-request state is pooled.

Port of examples/session_data.py:

  python -m brpc_tpu_torch.examples.session_data [--device cpu]
"""
import argparse
import sys

from brpc_tpu_torch import rpc
from brpc_tpu_torch.rpc.data_pools import DataFactory
from brpc_tpu_torch.rpc.proto import wire


class EchoService(rpc.Service):
    @rpc.rpc_method(wire.EchoRequest, wire.EchoResponse)
    def Echo(self, cntl, request, response, done):
        with rpc.ClosureGuard(done):
            data = cntl.session_local_data  # borrowed from the pool
            data["uses"] += 1
            response.message = f"{request.message} (session uses="
            response.message += f"{data['uses']})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    created = []

    def make_session():
        created.append(1)
        return {"uses": 0}

    srv = rpc.Server(rpc.ServerOptions(
        num_threads=2, device=args.device,
        session_local_data_factory=DataFactory(make_session)))
    srv.add_service(EchoService())
    if srv.start("127.0.0.1:0") != 0:
        raise RuntimeError("session_data: server start failed")
    ch = rpc.Channel(rpc.ChannelOptions(timeout_ms=1000))
    try:
        if ch.init(str(srv.listen_endpoint)) != 0:
            raise RuntimeError("session_data: channel init failed")
        for i in range(10):
            cntl, resp = ch.call("EchoService.Echo",
                                 wire.EchoRequest(message=f"req{i}"),
                                 wire.EchoResponse)
            if cntl.failed():
                raise RuntimeError(f"session_data: {cntl.error_text}")
        print(f"10 sequential requests reused "
              f"{len(created)} pooled session object(s)")
    finally:
        ch.close()
        srv.stop()
    # sequential calls should reuse a small pool, not create 10 objects
    return 0 if len(created) < 10 else 1


if __name__ == "__main__":
    sys.exit(main())
