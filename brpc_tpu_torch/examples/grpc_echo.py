"""grpc_echo — one service answers gRPC over h2 and tpu_std on one port
(example/grpc_c++ counterpart).

Port of examples/grpc_echo.py:

  python -m brpc_tpu_torch.examples.grpc_echo [--device cpu]
"""
import argparse
import sys

from brpc_tpu_torch import rpc
from brpc_tpu_torch.rpc.proto import wire


class EchoService(rpc.Service):
    @rpc.rpc_method(wire.EchoRequest, wire.EchoResponse)
    def Echo(self, cntl, request, response, done):
        with rpc.ClosureGuard(done):
            response.message = request.message


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    srv = rpc.Server(rpc.ServerOptions(device=args.device))
    srv.add_service(EchoService())
    if srv.start("127.0.0.1:0") != 0:
        print("failed: cannot start the server")
        return 1
    target = str(srv.listen_endpoint)
    try:
        gch = rpc.Channel(rpc.ChannelOptions(protocol="h2:grpc",
                                             timeout_ms=3000))
        gch.init(target)
        cntl, resp = gch.call("EchoService.Echo",
                              wire.EchoRequest(message="over grpc"),
                              wire.EchoResponse)
        gch.close()
        if cntl.failed():
            print("failed:", cntl.error_text)
            return 1
        print(f"grpc reply: {resp.message!r} "
              f"latency={cntl.latency_us:.0f}us")

        nch = rpc.Channel(rpc.ChannelOptions(timeout_ms=1000))
        nch.init(target)
        cntl2, resp2 = nch.call("EchoService.Echo",
                                wire.EchoRequest(message="over tpu_std"),
                                wire.EchoResponse)
        nch.close()
        if cntl2.failed():
            print("failed:", cntl2.error_text)
            return 1
        print(f"tpu_std reply on the same port: {resp2.message!r}")
        return 0
    finally:
        srv.stop()


if __name__ == "__main__":
    sys.exit(main())
