"""legacy_pbrpc_echo — one service answers hulu_pbrpc, sofa_pbrpc and
tpu_std on one port (the multi-protocol port).

Port of examples/legacy_pbrpc_echo.py:

  python -m brpc_tpu_torch.examples.legacy_pbrpc_echo [--device cpu]
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
    rc = 0
    try:
        for protocol in ("hulu_pbrpc", "sofa_pbrpc", "tpu_std"):
            ch = rpc.Channel(rpc.ChannelOptions(protocol=protocol,
                                                timeout_ms=1000))
            ch.init(target)
            cntl, resp = ch.call("EchoService.Echo",
                                 wire.EchoRequest(message=f"via {protocol}"),
                                 wire.EchoResponse)
            if cntl.failed():
                print(f"{protocol}: FAILED {cntl.error_text}")
                rc = 1
            else:
                print(f"{protocol}: {resp.message!r} "
                      f"({cntl.latency_us:.0f}us)")
            ch.close()
        return rc
    finally:
        srv.stop()


if __name__ == "__main__":
    sys.exit(main())
