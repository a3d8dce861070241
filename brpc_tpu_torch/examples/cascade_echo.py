"""cascade_echo — a call that hops through a chain of servers, with rpcz
tracing the whole path (example/cascade_echo_c++ counterpart; the
pipeline-stage shape).

Port of examples/cascade_echo.py:

  python -m brpc_tpu_torch.examples.cascade_echo [--depth 3]
"""
import argparse
import sys
import time

from brpc_tpu_torch import rpc, rpcz
from brpc_tpu_torch.rpc.proto import wire


class CascadeService(rpc.Service):
    SERVICE_NAME = "EchoService"

    def __init__(self, name, next_channel=None):
        self.name = name
        self.next_channel = next_channel

    @rpc.rpc_method(wire.EchoRequest, wire.EchoResponse)
    def Echo(self, cntl, request, response, done):
        if self.next_channel is not None:
            _, next_resp = self.next_channel.call(
                "EchoService.Echo",
                wire.EchoRequest(message=request.message),
                wire.EchoResponse, timeout_ms=3000)
            response.message = f"{self.name}->{next_resp.message}"
        else:
            response.message = self.name
        done()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--depth", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    servers, channels = [], []
    next_ch = None
    try:
        for i in reversed(range(args.depth)):
            srv = rpc.Server(rpc.ServerOptions(device=args.device))
            srv.add_service(CascadeService(f"hop{i}", next_ch))
            if srv.start("127.0.0.1:0") != 0:
                raise RuntimeError("cascade_echo: server start failed")
            servers.append(srv)
            next_ch = rpc.Channel()
            if next_ch.init(str(srv.listen_endpoint)) != 0:
                raise RuntimeError("cascade_echo: channel init failed")
            channels.append(next_ch)

        rpcz.clear_for_tests()
        cntl, resp = next_ch.call("EchoService.Echo",
                                  wire.EchoRequest(message="go"),
                                  wire.EchoResponse, timeout_ms=5000)
        print("cascade result:", resp.message)

        time.sleep(0.1)
        spans = rpcz.recent_spans()
        traces = {s.trace_id for s in spans}
        print(f"rpcz collected {len(spans)} spans in {len(traces)} trace(s):")
        for s in spans:
            print("  ", s.describe().splitlines()[0])
    finally:
        for ch in channels:
            ch.close()
        for srv in servers:
            srv.stop()
    return 0 if not cntl.failed() else 1


if __name__ == "__main__":
    sys.exit(main())
