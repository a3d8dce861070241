"""selective_echo — example/selective_echo_c++ counterpart: a
SelectiveChannel load-balances whole sub-channels and fails over when a
backend dies mid-run.

Port of examples/selective_echo.py:

  python -m brpc_tpu_torch.examples.selective_echo [--device cpu]
"""
import argparse
import sys

from brpc_tpu_torch import rpc
from brpc_tpu_torch.rpc.combo_channels import SelectiveChannel
from brpc_tpu_torch.rpc.proto import wire


class NamedEcho(rpc.Service):
    SERVICE_NAME = "EchoService"

    def __init__(self, tag):
        self.tag = tag

    @rpc.rpc_method(wire.EchoRequest, wire.EchoResponse)
    def Echo(self, cntl, request, response, done):
        with rpc.ClosureGuard(done):
            response.message = f"{self.tag}:{request.message}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    servers, channels = [], []
    schan = SelectiveChannel(max_retry=2)
    try:
        for tag in ("a", "b", "c"):
            srv = rpc.Server(rpc.ServerOptions(device=args.device))
            srv.add_service(NamedEcho(tag))
            if srv.start("127.0.0.1:0") != 0:
                raise RuntimeError("selective_echo: server start failed")
            servers.append(srv)
            ch = rpc.Channel(rpc.ChannelOptions(timeout_ms=500))
            if ch.init(str(srv.listen_endpoint)) != 0:
                raise RuntimeError("selective_echo: channel init failed")
            channels.append(ch)
            schan.add_channel(ch)

        seen = set()
        for i in range(12):
            cntl, resp = schan.call("EchoService.Echo",
                                    wire.EchoRequest(message=str(i)),
                                    wire.EchoResponse)
            if cntl.failed():
                raise RuntimeError(f"selective_echo: {cntl.error_text}")
            seen.add(resp.message.split(":")[0])
        print(f"spread across backends: {sorted(seen)}")

        # kill one backend: calls must fail over to the survivors
        servers[0].stop()
        ok = 0
        for i in range(8):
            cntl, resp = schan.call("EchoService.Echo",
                                    wire.EchoRequest(message=f"x{i}"),
                                    wire.EchoResponse)
            if not cntl.failed():
                ok += 1
        print(f"after killing backend 'a': {ok}/8 succeeded via failover")
    finally:
        for ch in channels:
            ch.close()
        for srv in servers:
            srv.stop()
    return 0 if len(seen) > 1 and ok == 8 else 1


if __name__ == "__main__":
    sys.exit(main())
