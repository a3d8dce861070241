"""backup_request + cancel — tail-latency tools
(example/backup_request_c++ and example/cancel_c++ counterparts).

Port of examples/backup_request.py:

  python -m brpc_tpu_torch.examples.backup_request [--device cpu]
"""
import argparse
import sys
import threading
import time

from brpc_tpu_torch import rpc
from brpc_tpu_torch.rpc import errors
from brpc_tpu_torch.rpc.proto import wire


class SlowEcho(rpc.Service):
    SERVICE_NAME = "EchoService"

    @rpc.rpc_method(wire.EchoRequest, wire.EchoResponse)
    def Echo(self, cntl, request, response, done):
        time.sleep(0.5)
        response.message = "slow"
        done()


class FastEcho(rpc.Service):
    SERVICE_NAME = "EchoService"

    @rpc.rpc_method(wire.EchoRequest, wire.EchoResponse)
    def Echo(self, cntl, request, response, done):
        response.message = "fast"
        done()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    servers = []
    try:
        for svc in (SlowEcho(), FastEcho()):
            srv = rpc.Server(rpc.ServerOptions(device=args.device))
            srv.add_service(svc)
            if srv.start("127.0.0.1:0") != 0:
                raise RuntimeError("backup_request: server start failed")
            servers.append(srv)
        slow, fast = servers

        # backup fires after 50ms; when rr lands on the slow node, the
        # backup attempt rescues the tail (controller.cpp:1256 path)
        ch = rpc.Channel(rpc.ChannelOptions(backup_request_ms=50,
                                            max_retry=2))
        if ch.init(f"list://{slow.listen_endpoint},{fast.listen_endpoint}",
                   "rr") != 0:
            raise RuntimeError("backup_request: channel init failed")
        for i in range(4):
            cntl, resp = ch.call("EchoService.Echo",
                                 wire.EchoRequest(message="x"),
                                 wire.EchoResponse, timeout_ms=3000)
            print(f"call {i}: reply={resp.message} backup="
                  f"{cntl.has_backup_request} "
                  f"latency={cntl.latency_us/1000:.0f}ms")
        ch.close()

        # cancel: abort an in-flight slow call (StartCancel analog)
        slow_ch = rpc.Channel(rpc.ChannelOptions(timeout_ms=5000))
        if slow_ch.init(str(slow.listen_endpoint)) != 0:
            raise RuntimeError("backup_request: channel init failed")
        cntl = rpc.Controller()
        resp = wire.EchoResponse()
        threading.Timer(0.05, cntl.cancel).start()
        slow_ch.call_method("EchoService.Echo", cntl,
                            wire.EchoRequest(message="c"), resp)
        slow_ch.close()
        if cntl.error_code != errors.ECANCELED:
            print(f"the cancelled call ended with {cntl.error_code}")
            return 1
        print(f"cancelled call ended with: {cntl.error_text} "
              f"after {cntl.latency_us/1000:.0f}ms")
    finally:
        for srv in servers:
            srv.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
