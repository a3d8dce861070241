"""asynchronous_echo — example/asynchronous_echo_c++ counterpart: issue
the RPC with a done-callback and keep working; the callback runs on
completion (client.cpp's HandleEchoResponse + NewCallback shape).

Port of examples/asynchronous_echo.py:

  python -m brpc_tpu_torch.examples.asynchronous_echo [--device cpu]
"""
import argparse
import sys
import threading

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
        raise RuntimeError("asynchronous_echo: server start failed")
    ch = rpc.Channel(rpc.ChannelOptions(timeout_ms=1000))
    try:
        if ch.init(str(srv.listen_endpoint)) != 0:
            raise RuntimeError("asynchronous_echo: channel init failed")
        n = 8
        finished = threading.Semaphore(0)
        results = [None] * n

        def make_done(i, resp):
            def handle(c):  # HandleEchoResponse role — runs on completion
                results[i] = (c.failed(), resp.message)
                finished.release()
            return handle

        for i in range(n):
            cntl = rpc.Controller()
            resp = wire.EchoResponse()
            ch.call_method("EchoService.Echo", cntl,
                           wire.EchoRequest(message=f"async {i}"), resp,
                           done=make_done(i, resp))
            # control returned immediately; the RPC completes in background

        for _ in range(n):
            finished.acquire()
        ok = all(not failed and msg == f"async {i}"
                 for i, (failed, msg) in enumerate(results))
        print("async results:", "all ok" if ok else results)
        return 0 if ok else 1
    finally:
        ch.close()
        srv.stop()


if __name__ == "__main__":
    sys.exit(main())
