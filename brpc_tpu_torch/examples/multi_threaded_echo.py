"""multi_threaded_echo — the example/multi_threaded_echo_c++ counterpart:
N client threads issue synchronous echoes through Server/Channel/
Controller, instrumented with a bvar LatencyRecorder like the reference
client (client.cpp:50-52: g_latency_recorder << elapsed; qps and
percentiles read back from it).

Port of examples/multi_threaded_echo.py:

  python -m brpc_tpu_torch.examples.multi_threaded_echo [--threads 4] [--seconds 2]
"""
import argparse
import sys
import threading
import time

from brpc_tpu_torch import bvar, rpc
from brpc_tpu_torch.rpc.proto import wire


class EchoService(rpc.Service):
    @rpc.rpc_method(wire.EchoRequest, wire.EchoResponse)
    def Echo(self, cntl, request, response, done):
        with rpc.ClosureGuard(done):
            response.message = request.message


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    srv = rpc.Server(rpc.ServerOptions(num_threads=4, device=args.device))
    srv.add_service(EchoService())
    if srv.start("127.0.0.1:0") != 0:
        raise RuntimeError("multi_threaded_echo: server start failed")
    target = str(srv.listen_endpoint)

    recorder = bvar.LatencyRecorder("mt_echo_client")
    error_count = bvar.Adder("mt_echo_client_errors")
    stop = threading.Event()

    def sender():
        ch = rpc.Channel(rpc.ChannelOptions(timeout_ms=1000))
        if ch.init(target) != 0:
            error_count.update(1)
            return
        i = 0
        while not stop.is_set():
            cntl, resp = ch.call(
                "EchoService.Echo",
                wire.EchoRequest(message=f"hello {i}"),
                wire.EchoResponse)
            if cntl.failed():
                error_count.update(1)
            else:
                recorder.update(cntl.latency_us)
            i += 1
        ch.close()

    threads = [threading.Thread(target=sender) for _ in range(args.threads)]
    try:
        for t in threads:
            t.start()
        deadline = time.monotonic() + args.seconds
        while time.monotonic() < deadline:
            time.sleep(max(0.05, min(1.0, deadline - time.monotonic())))
            print(f"qps={recorder.qps():.0f} avg={recorder.latency():.0f}us "
                  f"p99={recorder.latency_percentile(0.99):.0f}us "
                  f"max={recorder.max_latency():.0f}us "
                  f"errors={error_count.get_value()}")
    finally:
        stop.set()
        for t in threads:
            t.join()
        srv.stop()
    total = recorder.count()
    print(f"total={total} errors={error_count.get_value()}")
    return 0 if total > 0 and error_count.get_value() == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
