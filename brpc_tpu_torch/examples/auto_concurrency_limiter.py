"""auto_concurrency_limiter — adaptive admission control
(example/auto_concurrency_limiter counterpart): a server with method
max_concurrency="auto" sheds load under a burst; the limiter re-sizes from
measured qps and no-load latency.

Port of examples/auto_concurrency_limiter.py:

  python -m brpc_tpu_torch.examples.auto_concurrency_limiter [--device cpu]
"""
import argparse
import sys
import threading
import time

from brpc_tpu_torch import rpc
from brpc_tpu_torch.rpc import errors
from brpc_tpu_torch.rpc.proto import wire


class WorkService(rpc.Service):
    @rpc.rpc_method(wire.EchoRequest, wire.EchoResponse)
    def Work(self, cntl, request, response, done):
        time.sleep(0.01)  # 10ms of "work"
        response.message = "done"
        done()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    srv = rpc.Server(rpc.ServerOptions(
        num_threads=8, method_max_concurrency={"WorkService.Work": "auto"},
        device=args.device))
    srv.add_service(WorkService())
    if srv.start("127.0.0.1:0") != 0:
        raise RuntimeError("auto_concurrency_limiter: server start failed")

    status = srv.method_statuses()["WorkService.Work"]
    ok = [0]
    rejected = [0]
    lock = threading.Lock()

    def client(n):
        ch = rpc.Channel(rpc.ChannelOptions(timeout_ms=2000))
        ch.init(str(srv.listen_endpoint))
        for _ in range(n):
            cntl, _ = ch.call("WorkService.Work",
                              wire.EchoRequest(message="w"),
                              wire.EchoResponse)
            with lock:
                if cntl.failed() and cntl.error_code == errors.ELIMIT:
                    rejected[0] += 1
                elif not cntl.failed():
                    ok[0] += 1
        ch.close()

    threads = [threading.Thread(target=client, args=(30,)) for _ in range(8)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        print(f"ok={ok[0]} rejected={rejected[0]} "
              f"final_limit={status.limiter.max_concurrency()}")
    finally:
        srv.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
