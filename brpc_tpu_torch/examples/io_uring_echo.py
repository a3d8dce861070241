"""io_uring_echo — the native runtime's io_uring datapath: reads ride
provided-buffer multishot receives, responses fixed-buffer sends, and the
fiber scheduler drains the completions; ``ring_counters`` counts them.

Port of examples/io_uring_echo.py:

  python -m brpc_tpu_torch.examples.io_uring_echo [--seconds 2]

A kernel that refuses io_uring leaves epoll serving: the program says so
and exits 0, as the reference does. Where the native library does not
build this raises ``NativeUnavailable`` with the compiler's errors
(queue C #39).
"""
import argparse
import sys

from brpc_tpu_torch import native, rpc
from brpc_tpu_torch.rpc.proto import wire


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    native.load()  # raises NativeUnavailable with the compiler's errors
    if native.use_io_uring(True) != 1:
        print("io_uring unavailable in this kernel/sandbox (epoll remains)")
        return 0
    try:
        port = native.rpc_server_start("127.0.0.1", 0, nworkers=2,
                                       native_echo=True)
        # a generous timeout and one retry: a cold ring lane on a loaded
        # host can miss a tight deadline with nothing wrong
        ch = rpc.Channel(rpc.ChannelOptions(timeout_ms=15000))
        assert ch.init(f"127.0.0.1:{port}") == 0
        for _ in range(2):
            cntl, resp = ch.call("EchoService.Echo",
                                 wire.EchoRequest(message="over the ring"),
                                 wire.EchoResponse)
            if not cntl.failed():
                break
        assert not cntl.failed(), cntl.error_text
        print(f"echo reply: {resp.message!r}")
        ch.close()
        bench = native.rpc_client_bench("127.0.0.1", port, nconn=2,
                                        fibers_per_conn=64,
                                        seconds=args.seconds, payload=16)
        recv, send = native.ring_counters()
        print(f"ring-lane framework echo: {bench['qps']:.0f} qps "
              f"({bench['requests']} requests)")
        print(f"ring completions: {recv} provided-buffer receives, "
              f"{send} fixed-buffer sends")
        return 0
    finally:
        native.rpc_server_stop()
        native.use_io_uring(False)


if __name__ == "__main__":
    sys.exit(main())
