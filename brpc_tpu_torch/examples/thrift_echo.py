"""thrift_echo — a ThriftService handler behind framed binary thrift,
called with a stub-style client (example/thrift_extension_c++
counterpart).

Port of examples/thrift_echo.py:

  python -m brpc_tpu_torch.examples.thrift_echo [--device cpu]
"""
import argparse
import sys

from brpc_tpu_torch import rpc
from brpc_tpu_torch.rpc.thrift import T_STRING, ThriftMessage, ThriftService


def make_service() -> ThriftService:
    svc = ThriftService()

    def echo(body):  # handler(body struct) -> result struct
        data = body.get(1, (T_STRING, b""))[1]
        return {0: (T_STRING, b"thrift says: " + data)}

    svc.add_method("Echo", echo)
    return svc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    srv = rpc.Server(rpc.ServerOptions(device=args.device,
                                       thrift_service=make_service()))
    if srv.start("127.0.0.1:0") != 0:
        print("failed: cannot start the server")
        return 1
    ch = rpc.Channel(rpc.ChannelOptions(protocol="thrift", timeout_ms=1000))
    try:
        ch.init(str(srv.listen_endpoint))
        cntl = rpc.Controller()
        resp = ThriftMessage()
        ch.call_method("thrift", cntl,
                       ThriftMessage("Echo", {1: (T_STRING, b"hello")}), resp)
        if cntl.failed():
            print("failed:", cntl.error_text)
            return 1
        _, data = resp.body.get(0, (T_STRING, b""))
        print(f"thrift reply: {data!r}")
        return 0 if data == b"thrift says: hello" else 1
    finally:
        ch.close()
        srv.stop()


if __name__ == "__main__":
    sys.exit(main())
