"""native_protocol_clients — the native client machinery that speaks
tpu_std speaks HTTP/1.1 and h2/gRPC too; one server port on the native
runtime answers all three.

Port of examples/native_protocol_clients.py:

  python -m brpc_tpu_torch.examples.native_protocol_clients [--device cpu]

Where the native library does not build this raises
``NativeUnavailable`` with the compiler's errors (queue C #39).
"""
import argparse
import sys

from brpc_tpu_torch import native, rpc
from brpc_tpu_torch.rpc.proto import wire


class EchoService(rpc.Service):
    @rpc.rpc_method(wire.EchoRequest, wire.EchoResponse)
    def Echo(self, cntl, request, response, done):
        response.message = request.message
        done()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    native.load()  # raises NativeUnavailable with the compiler's errors
    srv = rpc.Server(rpc.ServerOptions(num_threads=2, device=args.device,
                                       use_native_runtime=True))
    srv.add_service(EchoService())
    assert srv.start("127.0.0.1:0") == 0
    port = srv.listen_endpoint.port
    print(f"native multi-protocol server on 127.0.0.1:{port}")
    try:
        # 1. gRPC through the native h2 client (preface, HPACK and flow
        # control in C++)
        g = native.channel_open_grpc("127.0.0.1", port)
        req = wire.EchoRequest(message="over-h2")
        status, body, msg = native.grpc_call(g, "/EchoService/Echo",
                                             req.SerializeToString(),
                                             timeout_ms=5000)
        reply = wire.EchoResponse()
        reply.ParseFromString(body)
        print(f"grpc: status={status} reply={reply.message!r}")
        assert status == 0 and reply.message == "over-h2"
        native.channel_close(g)

        # 2. HTTP/1.1 through the native client (pipelined, matched first
        # in first out)
        h = native.channel_open_http("127.0.0.1", port)
        code, body = native.http_call(h, "GET", "/health", timeout_ms=5000)
        print(f"http GET /health: {code} {body!r}")
        assert code == 200
        code, body = native.http_call(
            h, "POST", "/EchoService/Echo",
            body=b'{"message": "over-http"}',
            headers="Content-Type: application/json\r\n", timeout_ms=5000)
        print(f"http POST echo: {code} {body!r}")
        assert code == 200 and b"over-http" in body
        native.channel_close(h)
    finally:
        srv.stop()
    print("ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
