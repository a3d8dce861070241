"""echo — the canonical example (example/echo_c++ counterpart).

Port of examples/echo.py:

  python -m brpc_tpu_torch.examples.echo server [--port 8000]
  python -m brpc_tpu_torch.examples.echo client [--server 127.0.0.1:8000] [--attachment x]
  python -m brpc_tpu_torch.examples.echo demo          # both in one process
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
            # echo the attachment exactly as example/echo_c++ does
            cntl.response_attachment.append(cntl.request_attachment)


def run_server(port: int, device="cuda") -> rpc.Server:
    srv = rpc.Server(rpc.ServerOptions(device=device))
    srv.add_service(EchoService())
    if srv.start(f"127.0.0.1:{port}") != 0:
        raise RuntimeError(f"echo: cannot listen on port {port}")
    print(f"echo server on {srv.listen_endpoint} "
          f"(console: http://{srv.listen_endpoint}/status)")
    return srv


def run_client(target: str, attachment: str) -> int:
    ch = rpc.Channel(rpc.ChannelOptions(timeout_ms=1000))
    if ch.init(target) != 0:
        print("failed: cannot init a channel to", target)
        return 1
    cntl = rpc.Controller()
    if attachment:
        cntl.request_attachment.append(attachment)
    resp = wire.EchoResponse()
    ch.call_method("EchoService.Echo", cntl,
                   wire.EchoRequest(message="hello tpu"), resp)
    ch.close()
    if cntl.failed():
        print("failed:", cntl.error_text)
        return 1
    print(f"reply={resp.message!r} attachment="
          f"{cntl.response_attachment.to_bytes()!r} "
          f"latency={cntl.latency_us:.0f}us")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=["server", "client", "demo"])
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--server", default="127.0.0.1:8000")
    ap.add_argument("--attachment", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.mode == "server":
        run_server(args.port, args.device).run_until_asked_to_quit()
        return 0
    if args.mode == "client":
        return run_client(args.server, args.attachment)
    srv = run_server(0, args.device)
    try:
        return run_client(str(srv.listen_endpoint), "piggy-bytes")
    finally:
        srv.stop()


if __name__ == "__main__":
    sys.exit(main())
