"""http — RESTful access + console (example/http_c++ counterpart): the
same service answers tpu_std RPC, JSON-over-HTTP, and serves the builtin
console on one port (brpc's multi-protocol port).

Port of examples/http_server.py:

  python -m brpc_tpu_torch.examples.http_server          # demo: curl-style requests
  python -m brpc_tpu_torch.examples.http_server serve    # keep serving on :8000
"""
import argparse
import http.client
import json
import sys

from brpc_tpu_torch import rpc
from brpc_tpu_torch.rpc.proto import wire


class EchoService(rpc.Service):
    @rpc.rpc_method(wire.EchoRequest, wire.EchoResponse)
    def Echo(self, cntl, request, response, done):
        response.message = f"http says: {request.message}"
        done()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", nargs="?", choices=["serve"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    serve = args.mode == "serve"
    srv = rpc.Server(rpc.ServerOptions(device=args.device))
    srv.add_service(EchoService())
    if srv.start("127.0.0.1:8000" if serve else "127.0.0.1:0") != 0:
        raise RuntimeError("http_server: server start failed")
    print(f"serving on {srv.listen_endpoint} — try:")
    print(f"  curl http://{srv.listen_endpoint}/status")
    print(f"  curl -d '{{\"message\":\"hi\"}}' "
          f"http://{srv.listen_endpoint}/EchoService/Echo")
    if serve:
        srv.run_until_asked_to_quit()
        return 0

    try:
        conn = http.client.HTTPConnection("127.0.0.1",
                                          srv.listen_endpoint.port, timeout=5)
        conn.request("POST", "/EchoService/Echo",
                     body=json.dumps({"message": "from-curl"}),
                     headers={"Content-Type": "application/json"})
        print("JSON RPC:", conn.getresponse().read().decode())
        conn.request("GET", "/status")
        print("console /status:\n", conn.getresponse().read().decode()[:400])
        conn.close()
    finally:
        srv.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
