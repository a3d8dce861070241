"""trackme_server — receives version pings.

Port of tools/trackme_server.py (the counterpart of brpc's
tools/trackme_server): counts pings per version at /trackme and shows
the tallies at /tallies, on a port Server's console.

  python -m brpc_tpu_torch.tools.trackme_server [--port 8877] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import sys
import threading


def start(port: int, notice: str = "", device="cuda"):
    """A port Server on 127.0.0.1:``port`` (0: any) answering POST
    /trackme and GET /tallies; returns (server, counts by version)."""
    from brpc_tpu_torch import rpc

    counts = {}
    lock = threading.Lock()

    def trackme_handler(server, req):
        try:
            version = json.loads(req.body.to_bytes() or b"{}").get(
                "version", "unknown")
        except ValueError:
            version = "malformed"
        with lock:
            counts[version] = counts.get(version, 0) + 1
        body = {"ok": True}
        if notice:
            body["notice"] = notice
        return 200, "application/json", json.dumps(body)

    def tallies_handler(server, req):
        with lock:
            return 200, "application/json", json.dumps(counts, indent=1)

    srv = rpc.Server(rpc.ServerOptions(device=device))
    if srv.start(f"127.0.0.1:{port}") != 0:
        raise RuntimeError(f"trackme_server: cannot listen on port {port}")
    srv._builtin_handlers["trackme"] = trackme_handler
    srv._builtin_handlers["tallies"] = tallies_handler
    print(f"trackme server on {srv.listen_endpoint} "
          f"(POST /trackme, GET /tallies)")
    return srv, counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--port", type=int, default=8877)
    ap.add_argument("--notice", default="", help="notice pushed to pingers")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    srv, _ = start(args.port, args.notice, args.device)
    srv.run_until_asked_to_quit()
    return 0


if __name__ == "__main__":
    sys.exit(main())
