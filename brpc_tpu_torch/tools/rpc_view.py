"""rpc_view — view another server's builtin console pages from the CLI.

Port of tools/rpc_view.py (the counterpart of brpc's tools/rpc_view):
fetches /status /vars /flags /connections /rpcz ... from a server of
either package over HTTP on its RPC port.

Usage:
  python -m brpc_tpu_torch.tools.rpc_view 127.0.0.1:8000 [page] [--watch N]
"""
from __future__ import annotations

import argparse
import http.client
import sys
import time


def fetch(target: str, page: str) -> str:
    host, _, port = target.partition(":")
    conn = http.client.HTTPConnection(host, int(port or 80), timeout=5)
    conn.request("GET", f"/{page.lstrip('/')}")
    r = conn.getresponse()
    body = r.read().decode()
    conn.close()
    if r.status != 200:
        return f"HTTP {r.status}\n{body}"
    return body


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("target", help="ip:port of the server")
    ap.add_argument("page", nargs="?", default="status")
    ap.add_argument("--watch", type=float, default=0,
                    help="refresh every N seconds")
    args = ap.parse_args(argv)
    try:
        while True:
            out = fetch(args.target, args.page)
            if args.watch:
                print("\033[2J\033[H", end="")  # clear screen
            print(out)
            if not args.watch:
                break
            time.sleep(args.watch)
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
