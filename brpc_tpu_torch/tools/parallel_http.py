"""parallel_http — mass concurrent HTTP fetcher.

Port of tools/parallel_http.py (the counterpart of brpc's
tools/parallel_http): fetches many URLs concurrently and reports
success/latency stats from bvars.

Usage:
  python -m brpc_tpu_torch.tools.parallel_http --url-file urls.txt --concurrency 16
  python -m brpc_tpu_torch.tools.parallel_http --url http://127.0.0.1:8000/status -n 100
"""
from __future__ import annotations

import argparse
import http.client
import sys
import threading
import time
from collections import deque
from urllib.parse import urlparse


def fetch_all(urls, concurrency: int, timeout: float) -> dict:
    """Fetch ``urls`` on ``concurrency`` threads, print the reference's
    line and return the counts (fetched, ok, failed) and the seconds."""
    from brpc_tpu_torch import bvar

    urls = deque(urls)
    recorder = bvar.LatencyRecorder()
    ok = bvar.Adder()
    fail = bvar.Adder()
    lock = threading.Lock()

    def worker():
        while True:
            with lock:
                if not urls:
                    return
                url = urls.popleft()
            u = urlparse(url)
            t0 = time.monotonic()
            try:
                conn = http.client.HTTPConnection(
                    u.hostname, u.port or 80, timeout=timeout)
                conn.request("GET", u.path or "/")
                r = conn.getresponse()
                r.read()
                conn.close()
                if 200 <= r.status < 400:
                    ok.update(1)
                    recorder.update((time.monotonic() - t0) * 1e6)
                else:
                    fail.update(1)
            except OSError:
                fail.update(1)

    t0 = time.monotonic()
    threads = [threading.Thread(target=worker) for _ in range(concurrency)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    dt = time.monotonic() - t0
    total = ok.get_value() + fail.get_value()
    print(f"fetched={total} ok={ok.get_value()} failed={fail.get_value()} "
          f"in {dt:.1f}s ({total / dt:.1f}/s) "
          f"avg={recorder.latency():.0f}us "
          f"p99={recorder.latency_percentile(0.99):.0f}us")
    return {"fetched": total, "ok": ok.get_value(),
            "failed": fail.get_value(), "seconds": dt,
            "avg_us": recorder.latency(),
            "p99_us": recorder.latency_percentile(0.99)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--url", help="single URL (with -n repeats)")
    ap.add_argument("-n", type=int, default=1, help="repeat count for --url")
    ap.add_argument("--url-file", help="file with one URL per line")
    ap.add_argument("--concurrency", type=int, default=8)
    ap.add_argument("--timeout", type=float, default=5)
    args = ap.parse_args(argv)

    if args.url_file:
        with open(args.url_file) as f:
            urls = [line.strip() for line in f if line.strip()]
    elif args.url:
        urls = [args.url] * args.n
    else:
        ap.error("need --url or --url-file")
    fetch_all(urls, args.concurrency, args.timeout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
