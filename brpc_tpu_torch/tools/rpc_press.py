"""rpc_press — protocol-generic load generator.

Port of tools/rpc_press.py (the counterpart of brpc's tools/rpc_press):
fires a method at a target at a throttled qps (0 = max speed) from JSON
bodies, reporting qps + latency percentiles from a bvar LatencyRecorder.
The message classes come from ``--proto``, by default the port's
hand-written codec (``brpc_tpu_torch.rpc.proto.wire``).

Usage:
  python -m brpc_tpu_torch.tools.rpc_press --server 127.0.0.1:8000 \\
      --method EchoService.Echo --request-type EchoRequest \\
      --input '{"message": "hi"}' --qps 1000 --duration 10 --threads 4
"""
from __future__ import annotations

import argparse
import importlib
import sys
import threading
import time


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--server", required=True, help="ip:port or list://...")
    ap.add_argument("--lb", default="", help="load balancer when NS url")
    ap.add_argument("--method", required=True, help="Service.Method")
    ap.add_argument("--proto", default="brpc_tpu_torch.rpc.proto.wire",
                    help="python module holding the message classes")
    ap.add_argument("--request-type", default="EchoRequest")
    ap.add_argument("--response-type", default="")
    ap.add_argument("--input", default="{}",
                    help="JSON body or @file with one JSON per line")
    ap.add_argument("--qps", type=float, default=0, help="0 = no throttle")
    ap.add_argument("--duration", type=float, default=10)
    ap.add_argument("--threads", type=int, default=2)
    ap.add_argument("--timeout-ms", type=float, default=1000)
    ap.add_argument("--protocol", default="tpu_std")
    return ap.parse_args(argv)


def press(args) -> dict:
    """Run the load, print the progress and the totals lines; returns the
    totals: sent, errors, elapsed seconds, qps and latencies (us)."""
    from brpc_tpu_torch import bvar, rpc
    from brpc_tpu_torch.json2pb import json_to_pb

    mod = importlib.import_module(args.proto)
    req_cls = getattr(mod, args.request_type)
    resp_name = args.response_type or args.request_type.replace(
        "Request", "Response")
    resp_cls = getattr(mod, resp_name)

    if args.input.startswith("@"):
        with open(args.input[1:]) as f:
            bodies = [line.strip() for line in f if line.strip()]
    else:
        bodies = [args.input]
    requests = [json_to_pb(b, req_cls) for b in bodies]

    recorder = bvar.LatencyRecorder()
    sent = bvar.Adder()
    errors_count = bvar.Adder()
    stop = threading.Event()
    interval = args.threads / args.qps if args.qps > 0 else 0

    def worker(idx: int):
        ch = rpc.Channel(rpc.ChannelOptions(
            timeout_ms=args.timeout_ms, protocol=args.protocol))
        if ch.init(args.server, args.lb) != 0:
            print(f"worker {idx}: channel init failed", file=sys.stderr)
            return
        i = 0
        next_fire = time.monotonic()
        while not stop.is_set():
            if interval:
                now = time.monotonic()
                if now < next_fire:
                    time.sleep(min(interval, next_fire - now))
                    continue
                next_fire += interval
            req = requests[i % len(requests)]
            i += 1
            t0 = time.monotonic()
            cntl, _ = ch.call(args.method, req, resp_cls)
            sent.update(1)
            if cntl.failed():
                errors_count.update(1)
            else:
                recorder.update((time.monotonic() - t0) * 1e6)
        ch.close()

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(args.threads)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    try:
        deadline = t0 + args.duration
        while time.monotonic() < deadline:
            time.sleep(min(1.0, deadline - time.monotonic()) or 0.1)
            elapsed = time.monotonic() - t0
            print(f"[{elapsed:5.1f}s] sent={sent.get_value()} "
                  f"errors={errors_count.get_value()} "
                  f"avg={recorder.latency():.0f}us "
                  f"p99={recorder.latency_percentile(0.99):.0f}us")
    except KeyboardInterrupt:
        pass
    stop.set()
    for t in threads:
        t.join(5)
    elapsed = time.monotonic() - t0
    total = sent.get_value()
    out = {"sent": total, "errors": errors_count.get_value(),
           "seconds": elapsed, "qps": total / elapsed,
           "avg_us": recorder.latency(),
           "p50_us": recorder.latency_percentile(0.5),
           "p90_us": recorder.latency_percentile(0.9),
           "p99_us": recorder.latency_percentile(0.99)}
    print(f"\ntotal={total} qps={out['qps']:.1f} "
          f"errors={out['errors']} "
          f"avg={out['avg_us']:.0f}us "
          f"p50={out['p50_us']:.0f}us "
          f"p90={out['p90_us']:.0f}us "
          f"p99={out['p99_us']:.0f}us")
    return out


def main(argv=None) -> int:
    press(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
