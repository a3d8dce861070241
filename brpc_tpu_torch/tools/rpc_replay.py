"""rpc_replay — replays rpc_dump recordio samples against a live server.

Port of tools/rpc_replay.py (the counterpart of brpc's tools/rpc_replay):
reads the recordio files that the ``rpc_dump`` flag writes (either
package's: the format is the same) and re-issues each sampled request
through a Channel, optionally qps-throttled. Records of another lane than
``echo`` (tpu_std) are skipped.

``--native`` fires the capture (the native flight recorder's, from
``/rpc_dump?seconds=N``, or the Python lane's) through the native client
lanes instead (``native.replay_run``): tpu_std, HTTP and gRPC records
each by its own lane, from ``--concurrency`` threads, paced at ``--qps``
(ramped to ``--qps-to``) or pressed, with latency quantiles. A capture
with nothing to replay, or a server that cannot be reached, is refused
with exit code 2.

Usage:
  python -m brpc_tpu_torch.tools.rpc_replay --dir ./rpc_dump \\
      --server 127.0.0.1:8000 [--qps 100] [--times 1] \\
      [--native [--qps-to 500] [--concurrency 8]]
"""
from __future__ import annotations

import argparse
import glob
import os
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dir", required=True, help="rpc_dump directory")
    ap.add_argument("--server", required=True)
    ap.add_argument("--qps", type=float, default=0)
    ap.add_argument("--times", type=int, default=1)
    ap.add_argument("--timeout-ms", type=float, default=1000)
    ap.add_argument("--native", action="store_true",
                    help="replay through the native client lanes "
                         "(nat_replay_run)")
    ap.add_argument("--qps-to", type=float, default=0,
                    help="with --native: ramp the rate linearly from "
                         "--qps to this across the run")
    ap.add_argument("--concurrency", type=int, default=4,
                    help="with --native: worker threads firing calls")
    args = ap.parse_args(argv)

    if args.native:
        return _native_replay(args)

    from brpc_tpu_torch import rpc
    from brpc_tpu_torch.butil.recordio import RecordReader

    files = sorted(glob.glob(os.path.join(args.dir, "*.rio")))
    if not files:
        print(f"no .rio files under {args.dir}", file=sys.stderr)
        return 1

    ch = rpc.Channel(rpc.ChannelOptions(timeout_ms=args.timeout_ms))
    if ch.init(args.server) != 0:
        print("channel init failed", file=sys.stderr)
        return 1

    interval = 1.0 / args.qps if args.qps > 0 else 0
    ok = fail = skipped = 0
    t0 = time.monotonic()
    try:
        for _ in range(args.times):
            for path in files:
                with RecordReader(path) as reader:
                    for meta, payload in reader:
                        # only tpu_std records replay through this
                        # Channel: an HTTP/redis/worker record fired as
                        # "service.method" would be a bogus call
                        if meta.get("lane", "echo") != "echo":
                            skipped += 1
                            continue
                        method = f"{meta['service']}.{meta['method']}"
                        # raw payload bytes; the response left unparsed
                        cntl, _ = ch.call(method, payload, None,
                                          log_id=meta.get("log_id", 0))
                        if cntl.failed():
                            fail += 1
                        else:
                            ok += 1
                        if interval:
                            time.sleep(interval)
    finally:
        ch.close()
    dt = time.monotonic() - t0
    print(f"replayed ok={ok} failed={fail} skipped={skipped} "
          f"in {dt:.1f}s ({(ok + fail) / max(dt, 1e-9):.1f} qps)")
    return 1 if fail else 0


def _native_replay(args) -> int:
    from brpc_tpu_torch import native

    ip, _, port = args.server.rpartition(":")
    try:
        res = native.replay_run(ip or "127.0.0.1", int(port), args.dir,
                                times=args.times, qps=args.qps,
                                qps_to=args.qps_to,
                                concurrency=args.concurrency,
                                timeout_ms=int(args.timeout_ms))
    except (ValueError, ConnectionError) as e:
        print(f"rpc_replay: {e}", file=sys.stderr)
        return 2
    print(f"replayed ok={res['ok']} failed={res['failed']} "
          f"skipped={res['skipped']} in {res['seconds']:.1f}s "
          f"({res['qps']:.1f} qps) "
          f"p50={res['p50_us']:.0f}us p99={res['p99_us']:.0f}us")
    return 1 if res["failed"] else 0


if __name__ == "__main__":
    sys.exit(main())
