"""device_performance — the example/rdma_performance twin: a
bvar-instrumented client/server pair hammering the device-transport lane
with concurrent pushers, reporting qps / latency percentiles / achieved
bandwidth from LatencyRecorders the way rdma_performance's client does
(client.cpp:50-52,136-183: g_latency_recorder + bvar reads per second).

Port of examples/device_performance.py:

  python -m brpc_tpu_torch.examples.device_performance [--threads 2] [--mb 2] [--iters 8]

As in the reference, the payload is host bytes (float64 from
``np.random.default_rng(0)``) pushed to a server in this process: the
in-process lane hands a ticket over and the card is never touched.
``run_pushers`` aims the same pushers at any TensorStore, another
process's included. Then, as in the reference, the native bulk lane:
``--mb`` MiB attachments echoed through the native runtime (its socket
write queue, dispatcher and zero-copy echo) from C++ for 1.5 s, in GB/s.
Where the native library does not build, one line says why.
"""
import argparse
import sys
import threading
import time

import numpy as np
import torch

from brpc_tpu_torch import bvar, rpc
from brpc_tpu_torch.device import resolve_device
from brpc_tpu_torch.rpc import device_transport as dt
from brpc_tpu_torch.rpc.tensor_service import (
    TensorClient,
    TensorStoreService,
    make_device_channel,
)


def make_payload(mb: int) -> torch.Tensor:
    """The reference's payload bytes, as a host tensor."""
    return torch.from_numpy(np.random.default_rng(0).standard_normal(
        (mb * 1024 * 1024) // 8).astype(np.float64))


def run_pushers(target: str, payload, threads: int, iters: int, device,
                recorder, bytes_moved, errors) -> float:
    """``threads`` pushers, each on a device channel of its own to
    ``target``, push ``payload`` ``iters`` times as t<thread>.<i>; the
    latency of each push that succeeds goes to ``recorder`` (us), its
    bytes to ``bytes_moved``, a failure to ``errors``. Returns the wall
    time in seconds."""
    nbytes = payload.numel() * payload.element_size()

    def pusher(tid: int):
        ch = make_device_channel(target, rpc.ChannelOptions(device=device))
        if ch is None:
            errors.update(iters)
            return
        client = TensorClient(ch)
        for i in range(iters):
            t0 = time.perf_counter()
            cntl, resp = client.push(f"t{tid}.{i}", [payload])
            if cntl.failed() or not resp.ok:
                errors.update(1)
                continue
            recorder.update((time.perf_counter() - t0) * 1e6)
            bytes_moved.update(nbytes)
        ch.close()

    t0 = time.perf_counter()
    workers = [threading.Thread(target=pusher, args=(t,))
               for t in range(threads)]
    for t in workers:
        t.start()
    for t in workers:
        t.join()
    return time.perf_counter() - t0


def report(recorder, bytes_moved, errors, wall: float, lanes: dict) -> None:
    """The reference's three lines: the lane (the one ``lanes``, the lane
    counters' moves over the run, moved most), the latencies, the rate."""
    total = bytes_moved.get_value()
    lane = max(lanes, key=lanes.get)
    print(f"lane={lane} pushes={recorder.count()} "
          f"errors={errors.get_value()}")
    print(f"avg={recorder.latency():.0f}us "
          f"p99={recorder.latency_percentile(0.99):.0f}us "
          f"max={recorder.max_latency():.0f}us")
    print(f"throughput={total / wall / 1e9:.2f} GB/s "
          f"({total / 1e6:.0f} MB in {wall:.2f}s)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--threads", type=int, default=2)
    ap.add_argument("--mb", type=int, default=2)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    srv = rpc.Server(rpc.ServerOptions(num_threads=4, device=device))
    srv.add_service(TensorStoreService())
    if srv.start("127.0.0.1:0") != 0:
        raise RuntimeError("device_performance: server start failed")
    try:
        recorder = bvar.LatencyRecorder("device_perf")
        bytes_moved = bvar.Adder("device_perf_bytes")
        errors = bvar.Adder("device_perf_errors")
        lanes0 = dt.lane_counters()
        wall = run_pushers(str(srv.listen_endpoint), make_payload(args.mb),
                           args.threads, args.iters, device, recorder,
                           bytes_moved, errors)
        lanes1 = dt.lane_counters()
        report(recorder, bytes_moved, errors, wall,
               {k: lanes1[k] - lanes0[k] for k in lanes1})
    finally:
        srv.stop()

    native_bulk(args.mb)
    return 0 if recorder.count() > 0 and errors.get_value() == 0 else 1


def native_bulk(mb: int, seconds: float = 1.5) -> dict:
    """The native bulk lane: ``mb`` MiB attachments echoed by the native
    runtime's echo for ``seconds``; prints the reference's line."""
    from brpc_tpu_torch import native

    try:
        port = native.rpc_server_start(native_echo=True)
    except (native.NativeUnavailable, RuntimeError) as e:
        print(f"native bulk lane unavailable: {e}")
        return {}
    try:
        res = native.rpc_client_bench_bulk("127.0.0.1", port, mb << 20,
                                           seconds)
    finally:
        native.rpc_server_stop()
    print(f"native_bulk={res['GBps']:.2f} GB/s "
          f"({res['bytes'] / 1e6:.0f} MB echoed, {mb}MB attachments)")
    return res


if __name__ == "__main__":
    sys.exit(main())
