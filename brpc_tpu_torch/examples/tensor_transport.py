"""tensor_transport — the rdma_performance counterpart
(example/rdma_performance/): pushes/pulls device tensors through the
TensorStore service over a device-handshaked channel and reports achieved
throughput, then probes raw collective bandwidth on the mesh.

Port of examples/tensor_transport.py:

  python -m brpc_tpu_torch.examples.tensor_transport [--mb 8] [--iters 10] [--device cuda]

In process the device lane hands a ticket for the tensor over, so its
"GB/s" is the cost of a ticket, not of moving bytes. Across processes it
takes the shm lane (a shared page-locked arena), or xfer (CUDA IPC) with
``BRPC_TPU_DEVICE_TRANSPORT_PREFER_XFER=1`` in both processes; the lane
is named by the reference's rule, which knows "ring", "shm" and "wire"
(and prints "?" for xfer). The mesh probe runs on ``parallel.run_ranks``,
rank r on card r, when there are two cards or more; on the CPU ``--ranks``
sets the number of gloo ranks.
"""
import argparse
import os
import subprocess
import sys
import time

import torch

from brpc_tpu_torch import rpc
from brpc_tpu_torch.device import resolve_device
from brpc_tpu_torch.rpc import device_transport as dt
from brpc_tpu_torch.rpc.tensor_service import (
    TensorClient,
    TensorStoreService,
    make_device_channel,
)

# The cross-process server: a port TensorStore in a fresh interpreter on
# the given device, serving until its stdin closes.
_SERVER_SCRIPT = (
    "import sys\n"
    "from brpc_tpu_torch import rpc\n"
    "from brpc_tpu_torch.rpc.tensor_service import TensorStoreService\n"
    "srv = rpc.Server(rpc.ServerOptions(num_threads=2, device=sys.argv[1]))\n"
    "srv.add_service(TensorStoreService())\n"
    "if srv.start('127.0.0.1:0') != 0:\n"
    "    sys.exit('tensor_transport: the server did not start')\n"
    "print(srv.listen_endpoint.port, flush=True)\n"
    "sys.stdin.readline()\n"
    "srv.stop()\n"
)
_PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _ok(cntl):
    if cntl.failed():
        raise RuntimeError(f"tensor_transport: {cntl.error_text}")


def push_rounds(client: TensorClient, arr, iters: int, prefix: str) -> dict:
    """A warm push, then ``iters`` timed pushes named prefix0, prefix1,
    ...; the seconds they took, the lane counters they moved and the
    connection's endpoint."""
    lanes0 = dt.lane_counters()
    cntl, _ = client.push(f"{prefix}warm", [arr])
    _ok(cntl)
    ep = cntl._current_sock.app_state
    t0 = time.perf_counter()
    for i in range(iters):
        cntl, _ = client.push(f"{prefix}{i}", [arr])
        _ok(cntl)
    seconds = time.perf_counter() - t0
    lanes1 = dt.lane_counters()
    return {"seconds": seconds, "endpoint": ep,
            "lanes": {k: lanes1[k] - lanes0[k] for k in lanes1}}


def reference_lane(lanes: dict) -> str:
    """The lane as the reference names it (examples/tensor_transport.py)."""
    return next((k for k in ("ring", "shm", "wire") if lanes[k] > 0), "?")


def in_process(srv: rpc.Server, device, mb: int, iters: int) -> dict:
    """Push ``iters`` x ``mb`` MiB of zeros made on ``device`` to a server
    in this process, pull the first back, check it bit for bit."""
    ch = make_device_channel(str(srv.listen_endpoint),
                             rpc.ChannelOptions(device=device))
    try:
        client = TensorClient(ch)
        nbytes = mb << 20
        arr = torch.zeros((nbytes // 4,), dtype=torch.float32, device=device)
        run = push_rounds(client, arr, iters, "t")
        ep = run["endpoint"]
        print(f"endpoint state: {ep.state} "
              f"(2=ESTABLISHED, 3=FALLBACK_TCP), "
              f"same_process={ep.same_process}")
        total = nbytes * iters
        print(f"pushed {iters} x {mb}MB in {run['seconds']:.3f}s "
              f"-> {total / run['seconds'] / 1e9:.2f} GB/s "
              f"(zero-copy in-process device lane)")
        cntl, pulled = client.pull("t0")
        if pulled is None or not torch.equal(
                pulled[0].view(torch.uint8), arr.view(torch.uint8)):
            raise RuntimeError("tensor_transport: the pulled tensor differs")
        print("pull verified")
        return run
    finally:
        ch.close()


def spawn_server(device):
    """A port TensorStore server in a subprocess; (process, port)."""
    proc = subprocess.Popen(
        [sys.executable, "-c", _SERVER_SCRIPT, str(device)],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
        cwd=_PACKAGE_ROOT)
    line = proc.stdout.readline()
    if not line.strip().isdigit():
        stop_server(proc)
        raise RuntimeError(f"tensor_transport: the server printed {line!r}")
    return proc, int(line)


def stop_server(proc) -> int:
    try:
        proc.stdin.close()
    except OSError:
        pass
    try:
        return proc.wait(timeout=10)
    except subprocess.TimeoutExpired:
        proc.kill()
        return proc.wait()


def across_processes(client: TensorClient, arr, mb: int, iters: int) -> dict:
    """Push ``iters`` x ``arr`` to a server in another process and print
    the reference's cross-process line."""
    run = push_rounds(client, arr, iters, "x")
    ep = run["endpoint"]
    nbytes = arr.numel() * arr.element_size()
    print(f"cross-process pushed {iters} x {mb}MB in {run['seconds']:.3f}s "
          f"-> {nbytes * iters / run['seconds'] / 1e9:.2f} GB/s "
          f"({reference_lane(run['lanes'])} lane, same_host={ep.same_host}, "
          f"same_process={ep.same_process})")
    return run


def mesh_probe_rank(device, nbytes: int, iters: int) -> dict:
    """One rank of the mesh probe: the all-reduce bandwidth over every
    rank (``parallel.ici_bandwidth_probe`` on the dp axis)."""
    from brpc_tpu_torch import parallel
    from brpc_tpu_torch.tensor.config import MeshSpec

    mesh = parallel.RankMesh(MeshSpec(dp=torch.distributed.get_world_size()))
    return parallel.ici_bandwidth_probe(mesh, "dp", nbytes=nbytes,
                                        iters=iters)


def mesh_ranks(device, ranks) -> int:
    """The ranks of the mesh halves: every card on the card, the caller's
    count (default 1) on the CPU."""
    if ranks is not None:
        return ranks
    return torch.cuda.device_count() if device.type == "cuda" else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mb", type=int, default=8)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ranks", type=int, default=None,
                    help="mesh ranks (default: every card; 1 on the CPU)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    srv = rpc.Server(rpc.ServerOptions(device=device))
    srv.add_service(TensorStoreService())
    if srv.start("127.0.0.1:0") != 0:
        raise RuntimeError("tensor_transport: server start failed")
    try:
        in_process(srv, device, args.mb, args.iters)

        # cross-process lane: a subprocess server, payloads through the
        # shared page-locked arena (a descriptor on the wire), or pulled
        # card to card over CUDA IPC when xfer is preferred
        proc, port = spawn_server(device)
        try:
            xch = make_device_channel(f"127.0.0.1:{port}",
                                      rpc.ChannelOptions(device=device))
            try:
                arr = torch.zeros(((args.mb << 20) // 4,),
                                  dtype=torch.float32, device=device)
                across_processes(TensorClient(xch), arr, args.mb, args.iters)
            finally:
                xch.close()
        finally:
            stop_server(proc)

        n = mesh_ranks(device, args.ranks)
        if n >= 2:
            from brpc_tpu_torch import parallel

            stats = parallel.run_ranks(mesh_probe_rank, n,
                                       (1 << 22, 5), device=device)[0]
            print(f"mesh allreduce over {n} devices: "
                  f"{stats['allreduce_GBps']:.2f} GB/s")
    finally:
        srv.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
