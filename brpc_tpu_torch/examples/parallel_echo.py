"""parallel_echo — ParallelChannel fan-out (example/parallel_echo_c++
counterpart) plus its fused-device twin: the same call shape executed as
ONE collective through MeshChannel.

Port of examples/parallel_echo.py:

  python -m brpc_tpu_torch.examples.parallel_echo [--device cuda] [--ranks N]

The mesh half runs on ``parallel.run_ranks``, rank r on card r, when
there are two cards or more; on the CPU ``--ranks`` sets the number of
gloo ranks, as ``--xla_force_host_platform_device_count`` does for the
reference.
"""
import argparse
import sys

import torch

from brpc_tpu_torch import rpc
from brpc_tpu_torch.device import resolve_device
from brpc_tpu_torch.examples.tensor_transport import mesh_ranks
from brpc_tpu_torch.rpc.proto import wire


class NodeEcho(rpc.Service):
    SERVICE_NAME = "EchoService"

    def __init__(self, name):
        self.name = name

    @rpc.rpc_method(wire.EchoRequest, wire.EchoResponse)
    def Echo(self, cntl, request, response, done):
        response.message = f"{self.name}:{request.message};"
        done()


class ConcatMerger(rpc.ResponseMerger):
    def merge(self, main, sub):
        main.message += sub.message
        return 0


def mesh_fanout_rank(device) -> float:
    """One rank of the fused twin: shard r is [r]; each rank doubles its
    shard and the merger adds them, one all-reduce over every rank."""
    from brpc_tpu_torch import parallel
    from brpc_tpu_torch.tensor.config import MeshSpec

    n = torch.distributed.get_world_size()
    mesh = parallel.RankMesh(MeshSpec(dp=n))
    mc = parallel.MeshChannel(mesh, "dp")
    shard = torch.tensor([[float(mesh.rank)]], device=device)
    merged = mc.parallel_call(lambda s: s * 2.0, shard, merger="add")
    return float(merged.ravel()[0])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ranks", type=int, default=None,
                    help="mesh ranks (default: every card; 1 on the CPU)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    servers, channels = [], []
    try:
        pc = rpc.ParallelChannel()
        for i in range(3):
            srv = rpc.Server(rpc.ServerOptions(device=device))
            srv.add_service(NodeEcho(f"node{i}"))
            if srv.start("127.0.0.1:0") != 0:
                raise RuntimeError("parallel_echo: server start failed")
            servers.append(srv)
            ch = rpc.Channel()
            if ch.init(str(srv.listen_endpoint)) != 0:
                raise RuntimeError("parallel_echo: channel init failed")
            channels.append(ch)
            pc.add_channel(ch, response_merger=ConcatMerger())

        cntl, resp = pc.call("EchoService.Echo",
                             wire.EchoRequest(message="fanout"),
                             wire.EchoResponse, timeout_ms=3000)
        print("RPC fan-out merged:", resp.message,
              f"({cntl.latency_us:.0f}us)")

        # The fused twin: same semantics, one collective.
        n = mesh_ranks(device, args.ranks)
        if n >= 2:
            from brpc_tpu_torch import parallel

            merged = parallel.run_ranks(mesh_fanout_rank, n,
                                        device=device)[0]
            print(f"Mesh fan-out (ONE allreduce over {n} devices):", merged)
    finally:
        for ch in channels:
            ch.close()
        for srv in servers:
            srv.stop()
    return 0 if not cntl.failed() else 1


if __name__ == "__main__":
    sys.exit(main())
