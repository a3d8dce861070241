"""dynamic_partition_echo — example/dynamic_partition_echo_c++
counterpart: servers announce DIFFERENT partitioning schemes ("N/M" tags)
in one naming service; DynamicPartitionChannel groups them per scheme and
weights scheme choice by live capacity through the _dynpart LB.

Port of examples/dynamic_partition_echo.py:

  python -m brpc_tpu_torch.examples.dynamic_partition_echo [--device cpu]
"""
import argparse
import sys

from brpc_tpu_torch import rpc
from brpc_tpu_torch.rpc.combo_channels import (
    DynamicPartitionChannel,
    PartitionParser,
)
from brpc_tpu_torch.rpc.proto import wire


class PartEcho(rpc.Service):
    SERVICE_NAME = "EchoService"

    def __init__(self, part, total):
        self.part, self.total = part, total

    @rpc.rpc_method(wire.EchoRequest, wire.EchoResponse)
    def Echo(self, cntl, request, response, done):
        with rpc.ClosureGuard(done):
            response.message = f"{self.part}/{self.total}:{request.message}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    # one 2-way partitioned generation and one 3-way (the migration
    # scenario dynamic partitioning exists for)
    servers, nodes = [], []
    try:
        for total in (2, 3):
            for part in range(total):
                srv = rpc.Server(rpc.ServerOptions(device=args.device))
                srv.add_service(PartEcho(part, total))
                if srv.start("127.0.0.1:0") != 0:
                    raise RuntimeError("dynamic_partition_echo: server "
                                       "start failed")
                servers.append(srv)
                nodes.append(f"{srv.listen_endpoint} {part}/{total}")

        dpc = DynamicPartitionChannel()
        rc = dpc.init("list://" + ",".join(nodes), "rr",
                      parser=PartitionParser(),
                      options=rpc.ChannelOptions(timeout_ms=500))
        if rc != 0:
            raise RuntimeError(f"dynamic_partition_echo: init gave {rc}")

        counts = {2: 0, 3: 0}
        for i in range(20):
            cntl, resp = dpc.call("EchoService.Echo",
                                  wire.EchoRequest(message=str(i)),
                                  wire.EchoResponse)
            if cntl.failed():
                raise RuntimeError(f"dynamic_partition_echo: "
                                   f"{cntl.error_text}")
            total = int(resp.message.split(":")[0].split("/")[1])
            counts[total] += 1
        print(f"scheme usage (2-way vs 3-way, capacity-weighted): {counts}")
        dpc.stop()
    finally:
        for srv in servers:
            srv.stop()
    return 0 if counts[2] and counts[3] else 1


if __name__ == "__main__":
    sys.exit(main())
