"""partition_echo + selective_echo + dynamic partition — combo channels
over tagged naming (example/partition_echo_c++ / selective_echo_c++ /
dynamic_partition_echo_c++ counterparts).

Port of examples/partition_echo.py:

  python -m brpc_tpu_torch.examples.partition_echo [--device cpu]
"""
import argparse
import sys

from brpc_tpu_torch import rpc
from brpc_tpu_torch.rpc.proto import wire


class PartEcho(rpc.Service):
    SERVICE_NAME = "EchoService"

    def __init__(self, name):
        self.name = name

    @rpc.rpc_method(wire.EchoRequest, wire.EchoResponse)
    def Echo(self, cntl, request, response, done):
        response.message = f"{self.name},"
        done()


class ConcatMerger(rpc.ResponseMerger):
    def merge(self, main, sub):
        main.message += sub.message
        return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    servers, channels = [], []
    try:
        for i in range(3):
            srv = rpc.Server(rpc.ServerOptions(device=args.device))
            srv.add_service(PartEcho(f"part{i}"))
            if srv.start("127.0.0.1:0") != 0:
                raise RuntimeError("partition_echo: server start failed")
            servers.append(srv)

        # ---- PartitionChannel: tags "i/3" shard the service 3 ways
        url = "list://" + ",".join(
            f"{s.listen_endpoint} {i}/3" for i, s in enumerate(servers))
        pc = rpc.PartitionChannel()
        if pc.init(3, url, "rr") != 0:
            raise RuntimeError("partition_echo: partition channel init")
        for i in range(len(pc._subs)):
            ch, m, _ = pc._subs[i]
            pc._subs[i] = (ch, m, ConcatMerger())
        cntl, resp = pc.call("EchoService.Echo",
                             wire.EchoRequest(message="p"),
                             wire.EchoResponse, timeout_ms=3000)
        print("partitioned call hit:", resp.message)
        pc.stop()

        # ---- SelectiveChannel: one healthy channel per call with failover
        sc = rpc.SelectiveChannel()
        dead = rpc.Channel(rpc.ChannelOptions(max_retry=0, timeout_ms=200))
        dead.init("127.0.0.1:1")
        sc.add_channel(dead)
        live = rpc.Channel()
        live.init(str(servers[0].listen_endpoint))
        sc.add_channel(live)
        channels += [dead, live]
        cntl, resp = sc.call("EchoService.Echo",
                             wire.EchoRequest(message="s"),
                             wire.EchoResponse, timeout_ms=2000)
        print("selective call (with failover past a dead node):",
              resp.message)

        # ---- DynamicPartitionChannel: 1-way and 2-way schemes co-exist
        url2 = (f"list://{servers[0].listen_endpoint} 0/1,"
                f"{servers[1].listen_endpoint} 0/2,"
                f"{servers[2].listen_endpoint} 1/2")
        dc = rpc.DynamicPartitionChannel()
        if dc.init(url2, "rr") != 0:
            raise RuntimeError("partition_echo: dynamic partition init")
        for _ in range(3):
            cntl, resp = dc.call("EchoService.Echo",
                                 wire.EchoRequest(message="d"),
                                 wire.EchoResponse, timeout_ms=3000)
            print("dynamic-partition call hit:", resp.message)
        dc.stop()
    finally:
        for ch in channels:
            ch.close()
        for srv in servers:
            srv.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
