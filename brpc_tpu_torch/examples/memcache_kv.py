"""memcache_kv — batched memcache binary-protocol operations through a
memcache channel (example/memcache_c++ counterpart), against a port
server that speaks memcache.

Port of examples/memcache_kv.py:

  python -m brpc_tpu_torch.examples.memcache_kv [--device cpu]
"""
import argparse
import sys

from brpc_tpu_torch import rpc
from brpc_tpu_torch.rpc.memcache import (
    MemcacheRequest,
    MemcacheResponse,
    MemcacheService,
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    srv = rpc.Server(rpc.ServerOptions(device=args.device,
                                       memcache_service=MemcacheService()))
    if srv.start("127.0.0.1:0") != 0:
        print("failed: cannot start the server")
        return 1
    ch = rpc.Channel(rpc.ChannelOptions(protocol="memcache",
                                        timeout_ms=1000))
    try:
        ch.init(str(srv.listen_endpoint))
        req = MemcacheRequest().set("chip", "tpu-v5e").get("chip") \
                               .incr("hits", 1, initial=1).incr("hits", 1)
        resp = MemcacheResponse()
        cntl = rpc.Controller()
        ch.call_method("memcache", cntl, req, resp)
        if cntl.failed() or not resp.pop_store():
            print("failed:", cntl.error_text)
            return 1
        ok, value = resp.pop_get()
        print(f"get chip -> {value!r}")
        _, first = resp.pop_counter()
        _, second = resp.pop_counter()
        print(f"hits counter: {first} then {second}")
        return 0 if ok and value == b"tpu-v5e" and second == first + 1 else 1
    finally:
        ch.close()
        srv.stop()


if __name__ == "__main__":
    sys.exit(main())
