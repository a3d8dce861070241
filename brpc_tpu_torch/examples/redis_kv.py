"""redis_kv — a server that speaks redis (a RedisService with command
handlers) and a client that pipelines commands over a redis channel
(example/redis_c++ counterpart); redis-cli works against the port too.

Port of examples/redis_kv.py:

  python -m brpc_tpu_torch.examples.redis_kv [--device cpu]
"""
import argparse
import sys

from brpc_tpu_torch import rpc
from brpc_tpu_torch.rpc.redis import (
    DictRedisService,
    RedisRequest,
    RedisResponse,
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    srv = rpc.Server(rpc.ServerOptions(device=args.device,
                                       redis_service=DictRedisService()))
    if srv.start("127.0.0.1:0") != 0:
        print("failed: cannot start the server")
        return 1
    ch = rpc.Channel(rpc.ChannelOptions(protocol="redis", timeout_ms=1000))
    try:
        ch.init(str(srv.listen_endpoint))
        req = RedisRequest()
        req.add_command("SET", "pod", "v5e-8")
        req.add_command("GET", "pod")
        req.add_command("DEL", "pod")
        req.add_command("GET", "pod")
        resp = RedisResponse()
        cntl = rpc.Controller()
        ch.call_method("redis", cntl, req, resp)
        if cntl.failed() or resp.reply_count != 4:
            print("failed:", cntl.error_text)
            return 1
        print("SET ->", resp.reply(0))
        print("GET ->", resp.reply(1))
        print("DEL ->", resp.reply(2))
        print("GET after DEL ->", resp.reply(3), "(nil)" if
              resp.reply(3).is_nil() else "")
        return 0 if resp.reply(1).value == b"v5e-8" else 1
    finally:
        ch.close()
        srv.stop()


if __name__ == "__main__":
    sys.exit(main())
