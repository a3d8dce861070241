"""streaming_echo — Streams with flow control (example/streaming_echo_c++
counterpart): the client opens a stream on an RPC, pushes chunks, the
server echoes them back on the same stream.

Port of examples/streaming_echo.py:

  python -m brpc_tpu_torch.examples.streaming_echo [--device cpu]
"""
import argparse
import sys
import threading
import time

from brpc_tpu_torch import rpc
from brpc_tpu_torch.rpc.proto import wire


class StreamingEchoService(rpc.Service):
    @rpc.rpc_method(wire.EchoRequest, wire.EchoResponse)
    def Open(self, cntl, request, response, done):
        class EchoBack(rpc.StreamInputHandler):
            def on_received_messages(self, stream, messages):
                for m in messages:
                    stream.write(m)

            def on_closed(self, stream):
                print("[server] stream closed")

        stream = rpc.stream_accept(cntl,
                                   rpc.StreamOptions(handler=EchoBack()))
        response.message = "accepted" if stream else "no stream"
        done()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    srv = rpc.Server(rpc.ServerOptions(device=args.device))
    srv.add_service(StreamingEchoService())
    if srv.start("127.0.0.1:0") != 0:
        raise RuntimeError("streaming_echo: server start failed")

    got = []
    done_ev = threading.Event()

    class Collect(rpc.StreamInputHandler):
        def on_received_messages(self, stream, messages):
            for m in messages:
                got.append(m.to_bytes())
            if len(got) >= 5:
                done_ev.set()

        def on_closed(self, stream):
            print("[client] stream closed")

    ch = rpc.Channel()
    try:
        if ch.init(str(srv.listen_endpoint)) != 0:
            raise RuntimeError("streaming_echo: channel init failed")
        cntl = rpc.Controller()
        cntl.timeout_ms = 3000
        stream = rpc.stream_create(cntl,
                                   rpc.StreamOptions(handler=Collect()))
        resp = wire.EchoResponse()
        ch.call_method("StreamingEchoService.Open", cntl,
                       wire.EchoRequest(message="open"), resp)
        if cntl.failed():
            raise RuntimeError(f"streaming_echo: {cntl.error_text}")
        stream.wait_connected(3)
        for i in range(5):
            stream.write(f"chunk-{i}".encode())
        done_ev.wait(5)
        print("echoed back:", got)
        stream.close()
        time.sleep(0.1)
    finally:
        ch.close()
        srv.stop()
    return 0 if len(got) == 5 else 1


if __name__ == "__main__":
    sys.exit(main())
