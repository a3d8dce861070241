"""nshead_extension — an nshead server whose front end is generated by
mcpack2pb_gen, called with an mcpack body (example/nshead_extension_c++
and nshead_pb_extension_c++ counterpart).

Port of examples/nshead_extension.py:

  python -m brpc_tpu_torch.examples.nshead_extension [--device cpu]
"""
import argparse
import sys

from brpc_tpu_torch import mcpack2pb as mp
from brpc_tpu_torch import rpc
from brpc_tpu_torch.mcpack2pb_gen import (
    compile_codec,
    generate_nshead_adaptor_source,
)
from brpc_tpu_torch.rpc.nshead_protocol import NsheadMessage
from brpc_tpu_torch.rpc.proto import wire


class EchoService(rpc.Service):
    @rpc.rpc_method(wire.EchoRequest, wire.EchoResponse)
    def Echo(self, cntl, request, response, done):
        with rpc.ClosureGuard(done):
            response.message = request.message.swapcase()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    # the adaptor generated from the service's messages, as the
    # reference's generator writes it at build time
    src = generate_nshead_adaptor_source(EchoService)
    adaptor_cls = compile_codec(src, "echo_nshead").EchoServiceNsheadAdaptor
    srv = rpc.Server(rpc.ServerOptions(
        device=args.device, nshead_service=adaptor_cls(EchoService())))
    if srv.start("127.0.0.1:0") != 0:
        print("failed: cannot start the server")
        return 1
    ch = rpc.Channel(rpc.ChannelOptions(protocol="nshead", timeout_ms=1000))
    try:
        ch.init(str(srv.listen_endpoint))
        body = mp.enc_object("", [mp.enc_str("method", "Echo"),
                                  mp.enc_str("message", "Hello NSHEAD")])
        cntl, resp = ch.call("nshead", NsheadMessage(body), NsheadMessage)
        if cntl.failed():
            print("failed:", cntl.error_text)
            return 1
        msg = mp.loads(resp.body)["message"]
        if isinstance(msg, bytes):
            msg = msg.decode()
        print(f"nshead-mcpack reply: {msg!r}")
        return 0 if msg == "hELLO nshead" else 1
    finally:
        ch.close()
        srv.stop()


if __name__ == "__main__":
    sys.exit(main())
