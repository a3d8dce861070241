"""mcpack2pb_gen — write the mcpack codec of messages, or an nshead adaptor.

Port of tools/mcpack2pb_gen.py:

    python -m brpc_tpu_torch.tools.mcpack2pb_gen \\
        brpc_tpu_torch.rpc.proto.wire:EchoRequest \\
        brpc_tpu_torch.rpc.proto.wire:EchoResponse -o echo_mcpack.py

    python -m brpc_tpu_torch.tools.mcpack2pb_gen --service \\
        mymod:EchoService -o adaptor.py

The output imports ``brpc_tpu_torch`` and the messages' modules only.
"""
from __future__ import annotations

import argparse
import importlib
import sys


def _resolve(spec: str):
    module_name, _, attr = spec.partition(":")
    return getattr(importlib.import_module(module_name), attr)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("specs", nargs="+",
                    help="module:MessageClass (module:ServiceClass with "
                         "--service)")
    ap.add_argument("--service", action="store_true",
                    help="an nshead-mcpack adaptor of a Service subclass")
    ap.add_argument("-o", "--output", default="-",
                    help="the output file (default: standard output)")
    args = ap.parse_args(argv)

    from brpc_tpu_torch.mcpack2pb_gen import (
        generate_codec_source,
        generate_nshead_adaptor_source,
    )

    if args.service:
        if len(args.specs) != 1:
            ap.error("--service takes exactly one module:ServiceClass")
        src = generate_nshead_adaptor_source(_resolve(args.specs[0]))
    else:
        src = generate_codec_source([_resolve(s) for s in args.specs])
    if args.output == "-":
        sys.stdout.write(src)
    else:
        with open(args.output, "w") as f:
            f.write(src)
        print(f"wrote {args.output}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
