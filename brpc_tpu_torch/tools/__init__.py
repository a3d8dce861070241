"""tools — the twins of the repo's ``tools/`` on the port.

Each module keeps its reference file's name, prints the reference's lines
and has ``main(argv=None) -> int``:

    python -m brpc_tpu_torch.tools.rpc_press --server 127.0.0.1:8000 --method EchoService.Echo --input '{"message": "hi"}'
    python -m brpc_tpu_torch.tools.rpc_replay --dir ./rpc_dump --server 127.0.0.1:8000
    python -m brpc_tpu_torch.tools.rpc_view 127.0.0.1:8000 vars
    python -m brpc_tpu_torch.tools.parallel_http --url http://127.0.0.1:8000/status -n 100
    python -m brpc_tpu_torch.tools.trackme_server --port 8877
    python -m brpc_tpu_torch.tools.mcpack2pb_gen brpc_tpu_torch.rpc.proto.wire:EchoRequest -o echo_mcpack.py

They speak to servers of either package: the wire and the console pages
are the same. mcpack2pb_gen writes source that imports only the port.
"""
