"""examples — the twins of the repo's ``examples/`` on the port.

Each module keeps its reference file's name, prints the reference's lines
(only the numbers differ) and has ``main(argv=None) -> int``:

    python -m brpc_tpu_torch.examples.echo demo [--device cpu]
    python -m brpc_tpu_torch.examples.tensor_transport --mb 8 --iters 10

``--device`` (default ``cuda``) goes to every ``ServerOptions`` and to the
device channels; without a card ``cuda`` raises and never falls back to
the CPU. ``tensor_transport`` and ``device_performance`` push tensors;
``parallel_echo`` and ``tensor_transport`` run their mesh halves on
``parallel.run_ranks`` when there are two cards or more (``--ranks`` on
the CPU). The other examples are host programs; ``grpc_echo`` calls one
server over gRPC and over tpu_std on its one port, ``legacy_pbrpc_echo``
over hulu_pbrpc, sofa_pbrpc and tpu_std, ``redis_kv``,
``memcache_kv`` and ``thrift_echo`` call a server that speaks redis,
memcache or thrift, ``nshead_extension`` one whose nshead front end
mcpack2pb_gen writes, and ``rtmp_relay`` relays a live RTMP stream,
dumps it to FLV and MPEG-TS and pulls it to a second server over the
digest handshake. The native runtime's programs: ``native_client`` (a
sync call, a done-callback, a deadline, a revived connection),
``native_protocol_clients`` (gRPC and HTTP through the native clients),
``usercode_workers`` (handlers in shm worker processes) and
``io_uring_echo`` (the io_uring datapath and its completion counts);
``device_performance`` ends with the native bulk lane.
"""
