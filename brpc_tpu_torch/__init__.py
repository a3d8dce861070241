"""brpc_tpu_torch — the PyTorch/CUDA port of brpc_tpu.

A second package beside brpc_tpu, which stays the reference. It imports
torch and numpy, never jax, ml_dtypes, protobuf or any brpc_tpu module.
Module paths and names follow the reference's, so each counterpart is easy
to find:

* ``tensor`` — the flagship model: the single-device forward, and the
  SPMD forward and train step over the five mesh axes;
* ``parallel`` — the collective verbs, ``MeshChannel``, the rank mesh and
  the spawn harness, on torch.distributed;
* ``rpc`` — the tensor lane (the device handshake, the block pool, the
  TensorStore service), the client and the server;
* ``bthread`` and ``bvar`` — the task-control workers, butex, timers and
  call ids; named metrics, windows and latency recorders;
* ``builtin`` and ``json2pb`` — the console a server serves over HTTP
  on its RPC port, its profilers (the card trace on ``/hotspots/tpu``),
  and JSON to and from the port's messages;
* ``rpcz`` — a span for each call on both sides, one trace across hops
  and packages, browsable at ``/rpcz``;
* ``entry`` — ``entry(device=None)`` and ``dryrun_multichip``, the
  counterparts of ``__graft_entry__``'s;
* ``fleet`` — mergeable log2 histograms and the SLO burn-rate engine.

``Status`` (butil/status.py) is exported here, as the reference does.

Entry points run on the card unless the caller passes ``device="cpu"``;
without CUDA a request for the card raises.
"""

__version__ = "0.1.0"

from brpc_tpu_torch.butil.status import Status  # noqa: F401,E402
