"""rpc — the client and server of the port: the reference-grade channel
(naming services, load balancers, retries, backup requests, the circuit
breaker and the combo channels), the reference-grade server (acceptor,
input messenger and event dispatcher, method status and concurrency
limiters), the protocol registry with the tpu_std, stream and HTTP
framings, tpu_std compression (``compress``), streams and progressive
attachments (``progressive``), request recording (``rpc_dump``), the
device transport and the TensorStore service. Spans are in
``brpc_tpu_torch.rpcz``."""

from brpc_tpu_torch.rpc.channel import Channel, ChannelOptions  # noqa: F401
from brpc_tpu_torch.rpc.combo_channels import (  # noqa: F401
    CallMapper,
    DynamicPartitionChannel,
    ParallelChannel,
    PartitionChannel,
    PartitionParser,
    ResponseMerger,
    SelectiveChannel,
    SubCall,
)
from brpc_tpu_torch.rpc.controller import Controller, RetryPolicy  # noqa: F401
from brpc_tpu_torch.rpc.server import Server, ServerOptions  # noqa: F401
from brpc_tpu_torch.rpc.service import ClosureGuard, Service, rpc_method  # noqa: F401
from brpc_tpu_torch.rpc.stream import (  # noqa: F401
    Stream,
    StreamInputHandler,
    StreamOptions,
    stream_accept,
    stream_create,
)
