"""rpc — the client and server of the port: the reference-grade channel
(naming services, load balancers, retries, backup requests, the circuit
breaker and the combo channels), a small server, the tpu_std framing, the
device transport and the TensorStore service."""

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
from brpc_tpu_torch.rpc.service import Service, rpc_method  # noqa: F401
