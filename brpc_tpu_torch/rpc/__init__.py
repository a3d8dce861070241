"""rpc — the tensor lane of the port: a small server and channel, the
tpu_std framing, the device transport and the TensorStore service."""

from brpc_tpu_torch.rpc.channel import Channel, ChannelOptions  # noqa: F401
from brpc_tpu_torch.rpc.controller import Controller  # noqa: F401
from brpc_tpu_torch.rpc.server import Server, ServerOptions  # noqa: F401
