"""Tensor transport service — RPC-carried tensors.

Port of brpc_tpu/rpc/tensor_service.py: a TensorStore service accepts
pushed tensors and serves pulls; tensors ride the tpu_std attachment
described by RpcMeta.tensors, via brpc_tpu_torch.rpc.device_transport:
zero-copy in process, records in the receiver's descriptor-ring arena, a
shared-arena descriptor or a device-to-device pull on the same host, and
bytes on the wire otherwise.

Server-side handshake counterpart: the ``device_handshake`` protocol
below answers the DeviceEndpoint.app_connect handshake on accepted
connections, so both ends of a connection know each other's device
identity.
"""
from __future__ import annotations

import json
import struct
import threading
from typing import Callable, Dict, List, Optional

from brpc_tpu_torch.butil.iobuf import IOBuf
from brpc_tpu_torch.rpc import errors
from brpc_tpu_torch.rpc.device_transport import (
    DeviceEndpoint,
    local_device_info,
    receive_tensors,
)
from brpc_tpu_torch.rpc.protocol import (
    InputMessageBase,
    ParseResult,
    Protocol,
    ProtocolType,
    register_protocol,
)
from brpc_tpu_torch.rpc.proto import wire as ts_pb2
from brpc_tpu_torch.rpc.service import Service, rpc_method

_HANDSHAKE_MAGIC = b"TDEV"


class _HandshakeMsg(InputMessageBase):
    __slots__ = ("info", "is_request")

    def __init__(self, info: dict):
        super().__init__()
        self.info = info
        self.is_request = True


def _parse_handshake(portal: IOBuf, sock, read_eof: bool, arg) -> ParseResult:
    if len(portal) < 8:
        head = portal.copy_to_bytes(min(4, len(portal)))
        if _HANDSHAKE_MAGIC.startswith(head):
            return ParseResult.not_enough()
        return ParseResult.try_others()
    header = portal.copy_to_bytes(8)
    if header[:4] != _HANDSHAKE_MAGIC:
        return ParseResult.try_others()
    (length,) = struct.unpack(">I", header[4:8])
    if length > 1 << 20:
        return ParseResult.error_()
    if len(portal) < 8 + length:
        return ParseResult.not_enough()
    portal.pop_front(8)
    try:
        info = json.loads(portal.cutn_bytes(length))
    except ValueError:
        return ParseResult.error_()
    if not isinstance(info, dict):
        return ParseResult.error_()
    return ParseResult.ok(_HandshakeMsg(info))


def _process_handshake(msg: _HandshakeMsg):
    """Server half of the device handshake: answer with our identity and
    attach an ESTABLISHED/FALLBACK endpoint to the connection. The identity
    is the server's device (``ServerOptions.device``). A server with a
    TensorStore service arms the descriptor-ring fabric (its start already
    did) and advertises its segment, so same-host clients push straight
    into its blob arena (the ring lane); other servers advertise none
    (queue C #37)."""
    sock = msg.socket
    device = msg.arg.options.device
    ep = DeviceEndpoint(device=device)
    ep.peer_info = msg.info
    mine = local_device_info(device, arm_fabric=msg.arg.arms_fabric())
    from brpc_tpu_torch.rpc import device_transport as dt

    if msg.info.get("device_count", 0) > 0 and mine["device_count"] > 0:
        ep.state = dt.ESTABLISHED
        if msg.info.get("xfer"):
            try:
                fd = sock.fd()
                if fd is not None:
                    ep.resolve_xfer_addr(fd.getsockname()[0])
            except OSError:
                pass
    else:
        ep.state = dt.FALLBACK_TCP
    sock.app_state = ep
    info = json.dumps(mine).encode()
    out = IOBuf()
    out.append(_HANDSHAKE_MAGIC + struct.pack(">I", len(info)) + info)
    sock.write(out)


# processed inline: the endpoint is on the connection before any request
# that follows the handshake runs
register_protocol(Protocol(
    name="device_handshake",
    type=ProtocolType.TENSOR,
    parse=_parse_handshake,
    process_request=_process_handshake,
    process_inline=True,
    support_client=False,
))


# -- the store service ------------------------------------------------------

class TensorStoreService(Service):
    """In-memory named tensor store — push/pull over RPC."""

    SERVICE_NAME = "TensorStore"

    def __init__(self, on_push: Optional[Callable[[str, List], None]] = None):
        self._store: Dict[str, List] = {}
        self._lock = threading.Lock()
        self._on_push = on_push

    @rpc_method(ts_pb2.TensorPushRequest, ts_pb2.TensorPushResponse)
    def Push(self, cntl, request, response, done):
        meta = getattr(cntl, "_rpc_meta", None)
        if meta is None or not meta.tensors:
            cntl.set_failed(errors.EREQUEST, "no tensors in request")
            done()
            return
        ep = (cntl._server_socket.app_state
              if cntl._server_socket is not None else None)
        # host tensors from the wire and shm lanes, as in the reference; an
        # xfer push lands on the connection's device
        arrays, seq = receive_tensors(
            meta, cntl.request_attachment,
            endpoint=ep if isinstance(ep, DeviceEndpoint) else None)
        with self._lock:
            self._store[request.name] = arrays
        if self._on_push is not None:
            try:
                self._on_push(request.name, arrays)
            except Exception:
                pass  # the reference's rule: a hook never fails the push
        response.ok = True
        response.ack_seq = seq or 0
        done()

    @rpc_method(ts_pb2.TensorPullRequest, ts_pb2.TensorPullResponse)
    def Pull(self, cntl, request, response, done):
        with self._lock:
            arrays = self._store.get(request.name)
        if arrays is None:
            response.found = False
            done()
            return
        response.found = True
        meta = cntl._response_meta
        if meta is not None:
            ep = (cntl._server_socket.app_state
                  if cntl._server_socket is not None else None)
            if not isinstance(ep, DeviceEndpoint):
                ep = DeviceEndpoint()
            ep.prepare_send(arrays, meta, cntl.response_attachment)
        done()

    @rpc_method(ts_pb2.TensorAckRequest, ts_pb2.TensorAckResponse)
    def Ack(self, cntl, request, response, done):
        """Explicit ACK frame for pull transfers: releases the connection
        endpoint's retained sends and opens its window."""
        ep = (cntl._server_socket.app_state
              if cntl._server_socket is not None else None)
        if isinstance(ep, DeviceEndpoint) and request.seq:
            ep.on_ack(request.seq)
        response.ok = True
        done()

    def get(self, name: str) -> Optional[List]:
        with self._lock:
            return self._store.get(name)


class TensorClient:
    """Client-side helper: push/pull tensors through a channel whose
    connections carry a DeviceEndpoint: a Channel to one server or behind
    a naming service and a load balancer, or a SelectiveChannel. A push's
    ACK comes back in its response and is applied on the connection that
    served it; a pull's ACK is sent on the connection that served it."""

    def __init__(self, channel):
        self.channel = channel

    def push(self, name: str, arrays: List, timeout_ms: float = 10000):
        from brpc_tpu_torch.rpc.controller import Controller

        cntl = Controller()
        cntl.timeout_ms = timeout_ms
        cntl._outbound_tensors = arrays
        response = ts_pb2.TensorPushResponse()
        self.channel.call_method(
            "TensorStore.Push", cntl,
            ts_pb2.TensorPushRequest(name=name), response,
        )
        if not cntl.failed() and cntl._current_sock is not None:
            ep = cntl._current_sock.app_state
            if isinstance(ep, DeviceEndpoint) and response.ack_seq:
                ep.on_ack(response.ack_seq)
        return cntl, response

    def pull(self, name: str, timeout_ms: float = 10000, device=None):
        """``device=None`` returns host tensors (the xfer lane: tensors on
        the channel's device); a device lands the bytes there."""
        from brpc_tpu_torch.rpc.channel import call_on_socket
        from brpc_tpu_torch.rpc.controller import Controller

        cntl = Controller()
        cntl.timeout_ms = timeout_ms
        response = ts_pb2.TensorPullResponse()
        self.channel.call_method(
            "TensorStore.Pull", cntl,
            ts_pb2.TensorPullRequest(name=name), response,
        )
        if cntl.failed() or not response.found:
            return cntl, None
        meta = getattr(cntl, "_response_rpc_meta", None)
        if meta is None:
            return cntl, None
        ep = (cntl._current_sock.app_state
              if cntl._current_sock is not None else None)
        arrays, seq = receive_tensors(
            meta, cntl.response_attachment, device=device,
            endpoint=ep if isinstance(ep, DeviceEndpoint) else None)
        if seq:
            # the explicit ACK frees the server's retained span and window.
            # It rides the connection that served the pull, whose endpoint
            # retains it; a balancer could send it to another server
            # (ROADMAP queue C #8). The ACK's bytes are the reference's,
            # and it carries the channel's credential, as the reference's
            # (sent through the channel) does.
            ack_cntl = Controller()
            ack_cntl.timeout_ms = timeout_ms
            call_on_socket(cntl._current_sock, "TensorStore.Ack", ack_cntl,
                           ts_pb2.TensorAckRequest(seq=seq),
                           ts_pb2.TensorAckResponse(),
                           options=getattr(self.channel, "options", None))
        return cntl, arrays


def make_device_channel(target, options=None):
    """A Channel whose connection handshakes the device transport — sugar
    for ChannelOptions(use_device_transport=True)."""
    import dataclasses

    from brpc_tpu_torch.rpc.channel import Channel, ChannelOptions

    options = (dataclasses.replace(options, use_device_transport=True)
               if options is not None
               else ChannelOptions(use_device_transport=True))
    ch = Channel(options)
    rc = ch.init(target)
    if rc != 0:
        return None
    return ch
