"""Channel — the client endpoint of the tensor lane.

The reference's Channel (brpc_tpu/rpc/channel.py) adds retries, load
balancing, naming, backup requests and the native runtime; they come with
the reference-grade channel. This one keeps what the lane needs: one
connection per Channel, opened on the first call; the device handshake on
connect when ``use_device_transport`` is set (through the same
``_app_connect_factory`` seam as the reference); a correlation-id table
filled by a reader thread; and a synchronous ``call_method`` that fails
with ERPCTIMEDOUT when its deadline passes.
"""
from __future__ import annotations

import itertools
import socket as pysocket
import threading
import time
from dataclasses import dataclass
from typing import Dict, Optional

from brpc_tpu_torch.device import DeviceLike
from brpc_tpu_torch.rpc import errors, tpu_std_protocol
from brpc_tpu_torch.rpc.controller import Controller
from brpc_tpu_torch.rpc.server import EndPoint
from brpc_tpu_torch.rpc.socket import Socket


@dataclass
class ChannelOptions:
    """The reference's ChannelOptions defaults for the fields this channel
    reads, plus the identity its device handshake announces."""

    connect_timeout_ms: float = 200
    timeout_ms: float = 500
    # use_rdma analog: the connection runs the device handshake
    use_device_transport: bool = False
    # the card unless the caller asks for the CPU
    device: DeviceLike = None


class _Pending:
    __slots__ = ("cntl", "done")

    def __init__(self, cntl: Controller):
        self.cntl = cntl
        self.done = threading.Event()


class Channel:
    def __init__(self, options: Optional[ChannelOptions] = None):
        self.options = options or ChannelOptions()
        self._server_ep: Optional[EndPoint] = None
        self._sock: Optional[Socket] = None
        self._reader: Optional[threading.Thread] = None
        self._connect_lock = threading.Lock()
        self._pending: Dict[int, _Pending] = {}
        self._pending_lock = threading.Lock()
        self._ids = itertools.count(1)

    def init(self, target) -> int:
        """init('ip:port'); 0 on success."""
        try:
            self._server_ep = (target if isinstance(target, EndPoint)
                               else EndPoint.parse(str(target)))
        except ValueError:
            return errors.EINVAL
        return 0

    def _app_connect_factory(self):
        """Per-connection app-level connect hook (the AppConnect seam):
        each connection gets its own DeviceEndpoint."""
        if not self.options.use_device_transport:
            return None
        from brpc_tpu_torch.rpc.device_transport import DeviceEndpoint

        return lambda: DeviceEndpoint(device=self.options.device).app_connect

    def _get_socket(self) -> Optional[Socket]:
        with self._connect_lock:
            if self._sock is not None:
                return self._sock
            try:
                conn = pysocket.create_connection(
                    tuple(self._server_ep),
                    timeout=self.options.connect_timeout_ms / 1000.0)
            except OSError:
                return None
            conn.settimeout(None)
            sock = Socket(conn, str(self._server_ep))
            factory = self._app_connect_factory()
            if factory is not None:
                try:
                    factory()(sock)
                except BaseException:
                    sock.close()
                    raise
            self._sock = sock
            self._reader = threading.Thread(
                target=self._read, args=(sock,), name="tensor-channel-read",
                daemon=True)
            self._reader.start()
            return sock

    def _read(self, sock: Socket):
        sock.read_loop(((tpu_std_protocol.parse, self._on_response),), None)
        with self._connect_lock:
            if self._sock is sock:
                self._sock = None
        sock.close()
        with self._pending_lock:
            pending, self._pending = self._pending, {}
        for p in pending.values():
            p.cntl.set_failed(errors.EFAILEDSOCKET, "connection closed")
            p.done.set()

    def _on_response(self, msg):
        with self._pending_lock:
            p = self._pending.pop(msg.meta.correlation_id, None)
        if p is None:
            return  # late response of a call that already timed out
        cntl = p.cntl
        cntl._response_rpc_meta = msg.meta
        if msg.meta.response.error_code != 0:
            cntl.set_failed(msg.meta.response.error_code,
                            msg.meta.response.error_text)
        else:
            try:
                if cntl._response is not None and msg.payload:
                    cntl._response.ParseFromString(msg.payload)
                cntl.response_attachment = msg.attachment
            except ValueError as e:
                cntl.set_failed(errors.EREQUEST, f"fail to parse response: {e}")
        p.done.set()

    def call_method(self, method_full_name: str, cntl: Controller,
                    request, response):
        """Synchronous call: returns when the response arrived, the
        connection broke, or the deadline passed (ERPCTIMEDOUT)."""
        start = time.monotonic()
        if self._server_ep is None:
            cntl.set_failed(errors.EINVAL, "channel not initialized")
            return
        if cntl.timeout_ms is None:
            cntl.timeout_ms = self.options.timeout_ms
        cntl._method_full_name = method_full_name
        cntl._deadline = start + cntl.timeout_ms / 1000.0
        cntl._response = response
        sock = self._get_socket()
        if sock is None:
            cntl.set_failed(errors.EFAILEDSOCKET,
                            f"cannot connect to {self._server_ep}")
            return
        cntl._current_sock = sock
        cntl.remote_side = sock.remote_side
        cid = next(self._ids)
        payload = request.SerializeToString() if request is not None else b""
        frame = tpu_std_protocol.pack_request(payload, cntl, cid)
        p = _Pending(cntl)
        with self._pending_lock:
            self._pending[cid] = p
        if sock.write(frame) != 0:
            with self._pending_lock:
                self._pending.pop(cid, None)
            cntl.set_failed(errors.EFAILEDSOCKET, "write failed")
            return
        if not p.done.wait(max(0.0, cntl._deadline - time.monotonic())):
            with self._pending_lock:
                mine = self._pending.pop(cid, None) is not None
            if mine:
                cntl.set_failed(errors.ERPCTIMEDOUT,
                                f"reached timeout={cntl.timeout_ms}ms")
            else:
                p.done.wait()  # the reader is completing it right now

    def close(self):
        """Close the connection and wait for its reader."""
        with self._connect_lock:
            sock, self._sock = self._sock, None
            reader, self._reader = self._reader, None
        if sock is not None:
            sock.close()
        if reader is not None:
            reader.join(5.0)
