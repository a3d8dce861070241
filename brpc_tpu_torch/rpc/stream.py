"""Streams — ordered byte and tensor streams over an RPC connection.

Port of brpc_tpu/rpc/stream.py (brpc Streams: stream.h, stream.cpp,
stream_impl.h). ``stream_create`` rides the stream's setup on an RPC and
``stream_accept`` takes it up in the server's handler; writes go through
the connection's ordinary write path; what arrives is delivered in order
through an ExecutionQueue to the user's StreamInputHandler, and a sliding
window with FEEDBACK frames holds a writer back (``max_buf_size``, 2 MiB
by default).

This is the framework's lane for a pipeline stage that streams
activations to the next stage: ``write_tensor`` sends a tensor from the
card. Unlike a ``jax.Array`` a tensor can change after the call, so
``write_tensor`` copies the bytes it holds at the call, on the caller's
current CUDA stream, into page-locked host memory, and waits for that
stream before the frame is written (ROADMAP queue C).
"""
from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional

import torch

from brpc_tpu_torch import bvar
from brpc_tpu_torch.bthread.execution_queue import ExecutionQueue
from brpc_tpu_torch.butil.iobuf import IOBuf
from brpc_tpu_torch.rpc import errors

DEFAULT_MAX_BUF_SIZE = 2 * 1024 * 1024  # stream.h

_stream_count = bvar.Adder("stream_count")


class StreamInputHandler:
    """The user's callbacks. ``on_received_messages`` runs on a
    task-control worker and holds it while it runs."""

    def on_received_messages(self, stream: "Stream", messages: List[IOBuf]):
        raise NotImplementedError

    def on_idle_timeout(self, stream: "Stream"):
        pass

    def on_closed(self, stream: "Stream"):
        pass


class StreamOptions:
    def __init__(self, handler: Optional[StreamInputHandler] = None,
                 max_buf_size: int = DEFAULT_MAX_BUF_SIZE,
                 messages_in_batch: int = 128):
        self.handler = handler
        self.max_buf_size = max_buf_size
        self.messages_in_batch = messages_in_batch


def _snapshot(tensor: torch.Tensor) -> torch.Tensor:
    """The tensor's bytes as they are now, in host memory of their own. A
    card tensor is copied on the caller's current stream into page-locked
    memory, and that stream is waited for, so work the caller queued
    before the call is in the copy and a write after it is not."""
    t = tensor.detach()
    if t.device.type == "cuda":
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        torch.cuda.current_stream(t.device).synchronize()
        return host
    return t.clone(memory_format=torch.contiguous_format)


class Stream:
    """One endpoint of a stream. A write waits while the peer's window is
    full; the peer's FEEDBACK frames open it again."""

    _registry: Dict[int, "Stream"] = {}
    _registry_lock = threading.Lock()
    _next_id = 1

    def __init__(self, options: StreamOptions,
                 peer_id: Optional[int] = None):
        cls = type(self)
        with cls._registry_lock:
            self.stream_id = cls._next_id  # our id: frames to us carry it
            cls._next_id += 1
            cls._registry[self.stream_id] = self
        self.peer_id = peer_id  # the peer's id: frames from us carry it
        self.options = options
        self._sock = None
        self._closed = False
        self._close_reason = ""
        # the writer's window: bytes sent and not yet fed back as consumed
        self._unconsumed = 0
        self._window_cond = threading.Condition()
        # made now, so frames that arrive before bind() (the peer may write
        # as soon as it accepts, before our RPC's response is processed)
        # are queued, never dropped
        self._exec_q: Optional[ExecutionQueue] = None
        if options.handler is not None:
            self._exec_q = ExecutionQueue(
                self._consume_batch, batch_size=options.messages_in_batch)
        self._owed_feedback = 0  # consumed before bind: sent by bind
        self._connected = threading.Event()
        _stream_count.update(1)

    @classmethod
    def find(cls, stream_id: int) -> Optional["Stream"]:
        with cls._registry_lock:
            return cls._registry.get(stream_id)

    # -- binding -------------------------------------------------------------
    def bind(self, sock):
        """Attach the connection the stream's frames go out on, and send
        the feedback owed for what was consumed before."""
        self._sock = sock
        self._connected.set()
        with self._window_cond:
            owed, self._owed_feedback = self._owed_feedback, 0
        if owed:
            self._send_feedback(owed)

    def wait_connected(self, timeout: Optional[float] = None) -> bool:
        return self._connected.wait(timeout)

    @property
    def connected(self) -> bool:
        return self._connected.is_set()

    # -- writing -------------------------------------------------------------
    def write(self, data, timeout_s: Optional[float] = 5.0) -> int:
        """StreamWrite: waits while the window cannot take ``data``;
        EOVERCROWDED when it still cannot after ``timeout_s``. As in the
        reference, a message larger than ``max_buf_size`` never fits, even
        an empty window (ROADMAP queue C)."""
        from brpc_tpu_torch.rpc import streaming_protocol

        if self._closed:
            return errors.EEOF
        if self._sock is None or self.peer_id is None:
            return errors.EINVAL
        buf = data if isinstance(data, IOBuf) else IOBuf(data)
        size = len(buf)
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        with self._window_cond:
            while (self._unconsumed + size > self.options.max_buf_size
                   and not self._closed):
                remain = (None if deadline is None
                          else deadline - time.monotonic())
                if remain is not None and remain <= 0:
                    return errors.EOVERCROWDED
                self._window_cond.wait(remain)
            if self._closed:
                return errors.EEOF
            self._unconsumed += size
        rc = self._sock.write(streaming_protocol.pack_data_frame(self.peer_id,
                                                                 buf))
        if rc != 0:
            self.close("write failed")
            return rc
        return 0

    def write_tensor(self, tensor: torch.Tensor) -> int:
        """Write the tensor's bytes as they are at the call (see the
        module's docstring)."""
        buf = IOBuf()
        buf.append_device_array(_snapshot(tensor))
        return self.write(buf)

    def _on_feedback(self, consumed_bytes: int):
        with self._window_cond:
            self._unconsumed = max(0, self._unconsumed - consumed_bytes)
            self._window_cond.notify_all()

    @property
    def unconsumed_bytes(self) -> int:
        return self._unconsumed

    # -- receiving -----------------------------------------------------------
    def _on_data(self, payload: IOBuf):
        if self._exec_q is not None:
            self._exec_q.execute(payload)
        else:
            # no handler (a write-only endpoint): dropped, still fed back
            self._send_feedback(len(payload))

    def _consume_batch(self, it) -> int:
        msgs = list(it)
        if msgs:
            total = sum(len(m) for m in msgs)
            try:
                self.options.handler.on_received_messages(self, msgs)
            finally:
                self._send_feedback(total)
        if it.is_queue_stopped():
            self._run_on_closed()
        return 0

    def _run_on_closed(self):
        try:
            self.options.handler.on_closed(self)
        except Exception:
            logging.getLogger(__name__).exception("on_closed raised")

    def _send_feedback(self, consumed: int):
        from brpc_tpu_torch.rpc import streaming_protocol

        if self._sock is None or self.peer_id is None:
            with self._window_cond:
                self._owed_feedback += consumed  # sent by bind()
            return
        if not self._closed:
            self._sock.write(
                streaming_protocol.pack_feedback_frame(self.peer_id, consumed))

    # -- closing -------------------------------------------------------------
    def close(self, reason: str = "", notify_remote: bool = True):
        """StreamClose: a CLOSE frame to the peer, then the handler's queue
        drained, then ``on_closed``."""
        from brpc_tpu_torch.rpc import streaming_protocol

        if self._closed:
            return
        self._closed = True
        self._close_reason = reason
        with self._window_cond:
            self._window_cond.notify_all()
        if (notify_remote and self._sock is not None
                and not self._sock.failed() and self.peer_id is not None):
            self._sock.write(streaming_protocol.pack_close_frame(self.peer_id))
        if self._exec_q is not None:
            self._exec_q.stop()
        elif self.options.handler is not None:
            self._run_on_closed()
        with type(self)._registry_lock:
            type(self)._registry.pop(self.stream_id, None)
        _stream_count.update(-1)

    @property
    def closed(self) -> bool:
        return self._closed


def stream_create(cntl, options: Optional[StreamOptions] = None) -> Stream:
    """Client side, before the call: make the local endpoint; its id rides
    the request, and the response binds it (StreamCreate)."""
    stream = Stream(options or StreamOptions())
    cntl._request_stream = stream
    return stream


def stream_accept(cntl, options: Optional[StreamOptions] = None
                  ) -> Optional[Stream]:
    """Server side, in the handler: take up the stream riding the request
    (StreamAccept); None when the request carries none. The response
    carries our id back, so the client learns its peer."""
    sid = cntl._remote_stream_id
    if not sid:
        return None
    stream = Stream(options or StreamOptions(), peer_id=sid)
    stream.bind(cntl._server_socket)
    cntl._accepted_stream = stream
    return stream
