"""Progressive attachments — a body the server writes after its response.

Port of brpc_tpu/rpc/progressive.py (brpc's ProgressiveAttachment and
ProgressiveReader). The server answers at once, keeps the connection and
writes the body in chunks as they become ready; the client reads them
through a ProgressiveReader. A progressive body is a one-way stream
(rpc/stream.py), so it has the stream's window: a writer waits while
``max_buf_size`` bytes are unread, and a chunk larger than that never
fits (ROADMAP queue C #13).

Client, before the call: ``attach_progressive_reader(cntl, reader)``.
Server, in the handler: ``pa = create_progressive_attachment(cntl)``,
``done()``, then ``pa.write(chunk)`` for each chunk and ``pa.close()``.
"""
from __future__ import annotations

import threading
from typing import List, Optional

from brpc_tpu_torch.rpc.stream import (
    DEFAULT_MAX_BUF_SIZE,
    Stream,
    StreamInputHandler,
    StreamOptions,
    stream_accept,
    stream_create,
)


class ProgressiveAttachment:
    """The server's writer of a progressive body."""

    def __init__(self, stream: Stream):
        self._stream = stream

    def write(self, data) -> int:
        """0, or the stream's error code (EOVERCROWDED when the window
        stays full past the stream's timeout)."""
        return self._stream.write(data)

    def close(self):
        self._stream.close()

    @property
    def closed(self) -> bool:
        return self._stream.closed


class ProgressiveReader(StreamInputHandler):
    """The client's reader: override ``on_read_one_part`` and
    ``on_end_of_message``, or take the chunks with ``next_chunk`` and
    ``read_all``."""

    def __init__(self):
        self._chunks: List[bytes] = []
        self._cond = threading.Condition()
        self._ended = False

    def on_received_messages(self, stream, messages):
        with self._cond:
            for m in messages:
                part = m.to_bytes()
                self._chunks.append(part)
                self.on_read_one_part(part)
            self._cond.notify_all()

    def on_closed(self, stream):
        with self._cond:
            self._ended = True
            self._cond.notify_all()
        self.on_end_of_message()

    def on_read_one_part(self, data: bytes):
        pass

    def on_end_of_message(self):
        pass

    def next_chunk(self, timeout: float = 5.0) -> Optional[bytes]:
        """The next chunk; None at the end of the body, or when none
        comes within ``timeout``."""
        with self._cond:
            while not self._chunks and not self._ended:
                if not self._cond.wait(timeout):
                    return None
            if self._chunks:
                return self._chunks.pop(0)
            return None

    def read_all(self, timeout: float = 10.0) -> bytes:
        out = []
        while True:
            c = self.next_chunk(timeout)
            if c is None:
                break
            out.append(c)
        return b"".join(out)

    @property
    def ended(self) -> bool:
        return self._ended


def create_progressive_attachment(cntl, max_buf_size: int = DEFAULT_MAX_BUF_SIZE
                                  ) -> Optional[ProgressiveAttachment]:
    """Server side, in the handler; None when the client attached no
    reader."""
    s = stream_accept(cntl, StreamOptions(max_buf_size=max_buf_size))
    if s is None:
        return None
    return ProgressiveAttachment(s)


def attach_progressive_reader(cntl, reader: ProgressiveReader) -> Stream:
    """Client side, before the call: the reader rides the request's
    stream."""
    return stream_create(cntl, StreamOptions(handler=reader))
