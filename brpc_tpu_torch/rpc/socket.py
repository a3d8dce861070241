"""One TCP connection, as the tensor lane sees it.

The reference's Socket stands on the event dispatcher, the input messenger
and bthread; none of that is device code. Here a connection is a blocking
socket with a write lock, the ``app_state`` seam that holds the
connection's DeviceEndpoint, and a reader loop that one thread per
connection runs: it parses messages off the byte stream with the given
parsers and processes each inline.
"""
from __future__ import annotations

import socket as pysocket
import sys
import threading
import traceback
from typing import Callable, Sequence, Tuple

from brpc_tpu_torch.butil.iobuf import IOBuf
from brpc_tpu_torch.rpc.protocol import ParseResult

READ_CHUNK = 1 << 20


class Socket:
    def __init__(self, sock: pysocket.socket, remote_side: str):
        sock.setsockopt(pysocket.IPPROTO_TCP, pysocket.TCP_NODELAY, 1)
        self._sock = sock
        self.remote_side = remote_side
        self.app_state = None  # the connection's DeviceEndpoint, if any
        self._write_lock = threading.Lock()

    def fd(self) -> pysocket.socket:
        return self._sock

    def write(self, buf: IOBuf) -> int:
        """Write the whole chain; 0 on success, -1 when the connection
        broke. Tensors riding the chain are read to the host here."""
        try:
            with self._write_lock:
                for view in buf.iter_views():
                    self._sock.sendall(view)
            return 0
        except OSError:
            return -1

    def close(self):
        try:
            self._sock.shutdown(pysocket.SHUT_RDWR)
        except OSError:
            pass  # not connected any more
        self._sock.close()

    def read_loop(self, parsers: Sequence[Tuple[Callable, Callable]], arg):
        """Read until EOF. ``parsers`` are (parse, process) pairs tried in
        order on the buffered bytes; a parsed message gets ``socket`` and
        ``arg`` and is processed inline. Returns on EOF, on a broken
        connection or on bytes no parser accepts."""
        portal = IOBuf()
        while True:
            try:
                data = self._sock.recv(READ_CHUNK)
            except OSError:
                return
            if not data:
                return
            portal.append(data)
            while len(portal):
                status = ParseResult.TRY_OTHERS
                for parse, process in parsers:
                    result = parse(portal, self, False, arg)
                    status = result.status
                    if status == ParseResult.OK:
                        msg = result.message
                        msg.socket = self
                        msg.arg = arg
                        try:
                            process(msg)
                        except Exception:
                            # a fault in one message's processing must not
                            # take the connection's other calls down
                            traceback.print_exc(file=sys.stderr)
                        break
                    if status != ParseResult.TRY_OTHERS:
                        break
                if status == ParseResult.NOT_ENOUGH_DATA:
                    break
                if status != ParseResult.OK:
                    return  # malformed or unknown bytes: drop the connection
