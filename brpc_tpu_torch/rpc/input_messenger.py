"""InputMessenger — the read, cut and dispatch loop of a socket.

Port of brpc_tpu/rpc/input_messenger.py: reads into the socket's
``read_portal``, tries each protocol's ``parse`` in order until one
matches (the match is kept for the connection, and chosen again when it
answers TRY_OTHERS), and processes the cut messages: every message of a
read but the last in a task of its own, the last in the reading task
itself, and the messages of a ``process_inline`` protocol at once, in
wire order. No protocol matching the bytes fails the connection with
EPROTONOTSUP, a corrupt frame with EREQUEST.
"""
from __future__ import annotations

import logging
from typing import List, Optional

from brpc_tpu_torch import bvar
from brpc_tpu_torch.bthread import start_background
from brpc_tpu_torch.rpc import errors
from brpc_tpu_torch.rpc.protocol import ParseResult, Protocol
from brpc_tpu_torch.rpc.socket import Socket, _in_bytes

_msg_count = bvar.Adder("input_messenger_messages")

READ_CHUNK = 262144


class InputMessenger:
    def __init__(self, protocols: Optional[List[Protocol]] = None, arg=None):
        # ``arg`` reaches process_* with each message: the Server on the
        # server side, None on the client side
        self._protocols = list(protocols or [])
        self.arg = arg

    def on_new_messages(self, sock: Socket):
        """The socket's input handler, run in a task per readable edge."""
        portal = sock.read_portal
        while not sock.failed():
            fd = sock.fd()
            if fd is None:
                return
            try:
                n = portal.append_from_socket(fd, READ_CHUNK)
            except (BlockingIOError, InterruptedError):
                n = -1
            except OSError as e:
                sock.set_failed(e.errno or errors.EFAILEDSOCKET,
                                f"read failed: {e}", fd=fd)
                return
            if n == 0 and portal.empty():
                sock.set_failed(errors.ECLOSE, "remote closed", fd=fd)
                return
            if n > 0:
                _in_bytes.update(n)
            # cut every complete message buffered
            progressed = self._cut_and_process(sock, read_eof=(n == 0))
            if n == 0:
                sock.set_failed(errors.ECLOSE, "remote closed", fd=fd)
                return
            if n < 0:
                # would block: wait for the next readable edge, unless a
                # parsed message left a partial one behind
                if not progressed or portal.empty():
                    return

    def _cut_and_process(self, sock: Socket, read_eof: bool) -> bool:
        # every message but the last starts a task; the last runs here,
        # which saves a wakeup on the common one-message read
        deferred = []
        try:
            return self._cut_loop(sock, read_eof, deferred)
        finally:
            for process, msg in deferred[:-1]:
                start_background(self._process_safely, process, msg)
            if deferred:
                self._process_safely(*deferred[-1])

    def _cut_loop(self, sock: Socket, read_eof: bool, deferred) -> bool:
        portal = sock.read_portal
        progressed = False
        while not portal.empty():
            protocol = sock.matched_protocol
            result = None
            if protocol is not None:
                result = protocol.parse(portal, sock, read_eof, self.arg)
                if result.status == ParseResult.TRY_OTHERS:
                    # another protocol's frame on this connection (a
                    # request after the handshake): choose again
                    result = protocol = sock.matched_protocol = None
            if protocol is None:
                for p in self._protocols:
                    r = p.parse(portal, sock, read_eof, self.arg)
                    if r.status == ParseResult.TRY_OTHERS:
                        continue
                    result = r
                    if r.status in (ParseResult.OK,
                                    ParseResult.NOT_ENOUGH_DATA):
                        sock.matched_protocol = protocol = p
                    break
                if result is None:
                    sock.set_failed(errors.EPROTONOTSUP,
                                    "no protocol matched input")
                    return progressed
            if result.status == ParseResult.OK:
                progressed = True
                _msg_count.update(1)
                msg = result.message
                msg.socket = sock
                msg.protocol = protocol
                msg.arg = self.arg
                process = (protocol.process_request
                           if getattr(msg, "is_request", True)
                           else protocol.process_response)
                if process is None:
                    continue
                if protocol.process_inline:
                    self._process_safely(process, msg)
                else:
                    deferred.append((process, msg))
            elif result.status == ParseResult.NOT_ENOUGH_DATA:
                return progressed
            else:
                sock.set_failed(errors.EREQUEST, "protocol parse error")
                return progressed
        return progressed

    @staticmethod
    def _process_safely(process, msg):
        # a fault in one message must not take the connection's other
        # calls down
        try:
            process(msg)
        except Exception:
            logging.getLogger(__name__).exception("message processing raised")
