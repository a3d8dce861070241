"""Acceptor — the accept loop of a listening socket.

Port of brpc_tpu/rpc/acceptor.py: the listening fd is itself a Socket on
the dispatcher, whose input handler accepts until the listener would
block and makes one Socket per connection, handled by the server's
InputMessenger. No thread is started per connection. With an
``ssl_context`` each accepted connection finishes its TLS handshake in a
task of its own, within 5 s, never in the accept loop; a connection whose
handshake fails is closed before it has a socket id.
"""
from __future__ import annotations

import socket as pysocket
import threading
from typing import Dict

from brpc_tpu_torch.bthread import start_background
from brpc_tpu_torch.butil.endpoint import EndPoint
from brpc_tpu_torch.rpc.input_messenger import InputMessenger
from brpc_tpu_torch.rpc.socket import Socket


TLS_HANDSHAKE_S = 5.0


class Acceptor:
    def __init__(self, messenger: InputMessenger, ssl_context=None):
        self._messenger = messenger
        self._ssl_context = ssl_context
        self._listen_sid = 0
        self._connections: Dict[int, None] = {}  # socket ids, in order
        self._lock = threading.Lock()
        self._stopped = False

    def start_accept(self, listen_fd: pysocket.socket) -> int:
        listen_fd.setblocking(False)
        self._listen_sid = Socket.create(
            fd=listen_fd, on_edge_triggered_events=self._on_new_connections)
        return 0

    def _on_new_connections(self, listen_sock: Socket):
        while not self._stopped:
            fd = listen_sock.fd()
            if fd is None:
                return
            try:
                conn, addr = fd.accept()
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                return
            conn.setsockopt(pysocket.IPPROTO_TCP, pysocket.TCP_NODELAY, 1)
            remote = EndPoint(addr[0], addr[1])
            if self._ssl_context is not None:
                start_background(self._tls_accept, conn, remote)
            elif not self._add_connection(conn, remote):
                return

    def _tls_accept(self, conn: pysocket.socket, remote: EndPoint):
        try:
            conn.settimeout(TLS_HANDSHAKE_S)
            conn = self._ssl_context.wrap_socket(conn, server_side=True)
        except OSError:
            conn.close()
            return
        self._add_connection(conn, remote)

    def _add_connection(self, conn: pysocket.socket, remote: EndPoint) -> bool:
        # noted before the dispatcher can see it, so stop_accept fails
        # every connection it accepted; one accepted after the stop is
        # closed here
        with self._lock:
            if self._stopped:
                conn.close()
                return False
            sid = Socket.create(
                fd=conn, remote_side=remote,
                on_edge_triggered_events=self._messenger.on_new_messages)
            self._connections[sid] = None
        return True

    def connection_count(self) -> int:
        with self._lock:
            alive = 0
            dead = []
            for sid in self._connections:
                s = Socket.address(sid)
                if s is not None and not s.failed():
                    alive += 1
                else:
                    dead.append(sid)
            for sid in dead:
                self._connections.pop(sid, None)
            return alive

    def list_connections(self):
        with self._lock:
            sids = list(self._connections)
        out = []
        for sid in sids:
            s = Socket.address(sid)
            if s is not None and not s.failed():
                out.append(s)
        return out

    def stop_accept(self):
        with self._lock:
            self._stopped = True
            sids = list(self._connections)
            self._connections.clear()
        listen = Socket.address(self._listen_sid)
        if listen is not None:
            listen.set_failed(error_text="acceptor stopped")
        for sid in sids:
            s = Socket.address(sid)
            if s is not None:
                s.set_failed(error_text="server stopping")
