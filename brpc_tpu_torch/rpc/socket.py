"""Socket — one TCP connection, as the client and the server see it.

Port of brpc_tpu/rpc/socket.py without its event dispatcher, input
messenger and bthread writer tasks: here one OS thread per connection
reads and processes messages inline, and a writer sends a whole message
under the connection's write lock. What the reference's client fabric
needs is kept:

* versioned socket ids: ``Socket.create`` registers a socket and returns
  its id, ``Socket.address(sid)`` resolves it, or None once the socket is
  recycled, so a stale id never reaches a newer connection;
* ``set_failed`` closes the connection and fails every RPC attempt that
  registered its call id on it (``write(..., id_wait=cid)``), so the
  controller retries or ends the RPC;
* health-check revival: a failed socket with ``health_check_interval_s
  > 0`` probes its peer on the timer thread and reconnects when it
  answers;
* lame duck: a socket marked draining finishes its calls but is not
  chosen for new ones;
* the ``app_connect`` seam (the device handshake runs there before the
  reader starts) and ``app_state``, which holds the connection's
  DeviceEndpoint. A connection that fails or closes releases every send
  its endpoint still retains: no ACK can reach it any more.
"""
from __future__ import annotations

import socket as pysocket
import sys
import threading
import traceback
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from brpc_tpu_torch.bthread import id as bthread_id
from brpc_tpu_torch.bthread import timer_add
from brpc_tpu_torch.butil.endpoint import EndPoint
from brpc_tpu_torch.butil.iobuf import IOBuf
from brpc_tpu_torch.rpc import errors
from brpc_tpu_torch.rpc.protocol import ParseResult

READ_CHUNK = 1 << 20


class _Registry:
    """Versioned slots: a socket id is (version << 32) | slot; a slot's
    version moves on when its socket is recycled."""

    def __init__(self):
        self._lock = threading.Lock()
        self._slots: List[list] = []  # [version, socket or None]
        self._free: List[int] = []

    def put(self, sock: "Socket") -> int:
        with self._lock:
            if self._free:
                idx = self._free.pop()
            else:
                idx = len(self._slots)
                self._slots.append([0, None])
            slot = self._slots[idx]
            slot[0] += 1
            slot[1] = sock
            return (slot[0] << 32) | idx

    def address(self, sid: int) -> Optional["Socket"]:
        idx, version = sid & 0xFFFFFFFF, sid >> 32
        with self._lock:
            if idx >= len(self._slots) or self._slots[idx][0] != version:
                return None
            return self._slots[idx][1]

    def remove(self, sid: int) -> bool:
        idx, version = sid & 0xFFFFFFFF, sid >> 32
        with self._lock:
            if idx >= len(self._slots) or self._slots[idx][0] != version:
                return False
            self._slots[idx][0] += 1
            self._slots[idx][1] = None
            self._free.append(idx)
            return True


_registry = _Registry()


def _tcp_probe(sock: "Socket") -> bool:
    """The default health check: the peer accepts a TCP connection."""
    try:
        pysocket.create_connection(sock.remote_side.as_sockaddr(),
                                   timeout=1.0).close()
        return True
    except OSError:
        return False


class Socket:
    def __init__(self, fd: Optional[pysocket.socket] = None,
                 remote_side=None):
        """A server passes its accepted connection; a client socket is
        made by ``Socket.create`` and dials on ``connect``."""
        if fd is not None:
            fd.setsockopt(pysocket.IPPROTO_TCP, pysocket.TCP_NODELAY, 1)
        self._fd = fd
        self._sid = 0
        self.node_sid = 0  # the balancer's node this connection serves
        self.remote_side = remote_side
        self.app_state = None  # the connection's DeviceEndpoint, if any
        self.app_connect: Optional[Callable[["Socket"], int]] = None
        self.connection_type = "single"
        self.health_check_interval_s = -1.0
        self.lame_duck = False
        self.error_code = 0
        self.error_text = ""
        self._failed = False
        self._conn_ready = fd is not None
        self._recycled = False
        self._hc_running = False
        self._state_lock = threading.Lock()  # failure, ids, abandoned sends
        self._write_lock = threading.Lock()
        self._connect_lock = threading.Lock()
        self._inflight_ids = set()
        # attempt call id -> (endpoint, seq) of a send whose RPC ended
        # without it: released by its late response or the socket's end
        self._abandoned: Dict[int, Tuple[object, int]] = {}

    # -- ids ---------------------------------------------------------------
    @classmethod
    def create(cls, remote_side: EndPoint,
               health_check_interval_s: float = -1,
               app_connect: Optional[Callable[["Socket"], int]] = None) -> int:
        """An unconnected client socket; returns its id."""
        sock = cls(None, remote_side)
        sock.health_check_interval_s = health_check_interval_s
        sock.app_connect = app_connect
        sock._sid = sock.node_sid = _registry.put(sock)
        return sock._sid

    @classmethod
    def address(cls, sid: int) -> Optional["Socket"]:
        """The socket of ``sid``, failed or not; None once recycled."""
        return _registry.address(sid)

    @property
    def socket_id(self) -> int:
        return self._sid

    def fd(self) -> Optional[pysocket.socket]:
        return self._fd

    def failed(self) -> bool:
        return self._failed

    def mark_lame_duck(self):
        """The peer is draining: calls in flight complete here, new calls
        go elsewhere. Not a failure."""
        self.lame_duck = True

    def usable_for_new_calls(self) -> bool:
        return not self._failed and not self.lame_duck

    # -- connect -----------------------------------------------------------
    def connect(self, timeout_s: float = 1.0) -> int:
        """Dial the peer, run the app_connect hook (the device handshake
        owns the connection's first bytes) and start the reader."""
        try:
            fd = pysocket.create_connection(self.remote_side.as_sockaddr(),
                                            timeout=timeout_s)
        except OSError as e:
            return e.errno or errors.EFAILEDSOCKET
        fd.settimeout(None)
        fd.setsockopt(pysocket.IPPROTO_TCP, pysocket.TCP_NODELAY, 1)
        with self._state_lock:
            self._fd = fd
        if self.app_connect is not None:
            try:
                rc = self.app_connect(self)
            except Exception as e:
                rc = errors.EFAILEDSOCKET
                self.error_text = f"app connect raised: {e}"
            if rc != 0:
                self.set_failed(rc, "app connect failed")
                return rc
        from brpc_tpu_torch.rpc import tpu_std_protocol

        threading.Thread(
            target=self._client_read, name="socket-read", daemon=True,
            args=(fd, ((tpu_std_protocol.parse,
                        tpu_std_protocol.process_response),))).start()
        self._conn_ready = True
        return 0

    def ensure_connected(self, timeout_s: float = 1.0) -> int:
        """Connect once, for sockets made unconnected (those of a naming
        service, or of the socket map); racing callers wait for the one
        dial."""
        if self._conn_ready:
            return 0
        with self._connect_lock:
            if self._conn_ready:
                return 0
            if self._failed:
                return self.error_code or errors.EFAILEDSOCKET
            return self.connect(timeout_s)

    def _client_read(self, fd, parsers):
        self.read_loop(parsers, None, fd)
        self.set_failed(errors.ECLOSE, "remote closed", fd=fd)

    # -- read --------------------------------------------------------------
    def read_loop(self, parsers: Sequence[Tuple[Callable, Callable]], arg,
                  fd: Optional[pysocket.socket] = None):
        """Read until EOF. ``parsers`` are (parse, process) pairs tried in
        order on the buffered bytes; a parsed message gets ``socket`` and
        ``arg`` and is processed inline. Returns on EOF, on a broken
        connection or on bytes no parser accepts."""
        fd = fd if fd is not None else self._fd
        portal = IOBuf()
        while True:
            try:
                data = fd.recv(READ_CHUNK)
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

    # -- write -------------------------------------------------------------
    def write(self, buf: IOBuf, id_wait: Optional[int] = None) -> int:
        """Write the whole message; 0 on success, -1 when the connection
        is failed or breaks. ``id_wait`` is the call id of the attempt the
        message carries: a failure of this socket errors it, now or until
        the RPC removes it. Tensors riding the chain are read to the host
        here."""
        with self._state_lock:
            fd = self._fd
            if self._failed or fd is None:
                fail_now = True
            else:
                fail_now = False
                if id_wait is not None:
                    self._inflight_ids.add(id_wait)
        if fail_now:
            if id_wait is not None:
                bthread_id.error(id_wait, self.error_code or errors.EFAILEDSOCKET,
                                 self.error_text or "socket failed")
            return -1
        try:
            with self._write_lock:
                for view in buf.iter_views():
                    fd.sendall(view)
            return 0
        except OSError as e:
            self.set_failed(errors.EFAILEDSOCKET, f"write failed: {e}", fd=fd)
            return -1

    def remove_inflight(self, cid: int):
        with self._state_lock:
            self._inflight_ids.discard(cid)

    # -- sends of abandoned attempts ---------------------------------------
    def abandon_send(self, cid: int, endpoint, seq: int):
        """A send of attempt ``cid`` whose RPC ended without its response:
        released when that response arrives, or when this socket fails."""
        with self._state_lock:
            if not self._failed:
                self._abandoned[cid] = (endpoint, seq)
                return
        endpoint.on_ack(seq)

    def take_abandoned(self, cid: int) -> bool:
        """Release the abandoned send of ``cid``; False when there is
        none."""
        with self._state_lock:
            entry = self._abandoned.pop(cid, None)
        if entry is None:
            return False
        entry[0].on_ack(entry[1])
        return True

    def _release_sends(self):
        with self._state_lock:
            self._abandoned.clear()
        release_all = getattr(self.app_state, "release_all", None)
        if release_all is not None:
            release_all()

    # -- failure and revival -----------------------------------------------
    def set_failed(self, error_code: int = errors.EFAILEDSOCKET,
                   error_text: str = "", fd=None) -> bool:
        """Close the connection and fail every attempt registered on it.
        With ``fd``, only when that is still the connection (a reader of
        an old connection must not fail a revived one). False when the
        socket had already failed."""
        with self._state_lock:
            if self._failed or (fd is not None and fd is not self._fd):
                return False
            self._failed = True
            self._conn_ready = False
            self.error_code = error_code or errors.EFAILEDSOCKET
            self.error_text = error_text
            fd, self._fd = self._fd, None
            inflight, self._inflight_ids = list(self._inflight_ids), set()
            start_hc = (self.health_check_interval_s > 0
                        and not self._hc_running and not self._recycled
                        and self.remote_side is not None)
            if start_hc:
                self._hc_running = True
        if fd is not None:
            _close_fd(fd)
        self._release_sends()
        for cid in inflight:
            bthread_id.error(cid, self.error_code, error_text or "socket failed")
        if start_hc:
            timer_add(self.health_check_interval_s, self._health_check_once)
        return True

    def _health_check_once(self):
        if self._recycled:
            return
        try:
            healthy = _tcp_probe(self)
        except Exception:
            healthy = False
        if healthy and self.revive() == 0:
            with self._state_lock:
                self._hc_running = False
                failed_again = self._failed
            if failed_again:
                # a set_failed inside the revive window saw the checker
                # still running and scheduled none
                with self._state_lock:
                    self._hc_running = True
                timer_add(self.health_check_interval_s,
                          self._health_check_once)
            return
        timer_add(self.health_check_interval_s, self._health_check_once)

    def revive(self) -> int:
        """Reconnect and clear the failed state, under the connect lock so
        that no caller dials at the same time."""
        with self._connect_lock:
            if self._conn_ready and not self._failed:
                return 0
            with self._state_lock:
                self._failed = False
                self.lame_duck = False
                self.error_code = 0
                self.error_text = ""
            rc = self.connect()
            if rc != 0:
                with self._state_lock:
                    self._failed = True
            return rc

    def recycle(self):
        """Fail the socket and make its id stale."""
        self._recycled = True
        self.set_failed(errors.ECLOSE, "recycled")
        self.health_check_interval_s = -1
        _registry.remove(self._sid)

    def close(self):
        """The server's end of a connection: close it and release what its
        endpoint retains."""
        self.set_failed(errors.ECLOSE, "closed")

    def __repr__(self):
        state = "failed" if self._failed else "ok"
        return f"Socket(id={self._sid:#x}, remote={self.remote_side}, {state})"


def _close_fd(fd):
    try:
        fd.shutdown(pysocket.SHUT_RDWR)
    except OSError:
        pass  # not connected any more
    fd.close()
