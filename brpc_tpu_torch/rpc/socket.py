"""Socket — one TCP connection, as the client and the server see it.

Port of brpc_tpu/rpc/socket.py. A connected socket is non-blocking and
registered with an event dispatcher; no thread belongs to it:

* input: a readable edge starts one input task (``start_input_event``)
  that runs the socket's handler, an InputMessenger's
  ``on_new_messages``, over ``read_portal``; read events are suspended
  while it runs and resumed after, so one task at a time reads a
  connection;
* output: any thread queues a whole message (``write``); one of them
  becomes the writer, writes what the socket takes at once on its own
  thread, and hands the rest to a KeepWrite task that waits for the
  dispatcher's writable wakeup, so a 64 MiB frame leaves without
  blocking a caller;
* versioned socket ids: ``Socket.create`` registers a socket and returns
  its id, ``Socket.address(sid)`` resolves it, or None once the socket is
  recycled, so a stale id never reaches a newer connection;
* ``set_failed`` closes the connection and fails every RPC attempt that
  registered its call id on it (``write(..., id_wait=cid)``), so the
  controller retries or ends the RPC. The socket never holds its own
  locks while it errors a call id: the controller may retry inline;
* health-check revival: a failed client socket with
  ``health_check_interval_s > 0`` probes its peer on the timer thread and
  reconnects when it answers;
* lame duck: a socket marked draining finishes its calls but is not
  chosen for new ones;
* the ``app_connect`` seam (the device handshake runs there, on the
  blocking socket, before it joins the dispatcher) and ``app_state``,
  which holds the connection's DeviceEndpoint. A connection that fails
  or closes releases every send its endpoint still retains: no ACK can
  reach it any more;
* TLS: a client socket with an ``ssl_context`` wraps the dialed
  connection (handshake within the connect timeout) before
  ``app_connect``, so the device handshake runs inside the TLS session;
  a failed handshake fails the connect with ESSL (or the errno of the
  socket's own error) and never goes on in plaintext. A connection is
  read by its input task while another thread writes it, and one
  OpenSSL connection is not safe for two threads at once: a context made
  by ``tls_context`` wraps into a ``TLSSocket``, whose reads, writes and
  close take turns;
* the ``on_connected`` seam: a channel matches the connection to its
  protocol there and runs the hook of a protocol whose client speaks
  first (h2's preface and SETTINGS), after ``app_connect`` and before
  the socket joins the dispatcher, so a peer that answers at once finds
  the connection's protocol state attached;
* protocol state: whatever a protocol attaches to a socket (HTTP's ids in
  request order, h2's connection) is every attribute beyond those a new
  socket has, and a revived socket drops it all: it does not hold for
  the new connection. An ``on_protocol_failed`` callable among it runs
  in a task when the socket fails (an RTMP session leaves its relay);
* ``write_backlog_bytes``: the bytes queued and not yet written, which a
  media relay reads to shed a player that stopped reading.
"""
from __future__ import annotations

import socket as pysocket
import ssl
import threading
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from brpc_tpu_torch import bvar
from brpc_tpu_torch.bthread import id as bthread_id
from brpc_tpu_torch.bthread import start_background, timer_add
from brpc_tpu_torch.butil.endpoint import EndPoint
from brpc_tpu_torch.butil.iobuf import IOBuf, IOPortal
from brpc_tpu_torch.rpc import errors
from brpc_tpu_torch.rpc.event_dispatcher import get_global_dispatcher

_in_bytes = bvar.Adder("socket_in_bytes")
_out_bytes = bvar.Adder("socket_out_bytes")
_conn_count = bvar.Adder("socket_connection_count")


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

    def size(self) -> int:
        with self._lock:
            return len(self._slots)

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


class TLSSocket(ssl.SSLSocket):
    """An SSLSocket whose reads, writes and close take turns (a re-entrant
    lock per connection; each call is short, the socket being
    non-blocking)."""

    def _io_lock(self) -> threading.RLock:
        lock = self.__dict__.get("_tls_io_lock")
        if lock is None:
            lock = self.__dict__.setdefault("_tls_io_lock", threading.RLock())
        return lock

    def recv(self, buflen=1024, flags=0):
        with self._io_lock():
            return super().recv(buflen, flags)

    def send(self, data, flags=0):
        with self._io_lock():
            return super().send(data, flags)

    def shutdown(self, how):
        with self._io_lock():
            return super().shutdown(how)

    def _real_close(self):
        with self._io_lock():
            return super()._real_close()


def tls_context(server_side: bool, certfile: str = "", keyfile: str = "",
                verify: bool = False) -> ssl.SSLContext:
    """A server context with its certificate chain, or a client context
    (the system's trust store; without ``verify``, any certificate, as a
    self-signed test server needs); either wraps into TLSSocket."""
    if server_side:
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.load_cert_chain(certfile, keyfile or None)
        # no TLS 1.3 session tickets: no client here resumes a session,
        # and a ticket is bytes the client reads after its handshake
        # while its first request may be going out
        ctx.num_tickets = 0
    else:
        ctx = ssl.create_default_context()
        if not verify:
            ctx.check_hostname = False
            ctx.verify_mode = ssl.CERT_NONE
    ctx.sslsocket_class = TLSSocket
    return ctx


def _tcp_probe(sock: "Socket") -> bool:
    """The default health check: the peer accepts a TCP connection."""
    try:
        pysocket.create_connection(sock.remote_side.as_sockaddr(),
                                   timeout=1.0).close()
        return True
    except OSError:
        return False


class Socket:
    # the attributes a new socket has: anything beyond them is protocol
    # state, dropped on revival (captured from the first socket made)
    _core_attrs: "frozenset[str]" = None

    def __init__(self, fd: Optional[pysocket.socket] = None,
                 remote_side: Optional[EndPoint] = None):
        """Made by ``Socket.create``: with ``fd`` an accepted connection
        (or a listener), without it a client socket that dials on
        ``connect``."""
        self._fd = fd
        self._sid = 0
        self.node_sid = 0  # the balancer's node this connection serves
        self.remote_side = remote_side
        self.on_edge_triggered_events: Optional[Callable[["Socket"], None]] = None
        self.read_portal = IOPortal()
        self.matched_protocol = None  # kept by the InputMessenger
        self.app_state = None  # the connection's DeviceEndpoint, if any
        self.app_connect: Optional[Callable[["Socket"], int]] = None
        self.ssl_context: Optional[ssl.SSLContext] = None  # client TLS
        self.on_connected: Optional[Callable[["Socket"], None]] = None
        self.connection_type = "single"
        self.health_check_interval_s = -1.0
        self.lame_duck = False
        self.error_code = 0
        self.error_text = ""
        self._failed = False
        self._conn_ready = fd is not None
        self._accepted = fd is not None  # server side: no dial, no revival
        self._recycled = False
        self._hc_running = False
        # failure, the call ids, abandoned sends and the write queue
        self._state_lock = threading.Lock()
        self._connect_lock = threading.Lock()
        self._inflight_ids = set()
        # attempt call id -> (endpoint, seq) of a send whose RPC ended
        # without it: released by its late response or the socket's end
        self._abandoned: Dict[int, Tuple[object, int]] = {}
        self._write_q: deque = deque()
        self._writing = False
        self._write_gen = 0  # moves on at each failure: old writers stop
        self._epollout = threading.Event()
        self._reading = False
        self._reading_lock = threading.Lock()
        if Socket._core_attrs is None:
            Socket._core_attrs = frozenset(self.__dict__)

    # -- ids ---------------------------------------------------------------
    @classmethod
    def create(cls, fd: Optional[pysocket.socket] = None,
               remote_side: Optional[EndPoint] = None,
               on_edge_triggered_events: Optional[Callable] = None,
               health_check_interval_s: float = -1,
               app_connect: Optional[Callable[["Socket"], int]] = None,
               ssl_context: Optional[ssl.SSLContext] = None) -> int:
        """Register a socket and return its id. With ``fd`` (accepted or
        listening, TLS already done) it joins the dispatcher at once;
        without, it is a client socket that dials on ``connect``, through
        TLS with ``ssl_context``. ``on_edge_triggered_events`` handles its
        input."""
        sock = cls(fd, remote_side)
        sock.on_edge_triggered_events = on_edge_triggered_events
        sock.health_check_interval_s = health_check_interval_s
        sock.app_connect = app_connect
        sock.ssl_context = ssl_context
        sock._sid = sock.node_sid = _registry.put(sock)
        _conn_count.update(1)
        if fd is not None:
            fd.setblocking(False)
            sock._register_with_dispatcher(fd)
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
        """Dial the peer, finish the TLS handshake within the timeout when
        the socket has a context, run the app_connect hook on the blocking
        socket (the device handshake owns the connection's first bytes),
        make it non-blocking, run the on_connected hook (a failure of it
        fails the connect) and register it with the dispatcher."""
        try:
            fd = pysocket.create_connection(self.remote_side.as_sockaddr(),
                                            timeout=timeout_s)
        except OSError as e:
            return e.errno or errors.EFAILEDSOCKET
        fd.setsockopt(pysocket.IPPROTO_TCP, pysocket.TCP_NODELAY, 1)
        if self.ssl_context is not None:
            try:
                fd = self.ssl_context.wrap_socket(
                    fd, server_hostname=self.remote_side.ip)
            except OSError as e:
                fd.close()
                self.error_text = f"TLS handshake failed: {e}"
                if isinstance(e, ssl.SSLError) or not e.errno:
                    return errors.ESSL
                return e.errno
        fd.settimeout(None)
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
        fd.setblocking(False)
        if self.on_connected is not None:
            try:
                self.on_connected(self)
            except Exception as e:
                self.set_failed(errors.EFAILEDSOCKET,
                                f"on_connected hook failed: {e}")
                return errors.EFAILEDSOCKET
        with self._state_lock:
            if self._failed or self._fd is not fd:
                return self.error_code or errors.EFAILEDSOCKET
        self._register_with_dispatcher(fd)
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

    def _register_with_dispatcher(self, fd: pysocket.socket):
        fdno = fd.fileno()
        get_global_dispatcher(fdno).add_consumer(
            fdno, lambda: self.start_input_event(fd))

    # -- read --------------------------------------------------------------
    def start_input_event(self, fd: Optional[pysocket.socket] = None):
        """The dispatcher's callback: start one input task unless one is
        reading this connection already. Read events of the fd stay
        suspended until the task ends."""
        with self._reading_lock:
            if self._reading or self._failed:
                return
            fd = fd if fd is not None else self._fd
            handler = self.on_edge_triggered_events
            if handler is None or fd is None or fd is not self._fd:
                return
            self._reading = True
        fdno = fd.fileno()
        get_global_dispatcher(fdno).suspend_read(fdno)
        start_background(self._run_input_handler, handler, fd, fdno)

    def _run_input_handler(self, handler, fd, fdno: int):
        try:
            handler(self)
        finally:
            with self._reading_lock:
                self._reading = False
            if not self._failed and self._fd is fd:
                get_global_dispatcher(fdno).resume_read(fdno)

    # -- write -------------------------------------------------------------
    def write_backlog_bytes(self) -> int:
        """Bytes queued and not yet written: what a media relay reads to
        shed a player that stopped reading."""
        with self._state_lock:
            return sum(len(buf) for buf in self._write_q)

    def write(self, buf: IOBuf, id_wait: Optional[int] = None,
              on_queued: Optional[Callable[[], None]] = None) -> int:
        """Queue the whole message; 0 on success, -1 when the connection
        has failed. ``id_wait`` is the call id of the attempt the message
        carries: a failure of this socket errors it, now or until the RPC
        removes it. ``on_queued`` runs under the write lock as the message
        is queued, so per-connection state kept in request order (HTTP's
        correlation ids) follows the wire order. Tensors riding the chain
        are read to the host when the frame is written."""
        with self._state_lock:
            if self._failed or self._fd is None:
                fail_now = True
            else:
                fail_now = False
                if id_wait is not None:
                    self._inflight_ids.add(id_wait)
                self._write_q.append(buf)
                if on_queued is not None:
                    on_queued()
                if self._writing:
                    return 0  # the writer sends it after what it holds
                self._writing = True
                gen = self._write_gen
        if fail_now:
            if id_wait is not None:
                bthread_id.error(id_wait, self.error_code or errors.EFAILEDSOCKET,
                                 self.error_text or "socket failed")
            return -1
        # we are the writer: what the socket takes now, on this thread;
        # the rest in a KeepWrite task
        if not self._flush_some(gen):
            start_background(self._keep_write, gen)
        return 0

    def _flush_some(self, gen: int) -> bool:
        """Write the queue until it is empty or the writer's connection is
        gone (True), or until the socket is full (False)."""
        while True:
            with self._state_lock:
                if self._write_gen != gen:
                    return True  # failed: the queue was dropped
                if not self._write_q:
                    self._writing = False
                    return True
                buf, fd = self._write_q[0], self._fd
            try:
                n = buf.cut_into_socket(fd)
            except (BlockingIOError, InterruptedError):
                return False
            except OSError as e:
                self.set_failed(errors.EFAILEDSOCKET, f"write failed: {e}",
                                fd=fd)
                return True
            if n > 0:
                _out_bytes.update(n)
            if buf.empty():
                with self._state_lock:
                    if (self._write_gen == gen and self._write_q
                            and self._write_q[0] is buf):
                        self._write_q.popleft()
            elif n == 0:
                return False

    def _keep_write(self, gen: int):
        while True:
            with self._state_lock:
                if self._write_gen != gen:
                    return
                fd, wakeup = self._fd, self._epollout
            wakeup.clear()
            if self._flush_some(gen):
                return
            fdno = fd.fileno()
            if fdno < 0:
                return
            get_global_dispatcher(fdno).add_epollout(fdno, wakeup.set)
            wakeup.wait(timeout=1.0)

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
            self._write_q.clear()
            self._writing = False
            self._write_gen += 1
            wakeup = self._epollout
            start_hc = (self.health_check_interval_s > 0
                        and not self._hc_running and not self._recycled
                        and not self._accepted
                        and self.remote_side is not None)
            if start_hc:
                self._hc_running = True
        wakeup.set()  # a KeepWrite task waiting for room ends
        if fd is not None:
            _close_fd(fd)
        self._release_sends()
        for cid in inflight:
            bthread_id.error(cid, self.error_code, error_text or "socket failed")
        # a protocol whose state outlives a read (an RTMP session in its
        # relay) ends it in a task: the caller may hold that state's locks
        on_failed = self.__dict__.get("on_protocol_failed")
        if on_failed is not None:
            start_background(on_failed)
        if self._accepted and not self._recycled:
            # nothing dials an accepted connection again: its id goes
            self._recycled = True
            _registry.remove(self._sid)
            _conn_count.update(-1)
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
                self.read_portal = IOPortal()
                self.matched_protocol = None
                # what a protocol kept for the old connection (HTTP's
                # ids in request order, h2's connection) does not hold
                # for the new one
                for name in [n for n in self.__dict__
                             if n not in Socket._core_attrs]:
                    del self.__dict__[name]
                self._epollout = threading.Event()
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
        if _registry.remove(self._sid):
            _conn_count.update(-1)

    def close(self):
        """The server's end of a connection: close it and release what its
        endpoint retains."""
        self.set_failed(errors.ECLOSE, "closed")

    def __repr__(self):
        state = "failed" if self._failed else "ok"
        return f"Socket(id={self._sid:#x}, remote={self.remote_side}, {state})"


def _close_fd(fd: pysocket.socket):
    """Shut the connection down at once (the peer sees its end now), then
    close the fd on its dispatcher's loop thread, after unregistering it."""
    try:
        fd.shutdown(pysocket.SHUT_RDWR)
    except OSError:
        pass  # not connected, or a listener
    fdno = fd.fileno()
    if fdno < 0:
        return
    get_global_dispatcher(fdno).remove_and_close(fdno, fd)
