"""Channel — the client endpoint.

Port of brpc_tpu/rpc/channel.py. ``init('ip:port')`` talks to one server;
``init('list://a,b', 'rr')`` (or any naming-service URL, with any load
balancer ``name`` or ``name:params``) resolves servers through a
NamingServiceThread and picks one per attempt; ``init_with_filter`` adds
a node filter (the partition channels use it). ``call_method`` is
synchronous without ``done`` and returns at once with it; ``done(cntl)``
then runs on the thread that ends the RPC.

Per attempt the controller asks ``_select_socket`` for a connection:
the cluster-recover gate, then the balancer (excluding the servers that
already failed this RPC), then the connection type: ``single`` (one
connection per server shared by every channel of the process through
the SocketMap, or the naming service's own socket), ``pooled`` (a pool
per server) or ``short`` (a connection per RPC). Failed attempts are
retried under ``max_retry`` by the controller's retry policy; with
``backup_request_ms`` a second attempt goes to another server when the
first has not answered in time. With ``enable_circuit_breaker`` every
call's end feeds the connection's breaker, which fails the socket when
the error rate crosses its threshold.

Responses are read by the process's client InputMessenger
(``get_client_messenger``) in task-control workers, as a server reads
requests: no thread per connection.

With ``use_device_transport`` every connection runs the device handshake
before its first request, a naming service's sockets included (the hook
is attached before their first connect), and the channel keeps the
``single`` type, as the reference does: the ACK of a pull must reach the
endpoint that retains it. ``call_on_socket`` sends a call on one given
connection; TensorClient sends that ACK with it.

``protocol`` is ``tpu_std`` (the default), ``http`` (requests as
JSON, pipelined on a connection, rpc/http_protocol.py), ``h2:grpc``
(unary gRPC, a stream per call on one HTTP/2 connection,
rpc/h2_protocol.py), ``hulu_pbrpc``, ``sofa_pbrpc``, ``redis``,
``memcache``, ``thrift`` or ``nshead``; any other is refused with
EPROTONOTSUP. Channels of different protocols to one server do not
share a connection. Each new connection is matched to the channel's
protocol as it connects (and as it is revived), and the protocol's
``on_pinned`` hook runs then, so h2's preface is sent before the
connection is read.

``auth`` (an rpc/authenticator.py ``Authenticator``) gives each request
of tpu_std and hulu a credential, as in the reference; no other protocol
carries one. With ``use_ssl`` every connection of the channel, a naming
service's too, runs TLS (``ssl_verify`` checks the server's certificate
against the system's trust store; off, any certificate will do), and the
device handshake runs inside it; a failed handshake fails the attempt,
never falling back to plaintext. Channels differing in either do not
share a connection. The nshead family (``nova_pbrpc``,
``public_pbrpc``, ``ubrpc``) and ``esp`` are client protocols here as
in the reference. RTMP has a client of its own, not a channel:
rpc/rtmp_client.py's ``RtmpClient``, as in the reference. Left out:
the native runtime.

With the ``rpc_dump`` flag on, each call's serialized request is
recorded before it is compressed or sent (rpc/rpc_dump.py).
"""
from __future__ import annotations

import dataclasses
import threading
from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, Optional

from brpc_tpu_torch.butil.endpoint import EndPoint
from brpc_tpu_torch.device import DeviceLike
from brpc_tpu_torch.rpc import errors
from brpc_tpu_torch.rpc.controller import Controller
from brpc_tpu_torch.rpc.input_messenger import InputMessenger
from brpc_tpu_torch.rpc.protocol import (
    find_protocol_by_name,
    globally_initialize,
    list_server_protocols,
)
from brpc_tpu_torch.rpc.rpc_dump import maybe_dump_request
from brpc_tpu_torch.rpc.socket import Socket, tls_context


@dataclass
class ChannelOptions:
    """The reference's ChannelOptions and defaults, plus the device the
    handshake announces."""

    connect_timeout_ms: float = 200
    timeout_ms: float = 500
    backup_request_ms: float = -1
    max_retry: int = 3
    protocol: str = "tpu_std"
    connection_type: str = "single"  # single | pooled | short
    health_check_interval_s: float = -1
    enable_circuit_breaker: bool = False
    auth: Optional[object] = None  # an Authenticator
    use_ssl: bool = False
    ssl_verify: bool = False  # check the server's certificate
    # use_rdma analog: connections run the device handshake
    use_device_transport: bool = False
    # the card unless the caller asks for the CPU
    device: DeviceLike = None


_client_messenger: Optional[InputMessenger] = None
_client_messenger_lock = threading.Lock()


def get_client_messenger() -> InputMessenger:
    """The InputMessenger of every client connection in the process: the
    responses of a connection are read and processed by task-control
    workers, as the server's requests are."""
    global _client_messenger
    if _client_messenger is None:
        with _client_messenger_lock:
            if _client_messenger is None:
                globally_initialize()
                _client_messenger = InputMessenger(list_server_protocols())
    return _client_messenger


def _start_call(channel, method_full_name: str, cntl: Controller, request,
                response, done: Optional[Callable]):
    cntl._setup_call(channel, method_full_name, response, done)
    try:
        cntl._request_payload = channel._protocol.serialize_request(request,
                                                                    cntl)
    except Exception as e:
        cntl.set_failed(errors.EREQUEST, f"fail to serialize request: {e}")
        cntl._end_rpc(locked=False)
        return
    maybe_dump_request(method_full_name, cntl._request_payload, cntl.log_id)
    cntl.issue_rpc()
    if done is None:
        cntl.join()


class Channel:
    def __init__(self, options: Optional[ChannelOptions] = None):
        # a private copy: coercions must not reach a caller's options
        self.options = (dataclasses.replace(options) if options is not None
                        else ChannelOptions())
        if (self.options.use_device_transport
                and self.options.connection_type != "single"):
            self.options.connection_type = "single"
        self._server_ep: Optional[EndPoint] = None
        self._single_sid: Optional[int] = None
        self._single_lock = threading.Lock()
        self._pools: Dict[EndPoint, deque] = {}  # pooled connections
        self._pool_lock = threading.Lock()
        self._lb = None
        self._ns_thread = None
        self._circuit_breakers = {}  # socket id -> CircuitBreaker
        self._cb_lock = threading.Lock()
        self._init_done = False
        self._mapped_key = None  # our reference in the SocketMap
        self._mapped_sid = None
        self._protocol = None
        self._ssl_context = (tls_context(server_side=False,
                                         verify=self.options.ssl_verify)
                             if self.options.use_ssl else None)

    def close(self):
        """Stop the naming service (its sockets are recycled), drop the
        SocketMap reference and close pooled connections."""
        if self._ns_thread is not None:
            self._ns_thread.stop()
        if self._mapped_key is not None:
            from brpc_tpu_torch.rpc.socket_map import get_global_socket_map

            get_global_socket_map().remove(self._mapped_key,
                                           expected_sid=self._mapped_sid)
            self._mapped_key = self._mapped_sid = None
        with self._pool_lock:
            pooled = [s for q in self._pools.values() for s in q]
            self._pools.clear()
        for sock in pooled:
            sock.recycle()

    # -- init --------------------------------------------------------------
    def init(self, target, lb_name: str = "") -> int:
        """init('ip:port') for one server, or init('list://h1:p1,h2:p2',
        'rr') / init('file://...', 'la') and the like; 0 on success."""
        if not self._find_protocol():
            return errors.EPROTONOTSUP
        if "://" in str(target):
            return self.init_with_filter(str(target), lb_name, None)
        try:
            ep = (target if isinstance(target, EndPoint)
                  else EndPoint.parse(str(target)))
            self._server_ep = ep.resolve()
        except (ValueError, OSError):
            return errors.EINVAL
        self._init_done = True
        return 0

    def init_with_filter(self, naming_url: str, lb_name: str,
                         node_filter) -> int:
        """A naming service whose nodes pass ``node_filter((endpoint,
        weight, tag))``; 0 on success, EINVAL for an unknown scheme or
        balancer, a malformed recover suffix or an unparsable list."""
        if not self._find_protocol():
            return errors.EPROTONOTSUP
        from brpc_tpu_torch.rpc.load_balancer import create_load_balancer
        from brpc_tpu_torch.rpc.naming_service import start_naming_service

        self._lb = create_load_balancer(lb_name or "rr")
        if self._lb is None:
            return errors.EINVAL
        try:
            self._ns_thread = start_naming_service(
                naming_url, self._lb, self.options, node_filter)
        except ValueError:
            return errors.EINVAL
        if self._ns_thread is None:
            return errors.EINVAL
        self._init_done = True
        return 0

    def _find_protocol(self) -> bool:
        globally_initialize()
        p = find_protocol_by_name(self.options.protocol)
        if p is None or p.pack_request is None:
            return False
        self._protocol = p
        return True

    # -- connections -------------------------------------------------------
    def _app_connect_factory(self):
        """Each new connection gets its own DeviceEndpoint."""
        if not self.options.use_device_transport:
            return None
        from brpc_tpu_torch.rpc.device_transport import DeviceEndpoint

        device = self.options.device
        return lambda: DeviceEndpoint(device=device).app_connect

    def _connect_timeout_s(self) -> float:
        return self.options.connect_timeout_ms / 1000.0

    def _pin_protocol(self, sock: Socket):
        """A client connection speaks one protocol: when ``sock`` connects
        (and again when it is revived, which forgets the match), before it
        joins the dispatcher, it is matched to the channel's protocol, so
        a response whose magic is weak (thrift's, nshead's) or absent
        (redis's) is never taken by another parser, and the protocol's
        client hook runs (h2 attaches its connection state and sends its
        preface: a peer that speaks first finds the state there)."""
        if sock.on_connected is not None:
            return
        protocol = self._protocol

        def pin(s: Socket):
            s.matched_protocol = protocol
            if protocol.on_pinned is not None:
                protocol.on_pinned(s)

        sock.on_connected = pin

    def _connect_new_socket(self, ep: EndPoint, node_sid: int):
        factory = self._app_connect_factory()
        sid = Socket.create(
            remote_side=ep,
            on_edge_triggered_events=get_client_messenger().on_new_messages,
            app_connect=factory() if factory is not None else None,
            ssl_context=self._ssl_context)
        sock = Socket.address(sid)
        sock.node_sid = node_sid or sid
        self._pin_protocol(sock)
        if sock.connect(self._connect_timeout_s()) != 0:
            sock.recycle()
            return None
        return sock

    def _select_socket(self, cntl: Controller):
        """(socket, 0) for the next attempt, or (None, error code)."""
        if self._lb is not None:
            policy = getattr(self._lb, "cluster_recover_policy", None)
            if (policy is not None and policy.stop_recover_if_necessary()
                    and policy.do_reject(self._lb.server_ids())):
                return None, errors.EREJECT
            sid = self._lb.select_server(exclude=cntl._excluded_sids,
                                         request_code=cntl.request_code)
            if sid is None:
                if policy is not None:
                    policy.start_recover()
                return None, errors.EFAILEDSOCKET
            cntl._lb = self._lb
            main_sock = Socket.address(sid)
            if main_sock is None or main_sock.failed():
                return None, errors.EFAILEDSOCKET
            if self.options.connection_type != "single":
                return self._connection_of_type(main_sock.remote_side, cntl,
                                                sid)
            # a naming service's sockets dial on first use: the device
            # handshake and TLS are attached before that
            factory = self._app_connect_factory()
            if (factory is not None and main_sock.app_connect is None
                    and main_sock.fd() is None):
                main_sock.app_connect = factory()
            if main_sock.ssl_context is None and main_sock.fd() is None:
                main_sock.ssl_context = self._ssl_context
            self._pin_protocol(main_sock)
            if main_sock.ensure_connected(self._connect_timeout_s()) != 0:
                return None, errors.EFAILEDSOCKET
            return main_sock, 0
        if self._server_ep is None:
            return None, errors.EINVAL
        if self.options.connection_type != "single":
            return self._connection_of_type(self._server_ep, cntl, 0)
        return self._shared_socket(self._server_ep)

    def _connection_of_type(self, ep: EndPoint, cntl: Controller,
                            node_sid: int):
        if self.options.connection_type == "pooled":
            with self._pool_lock:
                pool = self._pools.setdefault(ep, deque())
                while pool:
                    sock = pool.popleft()
                    if not sock.failed():
                        return sock, 0
                    sock.recycle()
        sock = self._connect_new_socket(ep, node_sid)
        if sock is None:
            return None, errors.EFAILEDSOCKET
        sock.connection_type = self.options.connection_type
        return sock, 0

    def _shared_socket(self, ep: EndPoint):
        """The process-wide connection of this channel's signature
        (SocketMap), kept while it serves new calls."""
        from brpc_tpu_torch.rpc.socket_map import (
            get_global_socket_map,
            make_key,
        )

        with self._single_lock:
            if self._single_sid is not None:
                sock = Socket.address(self._single_sid)
                if sock is not None and sock.usable_for_new_calls():
                    if sock.ensure_connected(self._connect_timeout_s()) != 0:
                        return None, errors.EFAILEDSOCKET
                    return sock, 0
            key = make_key(ep, protocol=self.options.protocol,
                           ssl=self.options.use_ssl, auth=self.options.auth,
                           app_connect_id=(
                               f"device:{self.options.device}"
                               if self.options.use_device_transport else ""))
            smap = get_global_socket_map()
            sid = smap.insert(
                ep, key,
                health_check_interval_s=self.options.health_check_interval_s,
                app_connect_factory=self._app_connect_factory(),
                ssl_context=self._ssl_context)
            if self._mapped_key is not None:
                smap.remove(self._mapped_key, expected_sid=self._mapped_sid)
            self._mapped_key, self._mapped_sid = key, sid
            self._single_sid = sid
            sock = Socket.address(sid)
            if sock is None:
                return None, errors.EFAILEDSOCKET
            self._pin_protocol(sock)
            if sock.ensure_connected(self._connect_timeout_s()) != 0:
                return None, errors.EFAILEDSOCKET
            return sock, 0

    def _on_rpc_end(self, cntl: Controller):
        for sock in cntl._accessed:
            if sock.connection_type == "short":
                sock.recycle()
            elif sock.connection_type == "pooled":
                if sock.failed():
                    sock.recycle()
                else:
                    with self._pool_lock:
                        self._pools.setdefault(sock.remote_side,
                                               deque()).append(sock)
        if self.options.enable_circuit_breaker and cntl._current_sock:
            self._feed_circuit_breaker(cntl._current_sock, cntl)

    def _feed_circuit_breaker(self, sock: Socket, cntl: Controller):
        from brpc_tpu_torch.rpc.circuit_breaker import CircuitBreaker

        if sock.lame_duck:
            return  # a planned drain is no health signal
        with self._cb_lock:
            cb = self._circuit_breakers.get(sock.node_sid)
            if cb is None:
                cb = CircuitBreaker()
                self._circuit_breakers[sock.node_sid] = cb
        if not cb.on_call_end(cntl.error_code_value, cntl.latency_us):
            node = Socket.address(sock.node_sid) or sock
            node.set_failed(errors.EFAILEDSOCKET, "isolated by circuit breaker")

    # -- the RPC -----------------------------------------------------------
    def call_method(self, method_full_name: str, cntl: Controller,
                    request, response, done: Optional[Callable] = None):
        """Synchronous without ``done``; with it, returns at once and
        ``done(cntl)`` runs when the RPC ends."""
        if not self._init_done:
            cntl.set_failed(errors.EINVAL, "channel not initialized")
            if done:
                done(cntl)
            return
        if cntl.timeout_ms is None:
            cntl.timeout_ms = self.options.timeout_ms
        if cntl.max_retry == 3:  # the controller's default: take ours
            cntl.max_retry = self.options.max_retry
        if (cntl.backup_request_ms is None
                and self.options.backup_request_ms > 0):
            cntl.backup_request_ms = self.options.backup_request_ms
        _start_call(self, method_full_name, cntl, request, response, done)

    def call(self, method_full_name: str, request, response_class,
             timeout_ms: Optional[float] = None, **cntl_kwargs):
        """A synchronous call returning (controller, response)."""
        cntl = Controller()
        if timeout_ms is not None:
            cntl.timeout_ms = timeout_ms
        for k, v in cntl_kwargs.items():
            setattr(cntl, k, v)
        response = response_class() if response_class is not None else None
        self.call_method(method_full_name, cntl, request, response)
        return cntl, response


class _OneSocket:
    """The channel of a call pinned to one connection, over tpu_std, with
    the options (the authenticator) of the channel that made it."""

    def __init__(self, sock: Socket, options: Optional[ChannelOptions]):
        self._sock = sock
        self._protocol = find_protocol_by_name("tpu_std")
        self.options = options

    def _select_socket(self, cntl: Controller):
        if self._sock.failed():
            return None, errors.EFAILEDSOCKET
        return self._sock, 0

    def _on_rpc_end(self, cntl: Controller):
        pass


def call_on_socket(sock: Socket, method_full_name: str, cntl: Controller,
                   request, response, done: Optional[Callable] = None,
                   options: Optional[ChannelOptions] = None):
    """One attempt on ``sock`` itself: no balancing, no retry, no backup
    request. Fails with EFAILEDSOCKET when the connection is gone.
    ``options`` are those of the channel the connection belongs to: its
    ``auth`` gives the call its credential."""
    if cntl.timeout_ms is None:
        cntl.timeout_ms = ChannelOptions.timeout_ms
    cntl.max_retry = 0
    cntl.backup_request_ms = None
    _start_call(_OneSocket(sock, options), method_full_name, cntl, request,
                response, done)
