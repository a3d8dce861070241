"""Server — serves Services over the tensor lane's two framings.

Port of the Python path of brpc_tpu/rpc/server.py. ``add_service`` builds
the (service, method) map with a MethodStatus per method, whose limiter
comes from ``method_max_concurrency`` or ``max_concurrency``. ``start``
registers the protocols, sizes the process's task control
(``num_threads`` workers, the first caller decides), registers the
builtin console unless ``has_builtin_services`` is off, listens, builds
one InputMessenger over the enabled server protocols (``tpu_std``, the
stream frames, the ``TDEV`` device handshake and HTTP), starts the
Acceptor on the event dispatcher and exposes the process variables. Requests run in task-control workers:
no thread is started per connection. ``stop`` stops accepting and fails
every connection, as the reference's Python path does (no drain).

With ``device`` on the card, ``start`` makes the device identity once
(CUDA's start, the send arena's page-locking, the transfer server), so
that no handshake pays for it in the task that reads its connection. A
server with a TensorStore service also arms the descriptor-ring fabric
there (unless ``BRPC_TPU_FABRIC=0``), which its handshake advertises: the
native library is built at its first use, not under a call's deadline,
and a failed build raises. Other servers need no native library.

The RPC port answers HTTP too: ``curl http://host:port/status`` reads
the console (brpc_tpu_torch/builtin/console.py: ``/status``, ``/vars``,
``/brpc_metrics``, ``/connections``, ``/flags``, ``/hotspots`` with the
card trace on ``/hotspots/tpu``, ...), ``POST /Service/Method`` calls a
method with a JSON body, and ``restful_mappings``
(``"/v1/echo => EchoService.Echo, ..."``) give a method a path of its own.

The port speaks hulu_pbrpc and sofa_pbrpc to every added service; it
speaks redis, memcache, thrift, nshead (and through nshead the nova,
public and ubrpc adaptors of rpc/legacy_nshead_family.py), mongo and esp
through the service each one names in ``ServerOptions``
(``redis_service``, ``memcache_service``, ``thrift_service``,
``nshead_service``, ``mongo_service_adaptor``, ``esp_service``), all on
the one port. With ``rtmp_service`` (an ``RtmpService``,
rpc/rtmp_protocol.py) the port is also a live RTMP relay: publishers
and players hold RTMP sessions on it beside every other protocol.

With ``ssl_certfile`` (and ``ssl_keyfile``) the port speaks TLS only:
each connection's handshake runs in a task before its first byte is
read, and everything above rides inside it, the console, gRPC and the
device handshake included. With ``auth`` (an ``Authenticator``) every
tpu_std and hulu request must carry a credential it verifies, or is
answered EAUTH; the handler finds the verified ``cntl.auth_context``.
Other protocols carry no credential, as in the reference.

With ``use_native_runtime`` the port's native library owns the port
(rpc/native_runtime.py): accept, the event loop and the tpu_std, HTTP, h2
and redis framing run in C++, and the services run on a Python lane of
threads; with ``py_workers`` and ``py_worker_factory``, HTTP and gRPC
calls run in that many worker processes over the shm lane. At most one
native server lives in a process. ``start`` returns -1, and logs why,
when the native server cannot start; it never falls back to the Python
listener. ``stop`` then drains first: it stops accepting, lame-ducks every
connection, finishes admitted calls within
``graceful_shutdown_timeout_ms`` while refusing new ones, and closes the
connections once flushed.

``idle_timeout_s`` and ``server_info_name`` are read nowhere in the
reference and are not ported.
"""
from __future__ import annotations

import logging
import socket as pysocket
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple

from brpc_tpu_torch import bvar
from brpc_tpu_torch.bthread import get_task_control
from brpc_tpu_torch.butil.endpoint import EndPoint
from brpc_tpu_torch.device import DeviceLike, resolve_device
from brpc_tpu_torch.rpc.acceptor import Acceptor
from brpc_tpu_torch.rpc.concurrency_limiter import create_concurrency_limiter
from brpc_tpu_torch.rpc.data_pools import SimpleDataPool
from brpc_tpu_torch.rpc.input_messenger import InputMessenger
from brpc_tpu_torch.rpc.method_status import MethodStatus
from brpc_tpu_torch.rpc.protocol import globally_initialize, list_server_protocols
from brpc_tpu_torch.rpc.service import MethodInfo, Service
from brpc_tpu_torch.rpc.socket import tls_context

TENSOR_STORE_SERVICE = "TensorStore"


@dataclass
class ServerOptions:
    """The reference's ServerOptions that its Python path honours and this
    port serves, with their defaults, plus the device."""

    num_threads: int = 8
    max_concurrency: int = 0  # 0: unlimited; else a limiter per method
    method_max_concurrency: Dict[str, object] = field(default_factory=dict)
    interceptor: Optional[Callable] = None  # (cntl) -> (ok, code, text)
    session_local_data_factory: Optional[object] = None  # a DataFactory
    enabled_protocols: Tuple[str, ...] = ()  # empty: every registered one
    auth: Optional[object] = None  # an Authenticator of tpu_std and hulu
    # the console's pages and /hotspots on the RPC port, over HTTP
    has_builtin_services: bool = True
    # "/v1/echo => EchoService.Echo, /v1/x => S.M"
    restful_mappings: str = ""
    # SIGTERM becomes stop() + join() + exit(0)
    graceful_quit_on_sigterm: bool = False
    # the port speaks redis (a RedisService, rpc/redis.py)
    redis_service: Optional[object] = None
    # the port speaks the memcache binary protocol (rpc/memcache.py)
    memcache_service: Optional[object] = None
    # the port speaks framed thrift (a ThriftService, rpc/thrift.py)
    thrift_service: Optional[object] = None
    # the port speaks nshead (an NsheadService, rpc/nshead_protocol.py)
    nshead_service: Optional[object] = None
    # the port speaks mongo (a MongoServiceAdaptor, rpc/mongo.py)
    mongo_service_adaptor: Optional[object] = None
    # the port speaks esp (an EspService, rpc/esp_protocol.py)
    esp_service: Optional[object] = None
    # the port relays RTMP (an RtmpService, rpc/rtmp_protocol.py)
    rtmp_service: Optional[object] = None
    # TLS: PEM paths of the certificate chain and its key; empty: plaintext
    ssl_certfile: str = ""
    ssl_keyfile: str = ""
    # The identity the server half of the device handshake announces: the
    # card unless the caller asks for the CPU.
    device: DeviceLike = None
    # the port on the native runtime (rpc/native_runtime.py); one per process
    use_native_runtime: bool = False
    # with it, the native EchoService.Echo and POST /echo handlers, which
    # shadow Python services of the same name
    native_builtin_echo: bool = False
    # with it and redis_service, the GET/SET family on a native store
    native_redis_store: bool = False
    # with it, HTTP and gRPC calls in this many worker processes serving
    # the Services "module:function" returns (importable afresh)
    py_workers: int = 0
    py_worker_factory: str = ""
    # stop() on the native runtime drains admitted calls this long first
    # (<= 0: an abrupt stop)
    graceful_shutdown_timeout_ms: int = 5000


class Server:
    def __init__(self, options: Optional[ServerOptions] = None):
        self.options = options or ServerOptions()
        self._services: Dict[str, Service] = {}
        # (service, method) -> (service object, MethodInfo, MethodStatus)
        self._methods: Dict[Tuple[str, str],
                            Tuple[Service, MethodInfo, MethodStatus]] = {}
        self._acceptor: Optional[Acceptor] = None
        self._native_mount = None
        self._messenger: Optional[InputMessenger] = None
        self.listen_endpoint: Optional[EndPoint] = None
        self._started = False
        self._stopped_event = threading.Event()
        self.start_time = 0.0  # time.time() at the last start
        self.interceptor = self.options.interceptor
        self.auth = self.options.auth
        self.redis_service = self.options.redis_service
        self.memcache_service = self.options.memcache_service
        self.thrift_service = self.options.thrift_service
        self.nshead_service = self.options.nshead_service
        self.session_pool = None
        if self.options.session_local_data_factory is not None:
            self.session_pool = SimpleDataPool(
                self.options.session_local_data_factory)
        self._lock = threading.Lock()
        # restful path -> (service_name, method_name)
        self.restful_map: Dict[str, Tuple[str, str]] = {}
        for part in (self.options.restful_mappings or "").split(","):
            part = part.strip()
            if not part:
                continue
            path, _, target = part.partition("=>")
            service, _, method = target.strip().rpartition(".")
            path = "/" + path.strip().strip("/")
            if service and method:
                self.restful_map[path] = (service, method)

    # -- service registry --------------------------------------------------
    def add_service(self, service: Service) -> int:
        name = service.service_name()
        with self._lock:
            if self._started or name in self._services:
                return -1  # services are added before start
            self._services[name] = service
            for mname, minfo in service.methods().items():
                full = f"{name}.{mname}"
                spec = self.options.method_max_concurrency.get(full, 0)
                if not spec:
                    spec = self.options.max_concurrency
                limiter = create_concurrency_limiter(spec) if spec else None
                self._methods[(name, mname)] = (
                    service, minfo, MethodStatus(full, limiter))
        return 0

    def remove_service(self, service: Service) -> int:
        """Take a service and its methods out before start; -1 when
        running or when the service was not added."""
        name = service.service_name()
        with self._lock:
            if self._started or name not in self._services:
                return -1
            del self._services[name]
            for key in [k for k in self._methods if k[0] == name]:
                del self._methods[key]
        return 0

    def find_service(self, name: str) -> Optional[Service]:
        return self._services.get(name)

    def find_method(self, service_name: str, method_name: str):
        return self._methods.get((service_name, method_name))

    def method_statuses(self) -> Dict[str, MethodStatus]:
        return {f"{k[0]}.{k[1]}": v[2] for k, v in self._methods.items()}

    @property
    def service_count(self) -> int:
        return len(self._services)

    def arms_fabric(self) -> bool:
        """A server with a TensorStore service arms the descriptor-ring
        fabric, so that same-host pushes land in its blob arena."""
        return TENSOR_STORE_SERVICE in self._services

    # -- lifecycle ---------------------------------------------------------
    def start(self, address="127.0.0.1:0") -> int:
        """Listen on 'ip:port', ':port', an EndPoint or a port number (0:
        any free port); 0 on success."""
        globally_initialize()
        if isinstance(address, int):
            ep = EndPoint("127.0.0.1", address)
        elif isinstance(address, EndPoint):
            ep = address
        else:
            address = str(address)
            ep = EndPoint.parse("127.0.0.1" + address
                                if address.startswith(":") else address)
        device = resolve_device(self.options.device)
        from brpc_tpu_torch.rpc import device_transport as dt

        # CUDA's start, the send arena's page-locking, the transfer server's
        # start and, for a TensorStore, the fabric's arming (the native
        # library's build at its first use included, which raises when it
        # fails) happen here, not in a handshake under a call's deadline
        if device.type == "cuda":
            dt.local_device_info(device, arm_fabric=self.arms_fabric())
        elif self.arms_fabric():
            dt._fabric_arm_receiver()
        with self._lock:
            if self._started:
                return -1
            get_task_control(self.options.num_threads).init()
            if self.options.has_builtin_services:
                from brpc_tpu_torch.builtin import register_builtin_services

                register_builtin_services(self)
            ssl_ctx = None
            if self.options.ssl_certfile:
                try:
                    ssl_ctx = tls_context(server_side=True,
                                          certfile=self.options.ssl_certfile,
                                          keyfile=self.options.ssl_keyfile)
                except (OSError, ValueError):
                    return -1  # no such file, or not a key for the chain
            if self.options.use_native_runtime:
                if not self._start_native(ep):
                    return -1
            elif not self._start_listener(ep, ssl_ctx):
                return -1
            self._started = True
            self.start_time = time.time()
            self._stopped_event.clear()
            if self.options.graceful_quit_on_sigterm:
                self._install_sigterm_handler()
        bvar.expose_default_variables()
        return 0

    def _start_listener(self, ep: EndPoint, ssl_ctx) -> bool:
        lfd = pysocket.socket(pysocket.AF_INET, pysocket.SOCK_STREAM)
        lfd.setsockopt(pysocket.SOL_SOCKET, pysocket.SO_REUSEADDR, 1)
        try:
            lfd.bind((ep.ip, ep.port))
        except OSError:
            lfd.close()
            return False
        lfd.listen(1024)
        self.listen_endpoint = EndPoint(ep.ip, lfd.getsockname()[1])
        protocols = list_server_protocols()
        if self.options.enabled_protocols:
            protocols = [p for p in protocols
                         if p.name in self.options.enabled_protocols]
        self._messenger = InputMessenger(protocols, arg=self)
        self._acceptor = Acceptor(self._messenger, ssl_context=ssl_ctx)
        self._acceptor.start_accept(lfd)
        return True

    def _start_native(self, ep: EndPoint) -> bool:
        from brpc_tpu_torch.rpc.native_runtime import NativeRuntimeMount

        mount = NativeRuntimeMount(self, self.options.num_threads)
        try:
            port = mount.start(ep.ip, ep.port,
                               native_echo=self.options.native_builtin_echo)
        except Exception as e:
            # a bind conflict, a library that does not build, or a second
            # native server in this process
            logging.getLogger(__name__).error(
                "native runtime did not start on %s: %s", ep, e)
            return False
        self._native_mount = mount
        self.listen_endpoint = EndPoint(ep.ip, port)
        return True

    @property
    def native_mount(self):
        """The native-runtime mount while it serves, else None."""
        return self._native_mount

    def _install_sigterm_handler(self):
        """SIGTERM runs stop() and join(), then exits 0. Installable from
        the main thread only; elsewhere the embedder routes signals."""
        import signal

        if threading.current_thread() is not threading.main_thread():
            return

        def _on_sigterm(signum, frame):
            self.stop()
            self.join(5.0)
            sys.exit(0)

        try:
            signal.signal(signal.SIGTERM, _on_sigterm)
        except (ValueError, OSError):
            pass

    def stop(self, graceful: bool = True) -> int:
        """Stop accepting and fail every connection: their calls in flight
        end with a socket error on the client. On the native runtime the
        calls admitted drain first (unless ``graceful`` is off). -1 when
        not running."""
        with self._lock:
            if not self._started:
                return -1
            self._started = False
        mount, self._native_mount = self._native_mount, None
        if mount is not None:
            mount.stop(quiesce_timeout_ms=(
                self.options.graceful_shutdown_timeout_ms if graceful else 0))
        if self._acceptor is not None:
            self._acceptor.stop_accept()
        self._stopped_event.set()
        return 0

    def join(self, timeout: Optional[float] = None) -> int:
        self._stopped_event.wait(timeout)
        return 0

    def run_until_asked_to_quit(self):
        """Serve until stopped or interrupted (Ctrl-C stops and joins)."""
        try:
            while self._started:
                time.sleep(0.5)
        except KeyboardInterrupt:
            self.stop()
            self.join()

    @property
    def is_running(self) -> bool:
        return self._started

    def connection_count(self) -> int:
        return self._acceptor.connection_count() if self._acceptor else 0

    def list_connections(self):
        return self._acceptor.list_connections() if self._acceptor else []
