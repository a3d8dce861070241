"""Server — serves Services over the tensor lane's two framings.

The reference's Server (brpc_tpu/rpc/server.py) stands on the acceptor,
the event dispatcher, the input messenger and bthread. This one is
deliberately small: one accept thread, and one reader thread per
connection that parses the ``TDEV`` handshake and ``TRPC`` frames and
dispatches each inline. Builtin services, the native runtime, limiters
and graceful lame-duck draining come with the reference-grade server.
"""
from __future__ import annotations

import socket as pysocket
import threading
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Tuple

from brpc_tpu_torch.device import DeviceLike
from brpc_tpu_torch.rpc import tpu_std_protocol
from brpc_tpu_torch.rpc.service import MethodInfo, Service
from brpc_tpu_torch.rpc.socket import Socket


class EndPoint(NamedTuple):
    ip: str
    port: int

    def __str__(self) -> str:
        return f"{self.ip}:{self.port}"

    @classmethod
    def parse(cls, text: str) -> "EndPoint":
        ip, _, port = str(text).rpartition(":")
        return cls(ip or "127.0.0.1", int(port))


@dataclass
class ServerOptions:
    # The identity the server half of the device handshake announces: the
    # card unless the caller asks for the CPU.
    device: DeviceLike = None


class Server:
    def __init__(self, options: Optional[ServerOptions] = None):
        self.options = options or ServerOptions()
        self._services: Dict[str, Service] = {}
        self._methods: Dict[Tuple[str, str], Tuple[Service, MethodInfo]] = {}
        self._lock = threading.Lock()
        self._listen: Optional[pysocket.socket] = None
        self._threads: List[threading.Thread] = []
        self._conns: List[Socket] = []
        self._started = False
        self.listen_endpoint: Optional[EndPoint] = None

    # -- service registry --------------------------------------------------
    def add_service(self, service: Service) -> int:
        name = service.service_name()
        with self._lock:
            if self._started or name in self._services:
                return -1
            self._services[name] = service
            for mname, minfo in service.methods().items():
                self._methods[(name, mname)] = (service, minfo)
        return 0

    def find_service(self, name: str) -> Optional[Service]:
        return self._services.get(name)

    def find_method(self, service_name: str, method_name: str):
        return self._methods.get((service_name, method_name))

    # -- lifecycle ---------------------------------------------------------
    def start(self, address="127.0.0.1:0") -> int:
        """Listen on 'ip:port' (port 0: any free port); 0 on success."""
        ep = EndPoint.parse(address)
        with self._lock:
            if self._started:
                return -1
            lfd = pysocket.socket(pysocket.AF_INET, pysocket.SOCK_STREAM)
            lfd.setsockopt(pysocket.SOL_SOCKET, pysocket.SO_REUSEADDR, 1)
            try:
                lfd.bind((ep.ip, ep.port))
            except OSError:
                lfd.close()
                return -1
            lfd.listen(128)
            self._listen = lfd
            self.listen_endpoint = EndPoint(ep.ip, lfd.getsockname()[1])
            self._started = True
            self._spawn(self._accept_loop, "tensor-server-accept")
        return 0

    def _spawn(self, target, name, *args):
        t = threading.Thread(target=target, args=args, name=name, daemon=True)
        self._threads.append(t)
        t.start()

    def _accept_loop(self):
        from brpc_tpu_torch.rpc.tensor_service import (
            _parse_handshake,
            _process_handshake,
        )

        parsers = ((_parse_handshake, _process_handshake),
                   (tpu_std_protocol.parse, tpu_std_protocol.process_request))
        while True:
            try:
                conn, addr = self._listen.accept()
            except OSError:
                return  # listening socket closed by stop()
            sock = Socket(conn, f"{addr[0]}:{addr[1]}")
            with self._lock:
                if not self._started:
                    sock.close()
                    return
                self._conns.append(sock)
                self._threads = [t for t in self._threads if t.is_alive()]
            self._spawn(self._serve, "tensor-server-conn", sock, parsers)

    def _serve(self, sock: Socket, parsers):
        try:
            sock.read_loop(parsers, self)
        finally:
            sock.close()
            with self._lock:
                if sock in self._conns:
                    self._conns.remove(sock)

    def stop(self, timeout_s: float = 5.0) -> int:
        """Close the listener and every connection, then wait for the
        threads to end."""
        with self._lock:
            if not self._started:
                return -1
            self._started = False
            conns, self._conns = self._conns, []
            threads = list(self._threads)
        try:
            self._listen.shutdown(pysocket.SHUT_RDWR)
        except OSError:
            pass  # never connected: close() alone wakes accept()
        self._listen.close()
        for sock in conns:
            sock.close()
        for t in threads:
            t.join(timeout_s)
        return 0
