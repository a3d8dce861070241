"""NativeCluster — the Python handle on the native fan-out core.

Port of brpc_tpu/rpc/native_cluster.py over the port's native library
(native/src/nat_cluster.cpp): a double-buffered server list with
lock-free balancer selection, per-backend channels dialed lazily with
circuit breakers and lame-duck failover, and the combo channels' verbs
(selective with retry, parallel, partition, dynamic partition) issued and
merged natively.

The naming feed resolves through the same registry as the Python stack
(``naming_service._ns_registry``): the watcher re-resolves on each
scheme's interval and pushes the full node list down, so every scheme,
a registered custom one included, feeds the native cluster.
``rpc/combo_channels.py`` builds its ``native=True`` paths on this class.
"""
from __future__ import annotations

import threading
import weakref
from typing import Callable, List, Optional, Tuple

from brpc_tpu_torch import native
from brpc_tpu_torch.bthread import timer_add
from brpc_tpu_torch.butil.endpoint import EndPoint

# live clusters, walked by the builtin consoles (/status cluster table,
# /brpc_metrics nat_cluster_* rows); weak so a dropped cluster vanishes
_registry: "weakref.WeakSet[NativeCluster]" = weakref.WeakSet()
_registry_lock = threading.Lock()


def live_clusters() -> List["NativeCluster"]:
    with _registry_lock:
        return [c for c in _registry if not c.closed]


class NativeNamingWatcher:
    """Periodic NS -> native-cluster feed (details/naming_service_thread
    role, minus the Python Socket creation: backends live natively)."""

    def __init__(self, ns, service_path: str, cluster: "NativeCluster",
                 node_filter: Optional[Callable] = None):
        self._ns = ns
        self._path = service_path
        self._cluster = cluster
        self._filter = node_filter
        self._stopped = False
        self.refresh()  # first resolution is synchronous (blocking init)
        if ns.refresh_interval_s > 0:
            timer_add(ns.refresh_interval_s, self._periodic)

    def _periodic(self):
        if self._stopped or self._cluster.closed:
            return
        try:
            self.refresh()
        finally:
            if not self._stopped:
                timer_add(self._ns.refresh_interval_s, self._periodic)

    def refresh(self):
        nodes = self._ns.get_servers(self._path)
        if self._filter is not None:
            nodes = [n for n in nodes if self._filter(n)]
        self._cluster.update(nodes)

    def stop(self):
        self._stopped = True


class NativeCluster:
    """One native cluster handle. ``lb``: rr / wrr / random / wr / la /
    c_hash (aliases c_murmurhash, c_md5)."""

    def __init__(self, lb: str = "rr", connect_timeout_ms: int = 500,
                 health_check_ms: int = 100, breaker: bool = True,
                 name: str = ""):
        self._h = native.cluster_create(lb, connect_timeout_ms,
                                        health_check_ms, breaker)
        self.lb = lb
        self.name = name or f"cluster-{id(self) & 0xffff:x}"
        self.closed = False
        self._lock = threading.Lock()
        # verb gate: close() must not free the native handle under an
        # in-flight verb (the C side documents exactly this contract) —
        # verbs enter/exit a counter, close waits for it to drain
        self._cv = threading.Condition(self._lock)
        self._inflight = 0
        self._watcher: Optional[NativeNamingWatcher] = None
        with _registry_lock:
            _registry.add(self)

    def _enter(self) -> bool:
        with self._lock:
            if self.closed:
                return False
            self._inflight += 1
            return True

    def _exit(self):
        with self._lock:
            self._inflight -= 1
            if self.closed and self._inflight == 0:
                self._cv.notify_all()

    # -- membership --------------------------------------------------------
    def update(self, nodes) -> int:
        """Push the full resolved server list: an iterable of
        (EndPoint-or-"ip:port", weight, tag) tuples or bare endpoint
        strings, or a raw spec string."""
        if not isinstance(nodes, (str, bytes)):
            flat = []
            for n in nodes:
                ep = n[0] if isinstance(n, (tuple, list)) else n
                if isinstance(ep, EndPoint):
                    n = (f"{ep.ip}:{ep.port}",) + tuple(
                        n[1:] if isinstance(n, (tuple, list)) else ())
                flat.append(native.cluster_node_entry(n))
            nodes = flat
        with self._lock:
            if self.closed:
                return 0
            return native.cluster_update(self._h, nodes)

    def watch(self, naming_url: str,
              node_filter: Optional[Callable] = None
              ) -> "NativeNamingWatcher":
        """Start the naming observer: scheme://path resolved through the
        shared NS registry, re-resolved on the scheme's interval, full
        list pushed down on every refresh."""
        from brpc_tpu_torch.rpc.naming_service import _ns_registry

        scheme, sep, path = naming_url.partition("://")
        if not sep:
            raise ValueError(f"not a naming url: {naming_url!r}")
        factory = _ns_registry.get(scheme)
        if factory is None:
            raise ValueError(f"unknown naming scheme: {scheme!r}")
        self._watcher = NativeNamingWatcher(factory(), path, self,
                                            node_filter)
        return self._watcher

    def backend_count(self) -> int:
        return native.cluster_backend_count(self._h)

    def select_debug(self, request_code: int = 0) -> Optional[str]:
        return native.cluster_select_debug(self._h, request_code)

    # -- the verbs ---------------------------------------------------------
    _CLOSED = (1009, b"", "cluster closed")

    def call(self, service_method: str, payload: bytes = b"",
             timeout_ms: int = 1000, max_retry: int = 2,
             request_code: int = 0) -> Tuple[int, bytes, str]:
        if not self._enter():
            return self._CLOSED
        try:
            service, _, method = service_method.rpartition(".")
            return native.cluster_call(self._h, service, method, payload,
                                       timeout_ms, max_retry,
                                       request_code)
        finally:
            self._exit()

    def parallel_call(self, service_method: str, payload: bytes = b"",
                      timeout_ms: int = 1000, fail_limit: int = 0
                      ) -> Tuple[int, bytes, str, int]:
        if not self._enter():
            return self._CLOSED + (0,)
        try:
            service, _, method = service_method.rpartition(".")
            return native.cluster_parallel_call(self._h, service, method,
                                                payload, timeout_ms,
                                                fail_limit)
        finally:
            self._exit()

    def partition_call(self, service_method: str, payload: bytes = b"",
                       timeout_ms: int = 1000, partitions: int = 0,
                       fail_limit: int = 0) -> Tuple[int, bytes, str, int]:
        if not self._enter():
            return self._CLOSED + (0,)
        try:
            service, _, method = service_method.rpartition(".")
            return native.cluster_partition_call(self._h, service, method,
                                                 payload, timeout_ms,
                                                 partitions, fail_limit)
        finally:
            self._exit()

    def dynpart_call(self, service_method: str, payload: bytes = b"",
                     timeout_ms: int = 1000, fail_limit: int = 0
                     ) -> Tuple[int, bytes, str, int, int]:
        """DynamicPartitionChannel verb: scheme picked per call from the
        live "i/n" totals, capacity-weighted (_dynpart); returns
        (rc, merged, err, failed_subcalls, chosen_scheme)."""
        if not self._enter():
            return self._CLOSED + (0, 0)
        try:
            service, _, method = service_method.rpartition(".")
            return native.cluster_dynpart_call(self._h, service, method,
                                               payload, timeout_ms,
                                               fail_limit)
        finally:
            self._exit()

    def dynpart_debug(self, x01: float = 0.0) -> dict:
        """Live dynpart scheme table + the pick for point x01 (the
        native-vs-Python equivalence probe)."""
        if not self._enter():
            return {"schemes": [], "chosen": 0}
        try:
            return native.cluster_dynpart_debug(self._h, x01)
        finally:
            self._exit()

    def bench(self, mode: int = 0, seconds: float = 2.0,
              concurrency: int = 4, payload: bytes = b"x" * 16,
              timeout_ms: int = 2000, param: int = 2,
              service: str = "EchoService", method: str = "Echo") -> dict:
        if not self._enter():
            return {"qps": 0.0, "calls": 0, "failed": 0, "p99_us": 0.0}
        try:
            return native.cluster_bench(self._h, mode, service, method,
                                        payload, timeout_ms, param,
                                        seconds, concurrency)
        finally:
            self._exit()

    # -- observability -----------------------------------------------------
    def stats(self) -> list:
        if not self._enter():
            return []
        try:
            return native.cluster_stats(self._h)
        finally:
            self._exit()

    # -- lifecycle ---------------------------------------------------------
    def close(self):
        with self._lock:
            if self.closed:
                return
            self.closed = True
            if self._watcher is not None:
                self._watcher.stop()
            # wait out in-flight verbs (bounded by their own deadlines):
            # the native close frees the handle's last reference, so no
            # verb may still be inside the C surface when it runs
            while self._inflight > 0:
                self._cv.wait(timeout=1.0)
            native.cluster_close(self._h)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
