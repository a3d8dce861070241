"""Cluster recover policy — a copy of brpc_tpu/rpc/cluster_recover.py
(brpc's ClusterRecoverPolicy): after a whole
cluster goes down (every node isolated by the circuit breaker), letting all
traffic rush back the moment one node revives would knock it over again.
While "recovering", requests are randomly rejected in proportion to how
much of `min_working_instances` is actually usable; recovery ends once the
usable count has held stable for `hold_seconds`.

Attached to a load balancer via the LB-string params, the reference's
GetRecoverPolicyByParams grammar:
    "rr:min_working_instances=2 hold_seconds=3"
"""
from __future__ import annotations

import random
import threading
import time
from typing import List, Optional

_DETECT_INTERVAL_S = 0.01  # usable-count cache TTL (the reference's
# -detect_available_server_interval_ms)


class ClusterRecoverPolicy:
    """Interface (cluster_recover_policy.h:20-29)."""

    def start_recover(self):
        raise NotImplementedError

    def do_reject(self, server_ids: List[int]) -> bool:
        raise NotImplementedError

    def stop_recover_if_necessary(self) -> bool:
        """Returns True while still recovering."""
        raise NotImplementedError


class DefaultClusterRecoverPolicy(ClusterRecoverPolicy):
    def __init__(self, min_working_instances: int, hold_seconds: float):
        self._recovering = False
        self._min_working = max(1, int(min_working_instances))
        self._hold_s = float(hold_seconds)
        self._lock = threading.Lock()
        self._last_usable = 0
        self._last_usable_change_t = 0.0
        self._usable_cache = 0
        self._usable_cache_t = 0.0

    @property
    def recovering(self) -> bool:
        return self._recovering

    def start_recover(self):
        with self._lock:
            self._recovering = True

    def stop_recover_if_necessary(self) -> bool:
        if not self._recovering:
            return False
        now = time.monotonic()
        with self._lock:
            if (self._last_usable_change_t and self._last_usable
                    and now - self._last_usable_change_t > self._hold_s):
                self._recovering = False
                self._last_usable = 0
                self._last_usable_change_t = 0.0
                return False
        return True

    def _usable_count(self, now: float, server_ids: List[int]) -> int:
        if now - self._usable_cache_t < _DETECT_INTERVAL_S:
            return self._usable_cache
        from brpc_tpu_torch.rpc.socket import Socket

        usable = 0
        for sid in server_ids:
            s = Socket.address(sid)
            if s is not None and not s.failed():
                usable += 1
        with self._lock:
            self._usable_cache = usable
            self._usable_cache_t = now
        return usable

    def do_reject(self, server_ids: List[int]) -> bool:
        """Reject with probability 1 - usable/min_working_instances
        (cluster_recover_policy.cpp:91-108)."""
        if not self._recovering:
            return False
        now = time.monotonic()
        usable = self._usable_count(now, server_ids)
        if self._last_usable != usable:
            with self._lock:
                if self._last_usable != usable:
                    self._last_usable = usable
                    self._last_usable_change_t = now
        return random.randrange(self._min_working) >= usable


def recover_policy_from_params(params: str) -> Optional[ClusterRecoverPolicy]:
    """GetRecoverPolicyByParams (cluster_recover_policy.cpp:110-139):
    space-separated key=value pairs; both keys required."""
    min_working = hold_seconds = None
    try:
        for pair in params.split():
            key, sep, value = pair.partition("=")
            if not sep or not value:
                continue
            if key == "min_working_instances":
                min_working = int(value)
            elif key == "hold_seconds":
                hold_seconds = float(value)
    except ValueError:
        return None  # non-numeric values reject like the reference
    if min_working is None or hold_seconds is None:
        return None
    return DefaultClusterRecoverPolicy(min_working, hold_seconds)
