"""LoadBalancer — server selection policies over DoublyBufferedData.

Copy of brpc_tpu/rpc/load_balancer.py: rr, wrr, random, wr, consistent
hashing (c_murmurhash and c_md5 share the reference's md5 ring),
locality-aware (la: weight = 1 / (EMA latency x (inflight + 1))) and
_dynpart (weighted by a capacity callback), plus the reference's
``name:params`` cluster-recover suffix. Given the same nodes, the same
``random.seed`` and the same feedback, each picks the same sequence of
socket ids as its reference twin.

A server is a socket id; health is ``Socket.address(sid)`` neither failed
nor lame duck, so a socket failure and its health-check revival reach
selection with nothing else to do.
"""
from __future__ import annotations

import hashlib
import random
import threading
from bisect import bisect_right
from typing import Dict, List, Optional, Set

from brpc_tpu_torch.butil.dbd import DoublyBufferedData
from brpc_tpu_torch.rpc.socket import Socket


class ServerNode:
    __slots__ = ("sid", "weight", "tag")

    def __init__(self, sid: int, weight: int = 1, tag: str = ""):
        self.sid = sid
        self.weight = max(1, weight)
        self.tag = tag


def _alive(sid: int) -> bool:
    # a lame-duck socket finishes its calls but takes no new one
    s = Socket.address(sid)
    return s is not None and s.usable_for_new_calls()


class LoadBalancer:
    """Interface (load_balancer.h:35-126)."""

    name = "base"

    def __init__(self):
        self._dbd: DoublyBufferedData[List[ServerNode]] = DoublyBufferedData(list)
        self._lock = threading.Lock()

    # -- membership (driven by the NamingService observer) ----------------
    def add_server(self, sid: int, weight: int = 1, tag: str = ""):
        def add(lst: List[ServerNode]):
            if all(n.sid != sid for n in lst):
                lst.append(ServerNode(sid, weight, tag))

        self._dbd.modify(add)
        self._on_membership_change()

    def remove_server(self, sid: int):
        def rm(lst: List[ServerNode]):
            lst[:] = [n for n in lst if n.sid != sid]

        self._dbd.modify(rm)
        self._on_membership_change()

    def server_ids(self) -> List[int]:
        with self._dbd.read() as lst:
            return [n.sid for n in lst]

    def server_count(self) -> int:
        with self._dbd.read() as lst:
            return len(lst)

    def _on_membership_change(self):
        pass

    # -- selection ---------------------------------------------------------
    def select_server(self, exclude: Optional[Set[int]] = None,
                      request_code: int = 0) -> Optional[int]:
        raise NotImplementedError

    def feedback(self, sid: int, error_code: int, latency_us: float):
        """CallBack after each RPC (load_balancer.h:98 Feedback)."""

    def _usable(self, lst: List[ServerNode], exclude) -> List[ServerNode]:
        out = [n for n in lst if _alive(n.sid)]
        if exclude:
            filtered = [n for n in out if n.sid not in exclude]
            if filtered:  # excluding everything beats returning nothing
                return filtered
        return out


class RoundRobinLB(LoadBalancer):
    name = "rr"

    def __init__(self):
        super().__init__()
        self._index = 0

    def select_server(self, exclude=None, request_code: int = 0):
        with self._dbd.read() as lst:
            usable = self._usable(lst, exclude)
            if not usable:
                return None
            with self._lock:
                self._index = (self._index + 1) % len(usable)
                return usable[self._index].sid


class WeightedRoundRobinLB(LoadBalancer):
    name = "wrr"

    def __init__(self):
        super().__init__()
        self._current: Dict[int, float] = {}

    def select_server(self, exclude=None, request_code: int = 0):
        # Smooth weighted RR (nginx algorithm — equivalent coverage to
        # policy/weighted_round_robin_load_balancer.cpp).
        with self._dbd.read() as lst:
            usable = self._usable(lst, exclude)
            if not usable:
                return None
            with self._lock:
                total = 0
                best = None
                for n in usable:
                    cur = self._current.get(n.sid, 0.0) + n.weight
                    self._current[n.sid] = cur
                    total += n.weight
                    if best is None or cur > self._current[best.sid]:
                        best = n
                self._current[best.sid] -= total
                return best.sid


class RandomLB(LoadBalancer):
    name = "random"

    def select_server(self, exclude=None, request_code: int = 0):
        with self._dbd.read() as lst:
            usable = self._usable(lst, exclude)
            if not usable:
                return None
            return random.choice(usable).sid


class WeightedRandomLB(LoadBalancer):
    name = "wr"

    def select_server(self, exclude=None, request_code: int = 0):
        with self._dbd.read() as lst:
            usable = self._usable(lst, exclude)
            if not usable:
                return None
            total = sum(n.weight for n in usable)
            x = random.uniform(0, total)
            acc = 0.0
            for n in usable:
                acc += n.weight
                if x <= acc:
                    return n.sid
            return usable[-1].sid


class ConsistentHashLB(LoadBalancer):
    """Ketama-style ring (policy/consistent_hashing_load_balancer.cpp +
    hasher.cpp): each server owns `replicas` virtual points hashed by md5;
    requests route by request_code."""

    name = "c_murmurhash"
    replicas = 100

    def __init__(self):
        super().__init__()
        self._ring: List[int] = []  # sorted hash points
        self._ring_sids: List[int] = []

    def _on_membership_change(self):
        points = []
        with self._dbd.read() as lst:
            for n in lst:
                for r in range(self.replicas):
                    h = hashlib.md5(f"{n.sid}-{r}".encode()).digest()
                    points.append((int.from_bytes(h[:8], "little"), n.sid))
        points.sort()
        with self._lock:
            self._ring = [p[0] for p in points]
            self._ring_sids = [p[1] for p in points]

    def select_server(self, exclude=None, request_code: int = 0):
        with self._lock:
            ring, sids = self._ring, self._ring_sids
        if not ring:
            return None
        # Hash the request code onto the ring (the Hasher of hasher.cpp).
        hcode = hashlib.md5(request_code.to_bytes(8, "little", signed=False)
                            if request_code >= 0 else str(request_code).encode()
                            ).digest()
        point = int.from_bytes(hcode[:8], "little")
        idx = bisect_right(ring, point) % len(ring)
        # walk the ring until an alive, non-excluded node
        for step in range(len(ring)):
            sid = sids[(idx + step) % len(ring)]
            if _alive(sid) and (not exclude or sid not in exclude):
                return sid
        return None


class LocalityAwareLB(LoadBalancer):
    """Latency+inflight weighted selection
    (policy/locality_aware_load_balancer.{h,cpp}): weight_i proportional to
    1 / (ema_latency_i * (inflight_i + 1)); feedback() maintains the EMA."""

    name = "la"
    _EMA_ALPHA = 0.2
    _DEFAULT_LATENCY_US = 10_000.0

    def __init__(self):
        super().__init__()
        self._stats: Dict[int, List[float]] = {}  # sid -> [ema_us, inflight]

    def select_server(self, exclude=None, request_code: int = 0):
        with self._dbd.read() as lst:
            usable = self._usable(lst, exclude)
            if not usable:
                return None
            with self._lock:
                weights = []
                for n in usable:
                    ema, inflight = self._stats.get(
                        n.sid, [self._DEFAULT_LATENCY_US, 0.0]
                    )
                    weights.append(n.weight / (ema * (inflight + 1.0)))
                total = sum(weights)
                x = random.uniform(0.0, total)
                acc = 0.0
                chosen = usable[-1].sid
                for n, w in zip(usable, weights):
                    acc += w
                    if x <= acc:
                        chosen = n.sid
                        break
                st = self._stats.setdefault(
                    chosen, [self._DEFAULT_LATENCY_US, 0.0]
                )
                st[1] += 1.0
                return chosen

    def feedback(self, sid: int, error_code: int, latency_us: float):
        with self._lock:
            st = self._stats.setdefault(sid, [self._DEFAULT_LATENCY_US, 0.0])
            st[1] = max(0.0, st[1] - 1.0)
            sample = latency_us if error_code == 0 else latency_us * 10.0
            st[0] = (1 - self._EMA_ALPHA) * st[0] + self._EMA_ALPHA * sample


class DynPartLB(LoadBalancer):
    """_dynpart (policy/dynpart_load_balancer.cpp): selection weighted by
    each member's DYNAMIC capacity — in the reference, the sub-channel
    weight of the SelectiveChannel member (schan::GetSubChannelWeight);
    here a capacity callback installed by DynamicPartitionChannel. Members
    are scheme handles, not sockets, so liveness = capacity > 0."""

    name = "_dynpart"

    def __init__(self):
        super().__init__()
        self._capacity_fn = lambda sid: 1

    def set_capacity_fn(self, fn):
        self._capacity_fn = fn

    def select_server(self, exclude=None, request_code: int = 0):
        # weighted random by live capacity (dynpart_load_balancer.cpp:
        # 104-157 total_weight walk + fast_rand_less_than); capacities are
        # sampled ONCE so a concurrent NS update cannot skew the pick.
        with self._dbd.read() as lst:
            pairs = [(n.sid, self._capacity_fn(n.sid)) for n in lst]
        pairs = [(sid, c) for sid, c in pairs if c > 0]
        if exclude:
            filtered = [(sid, c) for sid, c in pairs if sid not in exclude]
            if filtered:
                pairs = filtered
        if not pairs:
            return None
        x = random.uniform(0, sum(c for _, c in pairs))
        acc = 0.0
        for sid, c in pairs:
            acc += c
            if x <= acc:
                return sid
        return pairs[-1][0]


_registry = {
    "rr": RoundRobinLB,
    "wrr": WeightedRoundRobinLB,
    "random": RandomLB,
    "wr": WeightedRandomLB,
    "c_murmurhash": ConsistentHashLB,
    "c_md5": ConsistentHashLB,
    "la": LocalityAwareLB,
    "_dynpart": DynPartLB,
}


def create_load_balancer(name: str) -> Optional[LoadBalancer]:
    """'name' or 'name:params' — params currently carry the cluster
    recover policy (load_balancer.h GetRecoverPolicyByParams wiring),
    e.g. 'rr:min_working_instances=2 hold_seconds=3'."""
    base, _, params = name.partition(":")
    cls = _registry.get(base)
    if cls is None:
        return None
    lb = cls()
    lb.cluster_recover_policy = None
    if params:
        from brpc_tpu_torch.rpc.cluster_recover import recover_policy_from_params

        lb.cluster_recover_policy = recover_policy_from_params(params)
        if lb.cluster_recover_policy is None:
            return None  # malformed params reject init (reference behavior)
    return lb
