"""Combo channels — fan-out, partition and failover compositions of channels.

Port of the Python path of brpc_tpu/rpc/combo_channels.py:

* ParallelChannel: one call fans out to every sub-channel, each mapped by
  a CallMapper and merged by a ResponseMerger; the call fails when the
  failed sub-calls reach ``fail_limit`` (default: all of them);
* PartitionChannel: one sub-channel per partition, all drawn from one
  naming service whose server tags name partitions ("index/count", read
  by a PartitionParser);
* DynamicPartitionChannel: servers of several partitioning schemes at
  once; each call picks a scheme by its live capacity (the _dynpart
  balancer) and fans out to that scheme's partitions;
* SelectiveChannel: each call goes to one sub-channel, the healthiest in
  turn, and fails over to another when it fails.

With ``native=True`` a channel is built by ``init(naming_url, ...)`` and
its server list, balancer, sub-calls and merge run in the port's native
library (rpc/native_cluster.py): the native merge concatenates the
successful sub-responses in sub-call order, which for serialized messages
is MergeFrom, the default ResponseMerger, so the response is the Python
path's. A SelectiveChannel carries a call's outbound tensors to the sub-channel
it tries and hands the served connection and the response's tensors back
to the caller's controller, so TensorClient works over it; the reference
carries only the request attachment.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from brpc_tpu_torch.rpc import errors
from brpc_tpu_torch.rpc.channel import Channel, ChannelOptions
from brpc_tpu_torch.rpc.controller import Controller

def _native_cluster_init(naming_url: str, lb_name: str,
                         options: Optional[ChannelOptions],
                         node_filter=None, name: str = ""):
    from brpc_tpu_torch.rpc.native_cluster import NativeCluster

    connect_ms = int(options.connect_timeout_ms) if options else 500
    hc_ms = (int(options.health_check_interval_s * 1000)
             if options is not None and options.health_check_interval_s > 0
             else 100)
    cluster = NativeCluster(lb=lb_name or "rr", connect_timeout_ms=connect_ms,
                            health_check_ms=hc_ms, name=name)
    cluster.watch(naming_url, node_filter)
    return cluster


def _native_call(cntl: Controller, request, response, done, verb):
    """Run one native verb ``verb(payload, timeout_ms) -> (rc, body, err,
    ...)``: inline without ``done``, else on a thread (the fan-out is
    parallel natively already; the thread carries done's contract). The
    body, the sub-responses concatenated, is parsed into ``response``."""
    payload = request.SerializeToString() if request is not None else b""
    timeout_ms = int(cntl.timeout_ms or 1000)
    start = time.monotonic()

    def run():
        rc, body, err = verb(payload, timeout_ms)[:3]
        if rc == 0:
            if response is not None and body:
                response.ParseFromString(body)
        else:
            cntl.set_failed(rc, err or errors.berror(rc))
        cntl.latency_us = (time.monotonic() - start) * 1e6
        if done is not None:
            done(cntl)

    if done is None:
        run()
    else:
        threading.Thread(target=run, daemon=True).start()


def _python_path_only(cluster, what: str):
    if cluster is not None:
        raise ValueError(f"a native {what} fans to its naming service's "
                         f"servers; add_channel is the Python path")


def _sub_controller(cntl: Controller) -> Controller:
    sub = Controller()
    sub.timeout_ms = cntl.timeout_ms
    sub.max_retry = cntl.max_retry
    sub.compress_type = cntl.compress_type
    sub.request_attachment.append(cntl.request_attachment)
    return sub


class SubCall:
    """What a CallMapper returns for one sub-channel."""

    __slots__ = ("method", "request", "response", "skip")

    def __init__(self, method=None, request=None, response=None,
                 skip: bool = False):
        self.method = method
        self.request = request
        self.response = response
        self.skip = skip

    @classmethod
    def skip_call(cls) -> "SubCall":
        return cls(skip=True)


class CallMapper:
    """Maps the main call onto sub-channel i."""

    def map(self, channel_index: int, method: str, request, response) -> SubCall:
        # default: the same request to every sub-channel, a fresh response
        sub_resp = type(response)() if response is not None else None
        return SubCall(method, request, sub_resp)


class ResponseMerger:
    """Merges one sub-response into the main response; 0 on success, < 0
    counts the sub-call as failed."""

    def merge(self, main_response, sub_response) -> int:
        if main_response is None or sub_response is None:
            return 0
        try:
            main_response.MergeFrom(sub_response)
            return 0
        except Exception:
            return -1


def _call(channel, method: str, request, response_class,
          timeout_ms: Optional[float]):
    cntl = Controller()
    if timeout_ms is not None:
        cntl.timeout_ms = timeout_ms
    response = response_class() if response_class else None
    channel.call_method(method, cntl, request, response)
    return cntl, response


class ParallelChannel:
    def __init__(self, fail_limit: int = -1, native: bool = False):
        self._subs: List[Tuple[Channel, Optional[CallMapper],
                               Optional[ResponseMerger]]] = []
        self.fail_limit = fail_limit
        self.native = native
        self._cluster = None

    def init(self, naming_url: str, lb_name: str = "rr",
             options: Optional[ChannelOptions] = None) -> int:
        """The native path: every server the naming url resolves to is a
        sub-channel."""
        if not self.native:
            raise ValueError("init(naming_url) needs native=True; the "
                             "Python path uses add_channel()")
        self._cluster = _native_cluster_init(naming_url, lb_name, options,
                                             name="parallel")
        return 0

    def add_channel(self, channel: Channel,
                    call_mapper: Optional[CallMapper] = None,
                    response_merger: Optional[ResponseMerger] = None):
        _python_path_only(self._cluster, "ParallelChannel")
        self._subs.append((channel, call_mapper, response_merger))

    @property
    def channel_count(self) -> int:
        if self._cluster is not None:
            return self._cluster.backend_count()
        return len(self._subs)

    def stop(self):
        if self._cluster is not None:
            self._cluster.close()

    def _native_verb(self, method: str):
        fail_limit = self.fail_limit if self.fail_limit > 0 else 0
        return lambda payload, timeout_ms: self._cluster.parallel_call(
            method, payload, timeout_ms=timeout_ms, fail_limit=fail_limit)

    def call_method(self, method: str, cntl: Controller, request, response,
                    done: Optional[Callable] = None):
        if self._cluster is not None:
            _native_call(cntl, request, response, done,
                         self._native_verb(method))
            return
        n = len(self._subs)
        if n == 0:
            cntl.set_failed(errors.EINVAL, "no sub channels")
            if done:
                done(cntl)
            return
        fail_limit = self.fail_limit if self.fail_limit > 0 else n
        default_mapper = CallMapper()
        default_merger = ResponseMerger()
        calls = []
        for i, (ch, mapper, merger) in enumerate(self._subs):
            sub = (mapper or default_mapper).map(i, method, request, response)
            if not sub.skip:
                calls.append((ch, sub, merger or default_merger))
        if not calls:
            cntl.set_failed(errors.EINVAL, "all sub calls skipped")
            if done:
                done(cntl)
            return
        state = {"pending": len(calls), "failed": 0, "first_error": (0, "")}
        lock = threading.Lock()
        finished = threading.Event()
        start_time = time.monotonic()

        def finalize():
            if state["failed"] >= min(fail_limit, len(calls)):
                code, text = state["first_error"]
                cntl.set_failed(errors.ETOOMANYFAILS,
                                f"{state['failed']}/{len(calls)} sub calls "
                                f"failed, first: {errors.berror(code)} {text}")
            cntl.latency_us = (time.monotonic() - start_time) * 1e6
            if done is not None:
                done(cntl)
            finished.set()

        def make_done(sub, merger):
            def sub_done(sub_cntl: Controller):
                with lock:
                    if sub_cntl.failed():
                        state["failed"] += 1
                        if state["first_error"][0] == 0:
                            state["first_error"] = (sub_cntl.error_code,
                                                    sub_cntl.error_text)
                    elif merger.merge(response, sub.response) < 0:
                        state["failed"] += 1
                        if state["first_error"][0] == 0:
                            state["first_error"] = (errors.EREQUEST,
                                                    "response merge failed")
                    state["pending"] -= 1
                    last = state["pending"] == 0
                if last:
                    finalize()

            return sub_done

        for ch, sub, merger in calls:
            ch.call_method(sub.method or method, _sub_controller(cntl),
                           sub.request, sub.response, make_done(sub, merger))
        if done is None:
            finished.wait()

    def call(self, method: str, request, response_class,
             timeout_ms: Optional[float] = None):
        return _call(self, method, request, response_class, timeout_ms)


class PartitionParser:
    """A server tag -> (partition index, partition count); the default
    syntax is 'N/M' with 0 <= N < M."""

    def parse(self, tag: str) -> Optional[Tuple[int, int]]:
        try:
            idx_s, _, total_s = tag.partition("/")
            idx, total = int(idx_s), int(total_s)
            if 0 <= idx < total:
                return idx, total
        except ValueError:
            pass
        return None


class PartitionChannel(ParallelChannel):
    """One sub-channel per partition, all fed by ONE naming service; a
    server's tag picks its partition."""

    def __init__(self, fail_limit: int = -1, native: bool = False):
        super().__init__(fail_limit, native=native)
        self._partition_count = 0

    def init(self, partition_count: int, naming_url: str, lb_name: str = "rr",
             parser: Optional[PartitionParser] = None,
             options: Optional[ChannelOptions] = None) -> int:
        if self.native:
            # the native core groups backends by the default "i/n" grammar
            if parser is not None and type(parser) is not PartitionParser:
                raise ValueError("a native PartitionChannel reads the default "
                                 "'i/n' tags only")
            self._partition_count = partition_count
            self._cluster = _native_cluster_init(naming_url, lb_name, options,
                                                 name="partition")
            return 0
        parser = parser or PartitionParser()
        for part in range(partition_count):
            ch = Channel(options)

            def node_filter(node, part=part):
                parsed = parser.parse(node[2])
                return (parsed is not None and parsed[0] == part
                        and parsed[1] == partition_count)

            rc = ch.init_with_filter(naming_url, lb_name, node_filter)
            if rc != 0:
                return rc
            self.add_channel(ch)
        return 0

    def _native_verb(self, method: str):
        fail_limit = self.fail_limit if self.fail_limit > 0 else 0
        return lambda payload, timeout_ms: self._cluster.partition_call(
            method, payload, timeout_ms=timeout_ms,
            partitions=self._partition_count, fail_limit=fail_limit)

    def stop(self):
        super().stop()
        for ch, _, _ in self._subs:
            ch.close()


class DynamicPartitionChannel:
    """Several partitioning schemes at once; each call picks a scheme
    weighted by its live server count (the _dynpart balancer, whose
    members are the schemes) and fans out to its partitions."""

    def __init__(self, fail_limit: int = -1, native: bool = False):
        self.fail_limit = fail_limit
        self.native = native
        self._cluster = None
        self._schemes: Dict[int, PartitionChannel] = {}
        self._dynlb = None

    def init(self, naming_url: str, lb_name: str = "rr",
             parser: Optional[PartitionParser] = None,
             options: Optional[ChannelOptions] = None,
             schemes: Optional[List[int]] = None) -> int:
        """``schemes``: the partition counts to serve; without it, the
        counts found in the tags of a first resolution. The native path
        reads the live schemes from the tags at every naming refresh, so
        it ignores ``schemes``."""
        from brpc_tpu_torch.rpc.load_balancer import create_load_balancer
        from brpc_tpu_torch.rpc.naming_service import _ns_registry

        if self.native:
            if parser is not None and type(parser) is not PartitionParser:
                raise ValueError("a native DynamicPartitionChannel reads the "
                                 "default 'i/n' tags only")
            self._cluster = _native_cluster_init(naming_url, "_dynpart",
                                                 options, name="dynpart")
            return 0
        parser = parser or PartitionParser()
        if not schemes:
            scheme, _, path = naming_url.partition("://")
            factory = _ns_registry.get(scheme)
            if factory is None:
                return errors.EINVAL
            try:
                nodes = factory().get_servers(path)
            except ValueError:
                return errors.EINVAL
            schemes = sorted({parsed[1] for parsed in
                              (parser.parse(tag) for _, _, tag in nodes)
                              if parsed})
        if not schemes:
            return errors.EINVAL
        self._dynlb = create_load_balancer("_dynpart")
        self._dynlb.set_capacity_fn(self._scheme_capacity)
        for total in schemes:
            pc = PartitionChannel(self.fail_limit)
            rc = pc.init(total, naming_url, lb_name, parser, options)
            if rc != 0:
                return rc
            self._schemes[total] = pc
            self._dynlb.add_server(total)  # a member is a scheme
        return 0

    def _scheme_capacity(self, total: int) -> int:
        pc = self._schemes.get(total)
        if pc is None:
            return 0
        return sum(ch._lb.server_count() for ch, _, _ in pc._subs
                   if ch._lb is not None)

    def call_method(self, method: str, cntl: Controller, request, response,
                    done: Optional[Callable] = None):
        if self._cluster is not None:
            fail_limit = self.fail_limit if self.fail_limit > 0 else 0

            def verb(payload, timeout_ms):
                out = self._cluster.dynpart_call(
                    method, payload, timeout_ms=timeout_ms,
                    fail_limit=fail_limit)
                cntl.partition_count = out[4]
                return out

            _native_call(cntl, request, response, done, verb)
            return
        total = (self._dynlb.select_server() if self._dynlb is not None
                 else None)
        pc = self._schemes.get(total) if total is not None else None
        if pc is None:
            cntl.set_failed(errors.EFAILEDSOCKET, "no usable partition scheme")
            if done:
                done(cntl)
            return
        pc.call_method(method, cntl, request, response, done)

    def call(self, method: str, request, response_class,
             timeout_ms: Optional[float] = None):
        return _call(self, method, request, response_class, timeout_ms)

    def stop(self):
        if self._cluster is not None:
            self._cluster.close()
        for pc in self._schemes.values():
            pc.stop()


class SelectiveChannel:
    """Each call goes to ONE sub-channel, the healthiest in turn; a failed
    call is retried on another, up to ``max_retry`` times."""

    def __init__(self, max_retry: int = 2, native: bool = False):
        self._channels: List[Channel] = []
        self._health: Dict[int, int] = {}  # index -> consecutive failures
        self._index = 0
        self._lock = threading.Lock()
        self.max_retry = max_retry
        self.native = native
        self._cluster = None

    def init(self, naming_url: str, lb_name: str = "rr",
             options: Optional[ChannelOptions] = None) -> int:
        """The native path: the balancer and the failover run in the
        native cluster (a retry skips the backends tried, breakers fail
        dead peers fast)."""
        if not self.native:
            raise ValueError("init(naming_url) needs native=True; the "
                             "Python path uses add_channel()")
        self._cluster = _native_cluster_init(naming_url, lb_name, options,
                                             name="selective")
        return 0

    def stop(self):
        if self._cluster is not None:
            self._cluster.close()

    def add_channel(self, channel: Channel) -> int:
        _python_path_only(self._cluster, "SelectiveChannel")
        with self._lock:
            self._channels.append(channel)
            return len(self._channels) - 1

    @property
    def channel_count(self) -> int:
        if self._cluster is not None:
            return self._cluster.backend_count()
        return len(self._channels)

    def _select(self, exclude: set) -> Optional[int]:
        with self._lock:
            order = sorted((i for i in range(len(self._channels))
                            if i not in exclude),
                           key=lambda i: self._health.get(i, 0))
            if not order:
                return None
            healthiest = self._health.get(order[0], 0)
            candidates = [i for i in order
                          if self._health.get(i, 0) == healthiest]
            self._index = (self._index + 1) % len(candidates)
            return candidates[self._index]

    def call_method(self, method: str, cntl: Controller, request, response,
                    done: Optional[Callable] = None):
        if self._cluster is not None:
            code = int(cntl.request_code or 0)
            _native_call(
                cntl, request, response, done,
                lambda payload, timeout_ms: self._cluster.call(
                    method, payload, timeout_ms=timeout_ms,
                    max_retry=self.max_retry, request_code=code))
            return
        tried = set()
        last = None
        for _ in range(self.max_retry + 1):
            idx = self._select(tried)
            if idx is None:
                break
            tried.add(idx)
            sub = _sub_controller(cntl)
            sub._outbound_tensors = cntl._outbound_tensors
            self._channels[idx].call_method(method, sub, request, response,
                                            None)
            last = sub
            with self._lock:
                self._health[idx] = (self._health.get(idx, 0) + 1
                                     if sub.failed() else 0)
            if not sub.failed():
                cntl.latency_us = sub.latency_us
                cntl.remote_side = sub.remote_side
                # what TensorClient reads: the served connection (its ACKs)
                # and the response's tensors
                cntl._current_sock = sub._current_sock
                cntl._response_rpc_meta = sub._response_rpc_meta
                cntl.response_attachment = sub.response_attachment
                if done:
                    done(cntl)
                return
        if last is not None:
            cntl.set_failed(last.error_code, last.error_text)
        else:
            cntl.set_failed(errors.EFAILEDSOCKET, "no usable sub channel")
        if done:
            done(cntl)

    def call(self, method: str, request, response_class,
             timeout_ms: Optional[float] = None):
        return _call(self, method, request, response_class, timeout_ms)
