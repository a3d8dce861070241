"""Native-runtime bvars — the C++ stat cells as variables of the registry.

Port of brpc_tpu/bvar/native_vars.py. The native library (nat_stats)
keeps per-thread cells of monotonic counters and log2 latency
histograms, combined on demand. ``register_native_bvars`` exposes that
surface beside the Python lanes on ``/vars``, ``/status`` and
``/brpc_metrics``:

- one PassiveStatus per counter under its native name (``nat_*``), and a
  PerSecond window ``<name>_second`` over each traffic counter;
- per-lane latency percentiles (``nat_<lane>_latency_p50/p99/p999_us``)
  from the combined log2 histograms;
- per-dispatcher rows (``nat_dispatcher_<i>_{sockets,wakeups,sqpoll}``);
- labelled rows (a {((label, value), ...): scalar} dict, rendered by
  ``dump_prometheus``): per-method stats, per-connection counters, the
  resource ledger, lock waits by rank and the native clusters' backends.

Every snapshot is cached for 0.25 s: one dump reads many rows. Nothing
here loads the library: a process that has not loaded it registers
nothing, and its pages show no native section (queue C #38; the
reference's registry and pages build its library on first use).
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from brpc_tpu_torch import native
from brpc_tpu_torch.bvar.variable import PassiveStatus, find_exposed
from brpc_tpu_torch.bvar.window import PerSecond

TTL_S = 0.25

_lock = threading.Lock()
_registered = False
_vars = []  # strong references: an exposed variable must not be collected


class _TtlCache:
    """The result of one snapshot call of the binder, kept ``TTL_S``."""

    def __init__(self, fetch):
        self._fetch = fetch
        self._ts = 0.0
        self._snap = None

    def get(self):
        now = time.monotonic()
        if self._snap is None or now - self._ts > TTL_S:
            self._snap = self._fetch()
            self._ts = now
        return self._snap

    def clear(self):
        self._ts, self._snap = 0.0, None


def _cluster_stats():
    """(cluster name, backend row) over every live native cluster."""
    from brpc_tpu_torch.rpc.native_cluster import live_clusters

    out = []
    for c in live_clusters():
        try:
            out.extend((c.name, row) for row in c.stats())
        except Exception:
            continue  # closed under our feet
    return out


_snap_cache = _TtlCache(lambda: native.stats_counters())
_method_cache = _TtlCache(lambda: native.method_stats())
_conn_cache = _TtlCache(lambda: native.conn_snapshot())
_res_cache = _TtlCache(lambda: native.res_stats())
_cluster_cache = _TtlCache(_cluster_stats)
_CACHES = (_snap_cache, _method_cache, _conn_cache, _res_cache,
           _cluster_cache)


def _snapshot() -> Dict[str, int]:
    return _snap_cache.get()


class _CounterSource:
    """A native counter as an invertible reducer, for PerSecond."""

    invertible = True

    def __init__(self, name: str):
        self._name = name

    def get_value(self) -> int:
        return int(_snapshot().get(self._name, 0))


# gauges and bookkeeping counters whose rate means nothing
_NO_RATE = {"nat_py_queue_depth", "nat_spans_dropped",
            "nat_connections_accepted", "nat_sqpoll_rings"}

_PCTS = (("p50", 0.50), ("p99", 0.99), ("p999", 0.999))


def _method_labels(row):
    return (("lane", row["lane"]), ("method", row["method"]))


def _method_dim(field: str):
    return {_method_labels(r): r[field] for r in _method_cache.get()}


def _lane_index() -> Dict[str, int]:
    return {name: i for i, name in enumerate(native.stats_lane_names())}


def _method_p99_dim():
    lanes = _lane_index()
    return {_method_labels(r): round(
                native.method_quantile(lanes[r["lane"]], r["method"], 0.99)
                / 1e3, 1)
            for r in _method_cache.get() if r["lane"] in lanes}


def _conn_labels(row):
    return (("sock_id", row["sock_id"]), ("remote", row["remote"]),
            ("protocol", row["protocol"]))


def _conn_dim(field: str):
    return {_conn_labels(r): r[field] for r in _conn_cache.get()}


def _res_dim(field: str):
    return {(("subsystem", r["subsystem"]),): r[field]
            for r in _res_cache.get()}


def _lock_dim(field: str):
    return {(("rank", r["rank"]), ("name", r["name"])): r[field]
            for r in native.mu_rank_stats()}


def _cluster_dim(field: str, as_int: bool = False):
    return {(("cluster", name), ("backend", r["endpoint"])):
            int(r[field]) if as_int else r[field]
            for name, r in _cluster_cache.get()}


class _ClampedPerSecond(PerSecond):
    """A PerSecond over a native counter, which only a stats_reset or a
    mu_prof_reset (tests, benches) takes back: never a negative rate."""

    def get_value(self):
        return max(0.0, float(super().get_value() or 0.0))


class _KeyedCounterSource:
    """One keyed row's counter (a method's count, a socket's bytes) as a
    reducer; a key gone reads 0, so its window decays."""

    invertible = True

    def __init__(self, snap_fn, key_fn, key, field):
        self._snap_fn = snap_fn
        self._key_fn = key_fn
        self._key = key
        self._field = field

    def get_value(self) -> float:
        for r in self._snap_fn():
            if self._key_fn(r) == self._key:
                return float(r[self._field])
        return 0.0


def _destroy_all(windows):
    for w in windows:  # destroy() talks to the sampler: not under a lock
        try:
            w.destroy()
        except Exception:
            pass


class _KeyedRates:
    """A PerSecond window per (key, field), made on first read; the
    windows of keys gone are destroyed by ``prune``."""

    def __init__(self, snap_fn, key_fn, window_s: int = 10):
        self._snap_fn = snap_fn
        self._key_fn = key_fn
        self._window_s = window_s
        self._mu = threading.Lock()  # scrapes and /connections at once
        self._windows = {}

    def rate(self, key, field) -> float:
        with self._mu:
            w = self._windows.get((key, field))
            if w is None:
                w = _ClampedPerSecond(
                    _KeyedCounterSource(self._snap_fn, self._key_fn, key,
                                        field), self._window_s)
                self._windows[(key, field)] = w
        return float(w.get_value() or 0.0)

    def prune(self, live_keys):
        with self._mu:
            dead = [self._windows.pop(k) for k in list(self._windows)
                    if k[0] not in live_keys]
        _destroy_all(dead)

    def clear(self):
        with self._mu:
            dead = list(self._windows.values())
            self._windows.clear()
        _destroy_all(dead)


_method_rates = _KeyedRates(_method_cache.get,
                            lambda r: (r["lane"], r["method"]))
_conn_rates = _KeyedRates(_conn_cache.get, lambda r: r["sock_id"])


def method_qps(lane: str, method: str) -> float:
    """One native method row's calls per second over its window."""
    return _method_rates.rate((lane, method), "count")


def connection_rates(sock_id: int):
    """One native socket's bytes per second each way (the /connections
    rate columns)."""
    return {"in_Bps": _conn_rates.rate(sock_id, "in_bytes"),
            "out_Bps": _conn_rates.rate(sock_id, "out_bytes")}


def prune_connection_windows(live_sock_ids):
    _conn_rates.prune(set(live_sock_ids))


_LABELED = (
    ("nat_method_count", lambda: _method_dim("count")),
    ("nat_method_errors", lambda: _method_dim("errors")),
    ("nat_method_concurrency", lambda: _method_dim("concurrency")),
    ("nat_method_max_concurrency", lambda: _method_dim("max_concurrency")),
    ("nat_method_qps",
     lambda: {_method_labels(r): round(method_qps(r["lane"], r["method"]), 1)
              for r in _method_cache.get()}),
    ("nat_method_latency_p99_us", _method_p99_dim),
    ("nat_connection_in_bytes", lambda: _conn_dim("in_bytes")),
    ("nat_connection_out_bytes", lambda: _conn_dim("out_bytes")),
    ("nat_connection_unwritten_bytes", lambda: _conn_dim("unwritten_bytes")),
    ("nat_connection_mem_bytes", lambda: _conn_dim("mem_bytes")),
    ("nat_mem_live_bytes", lambda: _res_dim("live_bytes")),
    ("nat_mem_live_objects", lambda: _res_dim("live_objects")),
    ("nat_mem_cum_allocs", lambda: _res_dim("cum_allocs")),
    ("nat_mem_cum_frees", lambda: _res_dim("cum_frees")),
    ("nat_mem_hwm_bytes", lambda: _res_dim("hwm_bytes")),
    ("nat_lock_contention_waits", lambda: _lock_dim("waits")),
    ("nat_lock_contention_wait_us", lambda: _lock_dim("wait_us")),
    ("nat_cluster_backend_selects", lambda: _cluster_dim("selects")),
    ("nat_cluster_backend_errors", lambda: _cluster_dim("errors")),
    ("nat_cluster_backend_inflight", lambda: _cluster_dim("inflight")),
    ("nat_cluster_backend_breaker_open",
     lambda: _cluster_dim("breaker_open", as_int=True)),
    ("nat_cluster_backend_lame_duck",
     lambda: _cluster_dim("lame_duck", as_int=True)),
    ("nat_cluster_backend_ema_latency_us",
     lambda: _cluster_dim("ema_latency_us")),
)


def _expose(make, name: str):
    if find_exposed(name) is None:
        _vars.append(make(name))


def register_native_bvars() -> bool:
    """Expose the native stat surface, once; False when this process has
    not loaded the native library (nothing is built here)."""
    global _registered
    if not native.is_loaded():
        return False
    with _lock:
        if not _registered:
            for name in native.stats_counter_names():
                _expose(lambda n: PassiveStatus(
                    lambda: int(_snapshot().get(n, 0)), n), name)
                if name not in _NO_RATE:
                    _expose(lambda n, c=name: _ClampedPerSecond(
                        _CounterSource(c), 10, n), f"{name}_second")
            for idx, lane in enumerate(native.stats_lane_names()):
                for suffix, q in _PCTS:
                    _expose(lambda n, i=idx, qq=q: PassiveStatus(
                        lambda: round(native.stats_quantile(i, qq) / 1e3, 1),
                        n), f"nat_{lane}_latency_{suffix}_us")
            for vname, fn in _LABELED:
                _expose(lambda n, f=fn: PassiveStatus(f, n), vname)
            _registered = True
        # the dispatcher pool may start after the first registration:
        # every call tops its rows up
        for i in range(native.dispatcher_count()):
            for field in ("sockets", "wakeups", "sqpoll"):
                _expose(lambda n, di=i, f=field: PassiveStatus(
                    lambda: _disp_field(di, f), n),
                    f"nat_dispatcher_{i}_{field}")
    return True


def _disp_field(idx: int, field: str):
    row = native._disp_row(native.load(), idx)
    return row[field] if row is not None else 0


# -- the RSS reconciliation line of /status ------------------------------------------

# fixed BSS pools: virtual until a sample touches their pages, so the
# share of the RSS is taken over the heap-backed subsystems
_FIXED_POOL_SUBSYSTEMS = ("prof.cells",)


def rss_reconciliation_line() -> str:
    """/status's nat_mem line: the ledger's bytes, the resident bytes, the
    growth of the resident bytes since the library loaded, and the share
    of that growth the heap-backed subsystems account for."""
    accounted = native.res_accounted_bytes()
    rows = _res_cache.get()
    fixed = sum(r["live_bytes"] for r in rows
                if r["subsystem"] in _FIXED_POOL_SUBSYSTEMS)
    heap_acct = accounted - fixed
    rss = native._read_rss()
    base = native.rss_at_load()
    delta = rss - base if base else 0
    share = (f" ({100.0 * heap_acct / delta:.0f}% of rss_delta)"
             if delta > 0 else "")
    top = sorted(rows, key=lambda r: -r["live_bytes"])[:3]
    top_s = " ".join(f"{r['subsystem']}={r['live_bytes']}"
                     for r in top if r["live_bytes"])
    return (f"  nat_mem: accounted={accounted} bytes "
            f"(heap={heap_acct} fixed_pools={fixed}){share} "
            f"rss={rss} rss_delta_since_native_load={delta}"
            + (f"  top: {top_s}" if top_s else ""))


# the robustness counters, one /status line as soon as any moves
_OVERLOAD_KEYS = ("nat_faults_injected", "nat_elimit_rejects",
                  "nat_queue_deadline_drops", "nat_retry_budget_exhausted",
                  "nat_breaker_isolations", "nat_breaker_revivals")

_PROTO_KEYS = (("tpu_std", "nat_tpu_std"), ("http", "nat_http"),
               ("grpc", "nat_grpc"), ("redis", "nat_redis"),
               ("client", "nat_client"))


def _method_lines(lanes: List[str]) -> List[str]:
    lane_idx = {name: i for i, name in enumerate(lanes)}
    lines = []
    for r in sorted(_method_cache.get(),
                    key=lambda r: (r["lane"], r["method"])):
        if not (r["count"] or r["concurrency"] or r["max_concurrency"]):
            continue  # a row claimed but never used
        li = lane_idx.get(r["lane"])
        p50 = p99 = 0.0
        if li is not None:
            p50 = native.method_quantile(li, r["method"], 0.50) / 1e3
            p99 = native.method_quantile(li, r["method"], 0.99) / 1e3
        lines.append(
            f"  method {r['method']} [{r['lane']}]: count={r['count']} "
            f"qps={method_qps(r['lane'], r['method']):.1f} "
            f"errors={r['errors']} concurrency={r['concurrency']} "
            f"max_concurrency={r['max_concurrency']} "
            f"latency_us: p50={p50:.1f} p99={p99:.1f}")
    return lines


def _cluster_lines() -> List[str]:
    from brpc_tpu_torch.rpc.native_cluster import live_clusters

    lines = []
    for c in live_clusters():
        rows = c.stats()
        lines.append(f"  cluster {c.name} [{c.lb}]: {len(rows)} backends")
        for r in rows:
            state = (["BREAKER-OPEN"] if r["breaker_open"] else []) + (
                ["lame-duck"] if r["lame_duck"] else []) + (
                [f"tag={r['tag']}"] if r["tag"] else [])
            lines.append(
                f"    {r['endpoint']} w={r['weight']} "
                f"selects={r['selects']} errors={r['errors']} "
                f"inflight={r['inflight']} ema_us={r['ema_latency_us']}"
                + (" " + " ".join(state) if state else ""))
    return lines


def native_status_lines(snap: Optional[Dict[str, int]] = None) -> List[str]:
    """The native section of /status: traffic by protocol, the memory
    ledger, overload counters, the per-method table, tail latency by lane
    and the native clusters; empty when the runtime carried nothing, or
    when this process has not loaded the library. ``snap`` replaces the
    live counter snapshot (tests)."""
    if not native.is_loaded():
        return []
    if snap is None:
        snap = native.stats_counters()
    lanes = native.stats_lane_names()
    if not any(snap.values()):
        return []
    lines = ["", "native runtime:", rss_reconciliation_line()]
    mem_rows = [r for r in _res_cache.get() if r["live_bytes"]]
    if mem_rows:
        lines.append("  nat_mem subsystems: " + " ".join(
            f"{r['subsystem']}={r['live_bytes']}/{r['live_objects']}obj"
            f"(hwm={r['hwm_bytes']})"
            for r in sorted(mem_rows, key=lambda r: -r["live_bytes"])))
    lines.append(
        f"  read_bytes: {snap.get('nat_socket_read_bytes', 0)}  "
        f"write_bytes: {snap.get('nat_socket_write_bytes', 0)}  "
        f"accepted: {snap.get('nat_connections_accepted', 0)}  "
        f"py_queue_depth: {snap.get('nat_py_queue_depth', 0)}")
    for label, pfx in _PROTO_KEYS:
        s_in, s_out, s_err = (("calls", "responses", "errors")
                              if label == "client"
                              else ("msgs_in", "responses_out", "errors"))
        msgs = snap.get(f"{pfx}_{s_in}", 0)
        if msgs:
            lines.append(
                f"  {label}: in={msgs} out={snap.get(f'{pfx}_{s_out}', 0)} "
                f"errors={snap.get(f'{pfx}_{s_err}', 0)}")
    if any(snap.get(k, 0) for k in _OVERLOAD_KEYS):
        lines.append("  overload/faults: " + " ".join(
            f"{k[4:]}={snap.get(k, 0)}" for k in _OVERLOAD_KEYS))
    lines += _method_lines(lanes)
    for idx, lane in enumerate(lanes):
        if not any(native.stats_hist(idx)):
            continue
        p50, p99, p999 = (native.stats_quantile(idx, q) / 1e3
                          for _, q in _PCTS)
        lines.append(f"  {lane}_latency_us: p50={p50:.1f} p99={p99:.1f} "
                     f"p999={p999:.1f}")
    return lines + _cluster_lines()


def settle_for_tests():
    """Drop the snapshot caches, so the next dump reads the runtime now."""
    with _lock:
        for c in _CACHES:
            c.clear()


def reset_for_tests():
    """Hide the registered variables, drop the caches and zero the native
    cells."""
    global _registered
    with _lock:
        for v in _vars:
            (v.destroy if hasattr(v, "destroy") else v.hide)()
        _vars.clear()
        _method_rates.clear()
        _conn_rates.clear()
        _registered = False
        for c in _CACHES:
            c.clear()
    if native.is_loaded():
        native.stats_reset()
        native.mu_prof_reset()
