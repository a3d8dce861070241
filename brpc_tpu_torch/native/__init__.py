"""brpc_tpu_torch.native — ctypes bindings to the port's native library.

Port of brpc_tpu/native/__init__.py, under the reference's names,
parameters, defaults and return shapes. The library is the port's own
copy of the reference's C++ runtime (``native/src``), built at first use
by ``native/build.py`` into ``brpc_tpu_torch/build/native/<digest>/``: a
fiber scheduler, native IOBuf, the tpu_std / HTTP / h2 / redis cut loops,
the shm descriptor-ring lane, the fan-out cluster, the client lanes, the
stat cells, span ring, profilers and flight recorder. ``load`` raises
``NativeUnavailable`` with the compiler's errors when the build fails,
and a process tries a failed build once: later calls raise the same
errors without compiling again. No prebuilt library is ever loaded in its
place. ``is_loaded`` tells whether this process has loaded it, without
building: the console, the bvar registry and ``/rpcz`` read only a
library that is loaded already.

Not bound yet (ROADMAP A12d, with the native tools): the reference's
bench and selftest calls ``sched_start``, ``sched_stop``,
``bench_spawn_join``, ``bench_ping_pong``, ``echo_server_start``,
``echo_server_stop``, ``echo_server_requests``, ``echo_client_bench``,
``redis_client_bench``, ``grpc_client_bench``, ``http_client_bench``,
``grpc_channel_bench``, ``http_channel_bench``, ``shm_push_bench``,
``shm_worker_drain_bench``, ``refguard_enabled``, ``refguard_ops``,
``refguard_selftest``, ``res_selftest`` and ``mu_contend_selftest``.
"""
from __future__ import annotations

import ctypes
import logging
import os
import threading
import time
from typing import Optional

import numpy as np

from brpc_tpu_torch.native import build as _build

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()
_build_error: Optional[str] = None  # a failed build, not tried again
# resident bytes just before the library loaded: the zero point of the
# /status nat_mem line (bvar/native_vars.py:rss_reconciliation_line)
_rss_at_load: Optional[int] = None


def _read_rss() -> int:
    try:
        with open("/proc/self/statm", "r") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGESIZE")
    except (OSError, ValueError, IndexError):
        return 0


def rss_at_load() -> int:
    """Resident bytes just before the library loaded (0: never loaded)."""
    return _rss_at_load or 0


class NativeUnavailable(RuntimeError):
    pass


class NatClusterRow(ctypes.Structure):
    """Mirror of nat_stats.h NatClusterRow: one backend of a native
    cluster's server list."""

    _fields_ = [
        ("selects", ctypes.c_uint64),
        ("errors", ctypes.c_uint64),
        ("inflight", ctypes.c_int64),
        ("ema_latency_us", ctypes.c_uint64),
        ("weight", ctypes.c_int32),
        ("breaker_open", ctypes.c_int32),
        ("lame_duck", ctypes.c_int32),
        ("part_index", ctypes.c_int32),
        ("part_total", ctypes.c_int32),
        ("endpoint", ctypes.c_char * 24),
        ("tag", ctypes.c_char * 16),
    ]


class NatResRow(ctypes.Structure):
    """Mirror of nat_res.h NatResRow: one subsystem of the native resource
    ledger (live bytes and objects, cumulative counts, high water)."""

    _fields_ = [
        ("live_bytes", ctypes.c_uint64),
        ("live_objects", ctypes.c_uint64),
        ("cum_allocs", ctypes.c_uint64),
        ("cum_frees", ctypes.c_uint64),
        ("cum_alloc_bytes", ctypes.c_uint64),
        ("hwm_bytes", ctypes.c_uint64),
        ("name", ctypes.c_char * 16),
    ]


class NatSpanRec(ctypes.Structure):
    """Mirror of nat_stats.h NatSpanRec: one sampled natively handled call
    (CLOCK_MONOTONIC ns; ``stats_now_ns`` maps them to wall time)."""

    _fields_ = [
        ("trace_id", ctypes.c_uint64),
        ("span_id", ctypes.c_uint64),
        ("parent_span_id", ctypes.c_uint64),
        ("sock_id", ctypes.c_uint64),
        ("recv_ns", ctypes.c_uint64),
        ("parse_ns", ctypes.c_uint64),
        ("dispatch_ns", ctypes.c_uint64),
        ("write_ns", ctypes.c_uint64),
        ("protocol", ctypes.c_int32),
        ("error_code", ctypes.c_int32),
        ("req_bytes", ctypes.c_uint32),
        ("resp_bytes", ctypes.c_uint32),
        ("method", ctypes.c_char * 48),
    ]


class NatMethodStatRow(ctypes.Structure):
    """Mirror of nat_stats.h NatMethodStatRow: one (lane, method) row."""

    _fields_ = [
        ("count", ctypes.c_uint64),
        ("errors", ctypes.c_uint64),
        ("concurrency", ctypes.c_int64),
        ("max_concurrency", ctypes.c_int64),
        ("lane", ctypes.c_int32),
        ("method", ctypes.c_char * 52),
    ]


class NatConnRow(ctypes.Structure):
    """Mirror of nat_stats.h NatConnRow: one native /connections row."""

    _fields_ = [
        ("sock_id", ctypes.c_uint64),
        ("in_bytes", ctypes.c_uint64),
        ("out_bytes", ctypes.c_uint64),
        ("in_msgs", ctypes.c_uint64),
        ("out_msgs", ctypes.c_uint64),
        ("read_calls", ctypes.c_uint64),
        ("write_calls", ctypes.c_uint64),
        ("unwritten_bytes", ctypes.c_uint64),
        ("mem_bytes", ctypes.c_uint64),
        ("fd", ctypes.c_int32),
        ("disp_idx", ctypes.c_int32),
        ("server_side", ctypes.c_int32),
        ("protocol", ctypes.c_char * 12),
        ("remote", ctypes.c_char * 24),
    ]


class NatLockRankRow(ctypes.Structure):
    """Mirror of nat_stats.h NatLockRankRow: contended-wait totals of one
    NatMutex rank."""

    _fields_ = [
        ("waits", ctypes.c_uint64),
        ("wait_us", ctypes.c_uint64),
        ("rank", ctypes.c_int32),
        ("name", ctypes.c_char * 20),
    ]


class NatDumpStatusRec(ctypes.Structure):
    """Mirror of nat_dump.h NatDumpStatusRec: the flight recorder's state
    (counts since the current window's start)."""

    _fields_ = [
        ("samples", ctypes.c_uint64),
        ("written", ctypes.c_uint64),
        ("bytes", ctypes.c_uint64),
        ("drops", ctypes.c_uint64),
        ("oversize", ctypes.c_uint64),
        ("rotations", ctypes.c_uint64),
        ("max_file_bytes", ctypes.c_uint64),
        ("max_payload", ctypes.c_uint64),
        ("seed", ctypes.c_uint64),
        ("every", ctypes.c_uint32),
        ("running", ctypes.c_int32),
        ("generations", ctypes.c_int32),
        ("dir", ctypes.c_char * 192),
    ]


class NatReplayResult(ctypes.Structure):
    """Mirror of nat_dump.h NatReplayResult: one replay's outcome
    (quantiles over the calls that succeeded)."""

    _fields_ = [
        ("loaded", ctypes.c_uint64),
        ("sent", ctypes.c_uint64),
        ("ok", ctypes.c_uint64),
        ("failed", ctypes.c_uint64),
        ("skipped", ctypes.c_uint64),
        ("seconds", ctypes.c_double),
        ("qps", ctypes.c_double),
        ("p50_us", ctypes.c_double),
        ("p99_us", ctypes.c_double),
    ]


_c = ctypes
_VP, _CP, _SZ = _c.c_void_p, _c.c_char_p, _c.c_size_t
_I, _I32, _I64, _U64, _D = _c.c_int, _c.c_int32, _c.c_int64, _c.c_uint64, _c.c_double
_P = _c.POINTER
# name -> (argtypes, restype); ``_VP`` data arguments take any buffer
# through ``_buf`` (bytes, bytearray, memoryview, numpy array)
_SIGNATURES = {
    # the server and its Python lane
    "nat_rpc_server_start": ([_CP, _I, _I, _I], _I),
    "nat_rpc_server_stop": ([], None),
    "nat_rpc_server_enable_raw_fallback": ([_I], _I),
    "nat_rpc_server_native_http": ([_I], _I),
    "nat_rpc_server_redis": ([_I], _I),
    "nat_rpc_server_ssl": ([_CP, _CP], _I),
    "nat_rpc_use_io_uring": ([_I], _I),
    "nat_take_request_batch": ([_P(_VP), _I, _I], _I),
    "nat_req_field": ([_VP, _I, _P(_SZ)], _VP),
    "nat_req_cid": ([_VP], _I64),
    "nat_req_aux": ([_VP], _U64),
    "nat_req_compress": ([_VP], _I32),
    "nat_req_sock_id": ([_VP], _U64),
    "nat_req_kind": ([_VP], _I32),
    "nat_req_free": ([_VP], None),
    "nat_respond": ([_VP, _I32, _CP, _VP, _SZ, _VP, _SZ], _I),
    "nat_sock_write": ([_U64, _VP, _SZ], _I),
    "nat_sock_set_failed": ([_U64], _I),
    "nat_http_respond": ([_U64, _I64, _VP, _SZ, _I], _I),
    "nat_grpc_respond": ([_U64, _I64, _VP, _SZ, _I, _CP], _I),
    "nat_redis_respond": ([_U64, _I64, _VP, _SZ], _I),
    "nat_server_quiesce": ([_I], _I),
    "nat_stats_enable_spans": ([_I], None),
    "nat_buf_free": ([_VP], None),
    "nat_res_count": ([], _I),
    "nat_res_stats": ([_P(NatResRow), _I], _I),
    # the server's remaining calls
    "nat_rpc_server_requests": ([], _U64),
    "nat_rpc_set_dispatchers": ([_I], _I),
    "nat_take_request": ([_I], _VP),
    "nat_sock_graceful_close": ([_U64], _I),
    "nat_rpc_server_add_port": ([_CP, _I], _I),
    "nat_rpc_server_remove_port": ([_I], _I),
    "nat_rpc_server_limiter": ([_CP], _I),
    "nat_rpc_server_queue_deadline_ms": ([_I], _I),
    "nat_rpc_server_inflight": ([], _I),
    "nat_rpc_server_limit": ([], _I),
    "nat_server_draining": ([], _I),
    "nat_fault_configure": ([_CP], _I),
    "nat_fault_enabled": ([], _I),
    "nat_fault_injected": ([], _U64),
    "nat_ring_counters": ([_P(_U64), _P(_U64)], None),
    "nat_disp_count": ([], _I),
    "nat_disp_stat": ([_I, _P(_U64), _P(_U64), _P(_I)], _I),
    # the client lanes
    "nat_channel_open": ([_CP, _I, _I, _I, _I, _I], _VP),
    "nat_channel_open_proto": ([_CP, _I, _I, _I, _I, _I, _I, _CP], _VP),
    "nat_channel_close": ([_VP], None),
    "nat_channel_call_full": ([_VP, _CP, _CP, _VP, _SZ, _I, _I, _I,
                               _P(_VP), _P(_SZ), _P(_VP)], _I),
    "nat_channel_acall": ([_VP, _CP, _CP, _VP, _SZ, _I, _VP, _VP], _I),
    "nat_channel_set_breaker": ([_VP, _I], _I),
    "nat_channel_breaker_state": ([_VP], _I),
    "nat_channel_retry_budget": ([_VP], _I),
    "nat_http_call": ([_VP, _CP, _CP, _CP, _VP, _SZ, _I, _P(_I), _P(_VP),
                       _P(_SZ)], _I),
    "nat_grpc_call": ([_VP, _CP, _VP, _SZ, _I, _P(_I), _P(_VP), _P(_SZ),
                       _P(_VP)], _I),
    "nat_rpc_client_bench": ([_CP, _I, _I, _I, _D, _I, _P(_U64)], _D),
    "nat_rpc_client_bench_bulk": ([_CP, _I, _I, _D, _P(_U64)], _D),
    # counters, histograms and spans
    "nat_stats_counter_count": ([], _I),
    "nat_stats_counter_name": ([_I], _CP),
    "nat_stats_counters": ([_P(_U64), _I], _I),
    "nat_stats_counter_bump": ([_CP, _U64], _I),
    "nat_stats_lane_count": ([], _I),
    "nat_stats_lane_name": ([_I], _CP),
    "nat_stats_hist_nbuckets": ([], _I),
    "nat_stats_hist": ([_I, _P(_U64), _I], _I),
    "nat_stats_hist_quantile": ([_I, _D], _D),
    "nat_stats_drain_spans": ([_P(NatSpanRec), _I], _I),
    "nat_stats_reset": ([], None),
    "nat_stats_now_ns": ([], _U64),
    "nat_stats_snapshot": ([_P(_VP), _P(_SZ)], _I),
    "nat_method_stats": ([_P(NatMethodStatRow), _I], _I),
    "nat_method_quantile": ([_I, _CP, _D], _D),
    "nat_method_hist": ([_I, _CP, _P(_U64), _I], _I),
    "nat_conn_snapshot": ([_P(NatConnRow), _I], _I),
    # the resource ledger and the profilers
    "nat_res_name": ([_I], _CP),
    "nat_res_accounted_bytes": ([], _U64),
    "nat_res_prof_start": ([_I, _U64], _I),
    "nat_res_prof_stop": ([], _I),
    "nat_res_prof_running": ([], _I),
    "nat_res_prof_samples": ([], _U64),
    "nat_res_prof_reset": ([], None),
    "nat_res_heap_report": ([_I, _P(_VP), _P(_SZ)], _I),
    "nat_res_growth_baseline": ([], _I),
    "nat_res_growth_report": ([_P(_VP), _P(_SZ)], _I),
    "nat_prof_start": ([_I], _I),
    "nat_prof_stop": ([], _I),
    "nat_prof_running": ([], _I),
    "nat_prof_samples": ([], _U64),
    "nat_prof_reset": ([], None),
    "nat_prof_report": ([_I, _P(_VP), _P(_SZ)], _I),
    "nat_mu_prof_start": ([_I, _I, _U64], _I),
    "nat_mu_prof_stop": ([], _I),
    "nat_mu_prof_running": ([], _I),
    "nat_mu_prof_samples": ([], _U64),
    "nat_mu_prof_reset": ([], None),
    "nat_mu_prof_reset_samples": ([], None),
    "nat_mu_prof_report": ([_I, _P(_VP), _P(_SZ)], _I),
    "nat_mu_rank_stats": ([_P(NatLockRankRow), _I], _I),
    "nat_mu_rank_name": ([_I], _CP),
    # trace context, capture and replay
    "nat_trace_set": ([_U64, _U64], None),
    "nat_dump_start": ([_CP, _I, _U64, _U64, _I, _U64], _I),
    "nat_dump_stop": ([], _I),
    "nat_dump_running": ([], _I),
    "nat_dump_status": ([_P(NatDumpStatusRec)], _I),
    "nat_replay_run": ([_CP, _I, _CP, _I, _D, _D, _I, _I,
                        _P(NatReplayResult)], _I),
    # the shm lane: usercode workers and the tensor fabric
    "nat_shm_lane_create": ([_SZ], _I),
    "nat_shm_lane_name": ([], _CP),
    "nat_shm_lane_enable": ([_I], _I),
    "nat_shm_lane_workers": ([], _I),
    "nat_shm_lane_max_workers": ([], _I),
    "nat_shm_lane_recover_probe": ([], _I),
    "nat_shm_worker_attach": ([_CP], _I),
    "nat_shm_take_request": ([_I], _VP),
    "nat_shm_respond": ([_I, _U64, _I64, _VP, _SZ, _I32, _CP, _I], _I),
    "nat_shm_push_tensor": ([_VP, _SZ, _U64], _I),
    "nat_shm_producer_attach": ([_CP], _I),
    "nat_shm_fabric_push": ([_VP, _SZ, _U64], _I),
    "nat_shm_fabric_take": ([_I], _VP),
    # the fan-out cluster
    "nat_cluster_create": ([_CP, _I, _I, _I], _VP),
    "nat_cluster_close": ([_VP], None),
    "nat_cluster_update": ([_VP, _CP], _I),
    "nat_cluster_backend_count": ([_VP], _I),
    "nat_cluster_select_debug": ([_VP, _U64, _CP, _SZ], _I),
    "nat_cluster_call": ([_VP, _CP, _CP, _VP, _SZ, _I, _I, _U64,
                          _P(_VP), _P(_SZ), _P(_VP)], _I),
    "nat_cluster_parallel_call": ([_VP, _CP, _CP, _VP, _SZ, _I, _I,
                                   _P(_VP), _P(_SZ), _P(_VP), _P(_I)], _I),
    "nat_cluster_partition_call": ([_VP, _CP, _CP, _VP, _SZ, _I, _I, _I,
                                    _P(_VP), _P(_SZ), _P(_VP), _P(_I)], _I),
    "nat_cluster_dynpart_call": ([_VP, _CP, _CP, _VP, _SZ, _I, _I,
                                  _P(_VP), _P(_SZ), _P(_VP), _P(_I),
                                  _P(_I)], _I),
    "nat_cluster_dynpart_debug": ([_VP, _D, _P(_I), _P(_I), _I, _P(_I)],
                                  _I),
    "nat_cluster_stats": ([_VP, _P(NatClusterRow), _I], _I),
    "nat_cluster_bench": ([_VP, _I, _CP, _CP, _VP, _SZ, _I, _I, _D, _I,
                           _P(_U64), _P(_U64), _P(_D)], _D),
}


def library_path() -> str:
    """The built library (building it first when needed)."""
    try:
        return str(_build.build_library())
    except (_build.BuildError, OSError) as e:
        raise NativeUnavailable(str(e)) from e


def load() -> ctypes.CDLL:
    """The port's native library, built at first use, with the signatures
    of every call this package makes."""
    global _lib, _build_error
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is None:
            if _build_error is not None:
                raise NativeUnavailable(_build_error)
            try:
                path = library_path()
            except NativeUnavailable as e:
                _build_error = str(e)
                raise
            global _rss_at_load
            if _rss_at_load is None:
                _rss_at_load = _read_rss()
            lib = ctypes.CDLL(path)
            for name, (args, res) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = res
            _lib = lib
    return _lib


def available() -> bool:
    try:
        load()
        return True
    except NativeUnavailable:
        return False


def is_loaded() -> bool:
    """Whether this process has loaded the library (never builds it)."""
    return _lib is not None


def _buf(data):
    """(pointer, length) of a byte buffer, without a copy where the buffer
    is writable or an ndarray; the caller keeps ``data`` alive."""
    if data is None:
        return None, 0
    if isinstance(data, bytes):
        return ctypes.cast(ctypes.c_char_p(data), ctypes.c_void_p), len(data)
    a = np.frombuffer(data, dtype=np.uint8) if not isinstance(
        data, np.ndarray) else np.ascontiguousarray(data).reshape(-1).view(
            np.uint8)
    if a.size == 0:
        return None, 0
    return a.ctypes.data, a.size


def _take_out(lib, p: ctypes.c_void_p, n: int = -1) -> bytes:
    """Copy a malloc'd native buffer out and free it (``n < 0``: a
    NUL-terminated string)."""
    if not p.value:
        return b""
    try:
        return ctypes.string_at(p, n) if n >= 0 else ctypes.string_at(p)
    finally:
        lib.nat_buf_free(p)


# -- the native RPC runtime ------------------------------------------------------

def rpc_server_start(ip: str = "127.0.0.1", port: int = 0,
                     nworkers: int = 0, native_echo: bool = False) -> int:
    """Start the native RPC server (one per process); returns the bound
    port."""
    rc = load().nat_rpc_server_start(ip.encode(), port, nworkers,
                                     1 if native_echo else 0)
    if rc <= 0:
        raise RuntimeError(f"native rpc server failed to start on "
                           f"{ip}:{port} (rc={rc})")
    return rc


def rpc_server_stop():
    load().nat_rpc_server_stop()


def use_io_uring(enable: bool = True) -> int:
    """The io_uring datapath: 1 = live, 0 = the kernel refused it (epoll
    serves), -1 = runtime error."""
    return load().nat_rpc_use_io_uring(1 if enable else 0)


def _field(lib, h, which: int) -> bytes:
    n = ctypes.c_size_t(0)
    p = lib.nat_req_field(h, which, ctypes.byref(n))
    return ctypes.string_at(p, n.value) if p and n.value else b""


def _request_tuple(lib, h):
    kind = lib.nat_req_kind(h)
    if kind in (3, 4):
        return (h, kind, _field(lib, h, 4), _field(lib, h, 2), b"",
                lib.nat_req_sock_id(h), lib.nat_req_cid(h),
                _field(lib, h, 0), _field(lib, h, 1), 0)
    if kind == 5:
        return (h, kind, b"", _field(lib, h, 2), b"",
                lib.nat_req_sock_id(h), lib.nat_req_cid(h),
                lib.nat_req_compress(h), b"", lib.nat_req_aux(h))
    return (h, kind, _field(lib, h, 4), _field(lib, h, 2),
            _field(lib, h, 3), lib.nat_req_sock_id(h),
            lib.nat_req_cid(h), b"", b"", 0)


def take_requests(max_items: int = 16, timeout_ms: int = 100):
    """The Python lane: up to max_items handed off by the native runtime,
    as (handle, kind, meta_bytes, payload, attachment, sock_id, seq, f0,
    f1, aux) tuples. kind 0 = a parsed tpu_std request; 1 = raw protocol
    bytes (seq orders a socket's chunks); 2 = connection closed; 3 = a
    natively parsed HTTP request (f0 verb, f1 uri, meta_bytes the
    lowercased "key: value\\n" headers, payload the body, seq the response
    token); 4 = a gRPC request (f1 the :path, seq the h2 stream id); 5 = a
    stream frame (f0 its type, aux the destination stream id); 6 = a redis
    command (payload the packed argv)."""
    lib = load()
    arr = (ctypes.c_void_p * max_items)()
    n = lib.nat_take_request_batch(arr, max_items, timeout_ms)
    return [_request_tuple(lib, arr[i]) for i in range(n)]


def rpc_server_enable_raw_fallback(enable: bool = True) -> int:
    """Unknown framing goes to the Python protocol stack as ordered raw
    chunks instead of failing the socket."""
    return load().nat_rpc_server_enable_raw_fallback(1 if enable else 0)


def rpc_server_native_http(enable: bool = True) -> int:
    """HTTP/1.1 and h2 connections parse natively and surface as kind-3
    and kind-4 requests."""
    return load().nat_rpc_server_native_http(1 if enable else 0)


def rpc_server_redis(mode: int = 1) -> int:
    """1 = RESP parsed natively, commands to the Python RedisService
    (kind 6); 2 = the GET/SET family against a native store as well."""
    return load().nat_rpc_server_redis(mode)


def rpc_server_ssl(certfile: str, keyfile: str) -> int:
    """TLS on the native port (plaintext keeps working): 0 = ok, -2 =
    libssl missing."""
    return load().nat_rpc_server_ssl(certfile.encode(), keyfile.encode())


def req_free(handle):
    load().nat_req_free(handle)


def respond(handle, error_code: int = 0, error_text: str = "",
            payload=b"", attachment=b"") -> int:
    """Answer a kind-0 request."""
    p, n = _buf(payload)
    a, m = _buf(attachment)
    return load().nat_respond(handle, error_code,
                              error_text.encode() or None, p, n, a, m)


def sock_write(sock_id: int, data) -> int:
    p, n = _buf(data)
    return load().nat_sock_write(sock_id, p, n)


def sock_set_failed(sock_id: int) -> int:
    return load().nat_sock_set_failed(sock_id)


def http_respond(sock_id: int, seq: int, data, close_after: bool = False) -> int:
    """Answer a kind-3 request with its whole serialized response; the
    native session keeps pipelined responses in request order."""
    p, n = _buf(data)
    return load().nat_http_respond(sock_id, seq, p, n, 1 if close_after else 0)


def grpc_respond(sock_id: int, stream_id: int, payload=b"",
                 grpc_status: int = 0, grpc_message: str = "") -> int:
    """Answer a kind-4 request: HEADERS, DATA and the grpc-status trailers
    framed natively."""
    p, n = _buf(payload)
    return load().nat_grpc_respond(sock_id, stream_id, p, n, grpc_status,
                                   grpc_message.encode() or None)


def redis_respond(sock_id: int, seq: int, data) -> int:
    """Answer a kind-6 command with its whole RESP reply, in order."""
    p, n = _buf(data)
    return load().nat_redis_respond(sock_id, seq, p, n)


def server_quiesce(timeout_ms: int = 5000) -> int:
    """Graceful quiesce of the running native server: stop accepting,
    lame-duck every connection by its protocol, drain admitted work (shm
    workers' included) under the deadline while new arrivals are refused
    (ELIMIT, 503, RESOURCE_EXHAUSTED), close sockets once flushed. 0 =
    drained, 1 = the deadline expired, -1 = no server. Call
    rpc_server_stop after."""
    return load().nat_server_quiesce(timeout_ms)


def rpc_server_requests() -> int:
    """Requests the native server has handled."""
    return load().nat_rpc_server_requests()


def take_request(timeout_ms: int = 100):
    """One item of the Python lane as ``take_requests`` gives it, or None
    on timeout."""
    lib = load()
    h = lib.nat_take_request(timeout_ms)
    if not h:
        return None
    return _request_tuple(lib, h)


def rpc_set_dispatchers(n: int) -> int:
    """The number of epoll/io_uring dispatcher loops (the
    event_dispatcher_num analog); call before the runtime starts."""
    return load().nat_rpc_set_dispatchers(n)


def sock_graceful_close(sock_id: int) -> int:
    """Fail the socket once its queued writes drained (FIN after the last
    response byte): ``Connection: close``."""
    return load().nat_sock_graceful_close(sock_id)


def rpc_server_add_port(ip: str = "127.0.0.1", port: int = 0) -> int:
    """Listen on one more port with the running native server; the bound
    port. Raises when no server runs."""
    rc = load().nat_rpc_server_add_port(ip.encode(), port)
    if rc <= 0:
        raise RuntimeError("nat_rpc_server_add_port failed")
    return rc


def rpc_server_remove_port(port: int) -> int:
    """Unregister a port added by ``rpc_server_add_port``: its accepted
    connections keep serving, new connections are refused."""
    return load().nat_rpc_server_remove_port(port)


def rpc_server_limiter(spec: str = "") -> int:
    """The native server's admission control: "" or "none" off, "auto"
    the gradient limiter, "constant:N" or "N" a fixed limit. A rejection
    answers ELIMIT (2004), HTTP 503 or gRPC RESOURCE_EXHAUSTED."""
    return load().nat_rpc_server_limiter(spec.encode() or None)


def rpc_server_queue_deadline_ms(ms: int) -> int:
    """Python-lane requests older than ``ms`` when a worker would take
    them are rejected with ELIMIT before dispatch; <= 0 turns it off."""
    return load().nat_rpc_server_queue_deadline_ms(ms)


def rpc_server_inflight() -> int:
    """Admitted requests in flight now."""
    return load().nat_rpc_server_inflight()


def rpc_server_limit() -> int:
    """The concurrency limit in force (auto: the computed one); 0 off."""
    return load().nat_rpc_server_limit()


def server_draining() -> bool:
    """True from a quiesce's start until the server stops or restarts."""
    return bool(load().nat_server_draining())


def fault_configure(spec: str = "") -> int:
    """Install (or clear, with "") the seeded fault table of
    ``native/src/nat_fault.h``: 0, or -1 on a parse error. The same seed
    and the same operations at each site give the same faults."""
    return load().nat_fault_configure(spec.encode() or None)


def fault_enabled() -> bool:
    return bool(load().nat_fault_enabled())


def fault_injected() -> int:
    """Faults injected in this process since the library loaded (also the
    ``nat_faults_injected`` counter)."""
    return load().nat_fault_injected()


def ring_counters():
    """(receive completions, send completions) of the io_uring
    datapath."""
    recv, send = ctypes.c_uint64(), ctypes.c_uint64()
    load().nat_ring_counters(ctypes.byref(recv), ctypes.byref(send))
    return recv.value, send.value


def _disp_row(lib, i: int):
    sockets, wakeups = ctypes.c_uint64(), ctypes.c_uint64()
    sqpoll = ctypes.c_int()
    if lib.nat_disp_stat(i, ctypes.byref(sockets), ctypes.byref(wakeups),
                         ctypes.byref(sqpoll)) != 0:
        return None
    return {"sockets": sockets.value, "wakeups": wakeups.value,
            "sqpoll": sqpoll.value}


def dispatcher_count() -> int:
    """The dispatcher loops in the pool."""
    return load().nat_disp_count()


def dispatcher_stats() -> list:
    """One row per dispatcher: {'sockets' owned now, 'wakeups' that
    delivered events, 'sqpoll' (-1 no ring, 0, 1)}."""
    lib = load()
    rows = []
    for i in range(lib.nat_disp_count()):
        row = _disp_row(lib, i)
        if row is None:
            break
        rows.append(row)
    return rows


def stats_enable_spans(every: int = 1):
    """0 = spans off; N = one span of every N natively handled calls."""
    load().nat_stats_enable_spans(every)


def res_stats() -> list:
    """The native resource ledger: one dict per subsystem (iobuf blocks,
    socket slabs, fiber stacks, shm segments, ``shm.span`` the fabric's
    leased spans, ...) with live bytes and objects, cumulative allocs,
    frees and bytes, and the high-water mark."""
    lib = load()
    n = lib.nat_res_count()
    arr = (NatResRow * n)()
    got = lib.nat_res_stats(arr, n)
    return [{"subsystem": r.name.decode(errors="replace"),
             "live_bytes": r.live_bytes,
             "live_objects": r.live_objects,
             "cum_allocs": r.cum_allocs,
             "cum_frees": r.cum_frees,
             "cum_alloc_bytes": r.cum_alloc_bytes,
             "hwm_bytes": r.hwm_bytes} for r in arr[:got]]


def res_live_bytes(subsystem: str) -> int:
    """One subsystem's live bytes in the ledger (0 when it has no row)."""
    return next((r["live_bytes"] for r in res_stats()
                 if r["subsystem"] == subsystem), 0)


# -- the descriptor-ring tensor fabric ------------------------------------------

class FabricLease:
    """One kind-8 tensor record leased from the fabric.

    ``view()`` reads the record's span of the producer's blob arena in
    place (no copy); the span stays held until ``release()``, which may
    come in any order relative to other leases. A view must not be read
    after its release. Dropping the last reference releases too."""

    __slots__ = ("_h", "tag", "trace_id", "parent_span_id", "nbytes",
                 "_ptr", "__weakref__")

    def __init__(self, h: int):
        lib = load()
        self._h = h
        self.tag = lib.nat_req_aux(h)
        self.trace_id = lib.nat_req_sock_id(h)
        self.parent_span_id = lib.nat_req_cid(h) & ((1 << 63) - 1)
        n = ctypes.c_size_t(0)
        self._ptr = lib.nat_req_field(h, 2, ctypes.byref(n))
        self.nbytes = n.value

    @property
    def address(self) -> int:
        """The span's address (0 when empty)."""
        return self._ptr or 0

    def view(self) -> memoryview:
        if self._h is None:
            raise ValueError("fabric lease already released")
        if self.nbytes == 0 or not self._ptr:
            return memoryview(b"")
        return memoryview(
            (ctypes.c_char * self.nbytes).from_address(self._ptr))

    @property
    def released(self) -> bool:
        return self._h is None

    def release(self):
        h, self._h = self._h, None
        if h:
            load().nat_req_free(h)

    def __del__(self):
        try:
            self.release()
        except Exception:
            pass  # interpreter teardown: the library may be gone


def fabric_producer_attach(name) -> int:
    """Claim a producer slot on a peer's fabric segment (by shm name).
    Returns the slot (>= 0) or -1."""
    if isinstance(name, str):
        name = name.encode()
    return load().nat_shm_producer_attach(name)


def fabric_push(data, tag: int) -> int:
    """Write ``data`` once into the attached segment's blob arena and
    publish one kind-8 descriptor under ``tag``. 0, or -1 when the ring
    or the arena is full."""
    p, n = _buf(data)
    return load().nat_shm_fabric_push(p, n, tag)


def fabric_take(timeout_ms: int = 200) -> Optional[FabricLease]:
    """Receiver side: one pushed record from any producer slot as a
    lease, or None on timeout or shutdown."""
    h = load().nat_shm_fabric_take(timeout_ms)
    return FabricLease(h) if h else None


def shm_push_tensor(data, tag: int) -> int:
    """Parent side of the worker lane: write ``data`` into some worker's
    blob arena as one kind-8 record under ``tag`` (the worker's tensor
    sink takes it). 0, or -1 when every ring is full."""
    p, n = _buf(data)
    return load().nat_shm_push_tensor(p, n, tag)


def shm_lane_name() -> str:
    """This process's lane segment ('' when none is mapped)."""
    return (load().nat_shm_lane_name() or b"").decode()


# -- the native cluster ---------------------------------------------------------

def cluster_create(lb: str = "rr", connect_timeout_ms: int = 500,
                   health_check_ms: int = 100, breaker: bool = True):
    """Open a native cluster (rr / wrr / random / wr / la / c_hash): a
    double-buffered server list, per-backend channels dialed lazily with
    circuit breakers and lame-duck failover."""
    h = load().nat_cluster_create(lb.encode(), connect_timeout_ms,
                                  health_check_ms, 1 if breaker else 0)
    if not h:
        raise RuntimeError(f"nat_cluster_create failed (lb={lb!r})")
    return h


def cluster_close(handle):
    load().nat_cluster_close(handle)


def cluster_node_entry(node):
    """(endpoint[, weight[, tag]]) or a bare endpoint -> (endpoint,
    weight, tag), each missing field by its own default."""
    if isinstance(node, (tuple, list)):
        ep = node[0]
        weight = node[1] if len(node) > 1 else 1
        tag = node[2] if len(node) > 2 else ""
        return str(ep), int(weight), str(tag)
    return str(node), 1, ""


def cluster_update(handle, servers) -> int:
    """The full server list: a spec string of "ip:port[ weight[ tag]]"
    entries (';', ',' or newline between) or an iterable of entries.
    Returns the backend count."""
    if not isinstance(servers, (str, bytes)):
        parts = []
        for s in servers:
            ep, weight, tag = cluster_node_entry(s)
            parts.append(f"{ep} {weight} {tag}".strip())
        servers = ";".join(parts)
    if isinstance(servers, str):
        servers = servers.encode()
    rc = load().nat_cluster_update(handle, servers)
    if rc < 0:
        raise ValueError("malformed server spec (or closed cluster)")
    return rc


def cluster_backend_count(handle) -> int:
    return load().nat_cluster_backend_count(handle)


def cluster_select_debug(handle, request_code: int = 0):
    """The endpoint the balancer would pick for request_code now (no
    dial, no counters); None when nothing is usable."""
    buf = ctypes.create_string_buffer(32)
    rc = load().nat_cluster_select_debug(handle, request_code, buf, 32)
    return buf.value.decode() if rc == 0 else None


def _outs():
    return ctypes.c_void_p(), ctypes.c_size_t(0), ctypes.c_void_p()


def _results(lib, resp, rlen, err):
    body = _take_out(lib, resp, rlen.value)
    text = _take_out(lib, err).decode(errors="replace")
    return body, text


def cluster_call(handle, service: str, method: str, payload=b"",
                 timeout_ms: int = 0, max_retry: int = 2,
                 request_code: int = 0):
    """One backend picked by the balancer, another on failure (the
    timeout covers every attempt). Returns (error_code, response,
    error_text)."""
    lib = load()
    resp, rlen, err = _outs()
    p, n = _buf(payload)
    rc = lib.nat_cluster_call(handle, service.encode(), method.encode(),
                              p, n, timeout_ms, max_retry, request_code,
                              ctypes.byref(resp), ctypes.byref(rlen),
                              ctypes.byref(err))
    return (rc,) + _results(lib, resp, rlen, err)


def _cluster_fan(fn, handle, service, method, payload, timeout_ms, args):
    lib = load()
    resp, rlen, err = _outs()
    failed = ctypes.c_int(0)
    p, n = _buf(payload)
    rc = fn(handle, service.encode(), method.encode(), p, n, timeout_ms,
            *args, ctypes.byref(resp), ctypes.byref(rlen), ctypes.byref(err),
            ctypes.byref(failed))
    return (rc,) + _results(lib, resp, rlen, err) + (failed.value,)


def cluster_parallel_call(handle, service: str, method: str, payload=b"",
                          timeout_ms: int = 0, fail_limit: int = 0):
    """The request to every backend, the successful responses merged
    natively in backend order. Returns (error_code, merged, error_text,
    failed_subcalls); fails once fail_limit sub-calls failed (<= 0: all
    must fail)."""
    return _cluster_fan(load().nat_cluster_parallel_call, handle, service,
                        method, payload, timeout_ms, (fail_limit,))


def cluster_partition_call(handle, service: str, method: str, payload=b"",
                           timeout_ms: int = 0, partitions: int = 0,
                           fail_limit: int = 0):
    """One sub-call per "i/n" partition group (n = partitions; 0: the
    largest scheme present), merged in partition order. Returns
    (error_code, merged, error_text, failed_subcalls)."""
    return _cluster_fan(load().nat_cluster_partition_call, handle, service,
                        method, payload, timeout_ms, (partitions, fail_limit))


def cluster_dynpart_call(handle, service: str, method: str, payload=b"",
                         timeout_ms: int = 0, fail_limit: int = 0):
    """The partition count picked per call from the live "i/n" schemes,
    weighted by usable capacity, then one sub-call per group. Returns
    (error_code, merged, error_text, failed_subcalls, chosen_scheme)."""
    lib = load()
    resp, rlen, err = _outs()
    failed, scheme = ctypes.c_int(0), ctypes.c_int(0)
    p, n = _buf(payload)
    rc = lib.nat_cluster_dynpart_call(
        handle, service.encode(), method.encode(), p, n, timeout_ms,
        fail_limit, ctypes.byref(resp), ctypes.byref(rlen), ctypes.byref(err),
        ctypes.byref(failed), ctypes.byref(scheme))
    return (rc,) + _results(lib, resp, rlen, err) + (failed.value,
                                                     scheme.value)


def cluster_dynpart_debug(handle, x01: float = 0.0,
                          max_schemes: int = 64) -> dict:
    """The live scheme table and the scheme the weighted walk picks for
    the point x01 in [0, 1): {'schemes': [(part_total, capacity), ...],
    'chosen': int}."""
    totals = (ctypes.c_int * max_schemes)()
    caps = (ctypes.c_int * max_schemes)()
    chosen = ctypes.c_int(0)
    n = load().nat_cluster_dynpart_debug(handle, x01, totals, caps,
                                         max_schemes, ctypes.byref(chosen))
    n = min(n, max_schemes)
    return {"schemes": [(totals[i], caps[i]) for i in range(n)],
            "chosen": chosen.value}


def cluster_stats(handle, max_rows: int = 4096) -> list:
    """One dict per backend: endpoint, tag, weight, selects, errors,
    inflight, ema_latency_us, breaker_open, lame_duck, part_index,
    part_total."""
    arr = (NatClusterRow * max_rows)()
    n = load().nat_cluster_stats(handle, arr, max_rows)
    out = []
    for i in range(n):
        r = arr[i]
        out.append({
            "endpoint": r.endpoint.decode(errors="replace"),
            "tag": r.tag.decode(errors="replace"),
            "weight": r.weight,
            "selects": r.selects,
            "errors": r.errors,
            "inflight": r.inflight,
            "ema_latency_us": r.ema_latency_us,
            "breaker_open": bool(r.breaker_open),
            "lame_duck": bool(r.lame_duck),
            "part_index": r.part_index,
            "part_total": r.part_total,
        })
    return out


def cluster_bench(handle, mode: int = 0, service: str = "EchoService",
                  method: str = "Echo", payload=b"x" * 16,
                  timeout_ms: int = 2000, param: int = 2,
                  seconds: float = 2.0, concurrency: int = 4) -> dict:
    """The cluster driven from C threads: mode 0 = selective (param =
    max_retry), 1 = parallel (param = fail_limit), 2 = dynpart. Returns
    {'qps', 'calls', 'failed', 'p99_us'}."""
    calls, failed = ctypes.c_uint64(0), ctypes.c_uint64(0)
    p99 = ctypes.c_double(0.0)
    p, n = _buf(payload)
    qps = load().nat_cluster_bench(
        handle, mode, service.encode(), method.encode(), p, n, timeout_ms,
        param, seconds, concurrency, ctypes.byref(calls),
        ctypes.byref(failed), ctypes.byref(p99))
    return {"qps": qps, "calls": calls.value, "failed": failed.value,
            "p99_us": p99.value}


# -- the client lanes -------------------------------------------------------------

def _open(ip, port, connect_timeout_ms, health_check_ms, protocol=0,
          authority="", batch_writes=False):
    lib = load()
    if protocol == 0:
        return lib.nat_channel_open(ip.encode(), port, 0,
                                    1 if batch_writes else 0,
                                    connect_timeout_ms, health_check_ms)
    return lib.nat_channel_open_proto(ip.encode(), port, 0, 0,
                                      connect_timeout_ms, health_check_ms,
                                      protocol, authority.encode() or None)


def channel_open(ip: str, port: int, batch_writes: bool = False,
                 connect_timeout_ms: int = 0, health_check_ms: int = 0):
    """A native tpu_std client channel. ``connect_timeout_ms`` bounds the
    dial (0: a 10 s guard); ``health_check_ms`` > 0 revives a failed
    connection in the background, and a call after a failure dials again
    on demand."""
    h = _open(ip, port, connect_timeout_ms, health_check_ms,
              batch_writes=batch_writes)
    if not h:
        raise RuntimeError("native channel connect failed")
    return h


def channel_close(handle):
    load().nat_channel_close(handle)


def channel_open_http(ip: str, port: int, authority: str = "",
                      connect_timeout_ms: int = 0,
                      health_check_ms: int = 0):
    """A native HTTP/1.1 client channel (request framing, pipelined
    responses matched first in first out, chunked bodies)."""
    h = _open(ip, port, connect_timeout_ms, health_check_ms, 1, authority)
    if not h:
        raise RuntimeError("native http channel connect failed")
    return h


def channel_open_grpc(ip: str, port: int, authority: str = "",
                      connect_timeout_ms: int = 0,
                      health_check_ms: int = 0):
    """A native h2/gRPC client channel (preface, SETTINGS, HPACK and
    flow-controlled unary streams)."""
    h = _open(ip, port, connect_timeout_ms, health_check_ms, 2, authority)
    if not h:
        raise RuntimeError("native grpc channel connect failed")
    return h


def http_call(handle, verb: str, path: str, body: bytes = b"",
              headers: str = "", timeout_ms: int = 0):
    """One HTTP call on a native HTTP channel: (status, body). ``headers``
    are raw "Name: value\\r\\n" lines added to the request's head. Raises
    ConnectionError when the transport fails."""
    lib = load()
    status = ctypes.c_int(0)
    resp, rlen = ctypes.c_void_p(), ctypes.c_size_t(0)
    p, n = _buf(body)
    rc = lib.nat_http_call(handle, verb.encode(), path.encode(),
                           headers.encode() or None, p, n, timeout_ms,
                           ctypes.byref(status), ctypes.byref(resp),
                           ctypes.byref(rlen))
    out = _take_out(lib, resp, rlen.value)
    if rc != 0:
        raise ConnectionError(f"native http call failed: rc={rc}")
    return status.value, out


def grpc_call(handle, path: str, payload: bytes = b"",
              timeout_ms: int = 0):
    """One unary gRPC call on a native h2 channel: (grpc_status, response,
    message). Raises ConnectionError when the transport fails."""
    lib = load()
    st = ctypes.c_int(-1)
    resp, rlen, err = _outs()
    p, n = _buf(payload)
    rc = lib.nat_grpc_call(handle, path.encode(), p, n, timeout_ms,
                           ctypes.byref(st), ctypes.byref(resp),
                           ctypes.byref(rlen), ctypes.byref(err))
    body, message = _results(lib, resp, rlen, err)
    if rc != 0:
        raise ConnectionError(
            f"native grpc call failed: {message or f'rc={rc}'}")
    return st.value, body, message


def channel_call(handle, service: str, method: str,
                 payload: bytes = b"", timeout_ms: int = 0,
                 max_retry: int = 0, backup_ms: int = 0):
    """One call on a native channel: (error_code, response, error_text).
    ``timeout_ms`` > 0 is a deadline over every attempt (1008 when it
    passes); ``max_retry`` attempts a failed connection's call again
    after a new dial; ``backup_ms`` > 0 sends the request again when no
    answer came by then (the first answer wins)."""
    lib = load()
    resp, rlen, err = _outs()
    p, n = _buf(payload)
    rc = lib.nat_channel_call_full(handle, service.encode(), method.encode(),
                                   p, n, timeout_ms, max_retry, backup_ms,
                                   ctypes.byref(resp), ctypes.byref(rlen),
                                   ctypes.byref(err))
    return (rc,) + _results(lib, resp, rlen, err)


ACALL_CB = ctypes.CFUNCTYPE(None, ctypes.c_void_p, ctypes.c_int32,
                            ctypes.POINTER(ctypes.c_char), ctypes.c_size_t)
# each callback object stays referenced here until its done has run: the
# C side holds a bare pointer to it. A finished one is kept a while longer
# (``_ACALL_RETIRE_S``), since its thunk is still returning when its done
# ends, and dropped by a later call.
_ACALL_RETIRE_S = 1.0
_acall_live = {}
_acall_retired = []  # (monotonic time it finished, callback)
_acall_lock = threading.Lock()


def _acall_retire_old(now: float):
    keep = [(t, cb) for t, cb in _acall_retired if now - t < _ACALL_RETIRE_S]
    _acall_retired[:] = keep


def channel_acall(handle, service: str, method: str, payload: bytes,
                  done, timeout_ms: int = 0) -> int:
    """An asynchronous call: done(error_code, response) runs once, on a
    runtime fiber, when the answer comes (keep it short; hand heavy work
    to a thread of your own). 0 when done will run (maybe already, with
    an error); otherwise done never runs. An exception raised by done is
    logged and goes no further."""
    key = []

    def trampoline(_arg, code, resp, n):
        try:
            done(code, ctypes.string_at(resp, n) if n else b"")
        except BaseException:
            logging.getLogger(__name__).exception(
                "a native channel_acall done callback raised")
        finally:
            with _acall_lock:
                cb_done = _acall_live.pop(key[0], None)
                if cb_done is not None:
                    _acall_retired.append((time.monotonic(), cb_done))

    cb = ACALL_CB(trampoline)
    key.append(id(cb))
    p, n = _buf(payload)
    with _acall_lock:
        _acall_retire_old(time.monotonic())
        _acall_live[id(cb)] = cb
    rc = load().nat_channel_acall(handle, service.encode(), method.encode(),
                                  p, n, timeout_ms,
                                  ctypes.cast(cb, ctypes.c_void_p), None)
    if rc != 0:  # never queued: done will not run
        with _acall_lock:
            _acall_live.pop(id(cb), None)
    return rc


def channel_set_breaker(handle, enable: bool = True) -> int:
    """The channel's circuit breaker (the two-EMA-window isolation of
    rpc/circuit_breaker.py): failed calls trip it, calls then fail fast
    through the isolation window, and the health check revives it."""
    return load().nat_channel_set_breaker(handle, 1 if enable else 0)


def channel_breaker_state(handle) -> int:
    """0 closed (healthy), 1 broken (isolated, waiting for revival)."""
    return load().nat_channel_breaker_state(handle)


def channel_retry_budget(handle) -> int:
    """The channel's retry budget left, in tenths of a token (a retry
    costs 10, a success gives back 1, up to a cap)."""
    return load().nat_channel_retry_budget(handle)


def rpc_client_bench(ip: str, port: int, nconn: int = 2,
                     fibers_per_conn: int = 32, seconds: float = 2.0,
                     payload: int = 16) -> dict:
    """Echo from C++: ``nconn`` native connections with
    ``fibers_per_conn`` fibers each making sync calls of ``payload``
    bytes for ``seconds``. {'qps', 'requests'}."""
    out_requests = ctypes.c_uint64(0)
    qps = load().nat_rpc_client_bench(ip.encode(), port, nconn,
                                      fibers_per_conn, seconds, payload,
                                      ctypes.byref(out_requests))
    return {"qps": qps, "requests": out_requests.value}


def rpc_client_bench_bulk(ip: str, port: int, att_bytes: int,
                          seconds: float = 1.5) -> dict:
    """The native bulk lane: one connection echoing ``att_bytes``
    attachments through the runtime for ``seconds``. {'GBps', 'bytes'}."""
    moved = ctypes.c_uint64(0)
    gbps = load().nat_rpc_client_bench_bulk(ip.encode(), port, att_bytes,
                                            seconds, ctypes.byref(moved))
    return {"GBps": gbps, "bytes": moved.value}


# -- counters, histograms, spans ----------------------------------------------

def _names(count_fn, name_fn) -> list:
    return [name_fn(i).decode() for i in range(count_fn())]


def stats_counter_names() -> list:
    """The native counters' names, in the order of their snapshot."""
    lib = load()
    return _names(lib.nat_stats_counter_count, lib.nat_stats_counter_name)


def stats_counters() -> dict:
    """Every native counter now, {name: value} (per-thread cells summed,
    gauges read in place)."""
    lib = load()
    n = lib.nat_stats_counter_count()
    arr = (ctypes.c_uint64 * n)()
    got = lib.nat_stats_counters(arr, n)
    return {lib.nat_stats_counter_name(i).decode(): arr[i]
            for i in range(got)}


def stats_counter_bump(name: str, delta: int = 1) -> int:
    """Add ``delta`` to a native counter by name; its id, or -1 for an
    unknown name."""
    return load().nat_stats_counter_bump(name.encode(), delta)


def stats_lane_names() -> list:
    """The latency histograms' lanes (echo, http, redis, grpc, client,
    ...)."""
    lib = load()
    return _names(lib.nat_stats_lane_count, lib.nat_stats_lane_name)


def stats_hist(lane: int) -> list:
    """One lane's log2 latency histogram (bucket b holds [2^(b-1), 2^b)
    ns)."""
    lib = load()
    nb = lib.nat_stats_hist_nbuckets()
    arr = (ctypes.c_uint64 * nb)()
    got = lib.nat_stats_hist(lane, arr, nb)
    return list(arr[:got])


def stats_quantile(lane: int, q: float) -> float:
    """A lane's latency quantile in ns, interpolated in its log2 bucket;
    0.0 when empty."""
    return load().nat_stats_hist_quantile(lane, q)


def stats_now_ns() -> int:
    """The spans' clock (CLOCK_MONOTONIC ns)."""
    return load().nat_stats_now_ns()


def _lane_name(lanes: list, i: int) -> str:
    return lanes[i] if 0 <= i < len(lanes) else str(i)


def stats_drain_spans(max_spans: int = 4096) -> list:
    """Take up to ``max_spans`` sampled span records out of the native
    ring, as dicts (monotonic ns, see ``stats_now_ns``)."""
    lib = load()
    arr = (NatSpanRec * max_spans)()
    n = lib.nat_stats_drain_spans(arr, max_spans)
    lanes = stats_lane_names()
    out = []
    for r in arr[:n]:
        out.append({
            "trace_id": r.trace_id,
            "span_id": r.span_id,
            "parent_span_id": r.parent_span_id,
            "sock_id": r.sock_id,
            "recv_ns": r.recv_ns,
            "parse_ns": r.parse_ns,
            "dispatch_ns": r.dispatch_ns,
            "write_ns": r.write_ns,
            "lane": _lane_name(lanes, r.protocol),
            "error_code": r.error_code,
            "req_bytes": r.req_bytes,
            "resp_bytes": r.resp_bytes,
            "method": r.method.decode(errors="replace"),
        })
    return out


def stats_reset():
    """Zero every stat cell and drop the spans not drained (tests and
    benches only)."""
    load().nat_stats_reset()


def _report(fn, *args) -> bytes:
    """The bytes of a report the library allocates (b"" when it fails)."""
    lib = load()
    out, n = ctypes.c_void_p(), ctypes.c_size_t(0)
    rc = fn(*args, ctypes.byref(out), ctypes.byref(n))
    if rc != 0:
        _take_out(lib, out, 0)
        return b""
    return _take_out(lib, out, n.value)


def stats_snapshot() -> bytes:
    """The builtin.stats snapshot JSON: counters, per-lane and per-method
    log2 buckets, overload and quiesce state, open client channels and
    the resource ledger."""
    return _report(load().nat_stats_snapshot)


def method_stats() -> list:
    """The native per-method rows: {'lane', 'method', 'count', 'errors',
    'concurrency', 'max_concurrency'} for each (lane, method)."""
    lib = load()
    lanes = stats_lane_names()
    arr = (NatMethodStatRow * 128)()
    n = lib.nat_method_stats(arr, 128)
    return [{"lane": _lane_name(lanes, r.lane),
             "method": r.method.decode(errors="replace"),
             "count": r.count,
             "errors": r.errors,
             # an end racing a stats_reset can read -1 for a moment
             "concurrency": max(0, r.concurrency),
             "max_concurrency": max(0, r.max_concurrency)}
            for r in arr[:n]]


def method_quantile(lane: int, method: str, q: float) -> float:
    """A latency quantile (ns) of one method's log2 histogram."""
    return load().nat_method_quantile(lane, method.encode(), q)


def method_hist(lane: int, method: str) -> list:
    """One method's log2 latency buckets; [] when the method has no
    row."""
    lib = load()
    nb = lib.nat_stats_hist_nbuckets()
    arr = (ctypes.c_uint64 * nb)()
    n = lib.nat_method_hist(lane, method.encode(), arr, nb)
    return list(arr[:n]) if n >= 0 else []


_CONN_FIELDS = ("sock_id", "in_bytes", "out_bytes", "in_msgs", "out_msgs",
                "read_calls", "write_calls", "unwritten_bytes", "mem_bytes",
                "fd", "disp_idx")


def conn_snapshot() -> list:
    """One dict per live native socket: bytes, messages and syscalls each
    way, unwritten bytes, buffered memory, the sniffed protocol, the
    peer, the owning dispatcher and the side."""
    lib = load()
    cap = 1024
    while True:  # a full table may be cut: grow until it is not
        arr = (NatConnRow * cap)()
        n = lib.nat_conn_snapshot(arr, cap)
        if n < cap:
            break
        cap *= 2
    out = []
    for r in arr[:n]:
        row = {f: getattr(r, f) for f in _CONN_FIELDS}
        row["server_side"] = bool(r.server_side)
        row["protocol"] = r.protocol.decode(errors="replace")
        row["remote"] = r.remote.decode(errors="replace")
        out.append(row)
    return out


# -- the resource ledger and the profilers ---------------------------------------

def res_names() -> list:
    """The ledger's subsystems in enum order (the nat_mem_* labels)."""
    lib = load()
    return _names(lib.nat_res_count, lib.nat_res_name)


def res_accounted_bytes() -> int:
    """Live bytes over every subsystem of the ledger."""
    return load().nat_res_accounted_bytes()


def res_prof_start(every: int = 1, seed: int = 42) -> int:
    """Arm the allocation-site sampler (one in ``every``, seeded): 0, or
    -1 when it runs already (an embedder owns it)."""
    return load().nat_res_prof_start(every, seed)


def res_prof_stop() -> int:
    return load().nat_res_prof_stop()


def res_prof_running() -> bool:
    return bool(load().nat_res_prof_running())


def res_prof_samples() -> int:
    return load().nat_res_prof_samples()


def res_prof_reset():
    """Forget the sampled sites and the baseline (the ledger stays)."""
    load().nat_res_prof_reset()


def res_heap_report(collapsed: bool = True) -> str:
    """/heap/native's body: live bytes by allocation site, as collapsed
    stacks (leaf "res:<subsystem>") or a flat table."""
    lib = load()
    return _report(lib.nat_res_heap_report, 1 if collapsed else 0).decode(
        errors="replace")


def res_growth_baseline() -> int:
    """Take /growth/native's zero point again."""
    return load().nat_res_growth_baseline()


def res_growth_report() -> str:
    """/growth/native's body: collapsed stacks by live-bytes growth since
    the baseline."""
    return _report(load().nat_res_growth_report).decode(errors="replace")


def prof_start(hz: int = 99) -> int:
    """Sample every thread's stack on CPU time at ``hz`` (SIGPROF, frame
    pointers): 0, -1 when it runs already, -2 when the handler or the
    timer could not be installed."""
    return load().nat_prof_start(hz)


def prof_stop() -> int:
    """Stop sampling; the samples stay to report."""
    return load().nat_prof_stop()


def prof_running() -> bool:
    return bool(load().nat_prof_running())


def prof_samples() -> int:
    """Samples since the start or the last reset."""
    return load().nat_prof_samples()


def prof_reset():
    load().nat_prof_reset()


def prof_report(collapsed: bool = False) -> str:
    """The profile: a flat table of self samples by symbol, or collapsed
    stacks (flamegraph.pl, speedscope)."""
    lib = load()
    return _report(lib.nat_prof_report, 1 if collapsed else 0).decode(
        errors="replace")


def mu_prof_start(threshold_us: int = 0, every: int = 1,
                  seed: int = 42) -> int:
    """Sample contended NatMutex waits of at least ``threshold_us``, one
    in ``every`` (seeded), with the stack that waited: 0, or -1 when it
    runs already."""
    return load().nat_mu_prof_start(threshold_us, every, seed)


def mu_prof_stop() -> int:
    """Stop sampling; the samples stay to report."""
    return load().nat_mu_prof_stop()


def mu_prof_running() -> bool:
    return bool(load().nat_mu_prof_running())


def mu_prof_samples() -> int:
    return load().nat_mu_prof_samples()


def mu_prof_reset():
    """Forget the sampled stacks and the per-rank wait totals."""
    load().nat_mu_prof_reset()


def mu_prof_reset_samples():
    """Forget the sampled stacks only: the per-rank totals are counters
    and keep growing."""
    load().nat_mu_prof_reset_samples()


def mu_prof_report(collapsed: bool = True) -> str:
    """The lock profile: collapsed stacks weighted by microseconds waited
    (leaf "lock:<rank name>"), or a flat table by lock site."""
    lib = load()
    return _report(lib.nat_mu_prof_report, 1 if collapsed else 0).decode(
        errors="replace")


def mu_rank_stats() -> list:
    """Contended waits by lock rank, always counted: [{'rank', 'name',
    'waits', 'wait_us'}, ...]."""
    arr = (NatLockRankRow * 128)()
    n = load().nat_mu_rank_stats(arr, 128)
    return [{"rank": r.rank, "name": r.name.decode(errors="replace"),
             "waits": r.waits, "wait_us": r.wait_us} for r in arr[:n]]


def mu_rank_name(rank: int):
    """A NatMutex rank's name, or None when it has none."""
    nm = load().nat_mu_rank_name(rank)
    return nm.decode() if nm is not None else None


# -- the trace context -----------------------------------------------------------

# this thread's context as this module last set it, so that a
# ``trace_scope`` restores the enclosing one on exit
_trace_tls = threading.local()


def trace_set(trace_id: int = 0, span_id: int = 0):
    """Arm (or clear, with 0, 0) this thread's trace context: native
    client calls made on this thread carry (trace_id, span_id) on the
    wire (tpu_std meta, x-bd-trace-* headers, gRPC metadata, kind-8
    descriptors), so the server's span chains under span_id."""
    load().nat_trace_set(trace_id, span_id)
    _trace_tls.ctx = (trace_id, span_id)


class trace_scope:
    """``with native.trace_scope(trace_id, span_id):`` arms the trace
    context for the calls inside and restores the enclosing one after."""

    def __init__(self, trace_id: int, span_id: int):
        self._ctx = (trace_id, span_id)
        self._prev = (0, 0)

    def __enter__(self):
        self._prev = getattr(_trace_tls, "ctx", (0, 0))
        trace_set(*self._ctx)
        return self

    def __exit__(self, *exc):
        trace_set(*self._prev)


# -- the flight recorder and its replay --------------------------------------------

def dump_start(directory: str, every: int = 1, seed: int = 42,
               max_file_bytes: int = 64 << 20, generations: int = 4,
               max_payload: int = 1 << 20) -> int:
    """Arm the native flight recorder: one request in ``every`` (seeded)
    at the native protocol seams (tpu_std, HTTP, gRPC, the redis store,
    kind-8 descriptors) into recordio files under ``directory``, rotated
    past ``max_file_bytes`` keeping ``generations`` files. A payload
    larger than ``max_payload`` is skipped whole. 0, -1 when it runs
    already, -2 on a directory or file error."""
    return load().nat_dump_start(directory.encode(), every, seed,
                                 max_file_bytes, generations, max_payload)


def dump_stop() -> int:
    """Disarm the recorder: drain its rings, flush and close the file."""
    return load().nat_dump_stop()


def dump_running() -> bool:
    return bool(load().nat_dump_running())


_DUMP_FIELDS = ("every", "seed", "samples", "written", "bytes", "drops",
                "oversize", "rotations", "max_file_bytes", "max_payload",
                "generations")


def dump_status() -> dict:
    """The recorder's state: counts since the current window's start, and
    the window's settings (the last one's when stopped)."""
    st = NatDumpStatusRec()
    load().nat_dump_status(ctypes.byref(st))
    out = {"running": bool(st.running),
           "dir": st.dir.decode(errors="replace")}
    out.update({f: getattr(st, f) for f in _DUMP_FIELDS})
    return out


_REPLAY_FIELDS = ("loaded", "sent", "ok", "failed", "skipped", "seconds",
                  "qps", "p50_us", "p99_us")


def replay_run(ip: str, port: int, files, times: int = 1,
               qps: float = 0.0, qps_to: float = 0.0,
               concurrency: int = 4, timeout_ms: int = 2000) -> dict:
    """Fire captured recordio traffic at ip:port through the native
    client lanes (tpu_std, HTTP, gRPC). ``files``: a path, a directory,
    or a list of them. ``qps`` > 0 paces the calls (``qps_to`` > 0 ramps
    to it over the run); ``qps`` <= 0 presses with ``concurrency``
    callers. Raises ValueError when nothing can be replayed,
    ConnectionError when the server cannot be reached."""
    if qps_to > 0 and qps <= 0:
        raise ValueError("qps_to requires a starting qps > 0 "
                         "(use qps=<low>, qps_to=<high> for a ramp)")
    if isinstance(files, (list, tuple)):
        spec = ";".join(str(f) for f in files)
    else:
        spec = str(files)
    res = NatReplayResult()
    rc = load().nat_replay_run(ip.encode(), port, spec.encode(), times,
                               qps, qps_to, concurrency, timeout_ms,
                               ctypes.byref(res))
    if rc == -1:
        raise ValueError(f"no replayable records under {spec!r}")
    if rc != 0:
        raise ConnectionError(f"native replay failed: rc={rc}")
    return {f: getattr(res, f) for f in _REPLAY_FIELDS}
