"""brpc_tpu_torch.native — ctypes bindings to the port's native library.

Port of the part of brpc_tpu/native/__init__.py that the native runtime,
its shm workers, the descriptor-ring tensor fabric and the native cluster
call, under the reference's names. The library is the port's own copy of
the reference's C++ runtime (``native/src``), built at first use by
``native/build.py`` into ``brpc_tpu_torch/build/native/<digest>/``: a
fiber scheduler, native IOBuf, the tpu_std / HTTP / h2 / redis cut loops,
the shm descriptor-ring lane and the fan-out cluster. ``load`` raises
``NativeUnavailable`` with the compiler's errors when the build fails,
and a process tries a failed build once: later calls raise the same
errors without compiling again. No prebuilt library is ever loaded in its
place.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np

from brpc_tpu_torch.native import build as _build

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()
_build_error: Optional[str] = None  # a failed build, not tried again


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
    out = []
    for i in range(n):
        h = arr[i]
        kind = lib.nat_req_kind(h)
        if kind in (3, 4):
            out.append((h, kind, _field(lib, h, 4), _field(lib, h, 2), b"",
                        lib.nat_req_sock_id(h), lib.nat_req_cid(h),
                        _field(lib, h, 0), _field(lib, h, 1), 0))
        elif kind == 5:
            out.append((h, kind, b"", _field(lib, h, 2), b"",
                        lib.nat_req_sock_id(h), lib.nat_req_cid(h),
                        lib.nat_req_compress(h), b"", lib.nat_req_aux(h)))
        else:
            out.append((h, kind, _field(lib, h, 4), _field(lib, h, 2),
                        _field(lib, h, 3), lib.nat_req_sock_id(h),
                        lib.nat_req_cid(h), b"", b"", 0))
    return out


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


def stats_enable_spans(every: int = 1):
    """0 = spans off; N = one span of every N natively handled calls."""
    load().nat_stats_enable_spans(every)


def res_stats() -> dict:
    """The native resource ledger: {subsystem: {'live_bytes',
    'live_objects'}} (``shm.span`` holds the fabric's leased spans)."""
    lib = load()
    n = lib.nat_res_count()
    arr = (NatResRow * n)()
    got = lib.nat_res_stats(arr, n)
    return {arr[i].name.decode(): {"live_bytes": arr[i].live_bytes,
                                   "live_objects": arr[i].live_objects}
            for i in range(got)}


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
