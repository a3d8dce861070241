"""rpcz — a span for each call, on both sides, browsable at /rpcz.

Port of brpc_tpu/rpcz.py (brpc's span.h and rpcz_service). A client span
opens when a call starts and ends once when the RPC ends, whatever its
attempts; a server span opens when a request has passed the limiter and
its parse, and ends when the handler's ``done`` runs. The trace and span
ids ride ``RpcMeta.request.trace_id``/``span_id``, and a client call made
inside a handler takes the handler's server span as its parent through
thread-local state (``parent_scope``), so one trace follows a call across
hops and across the two packages.

Ended spans go to a bounded collector (``rpcz_max_spans``, one kept in
``rpcz_sample_every``); with ``rpcz_database_dir`` set they are also
written, by a thread of their own, to a ``SpanDB`` of recordio files in
two generations, where ``find_trace`` looks for what left the memory.
``enable_rpcz`` is on by default, as in the reference.

``drain_native_spans`` files the spans that a native runtime of this
process sampled (``use_native_runtime``), each with its parse, dispatch
and write times; a native client call made under ``native.trace_scope``
carries the caller's ids, so its server's span chains under the caller.
"""
from __future__ import annotations

import json
import os
import random
import threading
import time
from collections import deque
from typing import Deque, List, Optional

from brpc_tpu_torch import native
from brpc_tpu_torch.butil import flags
from brpc_tpu_torch.butil.recordio import RecordReader, RecordWriter

flags.define_bool("enable_rpcz", True, "collect rpcz spans")
flags.define_int("rpcz_max_spans", 4096,
                 "bounded span store (collector budget analog)")
flags.define_int("rpcz_sample_every", 1,
                 "keep 1 of every N spans (sampling rate limit)")
flags.define_string("rpcz_database_dir", "",
                    "persist sampled spans on disk (the SpanDB of "
                    "span.h:206-224); empty = in-memory only")
flags.define_int("rpcz_database_max_spans", 200000,
                 "rotate the on-disk SpanDB past this many spans")

_tls = threading.local()
# span and trace ids come from a generator of their own: spans open on
# server and timer threads, and draws from the global ``random`` would
# move every seeded sequence of the process
_ids = random.Random()


class Span:
    __slots__ = (
        "trace_id", "span_id", "parent_span_id", "kind", "full_method",
        "remote_side", "start_time", "end_time", "error_code",
        "request_size", "response_size", "annotations", "log_id",
    )

    def __init__(self, kind: str, full_method: str, trace_id: int = 0,
                 parent_span_id: int = 0, log_id: int = 0):
        self.kind = kind  # "server" | "client"
        self.full_method = full_method
        self.trace_id = trace_id or _ids.getrandbits(63)
        self.span_id = _ids.getrandbits(63)
        self.parent_span_id = parent_span_id
        self.remote_side = None
        self.start_time = time.time()
        self.end_time = 0.0
        self.error_code = 0
        self.request_size = 0
        self.response_size = 0
        self.annotations: List = []
        self.log_id = log_id

    def annotate(self, text: str):
        """A timed line of free text in the span."""
        self.annotations.append((time.time(), text))

    def end(self, error_code: int = 0):
        self.end_time = time.time()
        self.error_code = error_code
        _submit(self)

    @property
    def latency_us(self) -> float:
        if not self.end_time:
            return 0.0
        return (self.end_time - self.start_time) * 1e6

    def describe(self) -> str:
        lines = [
            f"trace={self.trace_id:016x} span={self.span_id:016x} "
            f"parent={self.parent_span_id:016x} [{self.kind}] "
            f"{self.full_method} remote={self.remote_side} "
            f"latency={self.latency_us:.0f}us error={self.error_code} "
            f"req={self.request_size}B resp={self.response_size}B"
        ]
        for ts, text in self.annotations:
            offset_us = (ts - self.start_time) * 1e6
            lines.append(f"    +{offset_us:.0f}us {text}")
        return "\n".join(lines)

    # the SpanDB's record: the reference's keys in its order
    _RECORD = ("trace_id", "span_id", "parent_span_id", "kind",
               "full_method", "remote_side", "start_time", "end_time",
               "error_code", "request_size", "response_size", "log_id",
               "annotations")

    def to_dict(self) -> dict:
        return {name: getattr(self, name) for name in self._RECORD}

    @classmethod
    def from_dict(cls, d: dict) -> "Span":
        span = cls(d["kind"], d["full_method"], trace_id=d["trace_id"],
                   parent_span_id=d["parent_span_id"], log_id=d["log_id"])
        for name in ("span_id", "remote_side", "start_time", "end_time",
                     "error_code", "request_size", "response_size"):
            setattr(span, name, d[name])
        span.annotations = [tuple(a) for a in d["annotations"]]
        return span


# -- the parent of a client span: thread-local ------------------------------

def current_parent() -> Optional[Span]:
    return getattr(_tls, "parent_span", None)


def set_parent(span: Optional[Span]):
    _tls.parent_span = span


class parent_scope:
    """``with parent_scope(server_span): handler()``: client calls made
    inside take ``server_span`` as their parent."""

    def __init__(self, span: Optional[Span]):
        self._span = span
        self._prev = None

    def __enter__(self):
        self._prev = current_parent()
        set_parent(self._span)
        return self._span

    def __exit__(self, *exc):
        set_parent(self._prev)


# -- the on-disk SpanDB -----------------------------------------------------

class SpanDB:
    """Ended spans in recordio files, written by a thread of its own so an
    RPC's end never waits for the disk. Past ``max_spans / 2`` spans the
    file becomes generation 1 (the older one is dropped) and a new one
    starts: the footprint stays bounded. ``close`` stops the thread."""

    def __init__(self, directory: str, max_spans: int):
        os.makedirs(directory, exist_ok=True)
        self._dir = directory
        self._max = max(1000, max_spans)
        self._lock = threading.Lock()
        self._count = 0
        self._writer = RecordWriter(self._path(0))
        self._queue: Deque[Span] = deque()
        self._queue_cond = threading.Condition()
        self._closed = False
        self._thread = threading.Thread(target=self._drain_loop,
                                        name="rpcz-spandb", daemon=True)
        self._thread.start()

    def _path(self, gen: int) -> str:
        return os.path.join(self._dir, f"rpcz.{gen}.recordio")

    def append(self, span: Span):
        """Queue a span; the thread writes it. Past 65,536 queued spans a
        span is dropped rather than stall the caller."""
        with self._queue_cond:
            if self._closed or len(self._queue) > 65536:
                return
            self._queue.append(span)
            self._queue_cond.notify()

    def _drain_loop(self):
        while True:
            with self._queue_cond:
                while not self._queue and not self._closed:
                    self._queue_cond.wait()
                if self._closed and not self._queue:
                    return
                batch = list(self._queue)
                self._queue.clear()
            try:
                self._write_batch(batch)
            except OSError:
                pass  # a full or failing disk must not end the writer

    def _write_batch(self, batch):
        with self._lock:
            for span in batch:
                payload = json.dumps(span.to_dict()).encode()
                self._writer.write({"trace_id": f"{span.trace_id:016x}"},
                                   payload)
                self._count += 1
                if self._count >= self._max // 2:
                    self._rotate()
            self._writer.flush()

    def _rotate(self):
        self._writer.close()
        try:
            os.replace(self._path(0), self._path(1))
        except OSError:
            pass
        self._count = 0
        self._writer = RecordWriter(self._path(0))

    def drain(self, timeout_s: float = 5.0):
        """Wait until the queued spans are on disk."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._queue_cond:
                if not self._queue:
                    return
            time.sleep(0.005)

    def close(self):
        with self._queue_cond:
            self._closed = True
            self._queue_cond.notify()
        self._thread.join(5)
        with self._lock:
            self._writer.close()

    def find_trace(self, trace_id: int) -> List[Span]:
        """Every span of a trace, from both generations, older first."""
        needle = f"{trace_id:016x}"
        out: List[Span] = []
        self.drain(1.0)
        with self._lock:
            self._writer.flush()
        for gen in (1, 0):
            path = self._path(gen)
            if not os.path.exists(path):
                continue
            with RecordReader(path) as reader:
                for meta, payload in reader:
                    if meta.get("trace_id") == needle:
                        out.append(Span.from_dict(json.loads(payload)))
        return out


_span_db: Optional[SpanDB] = None
_span_db_lock = threading.Lock()


def _get_span_db() -> Optional[SpanDB]:
    """The SpanDB of ``rpcz_database_dir``: opened when the flag names a
    directory, reopened when it names another, closed when it is cleared."""
    global _span_db
    directory = flags.get_flag("rpcz_database_dir")
    if not directory and _span_db is None:
        return None
    with _span_db_lock:
        if _span_db is not None and _span_db._dir != directory:
            _span_db.close()
            _span_db = None
        if directory and _span_db is None:
            _span_db = SpanDB(directory,
                              flags.get_flag("rpcz_database_max_spans"))
        return _span_db


# -- the collector ----------------------------------------------------------

_spans: Deque[Span] = deque(maxlen=4096)
_spans_lock = threading.Lock()
_counter = [0]


def _submit(span: Span):
    global _spans
    if not flags.get_flag("enable_rpcz"):
        return
    every = max(1, flags.get_flag("rpcz_sample_every"))
    with _spans_lock:
        _counter[0] += 1
        if _counter[0] % every:
            return
        if _spans.maxlen != flags.get_flag("rpcz_max_spans"):
            _spans = deque(_spans,
                           maxlen=max(16, flags.get_flag("rpcz_max_spans")))
        _spans.append(span)
    try:
        db = _get_span_db()
    except OSError:
        return  # an unusable directory must not fail the RPC
    if db is not None:
        db.append(span)


def drain_native_spans() -> int:
    """File the spans the native runtime sampled (its bounded ring) with
    the Python spans, so /rpcz shows natively handled calls beside the
    Python lanes, with their parse, dispatch and write annotations.
    Native sampling already took one in ``rpcz_sample_every``. Reads only
    a library this process has loaded (queue C #38). Returns how many."""
    if not native.is_loaded():
        return 0
    recs = native.stats_drain_spans(4096)
    if not recs:
        return 0
    # the spans' CLOCK_MONOTONIC ns onto wall time
    offset = time.time() - native.stats_now_ns() / 1e9
    for r in recs:
        kind = "client" if r["lane"] == "client" else "server"
        span = Span(kind, r["method"] or f"native.{r['lane']}",
                    trace_id=r["trace_id"],
                    parent_span_id=r["parent_span_id"])
        span.span_id = r["span_id"]
        span.remote_side = f"native:{r['lane']}/sock={r['sock_id']}"
        span.start_time = offset + r["recv_ns"] / 1e9
        span.end_time = offset + r["write_ns"] / 1e9
        span.error_code = r["error_code"]
        span.request_size = r["req_bytes"]
        span.response_size = r["resp_bytes"]
        span.annotations = [
            (offset + r["parse_ns"] / 1e9, "native parse done"),
            (offset + r["dispatch_ns"] / 1e9, "native usercode done"),
            (offset + r["write_ns"] / 1e9, "native response queued"),
        ]
        with _spans_lock:
            _spans.append(span)
        # into the SpanDB too: find_trace looks there for what left the
        # memory's window
        try:
            db = _get_span_db()
        except OSError:
            continue
        if db is not None:
            db.append(span)
    return len(recs)


def recent_spans(limit: int = 100) -> List[Span]:
    drain_native_spans()
    with _spans_lock:
        return list(_spans)[-limit:]


def find_trace(trace_id: int) -> List[Span]:
    """The spans of one trace in memory, with those of the SpanDB that
    left the memory's window."""
    drain_native_spans()
    with _spans_lock:
        found = [s for s in _spans if s.trace_id == trace_id]
    try:
        db = _get_span_db()
    except OSError:
        db = None
    if db is not None:
        seen = {s.span_id for s in found}
        try:
            found.extend(s for s in db.find_trace(trace_id)
                         if s.span_id not in seen)
        except (OSError, ValueError):
            pass  # a damaged file: what memory holds is the answer
    return found


def clear_for_tests():
    # the native ring too: its old records must not come back later
    if native.is_loaded():
        native.stats_drain_spans(4096)
    with _spans_lock:
        _spans.clear()
        _counter[0] = 0


def describe_recent_spans(query: Optional[dict] = None) -> str:
    """The body of /rpcz: the newest spans first; ``trace_id=<hex>`` one
    trace, ``limit=N`` the newest N (50)."""
    query = query or {}
    if "trace_id" in query:
        try:
            spans = find_trace(int(query["trace_id"], 16))
        except ValueError:
            return "bad trace_id\n"
    else:
        limit = int(query.get("limit", "50") or 50)
        spans = recent_spans(limit)
    if not spans:
        return "no spans collected (enable_rpcz flag / traffic?)\n"
    return "\n".join(s.describe() for s in reversed(spans)) + "\n"


# -- where the protocols open spans -----------------------------------------

def start_server_span(full_method: str, meta, remote_side) -> Optional[Span]:
    if not flags.get_flag("enable_rpcz"):
        return None
    span = Span("server", full_method,
                trace_id=meta.request.trace_id,
                parent_span_id=meta.request.span_id,
                log_id=meta.request.log_id)
    span.remote_side = str(remote_side) if remote_side else None
    return span


def start_client_span(full_method: str, cntl) -> Optional[Span]:
    """Opens the call's client span under the thread's parent, if any, and
    gives the controller its ids for the request's meta."""
    if not flags.get_flag("enable_rpcz"):
        return None
    parent = current_parent()
    span = Span("client", full_method,
                trace_id=parent.trace_id if parent else 0,
                parent_span_id=parent.span_id if parent else 0,
                log_id=cntl.log_id)
    cntl.trace_id = span.trace_id
    cntl.span_id = span.span_id
    return span
