"""Hotspots — the profilers of the console, on demand.

Port of brpc_tpu/builtin/hotspots.py. ``GET /hotspots/cpu?seconds=N``
samples every thread's Python stack (``sys._current_frames``) for N
seconds and answers collapsed stacks ("frame;frame;frame count", for
flamegraph.pl or speedscope). The other kinds:

* ``heap``, ``growth`` — tracemalloc (builtin/profilers.py);
* ``contention`` — the stacks blocked in waits, one window at a time: a
  second request while one runs gets 503 with a ``Retry-After`` taken
  from the running window's deadline;
* ``tpu`` — the card trace of the server's device
  (``profilers.cuda_trace``), a zipped Chrome trace, under the
  reference's URL;
* ``native`` — the reference's answer for a process without its native
  runtime: the port has none.

``/pprof/{profile,heap,growth,contention,symbol}`` and ``/threads`` (every
thread's stack now) are the same profilers under pprof's names.
"""
from __future__ import annotations

import sys
import threading
import time
from collections import Counter

_NATIVE_UNAVAILABLE = "native runtime unavailable\n"


def sample_cpu(seconds: float = 1.0, hz: int = 99) -> str:
    """Collapsed stacks of every live thread but the caller's."""
    seconds = max(0.1, min(10.0, seconds))
    interval = 1.0 / max(1, hz)
    stacks: Counter = Counter()
    deadline = time.monotonic() + seconds
    own = threading.get_ident()
    nsamples = 0
    while time.monotonic() < deadline:
        for tid, frame in sys._current_frames().items():
            if tid == own:
                continue
            parts = []
            f = frame
            depth = 0
            while f is not None and depth < 64:
                code = f.f_code
                parts.append(f"{code.co_name} "
                             f"({code.co_filename.rsplit('/', 1)[-1]}:"
                             f"{f.f_lineno})")
                f = f.f_back
                depth += 1
            if parts:
                stacks[";".join(reversed(parts))] += 1
        nsamples += 1
        time.sleep(interval)
    lines = [f"# cpu profile: {nsamples} samples at {hz}Hz over {seconds}s",
             "# format: collapsed stacks (flamegraph.pl compatible)"]
    for stack, count in stacks.most_common():
        lines.append(f"{stack} {count}")
    return "\n".join(lines) + "\n"


def thread_dump() -> str:
    """Every thread's stack now (the /threads page)."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out = []
    for tid, frame in sys._current_frames().items():
        out.append(f"--- thread {names.get(tid, '?')} ({tid}) ---")
        f = frame
        depth = 0
        while f is not None and depth < 64:
            code = f.f_code
            out.append(f"  {code.co_filename}:{f.f_lineno} {code.co_name}")
            f = f.f_back
            depth += 1
    return "\n".join(out) + "\n"


class _ProfWindow:
    """One profiler window at a time: a second request while one runs is
    answered 503 with a Retry-After from the running window's deadline
    (its clamped length), not from the second request's own seconds."""

    def __init__(self, clamp_max_s: float, busy_text: str):
        self._lock = threading.Lock()
        self._deadline = 0.0
        self._clamp_max_s = clamp_max_s
        self._busy_text = busy_text

    def run(self, seconds: float, sample_fn):
        if not self._lock.acquire(blocking=False):
            remaining = self._deadline - time.monotonic()
            retry_s = max(1, int(remaining) + 1)
            return (503, "text/plain", self._busy_text,
                    {"Retry-After": str(retry_s)})
        try:
            seconds = max(0.1, min(self._clamp_max_s, seconds))
            self._deadline = time.monotonic() + seconds
            return 200, "text/plain", sample_fn(seconds)
        finally:
            self._lock.release()


_contention_prof_window = _ProfWindow(
    10.0, "nat_mu_prof busy: another /hotspots/contention window is "
          "running\n")


def sample_contention(seconds: float = 1.0, hz: int = 99) -> str:
    """/hotspots/contention: the wait-frame profile. The reference puts
    its native runtime's lock profile above it; the port has none."""
    from brpc_tpu_torch.builtin import profilers

    report = profilers.contention_profile(seconds, hz)
    return "# python wait-frame profile\n" + report.rstrip() + "\n"


def hotspots_handler(server, req):
    """/hotspots/{cpu,heap,growth,contention,tpu,native}."""
    from brpc_tpu_torch.builtin import profilers

    parts = [p for p in req.path.split("/") if p]
    kind = parts[1] if len(parts) > 1 else "cpu"
    seconds = float(req.query.get("seconds", "1") or 1)
    if kind == "cpu":
        return 200, "text/plain", sample_cpu(seconds)
    if kind == "native":
        return 200, "text/plain", _NATIVE_UNAVAILABLE
    if kind == "heap":
        return 200, "text/plain", profilers.heap_profile()
    if kind == "growth":
        return 200, "text/plain", profilers.growth_profile()
    if kind == "contention":
        return _contention_prof_window.run(seconds, sample_contention)
    if kind == "tpu":
        ctype, body = profilers.cuda_trace(seconds,
                                           device=server.options.device)
        return 200, ctype, body
    return 404, "text/plain", f"unknown hotspots kind {kind}\n"


def pprof_handler(server, req):
    """/pprof/{profile,heap,growth,contention,symbol}."""
    from brpc_tpu_torch.builtin import profilers

    parts = [p for p in req.path.split("/") if p]
    kind = parts[1] if len(parts) > 1 else "profile"
    if kind == "profile":
        seconds = float(req.query.get("seconds", "1") or 1)
        return 200, "text/plain", sample_cpu(seconds)
    if kind == "heap":
        return 200, "text/plain", profilers.heap_profile()
    if kind == "growth":
        return 200, "text/plain", profilers.growth_profile()
    if kind == "contention":
        seconds = float(req.query.get("seconds", "1") or 1)
        return 200, "text/plain", profilers.contention_profile(seconds)
    if kind == "symbol":
        return 200, "text/plain", "python frames are pre-symbolized\n"
    return 404, "text/plain", f"unknown pprof endpoint {kind}\n"


def threads_handler(server, req):
    return 200, "text/plain", thread_dump()
