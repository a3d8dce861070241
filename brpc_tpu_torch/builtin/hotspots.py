"""Hotspots — the profilers of the console, on demand.

Port of brpc_tpu/builtin/hotspots.py. ``GET /hotspots/cpu?seconds=N``
samples every thread's Python stack (``sys._current_frames``) for N
seconds and answers collapsed stacks ("frame;frame;frame count", for
flamegraph.pl or speedscope). The other kinds:

* ``heap``, ``growth`` — tracemalloc (builtin/profilers.py);
* ``contention`` — the native runtime's lock profile (contended NatMutex
  waits, weighted by the microseconds waited, with the waits by lock
  rank) above the stacks blocked in Python waits, both over one window;
* ``tpu`` — the card trace of the server's device
  (``profilers.cuda_trace``), a zipped Chrome trace, under the
  reference's URL;
* ``native`` — the native runtime's CPU profile (its SIGPROF sampler,
  frame pointers through the C++ runtime), collapsed stacks or
  ``?flat=1`` a table by symbol.

``heap_native`` and ``growth_native`` are the bodies of ``/heap/native``
and ``/growth/native`` (builtin/console.py): live native bytes by
allocation site, and their growth, from the tracker they arm on first
use. Each profiler runs one window at a time: a second request while one
runs gets 503 with a ``Retry-After`` taken from the running window's
deadline. The native kinds read only a library this process has loaded
(queue C #38): without one they answer the reference's "native runtime
unavailable".

``/pprof/{profile,heap,growth,contention,symbol}`` and ``/threads`` (every
thread's stack now) are the same profilers under pprof's names.
"""
from __future__ import annotations

import sys
import threading
import time
from collections import Counter

from brpc_tpu_torch import native

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


_native_prof_window = _ProfWindow(
    30.0, "nat_prof busy: another /hotspots/native window is running\n")
_contention_prof_window = _ProfWindow(
    10.0, "nat_mu_prof busy: another /hotspots/contention window is "
          "running\n")
# /heap/native and /growth/native share one window: both read the same
# allocation-site tracker, and the growth baseline is shared
_res_prof_window = _ProfWindow(
    30.0, "nat_res busy: another /heap/native or /growth/native window "
          "is running\n")


def _res_ensure_armed():
    """Arm the native allocation-site tracker on first use. (whether a
    native library is loaded, whether tracking started just now)."""
    if not native.is_loaded():
        return False, False
    if native.res_prof_running():
        return True, False
    # -1: an embedder owns the tracker; report without taking it
    return True, native.res_prof_start(1, 42) == 0


def heap_native(seconds: float = 0.0, flat: bool = False) -> str:
    """/heap/native's body: live bytes by native allocation site (the
    runtime's own allocators, which tracemalloc cannot see); ``seconds``
    > 0 lets the tracker watch that long first. The caller holds
    ``_res_prof_window``."""
    loaded, fresh = _res_ensure_armed()
    if not loaded:
        return _NATIVE_UNAVAILABLE
    if seconds > 0:
        time.sleep(min(seconds, 30.0))
    report = native.res_heap_report(collapsed=not flat)
    if fresh:
        report = ("# note: allocation-site tracking just started; pool "
                  "memory allocated earlier is in the nat_mem_* ledger "
                  "but not attributed to a site — rerun for steady "
                  "state\n") + report
    return report


def growth_native(seconds: float = 0.0) -> str:
    """/growth/native's body: live bytes by site grown since the baseline
    (taken at arming); ``seconds`` > 0 takes the baseline now and reports
    that window's growth. The caller holds ``_res_prof_window``."""
    loaded, fresh = _res_ensure_armed()
    if not loaded:
        return _NATIVE_UNAVAILABLE
    if seconds > 0:
        native.res_growth_baseline()
        time.sleep(min(seconds, 30.0))
    report = native.res_growth_report()
    if fresh:
        report = ("# note: tracking just started; baseline taken now — "
                  "rerun (or pass ?seconds=N) to see growth\n") + report
    return report


def sample_native(seconds: float = 1.0, hz: int = 99,
                  collapsed: bool = True) -> str:
    """/hotspots/native: the native runtime's SIGPROF sampler over every
    thread burning CPU (fiber workers, dispatchers, Python-lane threads),
    unwound through the C++ runtime. The caller holds
    ``_native_prof_window``."""
    if not native.is_loaded():
        return _NATIVE_UNAVAILABLE
    seconds = max(0.1, min(30.0, seconds))
    rc = native.prof_start(hz)
    if rc == -2:
        return "nat_prof: could not install SIGPROF handler/timer\n"
    owns = rc == 0  # -1: an embedder runs it; report without taking it
    time.sleep(seconds)
    if owns:
        native.prof_stop()
    report = native.prof_report(collapsed=collapsed)
    if owns:
        native.prof_reset()
    return report or "nat_prof: no samples (no native CPU burned?)\n"


def _native_lock_section(owns: bool) -> list:
    if owns:
        native.mu_prof_stop()
    parts = ["# native lock contention (nat_mu_prof: contended NatMutex "
             "waits, wait-us weighted)",
             native.mu_prof_report(collapsed=True).rstrip()]
    ranks = native.mu_rank_stats()
    if ranks:
        parts.append("# per-rank wait totals since start/reset:")
        parts += [f"#   rank {r['rank']:>3d} {r['name']:<14s} "
                  f"waits={r['waits']} wait_us={r['wait_us']}"
                  for r in sorted(ranks, key=lambda r: -r["wait_us"])]
    if owns:
        # the samples only: the per-rank totals are counters on
        # /brpc_metrics and outlive a page
        native.mu_prof_reset_samples()
    return parts


def sample_contention(seconds: float = 1.0, hz: int = 99) -> str:
    """/hotspots/contention: the native lock profile, armed for exactly
    the window the Python wait-frame sampler runs, above that profile."""
    from brpc_tpu_torch.builtin import profilers

    seconds = max(0.1, min(10.0, seconds))
    loaded = native.is_loaded()
    # every contended wait of the window (threshold 0); -1: an embedder
    # holds the sampler, which stays its own
    owns = loaded and native.mu_prof_start(0, 1, 42) == 0
    try:
        py_report = profilers.contention_profile(seconds, hz)
    except BaseException:
        if owns:  # a sampler left on would refuse every later window
            native.mu_prof_stop()
            native.mu_prof_reset_samples()
        raise
    parts = _native_lock_section(owns) if loaded else []
    parts += ["# python wait-frame profile", py_report.rstrip()]
    return "\n".join(parts) + "\n"


def hotspots_handler(server, req):
    """/hotspots/{cpu,native,heap,growth,contention,tpu}."""
    from brpc_tpu_torch.builtin import profilers

    parts = [p for p in req.path.split("/") if p]
    kind = parts[1] if len(parts) > 1 else "cpu"
    seconds = float(req.query.get("seconds", "1") or 1)
    if kind == "cpu":
        return 200, "text/plain", sample_cpu(seconds)
    if kind == "native":
        collapsed = req.query.get("flat", "") in ("", "0")
        return _native_prof_window.run(
            seconds, lambda s: sample_native(s, collapsed=collapsed))
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
