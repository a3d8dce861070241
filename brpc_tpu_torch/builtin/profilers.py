"""The profilers behind /hotspots: the host's heap, growth and lock
contention, and the card trace.

Port of brpc_tpu/builtin/profilers.py:

- heap       -> tracemalloc snapshot, live bytes by stack (collapsed);
- growth     -> tracemalloc diff against the snapshot taken when
                profiling started;
- contention -> a sampler keeping only the stacks blocked in lock,
                condition or butex waits;
- tpu        -> ``cuda_trace``: where the reference's ``tpu_trace`` takes
                a ``jax.profiler`` trace of the TPU, a ``torch.profiler``
                trace of the card (CUPTI) and of every thread's torch ops
                for the same window, returned as a zipped Chrome trace.
"""
from __future__ import annotations

import io
import os
import sys
import tempfile
import threading
import time
import tracemalloc
import zipfile
from collections import Counter

from brpc_tpu_torch.device import DeviceLike, resolve_device

_growth_baseline = None
_baseline_lock = threading.Lock()


def _ensure_tracemalloc(frames: int = 16) -> bool:
    """Start tracemalloc on the first profile; False when it just started
    (no data yet)."""
    global _growth_baseline
    if tracemalloc.is_tracing():
        # started elsewhere (PYTHONTRACEMALLOC, user code): the growth
        # baseline is now
        with _baseline_lock:
            if _growth_baseline is None:
                _growth_baseline = tracemalloc.take_snapshot()
        return True
    tracemalloc.start(frames)
    with _baseline_lock:
        _growth_baseline = tracemalloc.take_snapshot()
    return False


def _collapse(stat) -> str:
    parts = [f"{os.path.basename(frame.filename)}:{frame.lineno}"
             for frame in reversed(stat.traceback)]
    return ";".join(parts) if parts else "<unknown>"


def heap_profile(top: int = 64) -> str:
    """Live allocations by stack, collapsed format, byte counts."""
    fresh = not _ensure_tracemalloc()
    snap = tracemalloc.take_snapshot()
    stats = snap.statistics("traceback")
    total = sum(s.size for s in stats)
    lines = [
        f"# heap profile: {len(stats)} allocation sites, "
        f"{total} bytes live (tracemalloc)",
        "# format: collapsed stacks, value = live bytes",
    ]
    if fresh:
        lines.append("# note: tracing just started; rerun for steady state")
    for s in stats[:top]:
        lines.append(f"{_collapse(s)} {s.size}")
    return "\n".join(lines) + "\n"


def growth_profile(top: int = 64) -> str:
    """Allocation growth since profiling began."""
    fresh = not _ensure_tracemalloc()
    snap = tracemalloc.take_snapshot()
    with _baseline_lock:
        baseline = _growth_baseline
    lines = ["# growth profile: bytes allocated since profiling start",
             "# format: collapsed stacks, value = grown bytes"]
    if fresh or baseline is None:
        lines.append("# note: baseline just taken; rerun to see growth")
        return "\n".join(lines) + "\n"
    grown = [d for d in snap.compare_to(baseline, "traceback")
             if d.size_diff > 0]
    grown.sort(key=lambda d: d.size_diff, reverse=True)
    lines.insert(1, f"# {len(grown)} growing sites, "
                    f"{sum(d.size_diff for d in grown)} bytes total")
    for d in grown[:top]:
        lines.append(f"{_collapse(d)} {d.size_diff}")
    return "\n".join(lines) + "\n"


_WAIT_LEAVES = ("wait", "acquire", "_wait_for_tstate_lock", "wait_for",
                "futex_wait", "join")
_WAIT_FILES = ("threading.py", "butex.py", "parking_lot.py",
               "execution_queue.py", "id.py")


def contention_profile(seconds: float = 1.0, hz: int = 99) -> str:
    """Stacks observed blocked in lock, condition or butex waits."""
    seconds = max(0.1, min(10.0, seconds))
    interval = 1.0 / max(1, hz)
    stacks: Counter = Counter()
    own = threading.get_ident()
    deadline = time.monotonic() + seconds
    nsamples = 0
    while time.monotonic() < deadline:
        for tid, frame in sys._current_frames().items():
            if tid == own or frame is None:
                continue
            leaf = frame.f_code
            if (not leaf.co_name.startswith(_WAIT_LEAVES)
                    or os.path.basename(leaf.co_filename) not in _WAIT_FILES):
                continue
            parts = []
            f = frame
            depth = 0
            while f is not None and depth < 64:
                code = f.f_code
                parts.append(
                    f"{code.co_name} "
                    f"({os.path.basename(code.co_filename)}:{f.f_lineno})")
                f = f.f_back
                depth += 1
            stacks[";".join(reversed(parts))] += 1
        nsamples += 1
        time.sleep(interval)
    lines = [
        f"# contention profile: {nsamples} samples at {hz}Hz over "
        f"{seconds}s; stacks blocked in lock/cond waits",
        "# format: collapsed stacks, value = samples observed waiting",
    ]
    for stack, count in stacks.most_common():
        lines.append(f"{stack} {count}")
    if len(lines) == 2:
        lines.append("# no contention observed")
    return "\n".join(lines) + "\n"


# the profiler is one per process: a second trace while one runs breaks
# the first, so a trace that finds one running is refused
_trace_lock = threading.Lock()


def cuda_trace(seconds: float = 1.0, device: DeviceLike = None):
    """Trace the card (``device``: the card unless "cpu" is asked for) and
    the host's torch ops for ``seconds`` (0.1-30); returns (content_type,
    body): a zip of the Chrome trace, or a text saying why there is none.
    Raises without CUDA when the card is asked for."""
    seconds = max(0.1, min(30.0, seconds))
    dev = resolve_device(device)
    if (os.cpu_count() or 1) < 2 and not os.environ.get(
            "BRPC_TPU_FORCE_TPU_TRACE"):
        # the profiler's start and stop are seconds of native work that
        # would starve every other handler of a one-core server
        return ("text/plain",
                "profiler trace skipped: single-cpu host (trace collection "
                "would starve the server; set BRPC_TPU_FORCE_TPU_TRACE=1 "
                "to force)\n")
    import torch.profiler as tp
    from torch._C._profiler import _ExperimentalConfig

    activities = [tp.ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(tp.ProfilerActivity.CUDA)
    if not _trace_lock.acquire(blocking=False):
        return "text/plain", "profiler trace failed: a trace is running\n"
    try:
        with tempfile.TemporaryDirectory(prefix="cuda_trace_") as tmp:
            path = os.path.join(tmp, "cuda_trace.pt.trace.json")
            try:
                with tp.profile(activities=activities,
                                experimental_config=_ExperimentalConfig(
                                    profile_all_threads=True)) as prof:
                    # the window: RPC traffic and card work of every thread
                    # meanwhile is caught by the profiler's own hooks
                    time.sleep(seconds)
                prof.export_chrome_trace(path)
            except Exception as e:
                return "text/plain", f"profiler trace failed: {e}\n"
            buf = io.BytesIO()
            with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
                zf.write(path, os.path.basename(path))
            return "application/zip", buf.getvalue()
    finally:
        _trace_lock.release()
