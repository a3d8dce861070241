"""The card trace behind /hotspots.

Port of the device half of brpc_tpu/builtin/profilers.py: its
``tpu_trace`` takes a ``jax.profiler`` trace of the TPU; ``cuda_trace``
takes a ``torch.profiler`` trace of the card (CUPTI) and of every
thread's torch ops for the same window, and returns it as a zipped
Chrome trace. Left out until the HTTP protocol lands: the heap, growth
and contention profilers.
"""
from __future__ import annotations

import io
import os
import tempfile
import threading
import time
import zipfile

from brpc_tpu_torch.device import DeviceLike, resolve_device

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
