"""Process variables exposed by a running server.

Port of brpc_tpu/bvar/default_variables.py: the process's cpu seconds,
resident memory, fd and thread counts, pid and uptime, read from /proc,
and ``cuda_device_count`` (``torch.cuda.device_count()``) where the
reference reads ``tpu_device_count`` from ``jax.devices()``.
"""
from __future__ import annotations

import os
import time

from brpc_tpu_torch.bvar.variable import PassiveStatus

_CLK_TCK = os.sysconf("SC_CLK_TCK") if hasattr(os, "sysconf") else 100
_PAGE = os.sysconf("SC_PAGE_SIZE") if hasattr(os, "sysconf") else 4096


def _proc_stat_fields():
    try:
        with open("/proc/self/stat", "rb") as f:
            data = f.read().decode()
        # fields after the (comm) — comm may contain spaces
        return data[data.rindex(")") + 2 :].split()
    except OSError:
        return []


def _cpu_seconds() -> float:
    f = _proc_stat_fields()
    if len(f) < 13:
        return 0.0
    utime, stime = int(f[11]), int(f[12])  # fields 14,15 (1-based)
    return (utime + stime) / _CLK_TCK


def _rss_bytes() -> int:
    try:
        with open("/proc/self/statm", "rb") as f:
            return int(f.read().split()[1]) * _PAGE
    except OSError:
        return 0


def _fd_count() -> int:
    try:
        return len(os.listdir("/proc/self/fd"))
    except OSError:
        return 0


def _thread_count() -> int:
    f = _proc_stat_fields()
    return int(f[17]) if len(f) > 17 else 0


_start_time = time.time()

_exposed = False


def expose_default_variables():
    """Idempotently expose process_* variables (called by Server start)."""
    global _exposed
    if _exposed:
        return
    _exposed = True
    PassiveStatus(_cpu_seconds, "process_cpu_seconds")
    PassiveStatus(_rss_bytes, "process_memory_resident_bytes")
    PassiveStatus(_fd_count, "process_fd_count")
    PassiveStatus(_thread_count, "process_thread_count")
    PassiveStatus(lambda: os.getpid(), "process_pid")
    PassiveStatus(lambda: time.time() - _start_time, "process_uptime_seconds")

    def _device_count():
        import torch

        return torch.cuda.device_count()

    PassiveStatus(_device_count, "cuda_device_count")
