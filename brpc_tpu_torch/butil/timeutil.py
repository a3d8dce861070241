"""Time helpers (butil/time.h): the monotonic and wall clocks in ns and
us, and a stopwatch.

Port of brpc_tpu/butil/timeutil.py.
"""
from __future__ import annotations

import time


def cpuwide_time_ns() -> int:
    return time.monotonic_ns()


def cpuwide_time_us() -> int:
    return time.monotonic_ns() // 1000


def gettimeofday_us() -> int:
    return time.time_ns() // 1000


def monotonic_time_ns() -> int:
    return time.monotonic_ns()


class Timer:
    """Scoped stopwatch (butil::Timer)."""

    __slots__ = ("_start", "_stop")

    def __init__(self):
        self._start = 0
        self._stop = 0

    def start(self):
        self._start = time.monotonic_ns()
        self._stop = self._start

    def stop(self):
        self._stop = time.monotonic_ns()

    def n_elapsed(self) -> int:
        return self._stop - self._start

    def u_elapsed(self) -> int:
        return self.n_elapsed() // 1000

    def m_elapsed(self) -> int:
        return self.n_elapsed() // 1_000_000
