"""ConcurrencyLimiter — admission control for server methods.

Port of brpc_tpu/rpc/concurrency_limiter.py:

* ConstantLimiter ('constant:N', or a bare int): at most N calls at once;
* AutoLimiter ('auto'): a limit of max qps x no-load latency x (1 +
  alpha), from one-second windows of answered calls, the no-load latency
  an EMA re-probed every ten windows;
* TimeoutLimiter ('timeout:ms'): refuses when the expected queueing delay
  (calls in flight x average latency) reaches the budget.

MethodStatus calls on_requested / on_response around every call.
"""
from __future__ import annotations

import threading
import time


class ConcurrencyLimiter:
    def on_requested(self, current_concurrency: int) -> bool:
        raise NotImplementedError

    def on_response(self, error_code: int, latency_us: float):
        raise NotImplementedError

    def max_concurrency(self) -> int:
        return 0


class ConstantLimiter(ConcurrencyLimiter):
    def __init__(self, limit: int):
        self._limit = limit

    def on_requested(self, current: int) -> bool:
        return self._limit <= 0 or current < self._limit

    def on_response(self, error_code: int, latency_us: float):
        pass

    def max_concurrency(self) -> int:
        return self._limit


class AutoLimiter(ConcurrencyLimiter):
    """Gradient-style adaptive limit (auto_concurrency_limiter.h shape)."""

    ALPHA = 0.3  # headroom factor over measured capacity
    EMA_A = 0.1
    SAMPLE_WINDOW_S = 1.0
    MIN_LIMIT = 4

    def __init__(self):
        self._lock = threading.Lock()
        self._limit = 64.0
        self._min_latency_us = None  # EMA of no-load latency
        self._window_start = time.monotonic()
        self._window_count = 0
        self._window_latency_sum = 0.0
        self._probe_countdown = 10  # periodically re-probe min latency

    def on_requested(self, current: int) -> bool:
        return current < int(self._limit)

    def on_response(self, error_code: int, latency_us: float):
        if error_code != 0:
            return
        with self._lock:
            self._window_count += 1
            self._window_latency_sum += latency_us
            now = time.monotonic()
            dt = now - self._window_start
            if dt < self.SAMPLE_WINDOW_S or self._window_count == 0:
                return
            qps = self._window_count / dt
            avg_latency = self._window_latency_sum / self._window_count
            self._window_start = now
            self._window_count = 0
            self._window_latency_sum = 0.0
            if self._min_latency_us is None:
                self._min_latency_us = avg_latency
            else:
                self._probe_countdown -= 1
                if self._probe_countdown <= 0:
                    # re-probe: shrink limit briefly so min latency re-measures
                    self._probe_countdown = 10
                    self._min_latency_us = avg_latency
                else:
                    self._min_latency_us = min(
                        self._min_latency_us,
                        (1 - self.EMA_A) * self._min_latency_us
                        + self.EMA_A * avg_latency,
                    )
            capacity = qps * (self._min_latency_us / 1e6)
            self._limit = max(self.MIN_LIMIT, capacity * (1 + self.ALPHA))

    def max_concurrency(self) -> int:
        return int(self._limit)


class TimeoutLimiter(ConcurrencyLimiter):
    """Reject when estimated queue delay exceeds the budget
    (policy/timeout_concurrency_limiter.*)."""

    def __init__(self, timeout_ms: float = 500.0):
        self._timeout_s = timeout_ms / 1000.0
        self._avg_latency_s = 0.0
        self._lock = threading.Lock()

    def on_requested(self, current: int) -> bool:
        with self._lock:
            if self._avg_latency_s <= 0:
                return True
            expected_delay = current * self._avg_latency_s
            return expected_delay < self._timeout_s

    def on_response(self, error_code: int, latency_us: float):
        if error_code != 0:
            return
        with self._lock:
            sample = latency_us / 1e6
            if self._avg_latency_s == 0:
                self._avg_latency_s = sample
            else:
                self._avg_latency_s = 0.9 * self._avg_latency_s + 0.1 * sample


def create_concurrency_limiter(spec) -> ConcurrencyLimiter:
    """'constant:100' | 'auto' | 'timeout:500' | int (global.cpp:604-606
    registry shape)."""
    if isinstance(spec, int):
        return ConstantLimiter(spec)
    name, _, arg = str(spec).partition(":")
    if name == "auto":
        return AutoLimiter()
    if name == "timeout":
        return TimeoutLimiter(float(arg or 500))
    if name == "constant":
        return ConstantLimiter(int(arg or 0))
    raise ValueError(f"unknown concurrency limiter {spec!r}")
