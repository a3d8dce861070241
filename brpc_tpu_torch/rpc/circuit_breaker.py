"""CircuitBreaker — a per-node error-rate recorder that isolates the node.

Copy of brpc_tpu/rpc/circuit_breaker.py: two EMA windows (short and long)
of the error rate, judged on every call's end; crossing either threshold
isolates the node (the channel then fails its socket, and health-check
revival brings it back). An isolation soon after the last one doubles its
duration, up to the ceiling. The flags and their defaults are the
reference's.
"""
from __future__ import annotations

import threading
import time

from brpc_tpu_torch.butil import flags

flags.define_int("circuit_breaker_short_window_size", 128,
                 "sample count of the short EMA window")
flags.define_int("circuit_breaker_long_window_size", 1024,
                 "sample count of the long EMA window")
flags.define_int("circuit_breaker_short_window_error_percent", 10,
                 "max error percent tolerated by the short window")
flags.define_int("circuit_breaker_long_window_error_percent", 5,
                 "max error percent tolerated by the long window")
flags.define_int("circuit_breaker_min_isolation_duration_ms", 100,
                 "first isolation duration")
flags.define_int("circuit_breaker_max_isolation_duration_ms", 30000,
                 "isolation duration ceiling")


class _EmaWindow:
    def __init__(self, window_size: int, max_error_percent: int):
        self._alpha = 2.0 / (window_size + 1)
        self._threshold = max_error_percent / 100.0
        self._ema_error = 0.0

    def on_call(self, is_error: bool) -> bool:
        """Returns False when the window votes to isolate."""
        sample = 1.0 if is_error else 0.0
        self._ema_error = (1 - self._alpha) * self._ema_error + self._alpha * sample
        return self._ema_error < self._threshold

    @property
    def error_rate(self) -> float:
        return self._ema_error


class CircuitBreaker:
    def __init__(self):
        self._short = _EmaWindow(
            flags.get_flag("circuit_breaker_short_window_size"),
            flags.get_flag("circuit_breaker_short_window_error_percent"),
        )
        self._long = _EmaWindow(
            flags.get_flag("circuit_breaker_long_window_size"),
            flags.get_flag("circuit_breaker_long_window_error_percent"),
        )
        self._lock = threading.Lock()
        self._broken = False
        self._isolation_ms = flags.get_flag(
            "circuit_breaker_min_isolation_duration_ms")
        self._isolated_until = 0.0
        self._last_isolation = 0.0

    def on_call_end(self, error_code: int, latency_us: float) -> bool:
        """Feed one finished call; returns False when the node should be
        isolated (OnCallEnd, circuit_breaker.h:40)."""
        is_error = error_code != 0
        with self._lock:
            if self._broken:
                return False
            ok = self._short.on_call(is_error) and self._long.on_call(is_error)
            if not ok:
                self._mark_isolated_locked()
                return False
            return True

    def _mark_isolated_locked(self):
        now = time.monotonic()
        max_ms = flags.get_flag("circuit_breaker_max_isolation_duration_ms")
        # double the duration when re-isolated soon after the last one
        if now - self._last_isolation < 30.0 and self._last_isolation > 0:
            self._isolation_ms = min(self._isolation_ms * 2, max_ms)
        else:
            self._isolation_ms = flags.get_flag(
                "circuit_breaker_min_isolation_duration_ms")
        self._broken = True
        self._last_isolation = now
        self._isolated_until = now + self._isolation_ms / 1000.0

    def is_broken(self) -> bool:
        with self._lock:
            return self._broken

    def isolation_duration_ms(self) -> int:
        return int(self._isolation_ms)

    def remaining_isolation_s(self) -> float:
        with self._lock:
            return max(0.0, self._isolated_until - time.monotonic())

    def reset(self):
        """Called on revival (health check succeeded)."""
        with self._lock:
            self._broken = False
            self._short = _EmaWindow(
                flags.get_flag("circuit_breaker_short_window_size"),
                flags.get_flag("circuit_breaker_short_window_error_percent"),
            )
            self._long = _EmaWindow(
                flags.get_flag("circuit_breaker_long_window_size"),
                flags.get_flag("circuit_breaker_long_window_error_percent"),
            )
