"""MethodStatus — the concurrency gate and latency statistics of a method.

Port of brpc_tpu/rpc/method_status.py: each server method counts the
calls it runs and feeds a LatencyRecorder named after it (``TensorStore.
Push`` -> ``TensorStore_Push``); a ConcurrencyLimiter may refuse a call
before user code runs, which the server answers with ELIMIT.
"""
from __future__ import annotations

import threading
import time
from typing import Optional

from brpc_tpu_torch import bvar


class MethodStatus:
    def __init__(self, full_name: str, limiter: Optional[object] = None):
        self.full_name = full_name
        self._concurrency = 0
        self._lock = threading.Lock()
        self.latency_recorder = bvar.LatencyRecorder(
            full_name.replace(".", "_").replace("/", "_")
        )
        self._rejected = bvar.Adder()
        self.limiter = limiter  # ConcurrencyLimiter or None

    def on_requested(self) -> bool:
        """False = reject with ELIMIT (OnRequested, method_status.h)."""
        with self._lock:
            if self.limiter is not None and not self.limiter.on_requested(
                self._concurrency
            ):
                self._rejected.update(1)
                return False
            self._concurrency += 1
            return True

    def on_response(self, error_code: int, start_time_s: float):
        latency_us = (time.monotonic() - start_time_s) * 1e6
        with self._lock:
            self._concurrency -= 1
        self.latency_recorder.update(latency_us)
        if self.limiter is not None:
            self.limiter.on_response(error_code, latency_us)

    @property
    def concurrency(self) -> int:
        return self._concurrency

    @property
    def rejected_count(self) -> int:
        return self._rejected.get_value()

    def describe(self) -> str:
        return (
            f"{self.full_name}: concurrency={self._concurrency} "
            f"rejected={self.rejected_count} {self.latency_recorder.describe()}"
        )
