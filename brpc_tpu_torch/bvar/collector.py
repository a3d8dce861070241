"""Collector — sampling of arbitrary objects within a budget.

Port of brpc_tpu/bvar/collector.py (bvar::Collector): subsystems submit
objects (spans, recorded requests, ...) and the collector keeps at most
``max_samples_per_second`` of them in each one-second window (16384 by
default), dropping the rest; ``drain`` takes what was kept.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Deque, List, Optional

COLLECTOR_SAMPLING_BASE = 16384  # collector.h:40


class Collectable:
    """Optional base: override destroy() for cleanup on drop."""

    def destroy(self):
        pass


class Collector:
    def __init__(self, max_samples_per_second: int = COLLECTOR_SAMPLING_BASE,
                 drain_fn: Optional[Callable[[List], None]] = None,
                 max_pending: int = 65536):
        self._budget = max_samples_per_second
        self._drain_fn = drain_fn
        self._pending: Deque = deque(maxlen=max_pending)
        self._lock = threading.Lock()
        self._window_start = time.monotonic()
        self._window_count = 0
        self._submitted = 0
        self._sampled = 0

    def submit(self, obj) -> bool:
        """True if kept; False if dropped by the speed limit."""
        now = time.monotonic()
        with self._lock:
            self._submitted += 1
            if now - self._window_start >= 1.0:
                self._window_start = now
                self._window_count = 0
            if self._window_count >= self._budget:
                if isinstance(obj, Collectable):
                    obj.destroy()
                return False
            self._window_count += 1
            self._sampled += 1
            self._pending.append(obj)
            return True

    def drain(self) -> List:
        """Take everything collected so far (the background-thread pass of
        collector.cpp)."""
        with self._lock:
            out = list(self._pending)
            self._pending.clear()
        if self._drain_fn is not None and out:
            self._drain_fn(out)
        return out

    @property
    def submitted_count(self) -> int:
        return self._submitted

    @property
    def sampled_count(self) -> int:
        return self._sampled

    @property
    def pending_count(self) -> int:
        return len(self._pending)
