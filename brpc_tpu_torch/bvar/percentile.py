"""Percentile — a reservoir-sampled latency distribution.

Port of brpc_tpu/bvar/percentile.py: one bounded reservoir per sampling
interval (254 samples, uniform replacement), the last ``window_size``
intervals merged to read a quantile.
"""
from __future__ import annotations

import random
import threading
from collections import deque
from typing import Deque, List

SAMPLES_PER_INTERVAL = 254  # reference: 254 samples per ThreadLocalPercentileSamples
# the reservoir's draws come from a generator of their own: recorders are
# updated on server and worker threads, and draws from the global
# ``random`` would move every seeded sequence of the process
_rng = random.Random()


class _Interval:
    """One sampling interval's reservoir."""

    __slots__ = ("samples", "num_added")

    def __init__(self):
        self.samples: List[float] = []
        self.num_added = 0

    def add(self, value: float):
        self.num_added += 1
        if len(self.samples) < SAMPLES_PER_INTERVAL:
            self.samples.append(value)
        else:  # reservoir replacement keeps a uniform sample of the interval
            i = _rng.randrange(self.num_added)
            if i < SAMPLES_PER_INTERVAL:
                self.samples[i] = value


class Percentile:
    def __init__(self, window_size: int = 10):
        self._window_size = window_size
        self._current = _Interval()
        self._history: Deque[_Interval] = deque(maxlen=window_size)
        self._lock = threading.Lock()

    def update(self, value: float):
        with self._lock:
            self._current.add(value)

    __lshift__ = update

    def rotate(self):
        """Close the current interval into history (called by the sampler
        tick, mirroring take_sample of percentile.h)."""
        with self._lock:
            if self._current.num_added:
                self._history.append(self._current)
                self._current = _Interval()

    def _merged(self) -> List[float]:
        with self._lock:
            merged: List[float] = []
            for interval in self._history:
                merged.extend(interval.samples)
            merged.extend(self._current.samples)
        merged.sort()
        return merged

    def get_number(self, ratio: float) -> float:
        """Value at quantile `ratio` in the window (percentile.h
        GetPercentileValue)."""
        merged = self._merged()
        if not merged:
            return 0.0
        idx = min(len(merged) - 1, int(ratio * len(merged)))
        return merged[idx]

    def describe(self) -> str:
        return (
            f"p50={self.get_number(0.5):.0f} p90={self.get_number(0.9):.0f} "
            f"p99={self.get_number(0.99):.0f} p999={self.get_number(0.999):.0f}"
        )
