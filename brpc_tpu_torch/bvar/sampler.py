"""Sampler — the one-second tick behind every windowed variable.

Port of brpc_tpu/bvar/sampler.py: one daemon thread, started by the first
sampler, wakes every second and has each registered sampler take a
(timestamp, value) sample; Window, PerSecond and LatencyRecorder read
the ring of samples. ``force_tick_for_tests`` samples everything at once.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Deque, Optional, Tuple

MAX_WINDOW_SIZE = 3600


class Sampler:
    """One sampled series: a ring of (timestamp, value) pairs."""

    def __init__(self, take_fn, window_size: int = 60):
        self._take_fn = take_fn
        self._window = min(max(1, window_size), MAX_WINDOW_SIZE)
        self._samples: Deque[Tuple[float, object]] = deque(maxlen=self._window + 1)
        self._lock = threading.Lock()
        _collector().add(self)

    def take_sample(self):
        value = self._take_fn()
        with self._lock:
            self._samples.append((time.monotonic(), value))

    def latest(self) -> Optional[Tuple[float, object]]:
        with self._lock:
            return self._samples[-1] if self._samples else None

    def oldest_in(self, window_s: int) -> Optional[Tuple[float, object]]:
        """The sample closest to window_s seconds ago (value_at semantics of
        detail/series.h)."""
        cutoff = time.monotonic() - window_s - 0.5
        with self._lock:
            candidate = None
            for ts, v in self._samples:
                if ts >= cutoff:
                    return (ts, v) if candidate is None else candidate
                candidate = (ts, v)
            return candidate

    def samples_in(self, window_s: int):
        cutoff = time.monotonic() - window_s - 0.5
        with self._lock:
            return [(ts, v) for ts, v in self._samples if ts >= cutoff]

    def destroy(self):
        _collector().remove(self)


class _SamplerCollector:
    _instance = None
    _instance_lock = threading.Lock()

    def __init__(self):
        self._samplers = set()
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def add(self, sampler: Sampler):
        with self._lock:
            self._samplers.add(sampler)
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, name="bvar_sampler", daemon=True
                )
                self._thread.start()

    def remove(self, sampler: Sampler):
        with self._lock:
            self._samplers.discard(sampler)

    def _run(self):
        while not self._stop.wait(1.0):
            with self._lock:
                samplers = list(self._samplers)
            for s in samplers:
                try:
                    s.take_sample()
                except Exception:
                    pass  # one bad sampler must not kill the tick thread

    def force_tick_for_tests(self):
        with self._lock:
            samplers = list(self._samplers)
        for s in samplers:
            s.take_sample()


def _collector() -> _SamplerCollector:
    with _SamplerCollector._instance_lock:
        if _SamplerCollector._instance is None:
            _SamplerCollector._instance = _SamplerCollector()
        return _SamplerCollector._instance


def force_tick_for_tests():
    """Synchronously sample everything — lets tests avoid 1s sleeps."""
    _collector().force_tick_for_tests()
