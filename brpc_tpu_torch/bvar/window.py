"""Window / PerSecond — views of a reducer over the last N seconds.

Port of brpc_tpu/bvar/window.py: a Window shows the reducer's change
(invertible reducers: Adder, IntRecorder) or the series-combination of
its samples (Maxer) over ``window_size`` seconds; PerSecond
divides the change by the seconds it covers. The sampler thread feeds
both.
"""
from __future__ import annotations

from typing import Optional

from brpc_tpu_torch.bvar.reducer import Reducer
from brpc_tpu_torch.bvar.sampler import Sampler
from brpc_tpu_torch.bvar.variable import Variable


class Window(Variable):
    def __init__(self, reducer: Reducer, window_size: int = 10,
                 name: Optional[str] = None):
        self._reducer = reducer
        self._window_size = window_size
        self._sampler = Sampler(reducer.get_value, window_size)
        super().__init__(name)

    @property
    def window_size(self) -> int:
        return self._window_size

    def get_value(self):
        if getattr(self._reducer, "invertible", False):
            now = self._reducer.get_value()
            oldest = self._sampler.oldest_in(self._window_size)
            if oldest is None:
                return now
            return now - oldest[1]
        # Non-invertible (Maxer): series-combine the samples + live.
        samples = self._sampler.samples_in(self._window_size)
        result = self._reducer.get_value()
        for _, v in samples:
            result = self._reducer.series_op(result, v)
        return result

    def get_span(self) -> float:
        """Seconds actually covered (may be < window_size early on)."""
        oldest = self._sampler.oldest_in(self._window_size)
        latest = self._sampler.latest()
        if oldest is None or latest is None:
            return 0.0
        return max(0.0, latest[0] - oldest[0])

    def series(self):
        """Per-second data points for charting (the trend the reference
        plots in-browser with flot, vars_service.cpp ?series): list of
        (ts, value) — consecutive deltas for invertible reducers, raw
        samples otherwise."""
        samples = self._sampler.samples_in(self._window_size)
        if len(samples) < 2:
            return []
        if not getattr(self._reducer, "invertible", False):
            return [(ts, _plain(v)) for ts, v in samples]
        out = []
        for (t0, v0), (t1, v1) in zip(samples, samples[1:]):
            out.append((t1, _plain(v1 - v0)))
        return out

    def destroy(self):
        self._sampler.destroy()
        self.hide()


def _plain(v) -> float:
    """Collapse reducer values (incl. IntRecorder stats) to one number."""
    if hasattr(v, "average"):
        return float(v.average)
    try:
        return float(v)
    except (TypeError, ValueError):
        return 0.0


class PerSecond(Window):
    """Windowed delta divided by elapsed seconds (window.h:174-197)."""

    def series(self):
        samples = self._sampler.samples_in(self._window_size)
        out = []
        for (t0, v0), (t1, v1) in zip(samples, samples[1:]):
            dt = t1 - t0
            if dt <= 0:
                continue
            delta = v1 - v0
            if hasattr(delta, "sum"):  # IntRecorder: rate of the SUM,
                delta = delta.sum      # matching get_value's semantics
            out.append((t1, _plain(delta) / dt))
        return out

    def get_value(self):
        import time

        now = self._reducer.get_value()
        oldest = self._sampler.oldest_in(self._window_size)
        if oldest is None:
            return 0.0
        dt = time.monotonic() - oldest[0]
        if dt <= 0:
            return 0.0
        delta = now - oldest[1]
        if hasattr(delta, "sum"):  # IntRecorder _Stat
            delta = delta.sum
        return delta / dt
