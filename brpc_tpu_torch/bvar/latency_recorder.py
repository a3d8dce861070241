"""LatencyRecorder — qps, latency and percentiles from one update.

Port of brpc_tpu/bvar/latency_recorder.py: each ``update(latency_us)``
feeds the windowed average and maximum latency, the qps, the count and
the percentiles. Exposed under a name ``N`` as ``N_latency``,
``N_max_latency``, ``N_qps`` and ``N_count``; MethodStatus names one per
method (``TensorStore_Push``).
"""
from __future__ import annotations

from typing import Optional

from brpc_tpu_torch.bvar.percentile import Percentile
from brpc_tpu_torch.bvar.reducer import Adder, IntRecorder, Maxer
from brpc_tpu_torch.bvar.sampler import Sampler
from brpc_tpu_torch.bvar.window import PerSecond, Window


class LatencyRecorder:
    def __init__(self, name: Optional[str] = None, window_size: int = 10):
        self._latency = IntRecorder()
        self._max_latency = Maxer()
        self._count = Adder()
        self._latency_window = Window(self._latency, window_size)
        self._max_window = Window(self._max_latency, window_size)
        self._qps_window = PerSecond(self._count, window_size)
        self._percentile = Percentile(window_size)
        self._percentile_sampler = Sampler(self._rotate_percentile, window_size)
        if name:
            self.expose(name)

    def _rotate_percentile(self):
        self._percentile.rotate()

    def expose(self, name: str):
        self._latency_window.expose(f"{name}_latency")
        self._max_window.expose(f"{name}_max_latency")
        self._qps_window.expose(f"{name}_qps")
        self._count.expose(f"{name}_count")

    # -- hot path ----------------------------------------------------------
    def update(self, latency_us: float):
        self._latency.update(latency_us)
        self._max_latency.update(latency_us)
        self._count.update(1)
        self._percentile.update(latency_us)

    __lshift__ = update

    # -- reads -------------------------------------------------------------
    def latency(self) -> float:
        """Window-averaged latency (us)."""
        v = self._latency_window.get_value()
        return v.average if hasattr(v, "average") else 0.0

    def max_latency(self) -> float:
        return self._max_window.get_value()

    def qps(self) -> float:
        return self._qps_window.get_value()

    def count(self) -> int:
        return self._count.get_value()

    def latency_percentile(self, ratio: float) -> float:
        return self._percentile.get_number(ratio)

    def describe(self) -> str:
        return (
            f"count={self.count()} qps={self.qps():.1f} "
            f"avg={self.latency():.1f}us max={self.max_latency():.0f}us "
            f"{self._percentile.describe()}"
        )
