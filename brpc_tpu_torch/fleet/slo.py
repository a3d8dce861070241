"""SLO burn rates over merged latency and error streams.

Port of brpc_tpu/fleet/slo.py. An objective is a latency ceiling or an
error budget, evaluated as multi-window burn rates: burn = (observed bad
fraction / budgeted bad fraction) over a window, and an alert fires only
when both the fast window (5 min by default) and the slow window (1 h)
exceed their thresholds; it clears when either recovers.

``SloEngine.ingest(merged, now)`` takes a rollup (``methods`` keyed
"lane/Service.Method" with count, errors and log2 buckets); latency
objectives count bad samples off the merged buckets
(``hist.fraction_above``). Windows are on the caller's clock: ``now``
(default ``time.time()``) stamps each rollup, so a test or a second-long
window runs on a timeline of its own. Cumulative counts that shrink (a
backend restarted) give a delta of zero, not a negative one.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from brpc_tpu_torch.fleet import hist as _hist


@dataclass
class SloObjective:
    """One declarative objective.

    kind="latency": requests slower than ``ceiling_ms`` are bad; the
    budget is the allowed bad fraction (0.001 = "99.9% under ceiling").
    kind="errors": completions with a nonzero error are bad.

    ``method`` scopes to one merged (lane, method) stream ("lane/Service.
    Method" keys as the observatory merges them); None aggregates every
    method of ``lane``.
    """

    name: str
    kind: str = "latency"  # "latency" | "errors"
    lane: str = "echo"
    method: Optional[str] = None  # "EchoService.Echo" or None = whole lane
    ceiling_ms: float = 100.0  # latency objectives only
    budget: float = 0.001  # allowed bad fraction of the stream
    fast_window_s: float = 300.0  # 5m
    slow_window_s: float = 3600.0  # 1h
    fast_burn: float = 14.4  # SRE-workbook 5m/1h page thresholds
    slow_burn: float = 6.0

    def __post_init__(self):
        if self.kind not in ("latency", "errors"):
            raise ValueError(f"unknown SLO kind {self.kind!r}")
        if not 0.0 < self.budget < 1.0:
            raise ValueError("budget must be a fraction in (0, 1)")


@dataclass
class _ObjState:
    # ring of (ts, cumulative_total, cumulative_bad) merged samples;
    # bounded by the slow window (plus one sample past its edge)
    samples: deque = field(default_factory=deque)
    alert: bool = False
    fired_total: int = 0
    cleared_total: int = 0
    fast: float = 0.0
    slow: float = 0.0
    bad_total: float = 0.0
    stream_total: float = 0.0


class SloEngine:
    """Evaluates objectives against successive merged rollups."""

    def __init__(self, objectives: List[SloObjective]):
        names = [o.name for o in objectives]
        if len(set(names)) != len(names):
            raise ValueError("duplicate SLO objective names")
        self._objectives = list(objectives)
        self._lock = threading.Lock()
        self._state: Dict[str, _ObjState] = {
            o.name: _ObjState() for o in objectives}

    @property
    def objectives(self) -> List[SloObjective]:
        return list(self._objectives)

    # -- ingestion ---------------------------------------------------------
    def ingest(self, merged: dict, now: Optional[float] = None):
        """Feed one merged rollup (the observatory's ``merged()`` dict:
        ``methods`` keyed "lane/Service.Method" with count/errors/
        buckets). Cheap: one pass per objective."""
        ts = time.time() if now is None else now
        with self._lock:
            for obj in self._objectives:
                st = self._state[obj.name]
                tot, bad = self._measure(obj, merged)
                st.samples.append((ts, tot, bad))
                self._trim(st.samples, ts, obj.slow_window_s)
                st.fast = self._burn(st.samples, ts, obj.fast_window_s,
                                     obj.budget)
                st.slow = self._burn(st.samples, ts, obj.slow_window_s,
                                     obj.budget)
                st.stream_total = tot
                st.bad_total = bad
                firing = (st.fast >= obj.fast_burn and
                          st.slow >= obj.slow_burn)
                if firing and not st.alert:
                    st.alert = True
                    st.fired_total += 1
                elif not firing and st.alert:
                    st.alert = False
                    st.cleared_total += 1

    @staticmethod
    def _measure(obj: SloObjective, merged: dict) -> Tuple[float, float]:
        """Cumulative (total, bad) of the objective's stream from one
        merged rollup."""
        methods = merged.get("methods", {})
        prefix = f"{obj.lane}/"
        rows = [r for key, r in methods.items()
                if key.startswith(prefix) and
                (obj.method is None or key == prefix + obj.method)]
        if obj.kind == "errors":
            tot = float(sum(r.get("count", 0) for r in rows))
            bad = float(sum(r.get("errors", 0) for r in rows))
            return tot, bad
        buckets = _hist.merge(*[r.get("buckets", []) for r in rows]) \
            if rows else [0] * _hist.NBUCKETS
        bad, tot = _hist.fraction_above(buckets,
                                        obj.ceiling_ms * 1e6)
        return float(tot), bad

    @staticmethod
    def _trim(samples: deque, ts: float, slow_window_s: float):
        # keep ONE sample at/past the slow-window edge so the slow burn
        # always has a baseline older than its window
        edge = ts - slow_window_s
        while len(samples) >= 2 and samples[1][0] <= edge:
            samples.popleft()

    @staticmethod
    def _burn(samples: deque, ts: float, window_s: float,
              budget: float) -> float:
        """Burn rate over [ts - window_s, ts]: bad-fraction of the
        window's new samples over the budgeted fraction. Deltas clamp at
        zero (backend restarts shrink cumulative merged counts)."""
        if len(samples) < 2:
            return 0.0
        edge = ts - window_s
        base = samples[0]
        for s in samples:
            if s[0] > edge:
                break
            base = s
        cur = samples[-1]
        d_tot = max(0.0, cur[1] - base[1])
        d_bad = max(0.0, cur[2] - base[2])
        if d_tot <= 0.0:
            return 0.0
        return (d_bad / d_tot) / budget

    # -- readout -----------------------------------------------------------
    def status(self) -> Dict[str, dict]:
        """Per-objective readout: burn rates, alert state, transition
        totals — the /fleet SLO section and the fleet_slo_* bvar rows."""
        out = {}
        with self._lock:
            for obj in self._objectives:
                st = self._state[obj.name]
                out[obj.name] = {
                    "kind": obj.kind,
                    "lane": obj.lane,
                    "method": obj.method,
                    "ceiling_ms": obj.ceiling_ms,
                    "budget": obj.budget,
                    "fast_burn": round(st.fast, 3),
                    "slow_burn": round(st.slow, 3),
                    "fast_threshold": obj.fast_burn,
                    "slow_threshold": obj.slow_burn,
                    "alert": st.alert,
                    "fired_total": st.fired_total,
                    "cleared_total": st.cleared_total,
                    "stream_total": st.stream_total,
                    "bad_total": round(st.bad_total, 1),
                }
        return out

    def alerts_fired_total(self) -> int:
        with self._lock:
            return sum(s.fired_total for s in self._state.values())

    def alerts_cleared_total(self) -> int:
        with self._lock:
            return sum(s.cleared_total for s in self._state.values())
