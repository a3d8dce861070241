"""MultiDimension — one metric over label tuples.

Port of brpc_tpu/bvar/multi_dimension.py (bvar::MultiDimension):
``get_stats(*labels)`` makes the variable of a label combination on
first use; the value maps each label tuple to its variable's value, and
``/brpc_metrics`` shows each combination as one labelled sample.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Tuple

from brpc_tpu_torch.bvar.variable import Variable


class MultiDimension(Variable):
    def __init__(
        self,
        label_names: List[str],
        factory: Callable[[], Variable],
        name: Optional[str] = None,
    ):
        self._label_names = tuple(label_names)
        self._factory = factory
        self._stats: Dict[Tuple[str, ...], Variable] = {}
        self._lock = threading.Lock()
        super().__init__(name)

    def get_stats(self, *label_values: str) -> Variable:
        if len(label_values) != len(self._label_names):
            raise ValueError(
                f"expected {len(self._label_names)} labels, got {len(label_values)}"
            )
        key = tuple(str(v) for v in label_values)
        with self._lock:
            var = self._stats.get(key)
            if var is None:
                var = self._factory()
                self._stats[key] = var
            return var

    def has_stats(self, *label_values: str) -> bool:
        with self._lock:
            return tuple(str(v) for v in label_values) in self._stats

    def delete_stats(self, *label_values: str):
        with self._lock:
            self._stats.pop(tuple(str(v) for v in label_values), None)

    def count_stats(self) -> int:
        with self._lock:
            return len(self._stats)

    def get_value(self):
        """Dict of label-tuple -> scalar value; dump_prometheus renders each
        combination as one labelled sample."""
        with self._lock:
            items = list(self._stats.items())
        out = {}
        for key, var in items:
            labels = tuple(zip(self._label_names, key))
            out[labels] = var.get_value()
        return out
