"""Variable — a named, exposable metric and the global registry.

Copy of the part of brpc_tpu/bvar/variable.py the port uses: a metric
exposed under a unique name, found by it, listed, counted, hidden, and
dumped in bulk (``dump_exposed``, the body of ``/vars``) or as
Prometheus text (``dump_prometheus``, the body of ``/brpc_metrics``);
``PassiveStatus`` computes its value with a callback. Left out: the
set-by-hand status variable, which nothing of the port sets.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Tuple

_registry: "Dict[str, Variable]" = {}
_registry_lock = threading.Lock()


class Variable:
    """Base of all metrics; subclasses implement get_value()."""

    def __init__(self, name: Optional[str] = None):
        self._name: Optional[str] = None
        if name:
            self.expose(name)

    def expose(self, name: str) -> bool:
        """False when another variable holds the name."""
        name = name.strip().replace(" ", "_")
        with _registry_lock:
            if name in _registry and _registry[name] is not self:
                return False
            if self._name and self._name != name:
                _registry.pop(self._name, None)
            _registry[name] = self
            self._name = name
            return True

    def hide(self) -> bool:
        with _registry_lock:
            if self._name and _registry.get(self._name) is self:
                del _registry[self._name]
                self._name = None
                return True
            return False

    @property
    def name(self) -> Optional[str]:
        return self._name

    def get_value(self):
        raise NotImplementedError

    def describe(self) -> str:
        return str(self.get_value())


class PassiveStatus(Variable):
    """A value computed by a callback when read."""

    def __init__(self, callback: Callable[[], object],
                 name: Optional[str] = None):
        self._callback = callback
        super().__init__(name)

    def get_value(self):
        return self._callback()


def find_exposed(name: str) -> Optional[Variable]:
    with _registry_lock:
        return _registry.get(name)


def list_exposed() -> List[str]:
    with _registry_lock:
        return sorted(_registry.keys())


def count_exposed() -> int:
    with _registry_lock:
        return len(_registry)


def dump_exposed(filter_fn: Optional[Callable[[str], bool]] = None
                 ) -> List[Tuple[str, object]]:
    """(name, value) of every exposed variable, sorted by name."""
    with _registry_lock:
        items = list(_registry.items())
    out = []
    for name, var in sorted(items):
        if filter_fn and not filter_fn(name):
            continue
        try:
            out.append((name, var.get_value()))
        except Exception as e:  # a broken callback must not break the dump
            out.append((name, f"<error: {e}>"))
    return out


def _prom_label_escape(val) -> str:
    """Prometheus label-value escaping: backslash, double quote and
    newline."""
    return (str(val).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def dump_prometheus() -> str:
    """Prometheus text of every exposed scalar variable, and of every
    variable whose value maps label tuples to scalars."""
    lines = []
    for name, value in dump_exposed():
        metric = name.replace("-", "_").replace(".", "_").replace("/", "_")
        if isinstance(value, bool):
            value = int(value)
        if isinstance(value, (int, float)):
            lines.append(f"# TYPE {metric} gauge")
            lines.append(f"{metric} {value}")
        elif isinstance(value, dict):
            lines.append(f"# TYPE {metric} gauge")
            for labels, v in value.items():
                if isinstance(v, (int, float)):
                    label_s = ",".join(
                        f'{k}="{_prom_label_escape(val)}"'
                        for k, val in labels)
                    lines.append(f"{metric}{{{label_s}}} {v}")
    return "\n".join(lines) + "\n"
