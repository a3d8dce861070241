"""Variable — a named, exposable metric and the global registry.

Copy of the part of brpc_tpu/bvar/variable.py the client uses: a metric
exposed under a unique name and found by it. Hiding, bulk dumps, the
Prometheus text and the status variables come with the reference-grade
server."""
from __future__ import annotations

import threading
from typing import Dict, Optional

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

    @property
    def name(self) -> Optional[str]:
        return self._name

    def get_value(self):
        raise NotImplementedError


def find_exposed(name: str) -> Optional[Variable]:
    with _registry_lock:
        return _registry.get(name)
