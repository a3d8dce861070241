"""flags — the runtime configuration registry.

Copy of the subset of brpc_tpu/butil/flags.py that the port needs: typed
flags defined once, read with ``get_flag``, edited live with ``set_flag``,
and an environment override ``BRPC_TPU_<NAME>`` read when the flag is
defined. An unparsable or rejected override keeps the default. The tensor
lane defines its flags in device_transport.py, the circuit breaker its
own in circuit_breaker.py, with the reference's defaults.
"""
from __future__ import annotations

import logging
import os
import threading
from typing import Any, Callable, Dict, Optional


class Flag:
    __slots__ = ("name", "value", "default", "help", "type", "validator",
                 "reloadable")

    def __init__(self, name, value, help_, type_, validator, reloadable):
        self.name = name
        self.value = value
        self.default = value
        self.help = help_
        self.type = type_
        self.validator = validator
        self.reloadable = reloadable


_registry: Dict[str, Flag] = {}
_lock = threading.Lock()


def _parse(text: str, type_: type) -> Any:
    if type_ is bool:
        return text.lower() in ("1", "true", "yes", "on")
    return type_(text)


def _define(name: str, default: Any, help_: str, type_: type,
            validator: Optional[Callable[[Any], bool]] = None,
            reloadable: bool = True) -> Flag:
    with _lock:
        if name in _registry:
            raise ValueError(f"flag {name!r} already defined")
        env = os.environ.get("BRPC_TPU_" + name.upper())
        value = default
        if env is not None:
            try:
                parsed = _parse(env, type_)
            except ValueError:
                logging.getLogger(__name__).warning(
                    "ignoring unparsable env override for flag %s: %r",
                    name, env)
            else:
                if validator is None or validator(parsed):
                    value = parsed
        f = Flag(name, value, help_, type_, validator, reloadable)
        _registry[name] = f
        return f


def define_int(name: str, default: int, help_: str = "", **kw) -> Flag:
    return _define(name, int(default), help_, int, **kw)


def define_bool(name: str, default: bool, help_: str = "", **kw) -> Flag:
    return _define(name, bool(default), help_, bool, **kw)


def get_flag(name: str) -> Any:
    return _registry[name].value


def set_flag(name: str, value: Any) -> bool:
    """Live update. False if the flag is unknown, not reloadable, or fails
    validation."""
    with _lock:
        f = _registry.get(name)
        if f is None or not f.reloadable:
            return False
        if isinstance(value, str):
            try:
                value = _parse(value, f.type)
            except ValueError:
                return False
        if f.validator is not None and not f.validator(value):
            return False
        f.value = value
        return True
