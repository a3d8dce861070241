"""Service & method registry — how user code exposes RPC methods.

Port of brpc_tpu/rpc/service.py: a Service subclass declares methods with
``@rpc_method(Request, Response)`` (message classes of
``brpc_tpu_torch.rpc.proto.wire``), keeping brpc's CallMethod signature:

    @rpc_method(TensorPushRequest, TensorPushResponse)
    def Push(self, controller, request, response, done):
        ...
        done()

A service's methods in the order they are declared (a base class's
first) stand in for a .proto service's method indexes, which hulu
addresses methods by (``declared_methods``, ``declared_service``).
"""
from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Type


class MethodInfo(NamedTuple):
    name: str
    request_class: Type
    response_class: Type
    handler: Callable  # handler(self, cntl, req, res, done)


def rpc_method(request_class: Type, response_class: Type):
    """Mark a Service method as an RPC method."""

    def deco(fn):
        fn.__rpc_method__ = (request_class, response_class)
        return fn

    return deco


# service name -> the class declared last under it, in this process
_declared: Dict[str, type] = {}


def declared_service(name: str) -> Optional[type]:
    return _declared.get(name)


class Service:
    """Base class; service name defaults to the class name."""

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        _declared[cls.service_name()] = cls

    @classmethod
    def service_name(cls) -> str:
        return getattr(cls, "SERVICE_NAME", cls.__name__)

    @classmethod
    def declared_methods(cls) -> List[str]:
        """The RPC method names in declaration order, a base class's
        first; an override keeps its base's place."""
        rpc = cls.methods()
        names: List[str] = []
        for klass in reversed(cls.__mro__):
            for attr in vars(klass):
                if attr in rpc and attr not in names:
                    names.append(attr)
        return names

    @classmethod
    def methods(cls) -> Dict[str, MethodInfo]:
        out = {}
        for attr in dir(cls):
            fn = getattr(cls, attr, None)
            info = getattr(fn, "__rpc_method__", None)
            if info is not None:
                out[attr] = MethodInfo(attr, info[0], info[1], fn)
        return out


class ClosureGuard:
    """Runs done() on exit unless released (brpc::ClosureGuard)."""

    def __init__(self, done: Optional[Callable]):
        self._done = done

    def release(self):
        d, self._done = self._done, None
        return d

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self._done is not None:
            self._done()
            self._done = None

    def __del__(self):
        if self._done is not None:
            try:
                self._done()
            except Exception:
                pass
