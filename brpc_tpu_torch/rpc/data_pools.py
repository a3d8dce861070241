"""Session and thread data pools — user state lent to requests.

Port of brpc_tpu/rpc/data_pools.py: a server with a
``session_local_data_factory`` lends one object of its pool to each
request (``cntl.session_local_data``) and takes it back when the request
is done; ``ThreadLocalDataFactory`` keeps one object per worker thread.
"""
from __future__ import annotations

import threading
from typing import Callable, List, Optional


class DataFactory:
    """CreateData/DestroyData pair (data_factory.h)."""

    def __init__(self, create: Callable[[], object],
                 destroy: Optional[Callable[[object], None]] = None):
        self.create = create
        self.destroy = destroy or (lambda obj: None)


class SimpleDataPool:
    """Borrow/return pool with stats (simple_data_pool.h)."""

    def __init__(self, factory: DataFactory, reserve: int = 0):
        self._factory = factory
        self._free: List[object] = []
        self._lock = threading.Lock()
        self._created = 0
        for _ in range(reserve):
            self._free.append(factory.create())
            self._created += 1

    def borrow(self):
        with self._lock:
            if self._free:
                return self._free.pop()
            self._created += 1
        return self._factory.create()

    def return_(self, obj):
        if obj is None:
            return
        with self._lock:
            self._free.append(obj)

    @property
    def created_count(self) -> int:
        return self._created

    @property
    def free_count(self) -> int:
        return len(self._free)

    def destroy_all(self):
        with self._lock:
            for obj in self._free:
                self._factory.destroy(obj)
            self._free.clear()


class ThreadLocalDataFactory:
    """thread_local_data() of ServerOptions: one object per worker thread."""

    def __init__(self, factory: DataFactory):
        self._factory = factory
        self._tls = threading.local()

    def get(self):
        obj = getattr(self._tls, "obj", None)
        if obj is None:
            obj = self._factory.create()
            self._tls.obj = obj
        return obj
