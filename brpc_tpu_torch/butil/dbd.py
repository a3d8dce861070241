"""DoublyBufferedData — read-mostly data with near-lock-free reads.

Copy of brpc_tpu/butil/dbd.py: readers take only their own thread's
mutex and read the foreground copy; ``modify`` changes the background
copy, flips the two, waits out every reader of the old foreground by
taking each reader mutex once, and applies the change again. The load
balancers keep their server lists in one.
"""
from __future__ import annotations

import threading
from typing import Callable, Generic, List, TypeVar

T = TypeVar("T")


class _ReaderTls:
    __slots__ = ("lock",)

    def __init__(self):
        self.lock = threading.Lock()


class DoublyBufferedData(Generic[T]):
    def __init__(self, factory: Callable[[], T]):
        self._data: List[T] = [factory(), factory()]
        self._fg_index = 0
        self._modify_lock = threading.Lock()
        self._readers_lock = threading.Lock()
        self._readers: List[_ReaderTls] = []
        self._tls = threading.local()

    def _reader(self) -> _ReaderTls:
        r = getattr(self._tls, "r", None)
        if r is None:
            r = _ReaderTls()
            self._tls.r = r
            with self._readers_lock:
                self._readers.append(r)
        return r

    class _ScopedPtr(Generic[T]):
        __slots__ = ("data", "_lock")

        def __init__(self, data: T, lock: threading.Lock):
            self.data = data
            self._lock = lock

        def __enter__(self) -> T:
            return self.data

        def __exit__(self, *exc):
            self._lock.release()
            return False

    def read(self) -> "DoublyBufferedData._ScopedPtr[T]":
        """``with dbd.read() as value: ...``"""
        r = self._reader()
        r.lock.acquire()
        return self._ScopedPtr(self._data[self._fg_index], r.lock)

    def modify(self, fn: Callable[[T], object]):
        """Apply ``fn`` to both copies with a flip in between; ``fn`` must
        give the same result on either copy."""
        with self._modify_lock:
            bg = 1 - self._fg_index
            fn(self._data[bg])
            self._fg_index = bg
            with self._readers_lock:
                readers = list(self._readers)
            for r in readers:
                r.lock.acquire()
                r.lock.release()
            fn(self._data[1 - bg])
