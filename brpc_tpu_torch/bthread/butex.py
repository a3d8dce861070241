"""butex — futex-shaped wait and wake on one word.

Port of brpc_tpu/bthread/butex.py: ``wait`` blocks only while the word
still equals the expected value (checked under the wait-queue lock, so a
change followed by a wake cannot be missed); ``wake`` wakes waiters;
``requeue`` wakes one and moves the rest to another butex. Every waiter
is a thread (the reference's pthread-waiter path). Mutex, Cond,
CountdownEvent and task join stand on it.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Deque, Optional


class _Waiter:
    __slots__ = ("event", "butex")

    def __init__(self, butex: "Butex"):
        self.event = threading.Event()
        self.butex: Optional[Butex] = butex  # None once woken/requeued-out


class Butex:
    __slots__ = ("value", "_waiters", "_lock")

    def __init__(self, value: int = 0):
        self.value = value
        self._waiters: Deque[_Waiter] = deque()
        self._lock = threading.Lock()

    def wait(self, expected_value: int, timeout: Optional[float] = None) -> bool:
        """Block until woken, if value == expected_value at entry.

        Returns False immediately (EWOULDBLOCK) if the value already moved;
        True if woken; False on timeout.
        """
        with self._lock:
            if self.value != expected_value:
                return False
            w = _Waiter(self)
            self._waiters.append(w)
        ok = w.event.wait(timeout)
        if not ok:
            # Timed out: remove self unless a concurrent wake already took us.
            with self._lock:
                if w.butex is self:
                    try:
                        self._waiters.remove(w)
                    except ValueError:
                        pass
                    w.butex = None
        return ok

    def wake(self, n: int = 1) -> int:
        """Wake up to n waiters (butex_wake / butex_wake_all)."""
        woken = 0
        with self._lock:
            while self._waiters and woken < n:
                w = self._waiters.popleft()
                w.butex = None
                w.event.set()
                woken += 1
        return woken

    def wake_all(self) -> int:
        return self.wake(1 << 30)

    def requeue(self, dest: "Butex") -> int:
        """Wake one waiter, move the rest to dest (butex_requeue,
        butex.h:58) — the primitive behind Cond::broadcast without a
        thundering herd."""
        first, moved = None, []
        with self._lock:
            if self._waiters:
                first = self._waiters.popleft()
                first.butex = None
            while self._waiters:
                w = self._waiters.popleft()
                moved.append(w)
        if moved:
            with dest._lock:
                for w in moved:
                    w.butex = dest
                dest._waiters.extend(moved)
        if first is not None:
            first.event.set()
            return 1 + len(moved)
        return len(moved)


def butex_create(value: int = 0) -> Butex:
    return Butex(value)


def butex_wait(b: Butex, expected_value: int, timeout: Optional[float] = None) -> bool:
    return b.wait(expected_value, timeout)


def butex_wake(b: Butex, n: int = 1) -> int:
    return b.wake(n)


def butex_wake_all(b: Butex) -> int:
    return b.wake_all()
