"""bthread — the concurrency layer: the work-stealing task scheduler with
idle hooks, butex wait and wake, the timer thread, versioned call ids,
execution queues, and the mutex, condition and countdown event built on
butex, as in brpc_tpu/bthread.
"""
from __future__ import annotations

import threading
import time
from typing import Optional

from brpc_tpu_torch.bthread import id as bthread_id  # noqa: F401
from brpc_tpu_torch.bthread.butex import (  # noqa: F401
    Butex,
    butex_create,
    butex_wait,
    butex_wake,
    butex_wake_all,
)
from brpc_tpu_torch.bthread.execution_queue import (  # noqa: F401
    ExecutionQueue,
    TaskIterator,
    execution_queue_start,
)
from brpc_tpu_torch.bthread.parking_lot import ParkingLot  # noqa: F401
from brpc_tpu_torch.bthread.task_control import (  # noqa: F401
    TaskControl,
    TaskGroup,
    bthread_join,
    get_task_control,
    start_background,
    start_urgent,
)
from brpc_tpu_torch.bthread.timer_thread import (  # noqa: F401
    TimerThread,
    get_global_timer_thread,
    timer_add,
    timer_del,
)
from brpc_tpu_torch.bthread.work_stealing_queue import WorkStealingQueue  # noqa: F401


def usleep(us: float):
    """bthread_usleep — parks the calling (worker) thread."""
    time.sleep(us / 1e6)


def fd_wait(fd: int, events: str = "r", timeout_s: Optional[float] = None) -> bool:
    """bthread_fd_wait (bthread/fd.cpp:119-170): block the calling task
    until fd is readable ('r') / writable ('w'). True if ready, False on
    timeout."""
    import select

    r = [fd] if "r" in events else []
    w = [fd] if "w" in events else []
    rr, ww, _ = select.select(r, w, [], timeout_s)
    return bool(rr or ww)


def connect(address, timeout_s: float = 1.0):
    """bthread_connect (fd.cpp): blocking-in-task TCP connect returning a
    connected non-blocking socket, or raising OSError."""
    import socket as pysocket

    s = pysocket.create_connection(address, timeout=timeout_s)
    s.setblocking(False)
    return s


class Mutex:
    """bthread_mutex built on butex (bthread/mutex.cpp shape): the lock word
    is the butex value (0 free, 1 locked no waiters, 2 contended)."""

    def __init__(self):
        self._butex = Butex(0)
        self._guard = threading.Lock()

    def lock(self):
        while True:
            with self._guard:
                if self._butex.value == 0:
                    self._butex.value = 1
                    return
                self._butex.value = 2
            self._butex.wait(2, timeout=0.05)

    def unlock(self):
        with self._guard:
            contended = self._butex.value == 2
            self._butex.value = 0
        if contended:
            self._butex.wake(1)

    def __enter__(self):
        self.lock()
        return self

    def __exit__(self, *exc):
        self.unlock()


class Cond:
    """bthread_cond: seq-count butex; broadcast requeues to the mutex
    (bthread/condition_variable.cpp shape)."""

    def __init__(self):
        self._butex = Butex(0)

    def wait(self, mutex: Mutex, timeout: Optional[float] = None) -> bool:
        expected = self._butex.value
        mutex.unlock()
        woke = self._butex.wait(expected, timeout)
        mutex.lock()
        return woke

    def signal(self):
        self._butex.value += 1
        self._butex.wake(1)

    def broadcast(self):
        self._butex.value += 1
        self._butex.wake_all()


class CountdownEvent:
    """bthread::CountdownEvent (countdown_event.h)."""

    def __init__(self, initial_count: int = 1):
        self._butex = Butex(initial_count)
        self._lock = threading.Lock()

    def signal(self, sig: int = 1):
        with self._lock:
            self._butex.value -= sig
            done = self._butex.value <= 0
        if done:
            self._butex.wake_all()

    def add_count(self, v: int = 1):
        with self._lock:
            self._butex.value += v

    def wait(self, timeout: Optional[float] = None) -> bool:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._lock:
                current = self._butex.value
            if current <= 0:
                return True
            remain = None if deadline is None else deadline - time.monotonic()
            if remain is not None and remain <= 0:
                return False
            self._butex.wait(current, remain)


_key_registry: dict = {}
_key_lock = threading.Lock()
_next_key = [1]
_tls = threading.local()


def key_create(destructor=None) -> int:
    """bthread_key_create (bthread/key.cpp)."""
    with _key_lock:
        key = _next_key[0]
        _next_key[0] += 1
        _key_registry[key] = destructor
        return key


def setspecific(key: int, value):
    store = getattr(_tls, "store", None)
    if store is None:
        store = {}
        _tls.store = store
    store[key] = value


def getspecific(key: int):
    store = getattr(_tls, "store", None)
    return None if store is None else store.get(key)
