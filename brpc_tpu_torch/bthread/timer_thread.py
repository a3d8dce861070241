"""TimerThread — the one thread that runs every timed callback.

Port of brpc_tpu/bthread/timer_thread.py: RPC deadlines, backup-request
timers, health checks and naming-service refreshes are scheduled here and
run on this thread. The reference spreads producers over 13 hashed
buckets; here one lock guards one min-heap, which is the same contract
for the few timers a client holds. ``unschedule`` is best effort, as in
the reference: a task already running is not stopped.
"""
from __future__ import annotations

import heapq
import itertools
import logging
import threading
import time
from typing import Callable, Dict, Optional

TimerId = int


class _Task:
    __slots__ = ("run_time", "seq", "fn", "args", "cancelled", "done")

    def __init__(self, run_time: float, seq: int, fn: Callable, args):
        self.run_time = run_time
        self.seq = seq
        self.fn = fn
        self.args = args
        self.cancelled = False
        self.done = False

    def __lt__(self, other: "_Task") -> bool:
        return (self.run_time, self.seq) < (other.run_time, other.seq)


class TimerThread:
    def __init__(self):
        self._heap: list = []
        self._tasks: Dict[TimerId, _Task] = {}
        self._seq = itertools.count(1)
        self._cond = threading.Condition()
        self._thread: Optional[threading.Thread] = None

    def schedule(self, fn: Callable, delay_s: float, *args) -> TimerId:
        """Run fn(*args) delay_s seconds from now; returns an id for
        unschedule()."""
        seq = next(self._seq)
        task = _Task(time.monotonic() + max(0.0, delay_s), seq, fn, args)
        with self._cond:
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, name="bthread_timer", daemon=True)
                self._thread.start()
            self._tasks[seq] = task
            heapq.heappush(self._heap, task)
            if self._heap[0] is task:
                self._cond.notify()
        return seq

    def unschedule(self, timer_id: TimerId) -> int:
        """0: cancelled; 1: already ran or running; -1: unknown id."""
        with self._cond:
            task = self._tasks.pop(timer_id, None)
            if task is None:
                return -1
            if task.done:
                return 1
            task.cancelled = True
            return 0

    def _run(self):
        while True:
            with self._cond:
                while True:
                    now = time.monotonic()
                    while self._heap and self._heap[0].cancelled:
                        heapq.heappop(self._heap)
                    if self._heap and self._heap[0].run_time <= now:
                        task = heapq.heappop(self._heap)
                        task.done = True
                        self._tasks.pop(task.seq, None)
                        break
                    wait = (self._heap[0].run_time - now if self._heap
                            else None)
                    self._cond.wait(wait)
            try:
                task.fn(*task.args)
            except Exception:
                logging.getLogger(__name__).exception("timer task raised")


_global_timer: Optional[TimerThread] = None
_global_timer_lock = threading.Lock()


def get_global_timer_thread() -> TimerThread:
    global _global_timer
    if _global_timer is None:
        with _global_timer_lock:
            if _global_timer is None:
                _global_timer = TimerThread()
    return _global_timer


def timer_add(delay_s: float, fn: Callable, *args) -> TimerId:
    """bthread_timer_add: run fn(*args) on the timer thread in delay_s."""
    return get_global_timer_thread().schedule(fn, delay_s, *args)


def timer_del(timer_id: TimerId) -> int:
    return get_global_timer_thread().unschedule(timer_id)
