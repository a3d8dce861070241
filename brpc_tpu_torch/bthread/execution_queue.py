"""ExecutionQueue — many producers, one consumer at a time, in batches.

Port of brpc_tpu/bthread/execution_queue.py (bthread::ExecutionQueue):
producers ``execute`` tasks; at most one consumer runs, draining a batch
of at most ``batch_size`` through a TaskIterator; high-priority tasks go
first. After ``stop`` the tasks accepted before it are drained, then one
final empty iterator reports ``is_queue_stopped``; a negative return from
the consumer function stops the queue too. Streams deliver their frames
to the user's handler through one.
"""
from __future__ import annotations

import logging
import threading
from collections import deque
from typing import Callable, Deque, Iterator, Optional


class TaskIterator:
    """The batch handed to the consumer function."""

    def __init__(self, tasks, stopped: bool):
        self._tasks = tasks
        self._stopped = stopped

    def __iter__(self) -> Iterator:
        return iter(self._tasks)

    def is_queue_stopped(self) -> bool:
        return self._stopped


class ExecutionQueue:
    def __init__(self, execute_fn: Callable[[TaskIterator], int],
                 scheduler: Optional[Callable] = None, batch_size: int = 256):
        """execute_fn(iterator) -> int; a negative return stops the queue.
        scheduler(fn) runs fn later; by default a task of the port's
        task control (``start_background``)."""
        self._execute_fn = execute_fn
        self._tasks: Deque = deque()
        self._high_tasks: Deque = deque()
        self._lock = threading.Lock()
        self._running = False  # one consumer at a time
        self._stopped = False
        self._joined = threading.Event()
        self._batch_size = batch_size
        if scheduler is None:
            from brpc_tpu_torch.bthread.task_control import start_background

            scheduler = start_background
        self._schedule = scheduler

    def execute(self, task, high_priority: bool = False) -> bool:
        """Queue a task; False once the queue is stopped."""
        with self._lock:
            if self._stopped:
                return False
            (self._high_tasks if high_priority else self._tasks).append(task)
            if self._running:
                return True
            self._running = True
        self._schedule(self._consume)
        return True

    def _consume(self):
        while True:
            with self._lock:
                batch = []
                while self._high_tasks and len(batch) < self._batch_size:
                    batch.append(self._high_tasks.popleft())
                while self._tasks and len(batch) < self._batch_size:
                    batch.append(self._tasks.popleft())
                stopped = self._stopped
                if not batch and not stopped:
                    self._running = False
                    return
            # only the final, empty batch after stop() says the queue stopped
            rc = 0
            try:
                rc = self._execute_fn(
                    TaskIterator(batch, stopped and not batch)) or 0
            except Exception:
                logging.getLogger(__name__).exception(
                    "execution queue consumer raised")
            if (stopped and not batch) or rc < 0:
                with self._lock:
                    self._stopped = True
                    self._running = False
                self._joined.set()
                return

    def stop(self):
        """Accept no more tasks; the consumer gets one final stopped run."""
        with self._lock:
            self._stopped = True
            if self._running:
                return
            self._running = True
        self._schedule(self._consume)

    def join(self, timeout: Optional[float] = None) -> bool:
        """Wait until the queue stopped and its last batch ran; False when
        ``timeout`` seconds pass first."""
        return self._joined.wait(timeout)


def execution_queue_start(execute_fn, **kw) -> ExecutionQueue:
    return ExecutionQueue(execute_fn, **kw)
