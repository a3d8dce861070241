"""TaskControl / TaskGroup — the worker fleet of the scheduler.

Port of brpc_tpu/bthread/task_control.py: TaskControl owns N worker
threads, each running a TaskGroup loop over a local work-stealing deque
``_rq``, a ``_remote_rq`` fed by other threads and a ``_bound_rq`` of
tasks pinned to the group (never stolen). An idle worker runs the
registered idle hooks, optionally busy-polls (``worker_polling_time_us``),
steals every ``steal_task_rnd`` rounds, then parks on its own lot.

A task is a callable run to completion on a worker (brpc's
pthread-compatible mode): a task that blocks parks its worker. The
workers are daemon threads, started by the first task or the first
``init``, so importing this module starts nothing.
"""
from __future__ import annotations

import random
import threading
from collections import deque
from typing import Callable, Dict, List, Optional

from brpc_tpu_torch import bvar
from brpc_tpu_torch.bthread.parking_lot import ParkingLot
from brpc_tpu_torch.bthread.work_stealing_queue import WorkStealingQueue
from brpc_tpu_torch.butil import flags

# the idle loop's knobs, with the reference's defaults
flags.define_int("worker_polling_time_us", 0,
                 "busy-poll this long before parking an idle worker")
flags.define_int("steal_task_rnd", 1,
                 "steal every N idle rounds (1 = every round)")


class TaskMeta:
    __slots__ = ("fn", "args", "tid", "joined", "about_to_quit")

    def __init__(self, fn: Callable, args, tid: int):
        self.fn = fn
        self.args = args
        self.tid = tid
        self.joined = threading.Event()
        self.about_to_quit = False


class TaskGroup:
    def __init__(self, control: "TaskControl", group_id: int):
        self.control = control
        self.group_id = group_id
        self._rq = WorkStealingQueue()
        self._remote_rq: deque = deque()
        self._remote_lock = threading.Lock()
        self._bound_rq: deque = deque()  # group-pinned, never stolen
        self._bound_lock = threading.Lock()
        # fork: one parking lot per worker for precise wakeup
        self.parking_lot = ParkingLot()
        self.nswitch = 0

    # -- producers ---------------------------------------------------------
    def push_local(self, meta: TaskMeta):
        if not self._rq.push(meta):
            self.push_remote(meta)

    def push_remote(self, meta: TaskMeta):
        with self._remote_lock:
            self._remote_rq.append(meta)
        self.parking_lot.signal(1)

    def push_bound(self, meta: TaskMeta):
        """ready_to_run_bound (fork): pin a task to this group."""
        with self._bound_lock:
            self._bound_rq.append(meta)
        self.parking_lot.signal(1)

    # -- consumer ----------------------------------------------------------
    def _next_task(self, steal: bool = True) -> Optional[TaskMeta]:
        with self._bound_lock:
            if self._bound_rq:
                return self._bound_rq.popleft()
        meta = self._rq.pop()
        if meta is not None:
            return meta
        with self._remote_lock:
            if self._remote_rq:
                return self._remote_rq.popleft()
        if not steal:
            return None
        return self.control.steal_task(self.group_id)

    def run_main_task(self):
        """Worker main loop (task_group.cpp:238-270 + wait_task 139-232,
        including the fork's busy-poll window and steal frequency)."""
        import time as _time

        control = self.control
        idle_rounds = 0
        while not control._stopping:
            steal_rnd = max(1, flags.get_flag("steal_task_rnd"))
            meta = self._next_task(
                steal=(idle_rounds % steal_rnd == 0))
            if meta is None:
                idle_rounds += 1
                # Idle: run registered hooks (a completion poll, an external
                # processor), busy-poll if configured, then park on this lot.
                did_work = False
                for hook in control.idle_hooks:
                    try:
                        did_work |= bool(hook())
                    except Exception:
                        pass
                if did_work:
                    continue
                poll_us = flags.get_flag("worker_polling_time_us")
                if poll_us > 0:
                    deadline = _time.monotonic() + poll_us / 1e6
                    polled = None
                    while _time.monotonic() < deadline:
                        polled = self._next_task()
                        if polled is not None:
                            break
                    if polled is not None:
                        meta = polled
                    else:
                        continue
                if meta is None:
                    expected = self.parking_lot.get_state()
                    if (self._rq.empty() and not self._remote_rq
                            and not self._bound_rq):
                        self.parking_lot.wait(expected, timeout=0.1)
                    continue
            idle_rounds = 0
            self.nswitch += 1
            control._nswitch_var.update(1)
            try:
                meta.fn(*meta.args)
            except Exception:
                import logging

                logging.getLogger(__name__).exception("bthread raised")
            finally:
                meta.joined.set()
                # Detached-by-default reap (bthread_start_background tasks
                # are detached unless joined): tids are never reused, so a
                # later join() of a reaped tid correctly reports finished.
                control._metas.pop(meta.tid, None)
                control._finished_var.update(1)


class TaskControl:
    def __init__(self, concurrency: int = 4):
        self.concurrency = max(1, concurrency)
        self.groups: List[TaskGroup] = []
        self._threads: List[threading.Thread] = []
        self._stopping = False
        self._init_lock = threading.Lock()
        self._started = False
        self._next_tid = 1
        self._tid_lock = threading.Lock()
        self.idle_hooks: List[Callable[[], bool]] = []
        self._metas: Dict[int, TaskMeta] = {}
        # the steal start draws from a generator of its own: idle workers
        # steal ten times a second, and draws from the global ``random``
        # would move every seeded sequence of the process under its feet
        self._steal_rng = random.Random()
        # bvar instrumentation mirroring task_control.h:111-121
        self._nswitch_var = bvar.Adder("bthread_switch_count")
        self._finished_var = bvar.Adder("bthread_count_finished")
        bvar.PassiveStatus(lambda: len(self._threads), "bthread_worker_count")
        bvar.PassiveStatus(self._queued_count, "bthread_queued_count")

    def _queued_count(self) -> int:
        return sum(
            len(g._rq) + len(g._remote_rq) + len(g._bound_rq)
            for g in self.groups
        )

    def init(self):
        with self._init_lock:
            if self._started:
                return
            for i in range(self.concurrency):
                g = TaskGroup(self, i)
                self.groups.append(g)
            for g in self.groups:
                t = threading.Thread(
                    target=g.run_main_task, name=f"bthread_worker_{g.group_id}",
                    daemon=True,
                )
                t.start()
                self._threads.append(t)
            self._started = True

    def add_idle_hook(self, hook: Callable[[], bool]):
        """Register work for the idle loop (the fork's ext-processor seam,
        task_group.h:223-228). hook() returns True if it did work."""
        self.idle_hooks.append(hook)

    # -- spawn -------------------------------------------------------------
    def start_background(self, fn: Callable, *args) -> int:
        """bthread_start_background: queue to a group, signal its lot."""
        self.init()
        with self._tid_lock:
            tid = self._next_tid
            self._next_tid += 1
        meta = TaskMeta(fn, args, tid)
        self._metas[tid] = meta
        group = self.groups[tid % len(self.groups)]
        group.push_remote(meta)
        return tid

    def start_urgent(self, fn: Callable, *args) -> int:
        """bthread_start_urgent: jumps ahead via the bound lane."""
        self.init()
        with self._tid_lock:
            tid = self._next_tid
            self._next_tid += 1
        meta = TaskMeta(fn, args, tid)
        self._metas[tid] = meta
        group = self.groups[tid % len(self.groups)]
        group.push_bound(meta)
        return tid

    def join(self, tid: int, timeout: Optional[float] = None) -> bool:
        meta = self._metas.get(tid)
        if meta is None:
            return True
        ok = meta.joined.wait(timeout)
        if ok:
            self._metas.pop(tid, None)
        return ok

    def steal_task(self, thief_group_id: int) -> Optional[TaskMeta]:
        """Steal from a random victim's local queue (task_control.h:55);
        bound queues are exempt by construction."""
        n = len(self.groups)
        if n <= 1:
            return None
        start = self._steal_rng.randrange(n)
        for i in range(n):
            victim = self.groups[(start + i) % n]
            if victim.group_id == thief_group_id:
                continue
            meta = victim._rq.steal()
            if meta is not None:
                return meta
            # Remote queues are stealable too (task_control.cpp steal_task
            # covers _remote_rq) — otherwise tasks assigned to a worker
            # blocked in user code would starve.
            with victim._remote_lock:
                if victim._remote_rq:
                    return victim._remote_rq.popleft()
        return None

    def stop_and_join(self):
        self._stopping = True
        for g in self.groups:
            g.parking_lot.stop()
        for t in self._threads:
            t.join(timeout=2.0)


_control: Optional[TaskControl] = None
_control_lock = threading.Lock()


def get_task_control(concurrency: Optional[int] = None) -> TaskControl:
    global _control
    if _control is None:
        with _control_lock:
            if _control is None:
                import os

                # Workers here block in user code (pthread-mode bthreads),
                # so size generously — IO/sleep-bound, not CPU-bound.
                default = max(16, (os.cpu_count() or 1) + 3)
                _control = TaskControl(concurrency or default)
    return _control


def start_background(fn: Callable, *args) -> int:
    return get_task_control().start_background(fn, *args)


def start_urgent(fn: Callable, *args) -> int:
    return get_task_control().start_urgent(fn, *args)


def bthread_join(tid: int, timeout: Optional[float] = None) -> bool:
    return get_task_control().join(tid, timeout)
