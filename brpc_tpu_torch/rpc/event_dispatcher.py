"""EventDispatcher — the selector loop that feeds the RPC stack.

Port of brpc_tpu/rpc/event_dispatcher.py: ``event_dispatcher_num`` loops
(one by default), each a thread over a selector. A readable fd hands off
to its consumer (a Socket's ``start_input_event``), which only starts a
task: no user work runs on the loop thread. ``add_epollout`` registers a
one-shot writable wakeup (a blocked writer waits on it). Registration
calls come from any thread and queue through a self-pipe, so only the
loop thread touches its selector; ``remove_and_close`` closes an fd on
the loop thread after unregistering it, so a reused fd number never
meets a stale registration. The loops start on first use.
"""
from __future__ import annotations

import os
import selectors
import threading
from typing import Callable, Dict, List, Optional

from brpc_tpu_torch.butil import flags

flags.define_int("event_dispatcher_num", 1,
                 "number of event dispatcher loops")


class EventDispatcher:
    def __init__(self):
        self._selector = selectors.DefaultSelector()
        self._wakeup_r, self._wakeup_w = os.pipe()
        os.set_blocking(self._wakeup_r, False)
        self._selector.register(self._wakeup_r, selectors.EVENT_READ, None)
        self._pending: List = []
        self._pending_lock = threading.Lock()
        self._read_consumers: Dict[int, Callable] = {}
        self._write_consumers: Dict[int, Callable] = {}
        self._suspended: set = set()
        self._thread: Optional[threading.Thread] = None
        self._stop = False
        self._started_lock = threading.Lock()

    # -- public (thread-safe) ---------------------------------------------
    def add_consumer(self, fd: int, on_readable: Callable[[], None]):
        """Register fd for read events (AddConsumer, event_dispatcher.h:61).
        on_readable() is invoked on the loop thread and must only schedule."""
        self._enqueue(("add_read", fd, on_readable))

    def add_epollout(self, fd: int, on_writable: Callable[[], None]):
        """One-shot writable wakeup (AddEpollOut, event_dispatcher.h:80)."""
        self._enqueue(("add_write", fd, on_writable))

    def remove_consumer(self, fd: int):
        """Stop watching fd; the caller keeps and closes it."""
        self._enqueue(("remove", fd, None))

    def remove_and_close(self, fd: int, fileobj):
        """Unregister fd and close ``fileobj`` on the loop thread, in that
        order. A close on the caller's thread races the loop: the selector
        would poll a closed fd until the queued remove applies, and a new
        connection could reuse the fd number, so that the stale remove
        unregisters the new socket's consumer."""
        if self._stop or self._thread is None or not self._thread.is_alive():
            try:
                fileobj.close()
            except OSError:
                pass
            self._read_consumers.pop(fd, None)
            self._write_consumers.pop(fd, None)
            return
        self._enqueue(("remove_close", fd, fileobj))

    def suspend_read(self, fd: int):
        """Stop delivering read events while a reader drains the fd —
        edge-trigger-and-rearm semantics over a level-triggered selector
        (the consumer is re-armed by resume_read)."""
        self._enqueue(("suspend_read", fd, None))

    def resume_read(self, fd: int):
        self._enqueue(("resume_read", fd, None))

    def start(self):
        with self._started_lock:
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, name="event_dispatcher", daemon=True
                )
                self._thread.start()

    def stop(self):
        """End the loop after its current round."""
        self._stop = True
        self._wake()

    def join(self, timeout: float = 2.0):
        if self._thread:
            self._thread.join(timeout)

    # -- internals ---------------------------------------------------------
    def _enqueue(self, op):
        self.start()
        with self._pending_lock:
            self._pending.append(op)
        self._wake()

    def _wake(self):
        try:
            os.write(self._wakeup_w, b"x")
        except OSError:
            pass

    def _apply_pending(self):
        with self._pending_lock:
            ops, self._pending = self._pending, []
        for kind, fd, cb in ops:
            try:
                if kind == "add_read":
                    self._read_consumers[fd] = cb
                    self._suspended.discard(fd)
                    self._reregister(fd)
                elif kind == "suspend_read":
                    if fd in self._read_consumers:
                        self._suspended.add(fd)
                        self._reregister(fd)
                elif kind == "resume_read":
                    if fd in self._read_consumers:
                        self._suspended.discard(fd)
                        self._reregister(fd)
                elif kind == "add_write":
                    self._write_consumers[fd] = cb
                    self._reregister(fd)
                elif kind in ("remove", "remove_close"):
                    self._read_consumers.pop(fd, None)
                    self._write_consumers.pop(fd, None)
                    self._suspended.discard(fd)
                    try:
                        self._selector.unregister(fd)
                    except (KeyError, ValueError, OSError):
                        pass
                    if kind == "remove_close":
                        try:
                            cb.close()  # cb slot carries the file object
                        except OSError:
                            pass
            except (ValueError, OSError):
                # fd already closed — consumer cleanup races are benign
                self._read_consumers.pop(fd, None)
                self._write_consumers.pop(fd, None)

    def _reregister(self, fd: int):
        events = 0
        if fd in self._read_consumers and fd not in self._suspended:
            events |= selectors.EVENT_READ
        if fd in self._write_consumers:
            events |= selectors.EVENT_WRITE
        if events == 0:
            try:
                self._selector.unregister(fd)
            except (KeyError, ValueError, OSError):
                pass
            return
        try:
            self._selector.modify(fd, events, None)
        except KeyError:
            self._selector.register(fd, events, None)

    def _run(self):
        while not self._stop:
            self._apply_pending()
            try:
                events = self._selector.select(timeout=0.5)
            except OSError:
                continue
            for key, mask in events:
                fd = key.fd
                if fd == self._wakeup_r:
                    try:
                        os.read(self._wakeup_r, 4096)
                    except OSError:
                        pass
                    continue
                if mask & selectors.EVENT_WRITE:
                    cb = self._write_consumers.pop(fd, None)
                    if cb is not None:
                        try:
                            self._reregister(fd)
                        except (KeyError, ValueError, OSError):
                            pass
                        try:
                            cb()
                        except Exception:
                            _log_cb_error()
                if mask & selectors.EVENT_READ:
                    cb = self._read_consumers.get(fd)
                    if cb is not None:
                        try:
                            cb()
                        except Exception:
                            _log_cb_error()


def _log_cb_error():
    import logging

    logging.getLogger(__name__).exception("dispatcher consumer raised")


_dispatchers: List[EventDispatcher] = []
_dispatchers_lock = threading.Lock()


def get_global_dispatcher(fd_hint: int = 0) -> EventDispatcher:
    """fd-hashed pick among -event_dispatcher_num loops
    (GetGlobalEventDispatcher, event_dispatcher.cpp)."""
    with _dispatchers_lock:
        if not _dispatchers:
            for _ in range(max(1, flags.get_flag("event_dispatcher_num"))):
                d = EventDispatcher()
                d.start()
                _dispatchers.append(d)
    return _dispatchers[fd_hint % len(_dispatchers)]
