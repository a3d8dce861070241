"""WorkStealingQueue — per-worker deque: the owner pushes and pops one
end, thieves steal the other.

Port of brpc_tpu/bthread/work_stealing_queue.py: the shape of brpc's
Chase-Lev queue (owner end LIFO, thief end FIFO) behind one short lock.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Optional, TypeVar

T = TypeVar("T")


class WorkStealingQueue:
    def __init__(self, capacity: int = 4096):
        self._q: deque = deque()
        self._capacity = capacity
        self._lock = threading.Lock()

    def push(self, item) -> bool:
        """Owner-only push (bottom)."""
        with self._lock:
            if len(self._q) >= self._capacity:
                return False
            self._q.append(item)
            return True

    def pop(self) -> Optional[object]:
        """Owner-only pop (bottom, LIFO — newest first for locality)."""
        with self._lock:
            return self._q.pop() if self._q else None

    def steal(self) -> Optional[object]:
        """Thief pop (top, FIFO — oldest first)."""
        with self._lock:
            return self._q.popleft() if self._q else None

    def __len__(self) -> int:
        return len(self._q)

    def empty(self) -> bool:
        return not self._q
