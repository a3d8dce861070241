"""ParkingLot — sleep and wake of idle workers.

Port of brpc_tpu/bthread/parking_lot.py: a 31-bit signal counter plus a
stop bit; a worker reads the state before its last queue check and parks
only if the counter has not moved since (no lost wakeup). Each worker has
a lot of its own.
"""
from __future__ import annotations

import threading


class ParkingLot:
    STOP_BIT = 1 << 31

    def __init__(self):
        self._pending_signal = 0
        self._cond = threading.Condition()

    def signal(self, num_task: int = 1):
        with self._cond:
            self._pending_signal = (self._pending_signal + (num_task << 1)) & 0xFFFFFFFF
            self._cond.notify(num_task)

    def get_state(self) -> int:
        return self._pending_signal

    def wait(self, expected_state: int, timeout: float = None) -> bool:
        """Park unless a signal arrived since expected_state was read."""
        with self._cond:
            if self._pending_signal != expected_state:
                return False  # state moved: don't sleep, recheck queues
            return not self._cond.wait(timeout)

    def stop(self):
        with self._cond:
            self._pending_signal |= self.STOP_BIT
            self._cond.notify_all()

    def stopped(self) -> bool:
        return bool(self._pending_signal & self.STOP_BIT)
