"""bthread_id — versioned, lockable call ids.

Port of brpc_tpu/bthread/id.py. An id names one in-flight RPC; ``lock``
serialises every touch to its data; ``error`` delivers a failure to the
owner's ``on_error`` under the lock (queued while the lock is held);
``unlock_and_destroy`` makes every copy of the id stale and wakes its
joiners (``join``). A ranged id lets id+k address the same slot: the
controller gives attempt k of an RPC the version id+1+k, so a response
to an abandoned attempt, a deadline and a socket failure all race
through one lock, and whatever comes after the RPC ended finds a stale
id and is dropped.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Callable, Dict, Optional, Tuple

# on_error(id_value, data, error_code, error_text) -> None; it must end by
# calling unlock(id) or unlock_and_destroy(id).
OnError = Callable[[int, object, int, str], None]


class _IdSlot:
    __slots__ = ("first_version", "range", "locked", "destroyed", "data",
                 "on_error", "pending_errors", "cond", "joined")

    def __init__(self):
        self.first_version = 1
        self.range = 1
        self.locked = False
        self.destroyed = True
        self.data = None
        self.on_error: Optional[OnError] = None
        self.pending_errors: deque = deque()
        self.cond = threading.Condition()
        self.joined = threading.Event()


_slots: Dict[int, _IdSlot] = {}
_free_indexes: deque = deque()
_next_index = 1
_registry_lock = threading.Lock()


def _default_on_error(id_value: int, data, error_code: int, error_text: str):
    unlock_and_destroy(id_value)


def create(data=None, on_error: Optional[OnError] = None) -> int:
    return create_ranged(data, on_error, 1)


def create_ranged(data=None, on_error: Optional[OnError] = None,
                  range_: int = 1) -> int:
    """Versions [v, v+range_) all address this slot."""
    global _next_index
    with _registry_lock:
        if _free_indexes:
            index = _free_indexes.popleft()
            slot = _slots[index]
        else:
            index = _next_index
            _next_index += 1
            slot = _IdSlot()
            _slots[index] = slot
    with slot.cond:
        slot.range = max(1, range_)
        slot.locked = False
        slot.destroyed = False
        slot.data = data
        slot.on_error = on_error or _default_on_error
        slot.pending_errors.clear()
        slot.joined = threading.Event()
        return (index << 32) | slot.first_version


def _resolve(id_value: int) -> Tuple[Optional[_IdSlot], int]:
    with _registry_lock:
        slot = _slots.get(id_value >> 32)
    return slot, id_value & 0xFFFFFFFF


def _valid(slot: _IdSlot, version: int) -> bool:
    return (not slot.destroyed
            and slot.first_version <= version < slot.first_version + slot.range)


def lock(id_value: int, timeout: Optional[float] = None):
    """Lock the id and return its data; KeyError once it is stale."""
    slot, version = _resolve(id_value)
    if slot is None:
        raise KeyError(f"invalid bthread_id {id_value:#x}")
    with slot.cond:
        while True:
            if not _valid(slot, version):
                raise KeyError(f"destroyed bthread_id {id_value:#x}")
            if not slot.locked:
                slot.locked = True
                return slot.data
            if not slot.cond.wait(timeout):
                raise TimeoutError(f"lock timeout on {id_value:#x}")


def trylock(id_value: int):
    """The id's data with the lock taken, or None when it is held or the
    id is stale; KeyError for an id never made."""
    slot, version = _resolve(id_value)
    if slot is None:
        raise KeyError(f"invalid bthread_id {id_value:#x}")
    with slot.cond:
        if not _valid(slot, version) or slot.locked:
            return None
        slot.locked = True
        return slot.data


def unlock(id_value: int):
    """Release the lock, after handing one queued error, if any, to
    on_error with the lock still held."""
    slot, version = _resolve(id_value)
    if slot is None:
        raise KeyError(f"invalid bthread_id {id_value:#x}")
    pending = None
    with slot.cond:
        if not _valid(slot, version):
            # a stale id must not release the lock of the slot's next owner
            raise KeyError(f"destroyed bthread_id {id_value:#x}")
        if not slot.locked:
            raise RuntimeError(f"unlock of unlocked id {id_value:#x}")
        if slot.pending_errors:
            pending = slot.pending_errors.popleft()
        else:
            slot.locked = False
            slot.cond.notify()
    if pending is not None:
        slot.on_error(id_value, slot.data, *pending)


def unlock_and_destroy(id_value: int):
    """Make every copy of the id stale; wake the lock waiters and the
    joiners."""
    slot, _ = _resolve(id_value)
    if slot is None:
        raise KeyError(f"invalid bthread_id {id_value:#x}")
    with slot.cond:
        slot.first_version += slot.range
        slot.destroyed = True
        slot.locked = False
        slot.pending_errors.clear()
        slot.cond.notify_all()
        slot.joined.set()
    with _registry_lock:
        _free_indexes.append(id_value >> 32)


def join(id_value: int, timeout: Optional[float] = None) -> bool:
    """Wait until the id is destroyed; True at once for a stale id, False
    when ``timeout`` (seconds) passed first."""
    slot, version = _resolve(id_value)
    if slot is None:
        return True
    with slot.cond:
        if not _valid(slot, version):
            return True
        joined = slot.joined
    return joined.wait(timeout)


def error(id_value: int, error_code: int, error_text: str = "") -> bool:
    """Run on_error under the id lock, or queue the error while the lock
    is held. False for a stale id."""
    slot, version = _resolve(id_value)
    if slot is None:
        return False
    with slot.cond:
        if not _valid(slot, version):
            return False
        if slot.locked:
            slot.pending_errors.append((error_code, error_text))
            return True
        slot.locked = True
    slot.on_error(id_value, slot.data, error_code, error_text)
    return True
