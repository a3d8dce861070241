"""ObjectPool and ResourcePool: pools of objects, the second addressed by
versioned ids.

Port of brpc_tpu/butil/pools.py (butil::ObjectPool, butil::ResourcePool).
A ResourcePool hands out dense ids that may outlive their object:
``address`` checks the version stamped into the id, so a stale id never
reaches a newer occupant of its slot (the pattern behind socket ids,
bthread ids and call ids).

Ids are 64-bit: (version << 32) | slot index. A slot's version moves by
one when it is taken and by one when it is returned (odd: in use, even:
free).
"""
from __future__ import annotations

import threading
from typing import Callable, Generic, List, Optional, TypeVar

T = TypeVar("T")

INVALID_RESOURCE_ID = 0xFFFFFFFFFFFFFFFF


class ObjectPool(Generic[T]):
    """Freelist pool: get/return objects, constructing on miss."""

    def __init__(self, factory: Callable[[], T], max_free: int = 4096):
        self._factory = factory
        self._free: List[T] = []
        self._max_free = max_free
        self._lock = threading.Lock()
        self._created = 0

    def get(self) -> T:
        with self._lock:
            if self._free:
                return self._free.pop()
            self._created += 1
        return self._factory()

    def put(self, obj: T):
        with self._lock:
            if len(self._free) < self._max_free:
                self._free.append(obj)

    def free_count(self) -> int:
        return len(self._free)

    def created_count(self) -> int:
        return self._created


class _Slot(Generic[T]):
    __slots__ = ("obj", "version")

    def __init__(self):
        self.obj: Optional[T] = None
        self.version = 0  # even = free, odd = in use


class ResourcePool(Generic[T]):
    """Slot pool addressed by versioned 64-bit ids."""

    def __init__(self, factory: Callable[[], T]):
        self._factory = factory
        self._slots: List[_Slot[T]] = []
        self._free_slots: List[int] = []
        self._lock = threading.Lock()

    def get_resource(self) -> "tuple[int, T]":
        """Returns (resource_id, object)."""
        with self._lock:
            if self._free_slots:
                idx = self._free_slots.pop()
                slot = self._slots[idx]
            else:
                idx = len(self._slots)
                slot = _Slot()
                self._slots.append(slot)
            slot.version += 1  # even -> odd: now in use
            if slot.obj is None:
                slot.obj = self._factory()
            rid = (slot.version << 32) | idx
            return rid, slot.obj

    def address(self, rid: int) -> Optional[T]:
        """Validated id->object lookup: None if the id is stale
        (socket_inl.h:28-185 Address())."""
        if rid == INVALID_RESOURCE_ID:
            return None
        idx = rid & 0xFFFFFFFF
        version = rid >> 32
        if idx >= len(self._slots):
            return None
        slot = self._slots[idx]
        if slot.version != version or (version & 1) == 0:
            return None
        return slot.obj

    def return_resource(self, rid: int) -> bool:
        idx = rid & 0xFFFFFFFF
        version = rid >> 32
        with self._lock:
            if idx >= len(self._slots):
                return False
            slot = self._slots[idx]
            if slot.version != version or (version & 1) == 0:
                return False
            slot.version += 1  # odd -> even: free; stale ids now fail
            slot.obj = None
            self._free_slots.append(idx)
            return True

    def size(self) -> int:
        return len(self._slots)
