"""The rest of butil's containers and utilities.

Port of brpc_tpu/butil/containers.py: FlatMap, the one-level hashing map
whose buckets hold their first entry; fast_rand, a thread-local PRNG;
crc32c (Castagnoli); RawPacker/RawUnpacker, big-endian scalar packing;
ThreadLocal, a per-thread object made on first use.
"""
from __future__ import annotations

import random
import struct
import threading
from typing import Callable, Generic, Iterator, Optional, Tuple, TypeVar

K = TypeVar("K")
V = TypeVar("V")


class _Node:
    __slots__ = ("key", "value", "next")

    def __init__(self, key, value, next_=None):
        self.key = key
        self.value = value
        self.next = next_


class FlatMap(Generic[K, V]):
    """The reference's "one-level hashing" map (flat_map_inl.h:342-530): a
    bucket array whose slots EMBED the first entry, with collisions
    chained off the embedded node; a resize doubles buckets whenever
    size*100 >= nbucket*load_factor (flat_map.h:279-281). Most lookups hit
    the embedded slot directly — the cache-friendliness the reference
    builds the structure for."""

    def __init__(self, nbucket: int = 32, load_factor: int = 80):
        self._nbucket = max(1, nbucket)
        self._load_factor = load_factor
        self._buckets: list = [None] * self._nbucket
        self._size = 0

    def init(self, nbucket: int, load_factor: int = 80) -> bool:
        if self._size:
            return False  # init only before use, as the reference
        self._nbucket = max(1, nbucket)
        self._load_factor = load_factor
        self._buckets = [None] * self._nbucket
        return True

    def _index(self, key) -> int:
        return hash(key) % self._nbucket  # flatmap_mod (flat_map_inl.h:72)

    def _maybe_resize(self):
        if (self._size + 1) * 100 >= self._nbucket * self._load_factor:
            self.resize(self._nbucket * 2)

    def resize(self, nbucket: int) -> bool:
        old = self._buckets
        self._nbucket = max(1, nbucket)
        self._buckets = [None] * self._nbucket
        for node in old:
            while node is not None:
                nxt = node.next
                idx = self._index(node.key)
                node.next = self._buckets[idx]
                self._buckets[idx] = node
                node = nxt
        return True

    def _find_node(self, key) -> Optional[_Node]:
        node = self._buckets[self._index(key)]
        while node is not None:
            if node.key == key:
                return node
            node = node.next
        return None

    def insert(self, key: K, value: V) -> V:
        node = self._find_node(key)
        if node is not None:
            node.value = value
            return value
        self._maybe_resize()
        idx = self._index(key)
        self._buckets[idx] = _Node(key, value, self._buckets[idx])
        self._size += 1
        return value

    def seek(self, key: K) -> Optional[V]:
        node = self._find_node(key)
        return node.value if node is not None else None

    def __getitem__(self, key: K) -> V:
        """operator[]: inserts default None if missing (flat_map semantic
        is default-construct; here: None)."""
        node = self._find_node(key)
        if node is not None:
            return node.value
        self._maybe_resize()
        idx = self._index(key)
        self._buckets[idx] = _Node(key, None, self._buckets[idx])
        self._size += 1
        return None

    def __setitem__(self, key: K, value: V):
        self.insert(key, value)

    def erase(self, key: K) -> int:
        idx = self._index(key)
        node = self._buckets[idx]
        prev = None
        while node is not None:
            if node.key == key:
                if prev is None:
                    self._buckets[idx] = node.next
                else:
                    prev.next = node.next
                self._size -= 1
                return 1
            prev, node = node, node.next
        return 0

    def __len__(self) -> int:
        return self._size

    def __contains__(self, key: K) -> bool:
        return self._find_node(key) is not None

    def empty(self) -> bool:
        return self._size == 0

    def clear(self):
        self._buckets = [None] * self._nbucket
        self._size = 0

    @property
    def nbucket(self) -> int:
        return self._nbucket

    @property
    def load_factor(self) -> int:
        return self._load_factor

    def __iter__(self) -> Iterator[Tuple[K, V]]:
        for node in self._buckets:
            while node is not None:
                yield node.key, node.value
                node = node.next


_MISSING = object()


# -- fast_rand (fast_rand.cpp) ----------------------------------------------

_tls_rand = threading.local()


def _rng() -> random.Random:
    r = getattr(_tls_rand, "r", None)
    if r is None:
        r = random.Random()
        _tls_rand.r = r
    return r


def fast_rand() -> int:
    """64-bit thread-local PRNG draw."""
    return _rng().getrandbits(64)


def fast_rand_less_than(bound: int) -> int:
    return _rng().randrange(bound) if bound > 0 else 0


def fast_rand_in(lo: int, hi: int) -> int:
    return _rng().randint(lo, hi)


def fast_rand_double() -> float:
    return _rng().random()


# -- crc32c (crc32c.cc, Castagnoli polynomial) -------------------------------

_CRC32C_POLY = 0x82F63B78
_crc32c_table = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ _CRC32C_POLY if _c & 1 else _c >> 1
    _crc32c_table.append(_c)


def crc32c(data: bytes, init: int = 0) -> int:
    crc = init ^ 0xFFFFFFFF
    table = _crc32c_table
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


# -- RawPacker / RawUnpacker (raw_pack.h) ------------------------------------

class RawPacker:
    """Sequential big-endian scalar packing."""

    def __init__(self):
        self._parts = []

    def pack32(self, v: int) -> "RawPacker":
        self._parts.append(struct.pack(">I", v & 0xFFFFFFFF))
        return self

    def pack64(self, v: int) -> "RawPacker":
        self._parts.append(struct.pack(">Q", v & 0xFFFFFFFFFFFFFFFF))
        return self

    def bytes(self) -> bytes:
        return b"".join(self._parts)


class RawUnpacker:
    def __init__(self, data: bytes):
        self._data = data
        self._pos = 0

    def unpack32(self) -> int:
        (v,) = struct.unpack_from(">I", self._data, self._pos)
        self._pos += 4
        return v

    def unpack64(self) -> int:
        (v,) = struct.unpack_from(">Q", self._data, self._pos)
        self._pos += 8
        return v


# -- ThreadLocal (thread_local.h) --------------------------------------------

class ThreadLocal(Generic[V]):
    """Per-thread lazily-constructed object."""

    def __init__(self, factory: Callable[[], V]):
        self._factory = factory
        self._tls = threading.local()

    def get(self) -> V:
        v = getattr(self._tls, "v", _MISSING)
        if v is _MISSING:
            v = self._factory()
            self._tls.v = v
        return v

    def reset(self, value: V):
        self._tls.v = value
