"""Device transport — the tensor lane's endpoint, pool and receive path.

Port of brpc_tpu/rpc/device_transport.py for torch tensors:

* ``local_device_info`` — the handshake identity, with the reference's
  keys. ``platform`` is ``"gpu"`` on the card (what JAX reports on an
  NVIDIA card). ``arena`` names this process's send arena; ``xfer`` is
  True only when this process's transfer server has started; ``fabric``
  names this process's descriptor-ring segment when the server half of
  the handshake armed it (``arm_fabric``), else ``""``.
* ``DeviceBlockPool`` — size classes 8 KB / 64 KB / 2 MB of device byte
  blocks that received bytes land in (the reference's block_pool role).
* ``HostArena`` — a shared host arena carved into spans, page-locked for
  CUDA on the card (the reference's pinned-host arena, the
  ``ibv_reg_mr`` role): a same-host send stages its bytes there once.
* ``DeviceEndpoint`` — the TDEV handshake, the in-flight window and
  retention until ACK, and the send lanes in the reference's order:
  in-process ticket (the *same* tensor, zero-copy), xfer (device to
  device through the transfer server: CUDA IPC on one host, or the TCP
  fake), ring (the bytes written once into the receiver's blob arena as
  kind-8 records of the native descriptor-ring fabric, nothing on the
  wire), shm (one device-to-host copy into the arena, a descriptor on the
  wire) and wire bytes.
* ``receive_tensors`` — rebuilds tensors from every lane.
* The descriptor-ring fabric (the reference's ring lane): the start and
  the handshake of a server with a TensorStore service arm it
  (``BRPC_TPU_FABRIC=0`` keeps it off), creating this
  process's segment of the native shm lane (``BRPC_TPU_FABRIC_ARENA``
  bytes of blob arena per producer slot, 32 MiB by default) and a drain
  thread that takes pushed records as leases. A same-host client attaches
  to that segment as a producer (one segment per process) and pushes
  there. The receiver consumes a lease in place: a host tensor laid over
  the span (released when its storage dies), or, on the card, one copy
  from the page-locked segment to the device, after which the lease is
  released. Unlike the reference, which quietly advertises no fabric when
  its native library fails to load, arming raises then.
* The IOBuf arena seams: ``HostArena.make_block`` and
  ``install_as_iobuf_allocator``, and ``install_read_arena`` (a growable
  ``ReadArenaChain`` of arenas, page-locked on the card).

The lanes taken and the pool's blocks are counted in variables with the
reference's names, shown on the console's ``/vars``:
``device_transport_{zero_copy,shm,wire,xfer,ring}_transfers`` (read
together by ``lane_counters``) and ``device_block_pool_{acquired,
released}`` (every pool of the process; each pool also counts its own in
``acquired`` and ``released``).

Wire dtype names are numpy's (``"float32"``, ``"bfloat16"``, ``"int32"``),
as the reference writes them; bfloat16 bytes cross as 16-bit patterns.
"""
from __future__ import annotations

import atexit
import ctypes
import json
import math
import os
import struct
import threading
import time
import uuid
import weakref
from multiprocessing import resource_tracker, shared_memory
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from brpc_tpu_torch import bvar
from brpc_tpu_torch.butil import flags as _flags
from brpc_tpu_torch.butil.iobuf import IOBuf
from brpc_tpu_torch.device import DeviceLike, resolve_device
from brpc_tpu_torch.rpc.cuda_ipc_transfer import CudaIpcTransferServer

# -- dtypes on the wire ------------------------------------------------------

# numpy name on the wire -> (torch dtype, itemsize)
DTYPES: Dict[str, Tuple[torch.dtype, int]] = {
    "float64": (torch.float64, 8),
    "float32": (torch.float32, 4),
    "float16": (torch.float16, 2),
    "bfloat16": (torch.bfloat16, 2),
    "int64": (torch.int64, 8),
    "int32": (torch.int32, 4),
    "int16": (torch.int16, 2),
    "int8": (torch.int8, 1),
    "uint8": (torch.uint8, 1),
    "bool": (torch.bool, 1),
}
_NAMES = {dt: name for name, (dt, _) in DTYPES.items()}


def dtype_name(dtype: torch.dtype) -> str:
    """The numpy name the wire carries for a torch dtype."""
    try:
        return _NAMES[dtype]
    except KeyError:
        raise ValueError(f"device transport: dtype {dtype} has no wire name") from None


def _tensor_spec(t) -> Tuple[torch.dtype, Tuple[int, ...], int]:
    """(torch dtype, shape, nbytes) of a TensorMeta from the wire,
    checked: the peer is outside this program."""
    if t.dtype not in DTYPES:
        raise ValueError(f"device transport: unknown dtype {t.dtype!r}")
    dtype, itemsize = DTYPES[t.dtype]
    shape = tuple(int(d) for d in t.shape)
    if any(d < 0 for d in shape) or math.prod(shape) * itemsize != t.nbytes:
        raise ValueError(f"device transport: {t.nbytes} bytes do not hold "
                         f"{t.dtype}{list(shape)}")
    return dtype, shape, t.nbytes


def _bytes_as(raw_u8: torch.Tensor, dtype, shape) -> torch.Tensor:
    """Reinterpret a 1-D uint8 tensor as dtype/shape (no copy)."""
    return raw_u8.view(dtype).reshape(shape)


# -- identity (the reference's device_helper) --------------------------------

_process_uuid = uuid.uuid4().hex


def _host_boot_id() -> str:
    """Same-host identity: two processes share a shm segment only when they
    share a kernel."""
    try:
        with open("/proc/sys/kernel/random/boot_id") as f:
            return f.read().strip()
    except OSError:
        import socket as pysocket

        return pysocket.gethostname()


_boot_id = _host_boot_id()


def local_device_info(device: DeviceLike = None,
                      arm_fabric: bool = False) -> dict:
    """The handshake identity, with the reference's keys. ``device`` is the
    card unless the caller asks for the CPU. With ``arm_fabric`` (the
    server half of the handshake) the descriptor-ring fabric is armed and
    its segment advertised, page-locked first when ``device`` is the
    card."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    arena = default_send_arena()
    if arena is not None and on_card:
        arena.pin()
    fabric = _fabric_arm_receiver(pin=on_card) if arm_fabric else ""
    return {
        "process": _process_uuid,
        "host": _boot_id,
        "arena": arena.name if arena is not None else "",
        "fabric": fabric,
        # advertised only when the server really started: a peer that sees
        # True may publish xfer-lane payloads with nothing on the wire
        "xfer": _global_xfer_server(dev) is not None,
        "platform": "gpu" if on_card else "cpu",
        "device_count": torch.cuda.device_count() if on_card else 1,
    }


# -- DeviceBlockPool (block_pool analog) --------------------------------------

_pool_acquired = bvar.Adder("device_block_pool_acquired")
_pool_released = bvar.Adder("device_block_pool_released")


class DeviceBlockPool:
    """Pre-allocated device byte blocks by size class, the memory received
    bytes land in (the reference's block_pool.h role).

    ``put_via_pool`` copies the host bytes into a pooled block (on the card
    through a pinned staging buffer of the same size, asynchronously), then
    reinterprets the head of the block as the typed tensor. A torch view
    would alias the block, which goes back to the free list at once; so the
    typed tensor is cloned device to device, and the copies' stream is
    synchronised, before the block (and its staging buffer) is released.
    Above the largest class, or when the class is exhausted, the bytes go to
    the device with a plain ``.to`` — the reference's own rule."""

    SIZE_CLASSES = (8 << 10, 64 << 10, 2 << 20)

    def __init__(self, blocks_per_class: int = 8, device: DeviceLike = None):
        self._device = resolve_device(device)
        on_card = self._device.type == "cuda"
        self._free: Dict[int, List[Tuple[torch.Tensor, Optional[torch.Tensor]]]] = {}
        self._lock = threading.Lock()
        self.acquired = 0  # blocks handed out since creation
        self.released = 0
        for size in self.SIZE_CLASSES:
            self._free[size] = [
                (torch.empty(size, dtype=torch.uint8, device=self._device),
                 torch.empty(size, dtype=torch.uint8, pin_memory=True)
                 if on_card else None)
                for _ in range(blocks_per_class)
            ]

    def acquire(self, nbytes: int):
        """Returns (size_class, (block, staging)) or None if
        exhausted/oversized. ``staging`` is None off the card."""
        with self._lock:
            for size in self.SIZE_CLASSES:
                if nbytes <= size and self._free[size]:
                    self.acquired += 1
                    _pool_acquired.update(1)
                    return size, self._free[size].pop()
        return None

    def release(self, size_class: int, entry):
        with self._lock:
            if size_class in self._free:
                self._free[size_class].append(entry)
                self.released += 1
                _pool_released.update(1)

    def stats(self) -> Dict[int, int]:
        with self._lock:
            return {k: len(v) for k, v in self._free.items()}

    def put_via_pool(self, host_u8: torch.Tensor, dtype: torch.dtype, shape,
                     device: DeviceLike = None,
                     pinned: bool = False) -> torch.Tensor:
        """Host bytes (a 1-D uint8 CPU tensor) -> a tensor of dtype/shape on
        ``device`` (default: the pool's), through pooled memory. The result
        owns its memory and is ready when this returns. ``pinned`` says the
        bytes already lie in page-locked memory (a pinned HostArena): the
        copy to the card then reads them in place, without the staging
        buffer."""
        target = self._device if device is None else resolve_device(device)
        nbytes = host_u8.numel()
        got = self.acquire(nbytes) if target == self._device else None
        if got is None:
            return _bytes_as(host_u8, dtype, shape).to(target, copy=True)
        size_class, entry = got
        block, staging = entry
        try:
            head = block[:nbytes]
            if staging is not None and pinned:
                head.copy_(host_u8, non_blocking=True)
            elif staging is not None:
                staging[:nbytes].copy_(host_u8)
                head.copy_(staging[:nbytes], non_blocking=True)
            else:
                head.copy_(host_u8)
            return _bytes_as(head, dtype, shape).clone()
        finally:
            if staging is not None:
                # the queued copies read the staging buffer and the block:
                # both must be done before either is handed out again
                torch.cuda.current_stream(target).synchronize()
            self.release(size_class, entry)


_default_pools: Dict[torch.device, DeviceBlockPool] = {}
_default_pool_lock = threading.Lock()


def default_block_pool(device: DeviceLike = None) -> DeviceBlockPool:
    """The process-wide pool of ``device`` (the card unless told)."""
    dev = resolve_device(device)
    with _default_pool_lock:
        pool = _default_pools.get(dev)
        if pool is None:
            pool = _default_pools[dev] = DeviceBlockPool(device=dev)
    return pool


# -- HostArena (the cross-process half of block_pool) ---------------------------
#
# The reference registers big arenas with ibv_reg_mr so the NIC can DMA them
# (block_pool.h:29-94). The CUDA form is a shared host arena page-locked with
# cudaHostRegister: the sender's device-to-host copy lands in a span directly,
# the wire carries only an (arena, offset) descriptor, and a same-host peer
# maps the arena and copies from it to its card.

class HostArena:
    """Shared host arena carved by a first-fit span allocator (64-byte
    aligned spans, coalescing frees).

    Pages are prefaulted at create and at attach (one touch per 4 KB page),
    so first-touch faults are paid outside the transfer path, as
    registration pays them for the reference's RDMA arenas. ``pin()``
    page-locks the arena for CUDA, once; ``close()`` unpins,
    and only the owner unlinks the segment."""

    def __init__(self, size: int = 64 << 20, name: Optional[str] = None,
                 create: bool = True):
        if create:
            self.shm = shared_memory.SharedMemory(create=True, size=size)
        else:
            self.shm = shared_memory.SharedMemory(name=name)
            # The segment belongs to the peer: keep this process's resource
            # tracker from unlinking it when this process exits.
            resource_tracker.unregister(self.shm._name, "shared_memory")
        self._prefault(write=create)
        self.name = self.shm.name
        self.size = self.shm.size
        self.owner = create
        self._free = [(0, self.size)]  # sorted (offset, size) spans
        self._lock = threading.Lock()
        self._pinned_ptr = 0

    def _prefault(self, write: bool):
        view = np.frombuffer(self.shm.buf, dtype=np.uint8)
        if write:
            view[::4096] = 0  # one store per page
        else:
            int(view[::4096].sum())  # one load per page

    @property
    def pinned(self) -> bool:
        return self._pinned_ptr != 0

    def pin(self):
        """Page-lock the arena for CUDA (cudaHostRegister), once. Raises,
        naming the CUDA error, when CUDA refuses."""
        with self._lock:
            if self._pinned_ptr:
                return
            cudart = torch.cuda.cudart()
            ptr = np.frombuffer(self.shm.buf, dtype=np.uint8).ctypes.data
            err = cudart.cudaHostRegister(ptr, self.size, 0)
            if err != cudart.cudaError.success:
                raise RuntimeError(
                    f"device transport: cudaHostRegister of arena "
                    f"{self.name!r} ({self.size} B) failed: "
                    f"{cudart.cudaGetErrorString(err)}")
            self._pinned_ptr = ptr

    # -- span allocator ----------------------------------------------------
    def alloc(self, nbytes: int) -> Optional[int]:
        nbytes = max(64, (nbytes + 63) & ~63)
        with self._lock:
            for i, (off, sz) in enumerate(self._free):
                if sz >= nbytes:
                    if sz == nbytes:
                        self._free.pop(i)
                    else:
                        self._free[i] = (off + nbytes, sz - nbytes)
                    return off
        return None

    def free(self, offset: int, nbytes: int):
        nbytes = max(64, (nbytes + 63) & ~63)
        with self._lock:
            spans = sorted(self._free + [(offset, nbytes)])
            merged = []
            for off, sz in spans:
                if merged and merged[-1][0] + merged[-1][1] == off:
                    merged[-1] = (merged[-1][0], merged[-1][1] + sz)
                else:
                    merged.append((off, sz))
            self._free = merged

    def free_bytes(self) -> int:
        with self._lock:
            return sum(s for _, s in self._free)

    # -- the blockmem_allocate adapter ---------------------------------------
    def make_block(self, capacity: int = 256 << 10):
        """A writable IOBuf Block carved from this arena, its span freed
        when the block is collected; None when the arena is full."""
        from brpc_tpu_torch.butil.iobuf import Block

        off = self.alloc(capacity)
        if off is None:
            return None
        b = Block.__new__(Block)
        b.data = memoryview(self.shm.buf)[off:off + capacity]
        b.size = 0
        b.capacity = capacity
        b.kind = Block.USER
        b.deleter = None
        b.meta = off
        b.device_array = None
        weakref.finalize(b, self.free, off, capacity)
        return b

    def install_as_iobuf_allocator(self, capacity: int = 256 << 10):
        """Point IOBuf's block factory at this arena: appended bytes and
        socket reads are staged in memory a same-host peer can map (and,
        pinned, the card can copy from)."""
        from brpc_tpu_torch.butil import iobuf as iobuf_mod

        iobuf_mod.set_block_allocator(lambda: self.make_block(capacity))

    def tensor(self, offset: int, nbytes: int) -> torch.Tensor:
        """A uint8 tensor over [offset, offset + nbytes) of the arena."""
        if nbytes == 0:
            return torch.empty(0, dtype=torch.uint8)
        return torch.frombuffer(self.shm.buf, dtype=torch.uint8,
                                count=nbytes, offset=offset)

    def close(self):
        if self._pinned_ptr:
            try:
                torch.cuda.cudart().cudaHostUnregister(self._pinned_ptr)
            except RuntimeError:
                pass  # CUDA already torn down: the mapping goes below
            self._pinned_ptr = 0
        if self.owner:
            try:
                self.shm.unlink()
            except OSError:
                pass
        try:
            self.shm.close()
        except BufferError:
            # a live tensor still maps it; unmapped when that dies
            self.shm._buf = None
            self.shm._mmap = None


_send_arena: Optional[HostArena] = None
_send_arena_lock = threading.Lock()


def default_send_arena() -> Optional[HostArena]:
    """The process-wide outbound arena, created at first use and advertised
    in the handshake. None when no shared segment can be made."""
    global _send_arena
    if _send_arena is None:
        with _send_arena_lock:
            if _send_arena is None:
                try:
                    _send_arena = HostArena()
                except OSError:
                    return None
    return _send_arena


_attached_arenas: Dict[str, HostArena] = {}
_attached_lock = threading.Lock()


def attach_arena(name: str, pin: bool = False) -> Optional[HostArena]:
    """Map a peer's arena by name, once per process (page-locked too when
    ``pin``: its bytes go to the card). None when the segment cannot be
    opened (another host or shm namespace)."""
    own = _send_arena
    with _attached_lock:
        if own is not None and own.name == name:
            arena = own  # this process's own arena: no second mapping
        else:
            arena = _attached_arenas.get(name)
        if arena is None:
            try:
                arena = HostArena(name=name, create=False)
            except (OSError, ValueError):
                return None
            _attached_arenas[name] = arena
    if pin:
        arena.pin()
    return arena


def _cleanup_arenas():
    global _send_arena
    _fabric_disarm()
    with _send_arena_lock:
        if _send_arena is not None:
            _send_arena.close()
            _send_arena = None
    with _attached_lock:
        for arena in _attached_arenas.values():
            arena.close()
        _attached_arenas.clear()


atexit.register(_cleanup_arenas)


# -- the read-side arena seam (every IOBuf block transfer-ready) -------------------
#
# The reference points IOBuf's blockmem_allocate at its registered pool, so
# every buffer a socket drains into is transfer-ready. install_read_arena is
# that configuration: reads and appends land in prefaulted HostArena
# blocks, the chain growing by whole prefaulted arenas when one is full.

class ReadArenaChain:
    """A growable chain of prefaulted HostArenas serving IOBuf blocks; on
    the card each arena is page-locked as it is made."""

    MAX_ARENAS = 8

    def __init__(self, size: int = 32 << 20, capacity: int = 256 << 10,
                 pin: bool = False):
        self.size = size
        self.capacity = capacity
        self.pin = pin
        self._lock = threading.Lock()
        self.arenas = [self._arena()]
        self.grows = 0

    def _arena(self) -> HostArena:
        arena = HostArena(size=self.size)
        if self.pin:
            arena.pin()
        return arena

    def alloc_block(self):
        with self._lock:
            arenas = list(self.arenas)
        for arena in reversed(arenas):
            b = arena.make_block(self.capacity)
            if b is not None:
                return b
        with self._lock:
            if len(self.arenas) >= self.MAX_ARENAS:
                return None  # plain host blocks take over
            try:
                arena = self._arena()
            except OSError:
                return None
            self.arenas.append(arena)
            self.grows += 1
        return arena.make_block(self.capacity)

    def close(self):
        for arena in self.arenas:
            arena.close()


_read_chain: Optional[ReadArenaChain] = None
_read_chain_lock = threading.Lock()


def install_read_arena(size: int = 32 << 20, capacity: int = 256 << 10,
                       device: DeviceLike = None) -> ReadArenaChain:
    """Install a prefaulted, growable arena chain as the IOBuf block
    factory (page-locked when ``device`` is the card). Returns the chain;
    uninstall_read_arena undoes it."""
    global _read_chain
    from brpc_tpu_torch.butil import iobuf as iobuf_mod

    pin = resolve_device(device).type == "cuda"
    with _read_chain_lock:
        if _read_chain is None:
            _read_chain = ReadArenaChain(size=size, capacity=capacity,
                                         pin=pin)
        iobuf_mod.set_block_allocator(_read_chain.alloc_block)
    return _read_chain


def uninstall_read_arena():
    global _read_chain
    from brpc_tpu_torch.butil import iobuf as iobuf_mod

    with _read_chain_lock:
        iobuf_mod.set_block_allocator(None)
        chain, _read_chain = _read_chain, None
    if chain is not None:
        chain.close()


# -- lanes taken, and the transfer server of the xfer lane ----------------------

_flags.define_bool(
    "device_transport_prefer_xfer", False,
    "use the transfer-server lane even for same-host peers (it is always "
    "used for cross-host device peers when both sides support it)")

_lanes = {lane: bvar.Adder(f"device_transport_{name}_transfers")
          for lane, name in (("inproc", "zero_copy"), ("ring", "ring"),
                             ("shm", "shm"), ("wire", "wire"),
                             ("xfer", "xfer"))}


def _count(lane: str):
    _lanes[lane].update(1)


def lane_counters() -> dict:
    """Transfers sent per lane: {'inproc', 'ring', 'shm', 'wire', 'xfer'}."""
    return {lane: var.get_value() for lane, var in _lanes.items()}


_xfer_server = None
_xfer_server_lock = threading.Lock()
_xfer_conns: Dict[str, object] = {}
_xfer_conns_lock = threading.Lock()


def _global_xfer_server(device: DeviceLike = None):
    """The process's transfer server, started at first use: the TCP fake
    when BRPC_TPU_FAKE_XFER is set, else the CUDA IPC server for an
    endpoint on the card. None on the CPU with no switch set, as in the
    reference when its backend lacks the server. A start failure is not
    latched: the next handshake tries again."""
    global _xfer_server
    server = _xfer_server
    if server is None:
        with _xfer_server_lock:
            if _xfer_server is None:
                try:
                    if os.environ.get("BRPC_TPU_FAKE_XFER"):
                        from brpc_tpu_torch.rpc.fake_transfer import (
                            FakeTransferServer,
                        )

                        _xfer_server = FakeTransferServer()
                    elif resolve_device(device).type == "cuda":
                        _xfer_server = CudaIpcTransferServer()
                except OSError:
                    return None
            server = _xfer_server
    if (isinstance(server, CudaIpcTransferServer)
            and resolve_device(device).type != "cuda"):
        return None  # IPC lands on the card only
    return server


def _xfer_connect(addr: str, device: DeviceLike = None):
    with _xfer_conns_lock:
        conn = _xfer_conns.get(addr)
    if conn is not None:
        return conn
    server = _global_xfer_server(device)
    if server is None:
        raise ValueError("device transport: xfer lane without a local "
                         "transfer server to pull with")
    conn = server.connect(addr)  # dial outside the lock
    with _xfer_conns_lock:
        return _xfer_conns.setdefault(addr, conn)


def _xfer_evict(addr: str):
    """Drop a cached connection after a failed pull, so the next receive
    redials (a restarted sender on the same address recovers)."""
    with _xfer_conns_lock:
        _xfer_conns.pop(addr, None)


# -- the descriptor-ring tensor fabric (the ring lane) --------------------------
#
# The receiver owns a segment of the native shm lane whose slots same-host
# peers claim as producers. A send writes each tensor's bytes once into the
# receiver's blob arena (a kind-8 record, tagged) and only ``ring:<base>:
# <count>:<seq>`` rides the RPC. The receiver's drain thread takes records
# as leases, held by tag until the RPC that names them claims them (or
# their time to live runs out: a sender whose RPC failed after the push).
# Leases release in any order; the arena reclaims behind them.

_fabric_lock = threading.Lock()
_fabric_name: Optional[str] = None
_fabric_thread: Optional[threading.Thread] = None
_fabric_stop = threading.Event()
_fabric_cv = threading.Condition()
_fabric_records: Dict[int, Tuple[object, float]] = {}  # tag -> (lease, deadline)
_fabric_pinned: Optional[Tuple[int, int]] = None  # (address, bytes) registered
_producer_target: Optional[str] = None  # the segment this process pushes to
_fabric_leases: "weakref.WeakSet" = weakref.WeakSet()  # every lease taken
_FABRIC_RECORD_TTL_S = 30.0
_FABRIC_TAKE_MS = 200
_FABRIC_PUSH_WAIT_S = 0.25  # a full arena: back off this long, then shm


def _segment_mapping(name: str) -> Optional[Tuple[int, int]]:
    """(address, bytes) of this process's mapping of the shm segment
    ``name``, from /proc/self/maps."""
    path = "/dev/shm/" + name.lstrip("/")
    with open("/proc/self/maps") as f:
        for line in f:
            if line.rstrip().endswith(path):
                lo, hi = line.split()[0].split("-")
                return int(lo, 16), int(hi, 16) - int(lo, 16)
    return None


def _fabric_pin(name: str):
    """Page-lock the segment's mapping for CUDA, once (the reference's
    registered-memory role): a lease's bytes then go to the card in
    place."""
    global _fabric_pinned
    if _fabric_pinned is not None:
        return
    where = _segment_mapping(name)
    if where is None:
        raise RuntimeError(f"device transport: fabric segment {name!r} "
                           f"is not mapped in this process")
    cudart = torch.cuda.cudart()
    err = cudart.cudaHostRegister(where[0], where[1], 0)
    if err != cudart.cudaError.success:
        raise RuntimeError(
            f"device transport: cudaHostRegister of fabric segment "
            f"{name!r} ({where[1]} B) failed: "
            f"{cudart.cudaGetErrorString(err)}")
    _fabric_pinned = where


def _fabric_arm_receiver(pin: bool = False) -> str:
    """Create this process's fabric segment and start the drain thread,
    once; returns the segment's name. '' when BRPC_TPU_FABRIC=0. A native
    library that does not build or load raises (the reference advertises
    no fabric then)."""
    global _fabric_name, _fabric_thread
    if os.environ.get("BRPC_TPU_FABRIC", "1") == "0":
        return ""
    from brpc_tpu_torch import native

    lib = native.load()
    with _fabric_lock:
        if _fabric_thread is None or not _fabric_thread.is_alive():
            size = int(os.environ.get("BRPC_TPU_FABRIC_ARENA", str(32 << 20)))
            if lib.nat_shm_lane_create(size) != 0:
                raise RuntimeError("device transport: the fabric's shm "
                                   "segment could not be created")
            _fabric_name = native.shm_lane_name()
            _fabric_stop.clear()
            _fabric_thread = threading.Thread(
                target=_fabric_drain_loop, daemon=True,
                name="tensor-fabric-drain")
            _fabric_thread.start()
        if pin:
            _fabric_pin(_fabric_name)
        return _fabric_name


def _fabric_drain_loop():
    from brpc_tpu_torch import native

    while not _fabric_stop.is_set():
        t0 = time.monotonic()
        lease = native.fabric_take(_FABRIC_TAKE_MS)
        now = time.monotonic()
        with _fabric_cv:
            # abandoned records (their RPC failed after the push) must not
            # hold the arena forever; purged on every wakeup, because a
            # full arena stops the arrivals an arrival-gated purge awaits
            stale = [t for t, (_, dl) in _fabric_records.items() if dl <= now]
            for t in stale:
                _fabric_records.pop(t)[0].release()
        if lease is None:
            if now - t0 < 1e-3:
                # an empty take that did not wait: the lane is shut down
                _fabric_stop.wait(_FABRIC_TAKE_MS / 1e3)
            continue
        _fabric_leases.add(lease)
        with _fabric_cv:
            _fabric_records[lease.tag] = (lease, now + _FABRIC_RECORD_TTL_S)
            _fabric_cv.notify_all()


def _fabric_claim(tag: int, timeout_s: float = 10.0):
    """Wait for the drain thread to deliver tag's lease; None past the
    deadline."""
    deadline = time.monotonic() + timeout_s
    with _fabric_cv:
        while True:
            entry = _fabric_records.pop(tag, None)
            if entry is not None:
                return entry[0]
            remain = deadline - time.monotonic()
            if remain <= 0:
                return None
            _fabric_cv.wait(remain)


def fabric_state() -> dict:
    """The receiver's state: its segment, the records taken and not yet
    claimed, the leases not yet released (held records and tensors over
    spans), and whether the segment is page-locked."""
    with _fabric_cv:
        held = len(_fabric_records)
    live = sum(1 for lease in list(_fabric_leases) if not lease.released)
    return {"name": _fabric_name or "", "held_records": held,
            "live_leases": live,
            "pinned": _fabric_pinned is not None,
            "draining": _fabric_thread is not None
            and _fabric_thread.is_alive()}


def _fabric_disarm() -> bool:
    """Stop the drain, release every held record, unregister the
    page-locked mapping and unlink the segment (the library keeps its
    mapping, so the unregistration always comes first). A later
    handshake arms a fresh segment. False when nothing was armed."""
    global _fabric_thread, _fabric_name, _fabric_pinned
    with _fabric_lock:
        t, _fabric_thread = _fabric_thread, None
        if t is None:
            return False
        _fabric_stop.set()
        t.join(timeout=5.0)
        with _fabric_cv:
            for lease, _ in _fabric_records.values():
                lease.release()
            _fabric_records.clear()
        if _fabric_pinned is not None:
            try:
                torch.cuda.cudart().cudaHostUnregister(_fabric_pinned[0])
            except RuntimeError:
                pass  # CUDA already torn down (at exit)
            _fabric_pinned = None
        from brpc_tpu_torch import native

        native.load().nat_shm_lane_enable(0)  # unlinks the segment
        _fabric_name = None
    return True


def _fabric_attach_producer(name: str) -> bool:
    """Attach this process as a producer on the peer segment ``name``.
    The native mapping is process-wide: one target segment per process,
    and none for a process with a segment of its own (a receiver or an
    shm-worker parent), whose other peers take the shm lane."""
    global _producer_target
    from brpc_tpu_torch import native

    if not native.available():
        return False
    with _fabric_lock:
        if _producer_target is not None:
            return _producer_target == name
        own = native.shm_lane_name()
        if own and own != name:
            return False
        if native.fabric_producer_attach(name) < 0:
            return False
        _producer_target = name
        return True


# -- in-process tensor exchange ------------------------------------------------

_inproc_registry: Dict[int, List] = {}
_inproc_lock = threading.Lock()
_inproc_next = [1]


def inproc_publish(tensors: List) -> int:
    """Register tensors for same-process pickup; returns the ticket that
    rides the wire in their place. The receiver gets the *same* tensors:
    zero-copy, and — torch tensors being mutable, unlike jax.Arrays — a
    write by either side is seen by the other."""
    with _inproc_lock:
        ticket = _inproc_next[0]
        _inproc_next[0] += 1
        _inproc_registry[ticket] = tensors
    return ticket


def inproc_claim(ticket: int) -> Optional[List]:
    with _inproc_lock:
        return _inproc_registry.pop(ticket, None)


# -- DeviceEndpoint (RdmaEndpoint analog) ---------------------------------------

# endpoint states (rdma_endpoint.h:94-115)
UNINIT = 0
HANDSHAKING = 1
ESTABLISHED = 2
FALLBACK_TCP = 3

_HANDSHAKE_MAGIC = b"TDEV"
DEFAULT_WINDOW_BYTES = 64 << 20  # in-flight tensor bytes per endpoint


class DeviceEndpoint:
    """Attached to a connection through app_connect; upgrades it for tensor
    transfer. ``device`` is the identity the handshake announces (the card
    unless the caller asks for the CPU)."""

    def __init__(self, window_bytes: int = DEFAULT_WINDOW_BYTES,
                 device: DeviceLike = None):
        self.state = UNINIT
        self.peer_info: dict = {}
        self.device = device
        self.window_bytes = window_bytes
        self._inflight = 0
        self._window_cond = threading.Condition()
        # sends retained until ACKed (the _sbuf retention, rdma_endpoint.h:214)
        self._retained: Dict[int, Tuple[object, int]] = {}
        self._next_seq = 1
        self._lock = threading.Lock()
        # xfer lane: our transfer server's address as THIS peer reaches it,
        # and a per-endpoint uid base so pull ids never collide
        self._my_xfer_addr = ""
        self._xfer_uuid_base = (uuid.uuid4().int & ((1 << 62) - 1)) & ~0xFFFFF

    def resolve_xfer_addr(self, local_ip: str):
        """Called with the handshake connection's local IP: publishes the
        transfer server's address with a wildcard host replaced by it, so
        the peer dials back over the same network path."""
        server = _global_xfer_server(self.device)
        if server is None or not local_ip:
            return
        host, _, port = server.address().rpartition(":")
        if host in ("[::]", "0.0.0.0", ""):
            host = local_ip
        self._my_xfer_addr = f"{host}:{port}"

    # ---- handshake over the TCP connection ----
    def app_connect(self, sock) -> int:
        """Blocking handshake on the freshly connected socket. A peer that
        does not answer it leaves the connection on plain TCP
        (FALLBACK_TCP), as in the reference."""
        self.state = HANDSHAKING
        sock.app_state = self
        info = json.dumps(local_device_info(self.device)).encode()
        try:
            fd = sock.fd()
            fd.sendall(_HANDSHAKE_MAGIC + struct.pack(">I", len(info)) + info)
            header = _recv_exact(fd, 8)
            if header is None or header[:4] != _HANDSHAKE_MAGIC:
                self.state = FALLBACK_TCP
                return 0
            (length,) = struct.unpack(">I", header[4:8])
            peer = _recv_exact(fd, length)
            if peer is None:
                self.state = FALLBACK_TCP
                return 0
            self.peer_info = json.loads(peer)
            self.state = (ESTABLISHED
                          if self.peer_info.get("device_count", 0) > 0
                          else FALLBACK_TCP)
            if self.state == ESTABLISHED and self.peer_info.get("xfer"):
                self.resolve_xfer_addr(fd.getsockname()[0])
            return 0
        except (OSError, ValueError):
            self.state = FALLBACK_TCP
            return 0

    @property
    def same_process(self) -> bool:
        return self.peer_info.get("process") == _process_uuid

    @property
    def same_host(self) -> bool:
        return self.peer_info.get("host") == _boot_id

    # ---- send path ----
    def prepare_send(self, tensors: List, meta, attachment: IOBuf,
                     timeout_s: float = 10.0) -> int:
        """Fill meta.tensors + attachment for ``tensors``; blocks while the
        send window is full. Returns the send's sequence number, which its
        ACK names, or 0 when the window stays full past timeout_s.

        Lanes, in the reference's order: same process -> the tensors
        themselves (a ticket rides the wire); a peer with a transfer server
        across hosts, or on this host with device_transport_prefer_xfer ->
        xfer (device to device; CUDA IPC reaches this host only); same host
        -> one device-to-host copy into a span of the send arena, a
        descriptor on the wire; otherwise, or when the arena is full ->
        wire bytes, read to the host when the frame is written."""
        for a in tensors:
            if not isinstance(a, torch.Tensor):
                raise TypeError(f"device transport: expected torch.Tensor, got {type(a)}")
        total = sum(a.numel() * a.element_size() for a in tensors)
        with self._window_cond:
            deadline = time.monotonic() + timeout_s
            while self._inflight + total > self.window_bytes:
                remain = deadline - time.monotonic()
                if remain <= 0:
                    return 0
                self._window_cond.wait(remain)
            self._inflight += total
        with self._lock:
            seq = self._next_seq
            self._next_seq += 1
        meta.compress_type = 0
        for a in tensors:
            t = meta.tensors.add()
            t.dtype = dtype_name(a.dtype)
            t.shape.extend(int(d) for d in a.shape)
            t.nbytes = a.numel() * a.element_size()
        try:
            release = self._fill_lane(tensors, meta, attachment, seq, total)
        except BaseException:
            # a lane that raises (arena, publish) must not keep the window
            with self._window_cond:
                self._inflight -= total
                self._window_cond.notify_all()
            raise
        with self._lock:
            self._retained[seq] = (release, total)
        return seq

    def _xfer_server_for_send(self):
        """The transfer server when the xfer lane is this send's lane."""
        if not (self.state == ESTABLISHED and self._my_xfer_addr
                and self.peer_info.get("xfer")):
            return None
        server = _global_xfer_server(self.device)
        if server is None:
            return None
        if self.same_host:
            return (server if _flags.get_flag("device_transport_prefer_xfer")
                    else None)
        return None if getattr(server, "same_host_only", False) else server

    def _fill_lane(self, tensors, meta, attachment, seq, total):
        if self.state == ESTABLISHED and self.same_process:
            ticket = inproc_publish(tensors)
            meta.tensors[0].sharding_spec = f"inproc:{ticket}:{seq}"
            _count("inproc")
            return lambda t=ticket: inproc_claim(t)
        server = self._xfer_server_for_send()
        if server is not None:
            # published on OUR transfer server; the peer pulls it straight
            # into its device. Nothing rides the RPC wire.
            uid = self._xfer_uuid_base + seq
            server.await_pull(uid, tensors)
            meta.tensors[0].sharding_spec = (
                f"xfer|{self._my_xfer_addr}|{uid}|{seq}")
            _count("xfer")
            return lambda: server.cancel(uid)  # a no-op once pulled
        if (self.state == ESTABLISHED and self.same_host
                and self.peer_info.get("fabric")
                and self._ring_lane_send(tensors, meta, seq)):
            # written once into the receiver's blob arena; the receiver
            # owns the spans (leases), so the ACK has nothing to free
            _count("ring")
            return None
        if self.state == ESTABLISHED and self.same_host:
            arena = default_send_arena()
            offset = arena.alloc(total) if arena is not None else None
            if offset is not None:
                try:
                    pos = offset
                    for a in tensors:
                        n = a.numel() * a.element_size()
                        if n:
                            # one device-to-host copy, straight into the span
                            arena.tensor(pos, n).copy_(
                                a.detach().contiguous().reshape(-1)
                                .view(torch.uint8))
                        pos += n
                except BaseException:
                    arena.free(offset, total)
                    raise
                meta.tensors[0].sharding_spec = (
                    f"shm:{arena.name}:{offset}:{seq}")
                _count("shm")
                return lambda: arena.free(offset, total)
            # a full arena falls through to the wire, as in the reference
        meta.tensors[0].sharding_spec = f"wire::{seq}"
        for a in tensors:
            attachment.append_device_array(a)
        _count("wire")
        return None

    def _ring_lane_send(self, tensors, meta, seq) -> bool:
        """Push each tensor's bytes as one kind-8 record (tags base ..
        base + n - 1) onto the peer's fabric; ``ring:<base>:<n>:<seq>``
        rides the RPC instead. False: the caller goes on to the shm and
        wire lanes."""
        name = self.peer_info.get("fabric") or ""
        if not name or len(tensors) > 256 or not _fabric_attach_producer(name):
            # 256: the tag stride per seq (base = uid base + (seq << 8))
            return False
        from brpc_tpu_torch import native

        base = (self._xfer_uuid_base + (seq << 8)) & ((1 << 62) - 1)
        for i, a in enumerate(tensors):
            flat = a.detach().contiguous().reshape(-1).view(torch.uint8)
            host = flat.cpu().numpy()  # a card tensor: one copy to the host
            # bounded backoff only: a receiver holding leases blocks the
            # arena's reclaim, and the answer is the shm lane, not a stall
            deadline = time.monotonic() + _FABRIC_PUSH_WAIT_S
            while native.fabric_push(host, base + i) != 0:
                if time.monotonic() >= deadline:
                    return False  # pushed records expire at the receiver
                time.sleep(0.0005)
        meta.tensors[0].sharding_spec = f"ring:{base}:{len(tensors)}:{seq}"
        return True

    def on_ack(self, seq: int):
        """Peer confirmed receipt: run the lane's release action (free the
        arena span, drop an unclaimed ticket or publication) and open the
        window, even when the release raises."""
        with self._lock:
            entry = self._retained.pop(seq, None)
        if entry is not None:
            release, total = entry
            try:
                if release is not None:
                    release()
            except Exception:
                pass
            finally:
                with self._window_cond:
                    self._inflight = max(0, self._inflight - total)
                    self._window_cond.notify_all()

    def release_all(self):
        """The connection is gone, so no ACK can arrive: release every
        retained send."""
        with self._lock:
            seqs = list(self._retained)
        for seq in seqs:
            self.on_ack(seq)

    @property
    def inflight_bytes(self) -> int:
        return self._inflight

    @property
    def retained_count(self) -> int:
        return len(self._retained)


def _recv_exact(fd, n: int) -> Optional[bytes]:
    out = b""
    while len(out) < n:
        chunk = fd.recv(n - len(out))
        if not chunk:
            return None
        out += chunk
    return out


def _land(raw_u8: torch.Tensor, dtype, shape, device,
          pinned: bool = False) -> torch.Tensor:
    """Bytes -> a tensor that owns its memory: on ``device`` through the
    block pool, or on the host when device is None."""
    if device is not None:
        return default_block_pool(device).put_via_pool(raw_u8, dtype, shape,
                                                       pinned=pinned)
    return _bytes_as(raw_u8, dtype, shape).clone()


def _lease_tensor(lease) -> torch.Tensor:
    """A host uint8 tensor laid over the lease's span, no copy: the lease
    is released when the tensor's storage (every view of it) dies."""
    if lease.nbytes == 0:
        lease.release()
        return torch.empty(0, dtype=torch.uint8)
    span = (ctypes.c_char * lease.nbytes).from_address(lease.address)
    weakref.finalize(span, lease.release)
    return torch.frombuffer(span, dtype=torch.uint8)


def _receive_ring(parts, specs, device) -> List[torch.Tensor]:
    """The ring lane: the records arrived in this process's blob arena;
    claim their leases and consume them in place."""
    if len(parts) != 4 or not (parts[1].isdigit() and parts[2].isdigit()):
        raise ValueError(f"device transport: malformed ring spec "
                         f"{':'.join(parts)!r}")
    base, count = int(parts[1]), int(parts[2])
    if count != len(specs):
        raise ValueError(f"device transport: ring record count {count} != "
                         f"{len(specs)} tensors")
    leases = []
    try:
        for i in range(count):
            lease = _fabric_claim(base + i)
            if lease is None:
                raise ValueError(f"device transport: ring record "
                                 f"{base + i} never arrived (is the fabric "
                                 f"receiver draining?)")
            leases.append(lease)
        for (_, _, nbytes), lease in zip(specs, leases):
            if lease.nbytes != nbytes:
                raise ValueError(f"device transport: ring record of "
                                 f"{lease.nbytes} B for a {nbytes} B tensor")
        if device is None:
            # zero-copy: each tensor is its span, released when it dies
            out = [_bytes_as(_lease_tensor(lease), dtype, shape)
                   for (dtype, shape, _), lease in zip(specs, leases)]
            leases = []
            return out
        dev = resolve_device(device)
        pinned = _fabric_pinned is not None and dev.type == "cuda"
        out = []
        for (dtype, shape, nbytes), lease in zip(specs, leases):
            raw = (torch.frombuffer(lease.view(), dtype=torch.uint8)
                   if nbytes else torch.empty(0, dtype=torch.uint8))
            out.append(_land(raw, dtype, shape, dev, pinned=pinned))
        if dev.type == "cuda":
            # the copies read the spans: done before the leases go back
            torch.cuda.current_stream(dev).synchronize()
        return out
    finally:
        for lease in leases:
            lease.release()


def receive_tensors(meta, attachment: IOBuf, device: DeviceLike = None,
                    endpoint: Optional[DeviceEndpoint] = None
                    ) -> Tuple[List, Optional[int]]:
    """Rebuild tensors from a tensor-bearing message. Returns (tensors,
    ack_seq). ``device=None`` returns host tensors from the wire, shm and
    ring lanes (the reference returns numpy arrays then; a ring tensor lies
    over its arena span, released when the tensor dies); a device puts
    their bytes there through the block pool. The in-process lane hands over the
    sender's tensors. The xfer lane has no host landing: it pulls onto
    ``device``, else onto the connection's device (``endpoint.device``),
    and finishes before this returns, so the caller may ACK."""
    if not meta.tensors:
        return [], None
    spec = meta.tensors[0].sharding_spec or ""
    if spec.startswith("xfer|"):
        parts = spec.split("|")
        if len(parts) != 4 or not (parts[2].isdigit() and parts[3].isdigit()):
            raise ValueError(f"device transport: malformed xfer spec {spec!r}")
        _, addr, uid, seq = parts
        specs = [_tensor_spec(t) for t in meta.tensors]
        land = device if device is not None else (
            endpoint.device if endpoint is not None else None)
        conn = _xfer_connect(addr, land)
        try:
            tensors = conn.pull(int(uid), specs, land)
        except Exception:
            _xfer_evict(addr)  # redial next time (the sender may restart)
            raise
        return list(tensors), int(seq)
    parts = spec.split(":")
    seq = None
    if len(parts) >= 3 and parts[-1].isdigit():
        seq = int(parts[-1])
    specs = [_tensor_spec(t) for t in meta.tensors]
    if parts[0] == "ring":
        return _receive_ring(parts, specs, device), seq
    if parts[0] == "inproc" and len(parts) >= 2 and parts[1].isdigit():
        tensors = inproc_claim(int(parts[1]))
        if tensors is None:
            raise ValueError(f"device transport: in-process ticket "
                             f"{parts[1]} is no longer claimable")
        return tensors, seq
    if parts[0] == "shm" and len(parts) == 4:
        on_card = device is not None and resolve_device(device).type == "cuda"
        arena = attach_arena(parts[1], pin=on_card)
        if arena is None:
            raise ValueError(
                f"device transport: cannot attach shared arena "
                f"{parts[1]!r} (sender chose the same-host lane but the "
                f"shm namespace is not shared)")
        pos = int(parts[2])
        if pos < 0 or pos + sum(n for _, _, n in specs) > arena.size:
            raise ValueError("device transport: shm descriptor past the arena")
        tensors = []
        for dtype, shape, nbytes in specs:
            raw = arena.tensor(pos, nbytes)
            pos += nbytes
            # own the bytes before the ACK lets the sender reuse the span
            tensors.append(_land(raw, dtype, shape, device,
                                 pinned=arena.pinned))
        return tensors, seq
    tensors = []
    for dtype, shape, nbytes in specs:
        raw = attachment.cutn_bytes(nbytes)
        if len(raw) != nbytes:
            raise ValueError("device transport: attachment shorter than its tensors")
        raw_u8 = (torch.frombuffer(raw, dtype=torch.uint8) if nbytes
                  else torch.empty(0, dtype=torch.uint8))
        if device is not None:
            tensors.append(default_block_pool(device).put_via_pool(
                raw_u8, dtype, shape))
        else:
            tensors.append(_bytes_as(raw_u8, dtype, shape))  # owns `raw`
    return tensors, seq
