"""Device transport — the tensor lane's endpoint, pool and receive path.

Port of brpc_tpu/rpc/device_transport.py for torch tensors:

* ``local_device_info`` — the handshake identity, with the reference's
  keys. ``platform`` is ``"gpu"`` on the card (what JAX reports on an
  NVIDIA card). ``arena`` names this process's send arena; ``xfer`` is
  True only when this process's transfer server has started. The port
  has no descriptor-ring fabric, so ``fabric`` is ``""`` and a reference
  peer never picks the ring lane toward the port.
* ``DeviceBlockPool`` — size classes 8 KB / 64 KB / 2 MB of device byte
  blocks that received bytes land in (the reference's block_pool role).
* ``HostArena`` — a shared host arena carved into spans, page-locked for
  CUDA on the card (the reference's pinned-host arena, the
  ``ibv_reg_mr`` role): a same-host send stages its bytes there once.
* ``DeviceEndpoint`` — the TDEV handshake, the in-flight window and
  retention until ACK, and the send lanes in the reference's order:
  in-process ticket (the *same* tensor, zero-copy), xfer (device to
  device through the transfer server: CUDA IPC on one host, or the TCP
  fake), shm (one device-to-host copy into the arena, a descriptor on the
  wire) and wire bytes.
* ``receive_tensors`` — rebuilds tensors from every lane but the
  descriptor ring, which needs the native runtime.

Wire dtype names are numpy's (``"float32"``, ``"bfloat16"``, ``"int32"``),
as the reference writes them; bfloat16 bytes cross as 16-bit patterns.
"""
from __future__ import annotations

import atexit
import json
import math
import os
import struct
import threading
import time
import uuid
from multiprocessing import resource_tracker, shared_memory
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

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


def local_device_info(device: DeviceLike = None) -> dict:
    """The handshake identity, with the reference's keys. ``device`` is the
    card unless the caller asks for the CPU."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    arena = default_send_arena()
    if arena is not None and on_card:
        arena.pin()
    return {
        "process": _process_uuid,
        "host": _boot_id,
        "arena": arena.name if arena is not None else "",
        "fabric": "",
        # advertised only when the server really started: a peer that sees
        # True may publish xfer-lane payloads with nothing on the wire
        "xfer": _global_xfer_server(dev) is not None,
        "platform": "gpu" if on_card else "cpu",
        "device_count": torch.cuda.device_count() if on_card else 1,
    }


# -- DeviceBlockPool (block_pool analog) --------------------------------------

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
                    return size, self._free[size].pop()
        return None

    def release(self, size_class: int, entry):
        with self._lock:
            if size_class in self._free:
                self._free[size_class].append(entry)
                self.released += 1

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
    with _send_arena_lock:
        if _send_arena is not None:
            _send_arena.close()
            _send_arena = None
    with _attached_lock:
        for arena in _attached_arenas.values():
            arena.close()
        _attached_arenas.clear()


atexit.register(_cleanup_arenas)


# -- lanes taken, and the transfer server of the xfer lane ----------------------

_flags.define_bool(
    "device_transport_prefer_xfer", False,
    "use the transfer-server lane even for same-host peers (it is always "
    "used for cross-host device peers when both sides support it)")

_lanes = {"inproc": 0, "ring": 0, "shm": 0, "wire": 0, "xfer": 0}
_lanes_lock = threading.Lock()


def _count(lane: str):
    with _lanes_lock:
        _lanes[lane] += 1


def lane_counters() -> dict:
    """Transfers sent per lane: {'inproc', 'ring', 'shm', 'wire', 'xfer'}."""
    with _lanes_lock:
        return dict(_lanes)


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


def receive_tensors(meta, attachment: IOBuf, device: DeviceLike = None,
                    endpoint: Optional[DeviceEndpoint] = None
                    ) -> Tuple[List, Optional[int]]:
    """Rebuild tensors from a tensor-bearing message. Returns (tensors,
    ack_seq). ``device=None`` returns host tensors from the wire and shm
    lanes (the reference returns numpy arrays then); a device puts their
    bytes there through the block pool. The in-process lane hands over the
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
    if spec.startswith("ring:"):
        raise ValueError("device transport: lane 'ring' is not offered by "
                         "this port's handshake")
    parts = spec.split(":")
    seq = None
    if len(parts) >= 3 and parts[-1].isdigit():
        seq = int(parts[-1])
    specs = [_tensor_spec(t) for t in meta.tensors]
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
