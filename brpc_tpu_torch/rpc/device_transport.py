"""Device transport — the tensor lane's endpoint, pool and receive path.

Port of brpc_tpu/rpc/device_transport.py for torch tensors:

* ``local_device_info`` — the handshake identity, with the reference's
  keys. ``platform`` is ``"gpu"`` on the card (what JAX reports on an
  NVIDIA card). The port has no send arena, descriptor-ring fabric or
  transfer server yet, so ``arena``/``fabric``/``xfer`` are advertised as
  ``""``/``""``/``False``: a reference peer then never picks the ring or
  xfer lane toward the port.
* ``DeviceBlockPool`` — size classes 8 KB / 64 KB / 2 MB of device byte
  blocks that received bytes land in (the reference's block_pool role).
* ``DeviceEndpoint`` — the TDEV handshake, the in-flight window and
  retention until ACK, and two send lanes: the in-process ticket (same
  process: the *same* tensor is handed over, zero-copy) and wire bytes.
* ``receive_tensors`` — rebuilds tensors from the in-process, shm and wire
  lanes. The shm lane is only read: a reference peer on the same host
  stages its payload in its shared arena and sends a descriptor, and the
  port maps that segment by name.

Wire dtype names are numpy's (``"float32"``, ``"bfloat16"``, ``"int32"``),
as the reference writes them; bfloat16 bytes cross as 16-bit patterns.
"""
from __future__ import annotations

import atexit
import json
import math
import struct
import threading
import time
import uuid
from multiprocessing import resource_tracker, shared_memory
from typing import Dict, List, Optional, Tuple

import torch

from brpc_tpu_torch.butil.iobuf import IOBuf
from brpc_tpu_torch.device import DeviceLike, resolve_device

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
    return {
        "process": _process_uuid,
        "host": _boot_id,
        "arena": "",
        "fabric": "",
        "xfer": False,
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
                     device: DeviceLike = None) -> torch.Tensor:
        """Host bytes (a 1-D uint8 CPU tensor) -> a tensor of dtype/shape on
        ``device`` (default: the pool's), through pooled memory. The result
        owns its memory and is ready when this returns."""
        target = self._device if device is None else resolve_device(device)
        nbytes = host_u8.numel()
        got = self.acquire(nbytes) if target == self._device else None
        if got is None:
            return _bytes_as(host_u8, dtype, shape).to(target, copy=True)
        size_class, entry = got
        block, staging = entry
        try:
            head = block[:nbytes]
            if staging is not None:
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


# -- a peer's shared arena, attach-only (the reference's HostArena) ------------

_attached_arenas: Dict[str, shared_memory.SharedMemory] = {}
_attached_lock = threading.Lock()


def attach_arena(name: str) -> Optional[shared_memory.SharedMemory]:
    """Map a peer's arena by name, once per process. None when the segment
    cannot be opened (another host or shm namespace)."""
    with _attached_lock:
        shm = _attached_arenas.get(name)
        if shm is None:
            try:
                shm = shared_memory.SharedMemory(name=name)
            except (OSError, ValueError):
                return None
            # The segment belongs to the peer: keep this process's resource
            # tracker from unlinking it when this process exits.
            resource_tracker.unregister(shm._name, "shared_memory")
            _attached_arenas[name] = shm
    return shm


def _close_arenas():
    with _attached_lock:
        for shm in _attached_arenas.values():
            try:
                shm.close()
            except BufferError:
                pass  # a live view still maps it; unmapped when that dies
        _attached_arenas.clear()


atexit.register(_close_arenas)


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
            return 0
        except (OSError, ValueError):
            self.state = FALLBACK_TCP
            return 0

    @property
    def same_process(self) -> bool:
        return self.peer_info.get("process") == _process_uuid

    # ---- send path ----
    def prepare_send(self, tensors: List, meta, attachment: IOBuf,
                     timeout_s: float = 10.0) -> bool:
        """Fill meta.tensors + attachment for ``tensors``; blocks while the
        send window is full (False when it stays full past timeout_s).

        Lanes: same process -> the tensors themselves (a ticket rides the
        wire); otherwise -> wire bytes, read to the host (one device-to-host
        copy) when the frame is written."""
        for a in tensors:
            if not isinstance(a, torch.Tensor):
                raise TypeError(f"device transport: expected torch.Tensor, got {type(a)}")
        total = sum(a.numel() * a.element_size() for a in tensors)
        with self._window_cond:
            deadline = time.monotonic() + timeout_s
            while self._inflight + total > self.window_bytes:
                remain = deadline - time.monotonic()
                if remain <= 0:
                    return False
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
        release = self._fill_lane(tensors, meta, attachment, seq)
        with self._lock:
            self._retained[seq] = (release, total)
        return True

    def _fill_lane(self, tensors, meta, attachment, seq):
        if self.state == ESTABLISHED and self.same_process:
            ticket = inproc_publish(tensors)
            meta.tensors[0].sharding_spec = f"inproc:{ticket}:{seq}"
            return lambda t=ticket: inproc_claim(t)
        meta.tensors[0].sharding_spec = f"wire::{seq}"
        for a in tensors:
            attachment.append_device_array(a)
        return None

    def on_ack(self, seq: int):
        """Peer confirmed receipt: run the lane's release action (drop the
        unclaimed ticket) and open the window."""
        with self._lock:
            entry = self._retained.pop(seq, None)
        if entry is not None:
            release, total = entry
            if release is not None:
                release()
            with self._window_cond:
                self._inflight = max(0, self._inflight - total)
                self._window_cond.notify_all()

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


def _land(raw_u8: torch.Tensor, dtype, shape, device) -> torch.Tensor:
    """Bytes -> a tensor that owns its memory: on ``device`` through the
    block pool, or on the host when device is None."""
    if device is not None:
        return default_block_pool(device).put_via_pool(raw_u8, dtype, shape)
    return _bytes_as(raw_u8, dtype, shape).clone()


def receive_tensors(meta, attachment: IOBuf,
                    device: DeviceLike = None) -> Tuple[List, Optional[int]]:
    """Rebuild tensors from a tensor-bearing message. Returns (tensors,
    ack_seq). ``device=None`` returns host tensors (the reference returns
    numpy arrays then); a device puts the wire and shm bytes there through
    the block pool. The in-process lane hands over the sender's tensors."""
    if not meta.tensors:
        return [], None
    spec = meta.tensors[0].sharding_spec or ""
    if spec.startswith(("xfer|", "ring:")):
        raise ValueError(f"device transport: lane {spec.split(':')[0]!r} is "
                         f"not offered by this port's handshake")
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
        arena = attach_arena(parts[1])
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
            raw = (torch.frombuffer(arena.buf, dtype=torch.uint8,
                                    count=nbytes, offset=pos)
                   if nbytes else torch.empty(0, dtype=torch.uint8))
            pos += nbytes
            # own the bytes before the ACK lets the sender reuse the span
            tensors.append(_land(raw, dtype, shape, device))
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
