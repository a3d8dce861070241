"""CUDA IPC transfer server — the xfer lane's device-to-device backend on one
host.

The reference's xfer lane rides ``jax.experimental.transfer``: a server
where a sender publishes arrays (``await_pull``) and a peer pulls them
straight into its own devices (``connect(addr).pull``). Torch has no such
server. On one host the CUDA form of it is IPC between two processes, and
this module gives it the same surface: ``address()``, ``await_pull(uid,
tensors)``, ``connect(addr)`` and ``conn.pull(uid, specs, device)``.

* Publisher. ``await_pull`` makes each tensor a contiguous card tensor (a
  copy where it was not one; the copy is what the publication retains),
  records an interprocess event on the producer's stream after the
  tensor's last write, and exports the memory handle of the allocation
  that holds it with the tensor's byte offset inside it (a handle names
  the caching allocator's whole segment). A pull request comes over TCP;
  the answer is one fixed record per tensor.
* Puller. It opens each memory handle, makes its stream wait on the
  event, copies device to device into a tensor it owns, synchronises,
  and unmaps. Only then does it answer "done"; the publisher then drops
  the publication. No payload byte touches the host.

Every field crosses in a fixed binary layout, never pickle: a peer's bytes
must not run code here. The IPC calls are a few lines of C
(``brpc_tpu_torch/csrc/cuda_ipc.cu``) built with ``nvcc`` at first use into
``brpc_tpu_torch/build/``. The lane needs the default CUDA allocator:
with ``PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True`` a tensor's
memory is not a ``cudaMalloc`` allocation, and the export fails.

Wire layout (big-endian):

    request   uid u64 | magic "CUDAIPC1"
    reply     magic "CUDAIPC1" | status u32 | count u32
    entry     mem handle 64 B | offset u64 | nbytes u64 | event handle 64 B
    done      "DONE" | uid u64          (answered with one byte, 0x01)
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import socket
import struct
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from brpc_tpu_torch.device import DeviceLike, resolve_device

MAGIC = b"CUDAIPC1"
REQUEST = struct.Struct(">Q8s")
REPLY = struct.Struct(">8sII")
ENTRY = struct.Struct(">64sQQ64s")
DONE = struct.Struct(">4sQ")
OK, UNKNOWN_UID, BAD_REQUEST = 0, 1, 2
_STATUS = {UNKNOWN_UID: "no publication under that uid",
           BAD_REQUEST: "request not understood"}

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "cuda_ipc.cu"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O2", "-shared", "-Xcompiler", "-fPIC"]
PUBLISH_WAIT_S = 10.0  # how long a pull waits for its uid, as the fake does
REQUEST_WAIT_S = 1.0   # a pull request arrives whole, or not at all


def _lane_error(what: str) -> ValueError:
    return ValueError(f"xfer lane (CUDA IPC): {what}")


def recv_exact(conn: socket.socket, n: int, what: str,
               error=_lane_error) -> bytearray:
    """n bytes or a ValueError naming the lane (made by ``error``): a
    closed or silent peer is a malformed reply, never a hang."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    try:
        while got < n:
            k = conn.recv_into(view[got:])
            if not k:
                raise error(f"short read of the {what} ({got} of {n} bytes)")
            got += k
    except socket.timeout:
        raise error(f"timed out reading the {what}") from None
    return buf


# -- the C library ------------------------------------------------------------

_lib = None
_lib_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


def build_library() -> Path:
    """Compile csrc/cuda_ipc.cu once per source version; concurrent
    processes wait on one lock and share the result."""
    src = SOURCE.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    out = BUILD_DIR / f"libbt_cuda_ipc-{digest[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "cuda_ipc.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            return out
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE), "-ldl"]
        try:
            r = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=600)
        except OSError as e:
            raise RuntimeError(f"cuda_ipc build: cannot run nvcc: {e}") from e
        if r.returncode != 0:
            raise RuntimeError(f"cuda_ipc build failed ({' '.join(cmd)}):\n"
                               f"{r.stdout}{r.stderr}")
        os.replace(tmp, out)
    return out


def load_library():
    """The built library with its argument types set."""
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library()))
            u64, u64p = ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint64)
            for name, args in (
                    ("bt_ipc_export", [ctypes.c_int, u64, ctypes.c_char_p, u64p]),
                    ("bt_ipc_open", [ctypes.c_int, ctypes.c_char_p, u64p]),
                    ("bt_ipc_close", [ctypes.c_int, u64]),
                    ("bt_ipc_copy", [ctypes.c_int, u64, u64, u64, u64]),
                    ("bt_ipc_sync", [ctypes.c_int, u64])):
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
            lib.bt_ipc_error_string.argtypes = [ctypes.c_int]
            lib.bt_ipc_error_string.restype = ctypes.c_char_p
            if lib.bt_ipc_handle_size() != 64:
                raise RuntimeError("cuda_ipc: cudaIpcMemHandle_t is not 64 bytes")
            _lib = lib
    return _lib


def _check(lib, rc: int, call: str):
    if rc != 0:
        raise RuntimeError(f"cuda_ipc: {call} failed: "
                           f"{lib.bt_ipc_error_string(rc).decode()} ({rc})")


# -- publisher ------------------------------------------------------------------

class _Publication:
    __slots__ = ("tensors", "events", "entries")

    def __init__(self, tensors, events, entries):
        self.tensors = tensors  # retained until the puller is done
        self.events = events    # kept alive until the puller waited on them
        self.entries = entries


def _publish(tensors: Sequence[torch.Tensor]) -> _Publication:
    lib = None
    kept, events, entries = [], [], []
    for t in tensors:
        if t.device.type != "cuda":
            t = t.to(resolve_device(None))
        t = t.contiguous()  # a copy only where needed; the publication keeps it
        dev = t.device
        nbytes = t.numel() * t.element_size()
        handle, offset, ev_handle = bytes(64), 0, bytes(64)
        if nbytes:
            lib = lib or load_library()
            with torch.cuda.device(dev):
                ev = torch.cuda.Event(interprocess=True)
                ev.record(torch.cuda.current_stream(dev))
                ev_handle = ev.ipc_handle()
            events.append(ev)
            buf = ctypes.create_string_buffer(64)
            off = ctypes.c_uint64()
            _check(lib, lib.bt_ipc_export(dev.index, t.data_ptr(), buf,
                                          ctypes.byref(off)),
                   "cudaIpcGetMemHandle (is the default CUDA allocator in "
                   "use? expandable_segments memory cannot be exported)")
            handle, offset = buf.raw, off.value
        kept.append(t)
        entries.append(ENTRY.pack(handle, offset, nbytes, ev_handle))
    return _Publication(kept, events, b"".join(entries))


class CudaIpcTransferServer:
    """Quacks like jax.experimental.transfer's server, over CUDA IPC. Pulls
    are served on the server's own threads, never on an RPC thread."""

    # IPC handles open only on this host: a cross-host peer never takes
    # this lane
    same_host_only = True

    def __init__(self, ip: str = "127.0.0.1"):
        self._published: Dict[int, _Publication] = {}
        self._cv = threading.Condition()
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((ip, 0))
        self._listener.listen(64)
        self._ip = ip
        self._port = self._listener.getsockname()[1]
        threading.Thread(target=self._accept_loop, daemon=True,
                         name="cuda_ipc_xfer_server").start()

    def address(self) -> str:
        # loopback, not the wildcard: the lane is same-host by nature
        return f"{self._ip}:{self._port}"

    def await_pull(self, uid: int, tensors):
        pub = _publish(list(tensors))
        with self._cv:
            self._published[uid] = pub
            self._cv.notify_all()

    def cancel(self, uid: int):
        """Drop a publication no peer pulled (its sender got the ACK)."""
        with self._cv:
            self._published.pop(uid, None)

    def connect(self, addr: str) -> "CudaIpcConnection":
        return CudaIpcConnection(addr)

    def published_count(self) -> int:
        with self._cv:
            return len(self._published)

    def stop(self):
        try:
            self._listener.close()
        except OSError:
            pass

    def _accept_loop(self):
        while True:
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            threading.Thread(target=self._serve, args=(conn,), daemon=True,
                             name="cuda_ipc_xfer_pull").start()

    def _serve(self, conn: socket.socket):
        with conn:
            conn.settimeout(REQUEST_WAIT_S)
            try:
                uid, magic = REQUEST.unpack(
                    recv_exact(conn, REQUEST.size, "pull request"))
            except ValueError:
                magic = b""
            if magic != MAGIC:
                # a peer of another kind (the TCP fake's 8-byte request):
                # answer with our magic so it fails at once
                conn.sendall(REPLY.pack(MAGIC, BAD_REQUEST, 0))
                return
            with self._cv:
                self._cv.wait_for(lambda: uid in self._published,
                                  PUBLISH_WAIT_S)
                # serving the pull releases the publication once the
                # puller is done with it (or gone)
                pub = self._published.pop(uid, None)
            if pub is None:
                conn.sendall(REPLY.pack(MAGIC, UNKNOWN_UID, 0))
                return
            conn.settimeout(None)
            try:
                conn.sendall(REPLY.pack(MAGIC, OK, len(pub.tensors))
                             + pub.entries)
                tag, done_uid = DONE.unpack(
                    recv_exact(conn, DONE.size, "done frame"))
                del pub
                if tag == b"DONE" and done_uid == uid:
                    conn.sendall(b"\x01")
            except (OSError, ValueError):
                pass


# -- puller ---------------------------------------------------------------------

Spec = Tuple[torch.dtype, Tuple[int, ...], int]  # dtype, shape, nbytes


def read_reply(conn: socket.socket, addr: str, specs: Sequence[Spec]):
    """The publisher's reply, checked against what the RPC meta announced,
    before any CUDA call: [(mem handle, offset, nbytes, event handle)]."""
    magic, status, count = REPLY.unpack(
        recv_exact(conn, REPLY.size, "reply header"))
    if magic != MAGIC:
        raise _lane_error(f"{addr} is not a CUDA IPC transfer server "
                          f"(reply starts {magic!r})")
    if status != OK:
        raise _lane_error(f"{addr}: {_STATUS.get(status, status)}")
    if count != len(specs):
        raise _lane_error(f"{count} tensors published, {len(specs)} requested")
    entries = []
    for i, (_, _, want) in enumerate(specs):
        handle, offset, nbytes, ev = ENTRY.unpack(
            recv_exact(conn, ENTRY.size, f"entry {i}"))
        if nbytes != want:
            raise _lane_error(f"tensor {i}: {nbytes} bytes published, "
                              f"{want} announced")
        entries.append((handle, offset, nbytes, ev))
    return entries


class CudaIpcConnection:
    def __init__(self, addr: str):
        self.addr = addr

    def pull(self, uid: int, specs: Sequence[Spec],
             device: DeviceLike = None) -> List[torch.Tensor]:
        """Pull a publication onto ``device`` (the card unless told; the
        lane has no host landing). Returns tensors this process owns,
        ready when this returns."""
        host, _, port = self.addr.rpartition(":")
        with socket.create_connection((host, int(port)),
                                      timeout=PUBLISH_WAIT_S + 5) as c:
            c.sendall(REQUEST.pack(uid, MAGIC))
            entries = read_reply(c, self.addr, specs)
            dev = resolve_device(device)
            if dev.type != "cuda":
                raise _lane_error(f"cannot land on {dev}: the lane is "
                                  f"device to device")
            out = _copy_in(entries, specs, dev)
            c.sendall(DONE.pack(b"DONE", uid))
            if recv_exact(c, 1, "release answer") != b"\x01":
                raise _lane_error("publisher did not confirm the release")
        return out


def _copy_in(entries, specs, dev: torch.device) -> List[torch.Tensor]:
    lib = load_library()
    stream = torch.cuda.current_stream(dev)
    bases: Dict[bytes, int] = {}
    out = []
    try:
        for (handle, offset, nbytes, ev), (dtype, shape, _) in zip(entries,
                                                                   specs):
            dst = torch.empty(nbytes, dtype=torch.uint8, device=dev)
            if nbytes:
                # the producer's writes are ordered before our copy
                stream.wait_event(torch.cuda.Event.from_ipc_handle(dev, ev))
                base = bases.get(handle)
                if base is None:
                    b = ctypes.c_uint64()
                    _check(lib, lib.bt_ipc_open(dev.index, handle,
                                                ctypes.byref(b)),
                           "cudaIpcOpenMemHandle")
                    base = bases[handle] = b.value
                _check(lib, lib.bt_ipc_copy(dev.index, dst.data_ptr(),
                                            base + offset, nbytes,
                                            stream.cuda_stream),
                       "cudaMemcpyAsync")
            out.append(dst.view(dtype).reshape(shape))
    finally:
        # the copies finish before the mappings go, whatever happened;
        # unmap before answering "done": a mapping left open would keep
        # the producer's segment pinned past its release
        rc = lib.bt_ipc_sync(dev.index, stream.cuda_stream)
        for base in bases.values():
            lib.bt_ipc_close(dev.index, base)
    _check(lib, rc, "cudaStreamSynchronize")
    return out
